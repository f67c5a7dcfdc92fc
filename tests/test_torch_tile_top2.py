"""``tile_top2`` (the port's counterpart of the TPU kernel #2, the per-step
lane-reduce body of ``fqtk_tpu/ops/pallas_matcher.py:285``) against the JAX
package, on the same seeded bit2 inputs.

On the CPU the wrapper runs the kernel's plain PyTorch version
(``tile_top2_reference``; the port's matcher is built on a ``tile_top2``
state whatever K is); the JAX side runs ``make_pallas_assign_fn`` in
interpret mode with flags that make its plan take kernel #2
(``_top2_colmerge=False`` or ``mxu_dtype="bf16"``), and the NumPy spec
``assign_batch_np``.  The CUDA kernel itself is held to the plain version by
``test_torch_kernels_gpu.py`` and ``chip_smoke.py`` on the card.  Every
comparison is exact (tolerance 0): the outputs are integers."""

import logging

import numpy as np
import pytest
import torch

from fqtk_tpu.ops.matcher import ExpectedSet
from fqtk_tpu.ops.pallas_matcher import (
    _compat_classmajor,
    make_pallas_assign_fn,
    plan_local_kernel,
)
from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.runtime import demux as torch_demux

from .test_torch_demux_e2e import _kw, _outputs, _write_inputs
from .test_torch_kernels_gpu import ACGT, spec, whitelist_case

#: flags that turn the TPU kernel's column-merge scheme off (kernel #2 runs)
KERNEL2_FLAGS = {
    "no_colmerge": {"_top2_colmerge": False},
    "bf16": {"mxu_dtype": "bf16"},
}


def tile_fn(es, mm, delta):
    """The port's matcher on a ``tile_top2`` state (on the CPU)."""
    state = hm.hopper_state_from_numpy(es, "cpu", "tile_top2")
    return hm.HopperAssignFn(state, mm, delta, compact_output=True)


def port(es, mm, delta, packed):
    fn = tile_fn(es, mm, delta)
    assert fn.scheme == "tile_top2"
    idx, best, nxt = (t.numpy() for t in fn(packed))
    tile, colmerge = fn.kernels["tile_top2"], fn.kernels["colmerge_top2"]
    assert (tile.plain_calls, tile.launches) == (1, 0)
    assert (colmerge.plain_calls, colmerge.launches) == (0, 0)
    return idx, best, nxt


def pallas(es, mm, delta, packed, **flags):
    assert not plan_local_kernel(
        es.count, es.length, tile_b=256, tile_k=128, packed2=True, **flags
    ).colmerge
    fn = make_pallas_assign_fn(
        es, mm, delta, interpret=True, packed2=True, compact_output=True,
        tile_b=256, tile_k=128, **flags,
    )
    return tuple(np.asarray(x) for x in fn(packed))


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            np.asarray(g).astype(np.int64), np.asarray(w).astype(np.int64)
        )


@pytest.mark.parametrize("mode", sorted(KERNEL2_FLAGS))
@pytest.mark.parametrize("mm,delta", [(1, 2), (0, 0), (2, 1)])
@pytest.mark.parametrize("length", [9, 12, 17])
@pytest.mark.parametrize("k", [1, 43, 300])
def test_matches_pallas_kernel2_and_numpy(k, length, mm, delta, mode):
    rng = np.random.default_rng(k * 100 + length)
    es, obs = whitelist_case(rng, k=k, length=length, b=300)
    packed = pack_bit2(obs)
    flags = KERNEL2_FLAGS[mode]
    got = port(es, mm, delta, packed)
    assert got[0].dtype == (np.uint8 if k < 255 else np.int32)
    assert_same(got, pallas(es, mm, delta, packed, **flags))
    assert_same(got, spec(obs, es, mm, delta))


@pytest.mark.parametrize("tile_k", [7, 64, 128])
def test_first_index_tie_across_k_tiles(monkeypatch, tile_k):
    """Duplicated barcodes in different K tiles force cross-tile ties: the
    first global index must win, and ``next`` equals ``best``."""
    rng = np.random.default_rng(23)
    seqs = rng.choice(ACGT, size=(300, 12)).astype(np.uint8)
    seqs[150] = seqs[3]
    seqs[299] = seqs[0]
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in seqs])
    obs = rng.choice(ACGT, size=(333, 12)).astype(np.uint8)
    obs[:300] = seqs
    packed = pack_bit2(obs)
    monkeypatch.setattr(hm, "TILE_K", tile_k)
    got = port(es, 2, 0, packed)
    assert got[0][150] == 3 and got[1][150] == 0 and got[2][150] == 0
    assert got[0][299] == 0 and got[2][299] == 0
    assert_same(got, spec(obs, es, 2, 0))
    assert_same(got, pallas(es, 2, 0, packed, _top2_colmerge=False))


@pytest.mark.parametrize("mode", sorted(KERNEL2_FLAGS))
def test_iupac_whitelist(mode):
    es = ExpectedSet.from_barcodes(["NNAAAAAA", "NNCCCCCC", "RYAAAAAA"])
    reads = [b"ACAAAAAA", b"GTCCCCCC", b"GCAAAAAA", b"TTTTTTTT"]
    obs = np.stack([np.frombuffer(r, dtype=np.uint8) for r in reads])
    packed = pack_bit2(obs)
    got = port(es, 0, 0, packed)
    assert list(got[0]) == [0, 1, 0, 3]
    assert_same(got, spec(obs, es, 0, 0))
    assert_same(got, pallas(es, 0, 0, packed, **KERNEL2_FLAGS[mode]))


@pytest.mark.parametrize("b", [1, 255, 513])
def test_b_not_a_tile_multiple(monkeypatch, b):
    rng = np.random.default_rng(b)
    es, obs = whitelist_case(rng, k=96, length=17, b=b)
    packed = pack_bit2(obs)
    monkeypatch.setattr(hm, "TILE_K", 40)  # a ragged last K tile as well
    got = port(es, 1, 2, packed)
    assert got[0].shape == (b,)
    assert_same(got, spec(obs, es, 1, 2))


def test_plain_version_row_chunks(monkeypatch):
    """Row chunks of the plain version (``_PLAIN_CHUNK_ELEMS // TILE_K``
    rows) concatenate to the unchunked result."""
    rng = np.random.default_rng(4)
    es, obs = whitelist_case(rng, k=70, length=10, b=301)
    state = hm.hopper_state_from_numpy(es, "cpu", "tile_top2")
    packed = torch.from_numpy(pack_bit2(obs))
    whole = hm.tile_top2_reference(packed, state.table, es.count, es.length)
    monkeypatch.setattr(hm, "TILE_K", 16)
    monkeypatch.setattr(hm, "_PLAIN_CHUNK_ELEMS", 16 * 50)  # 50 rows a chunk
    chunked = hm.tile_top2_reference(packed, state.table, es.count, es.length)
    assert_same([t.numpy() for t in chunked], [t.numpy() for t in whole])
    assert_same([whole[0].numpy(), whole[2].numpy()], spec(obs, es, 1, 2)[1:])


SCHEME_KS = [
    1, 96, 128, 129, 2048, 2049, 8192, 65_536, 737_280, 2_097_152, 2_097_153,
    4_194_303, 4_194_304, 4_194_305, 6_794_880, 8_388_608, 8_388_609,
    9_000_000, 16_777_216, 33_554_433, 100_000_000, 1_000_000_000,
]


@pytest.mark.parametrize("length", [8, 16, 17])
@pytest.mark.parametrize("k", SCHEME_KS)
def test_scheme_is_the_jax_plan_choice(k, length):
    """The port runs kernel #2's counterpart exactly where the JAX package's
    device path (``fqtk_tpu.runtime.demux``: tile_b 512, tile_k 2048, int8)
    runs kernel #2."""
    plan = plan_local_kernel(
        k, length, tile_b=512, tile_k=2048, packed2=True, mxu_dtype="int8"
    )
    want = "colmerge_top2" if plan.colmerge else "tile_top2"
    assert hm.hopper_scheme(k, length) == want


def test_scheme_at_the_demux_tiling():
    """The column-merge scheme ends at 4,194,304 barcodes; the single-cell
    whitelist takes tile_top2."""
    got = {k: hm.hopper_scheme(k, 16) for k in SCHEME_KS}
    assert [k for k, s in got.items() if s == "colmerge_top2"] == SCHEME_KS[:13]
    assert got[6_794_880] == "tile_top2"


def test_fn_scheme_matches_helper(monkeypatch):
    rng = np.random.default_rng(2)
    es, _ = whitelist_case(rng, k=43, length=12, b=1)
    fn = hm.make_hopper_assign_fn(es, 1, 2, device="cpu")
    assert fn.scheme == fn.state.scheme == hm.hopper_scheme(43, 12) == "colmerge_top2"
    assert fn.state.table.dtype == torch.int8
    monkeypatch.setattr(hm, "hopper_scheme", lambda k, length: "tile_top2")
    fn = hm.make_hopper_assign_fn(es, 1, 2, device="cpu")
    assert fn.scheme == fn.state.scheme == "tile_top2"
    # both schemes read the one int8 table of the tensor-core product
    assert fn.state.table.dtype == torch.int8
    assert fn.state.table.numel() == fn.state.k_pad * hm.table_depth(12)
    with pytest.raises(ValueError, match="scheme"):
        hm.hopper_state_from_numpy(es, "cpu", "colmerge")


def test_k_above_colmerge_key_limit_is_accepted():
    """More than 2^23 barcodes (colmerge_top2's key limit) go to tile_top2
    instead of being refused; colmerge_top2 itself keeps its bound."""
    k = hm.MAX_K + 1
    masks = np.ones((k, 1), dtype=np.uint8)  # 'A'
    masks[5_000_001, 0] = masks[k - 1, 0] = 4  # 'G', in tiles 610 and 1024
    es = ExpectedSet(masks=masks, max_ns_in_barcodes=0, length=1, count=k)
    fn = hm.make_hopper_assign_fn(es, 0, 0, device="cpu")
    assert fn.scheme == "tile_top2"
    obs = np.frombuffer(b"GCA", dtype=np.uint8)[:, None]
    assigned, best, nxt = (t.numpy() for t in fn(pack_bit2(obs)))
    assert fn.kernels["tile_top2"].plain_calls == 1
    assert list(assigned) == [5_000_001, k, 0]
    assert list(best) == [0, 1, 0] and list(nxt) == [0, 1, 0]
    assert_same((assigned, best, nxt), spec(obs, es, 0, 0))
    table = torch.ones_like(fn.state.table)
    with pytest.raises(ValueError, match="k="):
        hm.ColmergeTop2()._launch(torch.from_numpy(pack_bit2(obs)), table, k, 1)


@pytest.mark.parametrize("length", [8, 17, 33])
@pytest.mark.parametrize("k", [1, 43, 300])
def test_bits_table_is_the_packed_compat_table(k, length):
    rng = np.random.default_rng(k + length)
    es, _ = whitelist_case(rng, k=k, length=length, b=1)
    state = hm.hopper_state_from_numpy(es, "cpu", "tile_top2")
    k_pad = state.k_pad
    compat = _compat_classmajor(es.masks, k_pad, 4)  # [4L, k_pad] 0/1
    kp = 32 * -(-4 * length // 32)
    kp = kp if kp <= 128 else 128 * -(-kp // 128)
    assert k_pad % 128 == 0 and k_pad - k < 128
    assert state.table.dtype == torch.int8 and state.table.is_contiguous()
    assert kp == hm.table_depth(length)
    sb = min(kp, 128)  # depth bytes of one staged slice
    assert tuple(state.table.shape) == (k_pad // 128, kp // sb, 16, sb // 16, 8, 16)
    # entry j of column c sits where wgmma's no-swizzle K-major B tile has it:
    # sub-tile, slice, 8-column group, 16-byte depth chunk, column, byte
    tiled = state.table.numpy()
    got = tiled.transpose(0, 2, 4, 1, 3, 5).reshape(k_pad, kp)
    np.testing.assert_array_equal(got[:, : 4 * length], compat.T)
    assert not got[:, 4 * length:].any()  # the depth pad multiplies to nothing
    rng2 = np.random.default_rng(0)
    for c, j in zip(rng2.integers(0, k_pad, 50), rng2.integers(0, 4 * length, 50)):
        off = ((c // 128 * (kp // sb) + j // sb) * 128 * sb
               + ((c % 128 // 8) * (sb // 16) + j % sb // 16) * 128 + c % 8 * 16 + j % 16)
        assert tiled.reshape(-1)[off] == compat[j, c]
    np.testing.assert_array_equal(
        hm.table_columns(state.table, 0, k_pad, 4 * length).numpy(), compat
    )
    # the bit words the kernel builds its one-hot against are those of the
    # lab's bit table (the previous layout) of the same columns
    nw = -(-4 * length // 32)
    padded = np.zeros((nw * 32, k_pad), dtype=np.uint64)
    padded[: 4 * length] = compat
    shifts = np.arange(32, dtype=np.uint64)[None, :, None]
    want = (padded.reshape(nw, 32, k_pad) << shifts).sum(axis=1)
    want = want.astype(np.uint32).T  # [k_pad, nw]
    from fqtk_tpu_torch.ops.lab_kernels import pack_compat_bits

    bits = pack_compat_bits(torch.from_numpy(got[:, : 4 * length].T.copy()))
    np.testing.assert_array_equal(bits.numpy(), want)


def _clustered_window(rng, barcodes, b, cells):
    """bench.py's clustered single-cell recipe: reads drawn from ``cells``
    whitelist entries, 10% with a random base at a random position."""
    codes = rng.integers(0, len(barcodes), size=cells)
    obs = barcodes[codes[rng.integers(0, cells, size=b)]].copy()
    length = barcodes.shape[1]
    mut = rng.integers(0, 10, size=b) == 0
    pos = rng.integers(0, length, size=b)
    obs[mut, pos[mut]] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
    return obs


def test_slice_window_through_dedup_matches_jax(monkeypatch):
    """A clustered 8,192-row window through the port's window dedup and
    tile_top2's plain version equals the JAX kernel #2 behind the JAX
    package's window dedup, and the NumPy spec."""
    monkeypatch.delenv("FQTK_DEVICE_DEDUP", raising=False)
    rng = np.random.default_rng(31)
    barcodes = np.unique(rng.choice(ACGT, size=(320, 16)).astype(np.uint8), axis=0)[:300]
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in barcodes])
    obs = _clustered_window(rng, barcodes, 8192, cells=40)
    packed = pack_bit2(obs)

    fn = tile_fn(es, 1, 2)
    sent = []

    def call(rows):
        sent.append(len(rows))
        return torch_demux._Pending(fn(rows)[0], keep=rows)

    got = torch_demux._wrap_window_dedup(call)(packed).fetch()
    assert sent == [4096]  # the dedup engaged: one bucket of unique rows
    assert fn.kernels["tile_top2"].plain_calls == 1

    jfn = make_pallas_assign_fn(
        es, 1, 2, interpret=True, packed2=True, compact_output=True,
        tile_b=256, tile_k=128, _top2_colmerge=False,
    )
    want = jax_demux._wrap_window_dedup(lambda rows: jfn(rows)[0])(packed)
    np.testing.assert_array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(got.astype(np.int64), spec(obs, es, 1, 2)[0])


@pytest.fixture(scope="module")
def demux_inputs(tmp_path_factory):
    from fqtk_tpu.io import native as native_io

    if not native_io.available():
        pytest.skip("native library unavailable")
    tmp = tmp_path_factory.mktemp("torch_tile_top2")
    rng = np.random.default_rng(5)
    barcodes = sorted({"".join(rng.choice(list("ACGT"), size=17)) for _ in range(24)})
    paths, meta = _write_inputs(tmp, barcodes)
    return tmp, paths, meta


def test_demux_through_tile_top2_matches_colmerge_run(demux_inputs, monkeypatch, caplog):
    tmp, paths, meta = demux_inputs

    def run(name):
        out = tmp / name
        with caplog.at_level(logging.INFO, logger="fqtk"):
            res = torch_demux.run_demux(
                torch_demux.DemuxConfig(
                    **_kw(paths, meta, out, matcher="device", device="cpu")
                )
            )
        return res, _outputs(out)

    res_c, out_c = run("colmerge")
    assert res_c.matcher["colmerge_top2_plain_calls"] >= 3
    assert res_c.matcher["tile_top2_plain_calls"] == 0
    assert "device matcher colmerge_top2: 0 kernel launches" in caplog.text
    caplog.clear()

    monkeypatch.setattr(hm, "hopper_scheme", lambda k, length: "tile_top2")
    res_t, out_t = run("tile")
    assert res_t.matcher["tile_top2_plain_calls"] >= 3
    assert res_t.matcher["colmerge_top2_plain_calls"] == 0
    assert res_t.matcher["launches"] == 0  # no card here
    assert res_t.matcher["plain_calls"] == res_t.matcher["tile_top2_plain_calls"]
    assert "device matcher: Hopper tile_top2 on cpu" in caplog.text
    assert "device matcher tile_top2: 0 kernel launches" in caplog.text
    assert out_t == out_c
    assert res_t.total_templates == res_c.total_templates
