"""The port's kernel lab (``fqtk_tpu_torch.lab.kernel_lab``, TPU kernels
#3-#7 and the ``v0_colmerge`` baseline) against ``scripts/kernel_lab.py``
on the same seeded inputs.

The JAX script is imported by path.  Its Pallas bodies run in interpret mode
here: for these tests only, ``jax.experimental.pallas.pallas_call`` is
replaced by a wrapper that sets ``interpret=True`` (the JAX package is not
changed).  ``v4_int4`` (kernel #3) is the exception: XLA:CPU has no int4
dot, so its port is held to a NumPy oracle of the body (the count of
column 0 of the last K tile) built from the script's own table.  The port
runs on the CPU, i.e. through the kernels' plain
PyTorch versions; the CUDA kernels are held to those by
``test_torch_kernels_gpu.py`` and ``chip_smoke.py`` on the card.  Every
comparison is exact (tolerance 0): the outputs are integers."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fqtk_tpu.core.encoding import ENCODE_LUT
from fqtk_tpu_torch.lab import kernel_lab as lab
from fqtk_tpu_torch.ops import lab_kernels as lk
from fqtk_tpu_torch.ops.lab_kernels import pack_compat_bits

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "kernel_lab.py"

#: every ported variant name the JAX lab runs on the CPU (``v4_int4``:
#: see :func:`test_v4_int4_matches_numpy_oracle`)
PORTED = ("v0_colmerge", *lk.PROBES, "v5_clamp16", "v6_group2", "v6_group4",
          "v6_group8", "v3_clamp8", "v3w_clamp8")

#: (K, L, tile_b, tile_k): K = 1,000 is not a multiple of tile_k (pad
#: columns of all ones take part); L = 7 fills one bit word partly
SHAPES = [(1024, 16, 32, 128), (1000, 16, 32, 128), (1000, 7, 32, 128)]
B = 64


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_kernel_lab", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    )


def jax_masks(codes):
    return ENCODE_LUT[np.frombuffer(b"ACGT", dtype=np.uint8)[codes]]


def reads(codes, b, seed):
    """Rows drawn from the list: a third exact, a third with one random
    base, a third random."""
    rng = np.random.default_rng(seed)
    k, length = codes.shape
    obs = codes[rng.integers(0, k, size=b)].copy()
    one = np.arange(b) % 3 == 1
    obs[one, rng.integers(0, length, size=b)[one]] = rng.integers(0, 4, size=int(one.sum()))
    rand = np.arange(b) % 3 == 2
    obs[rand] = rng.integers(0, 4, size=(int(rand.sum()), length))
    return obs.astype(np.uint8)


def run_jax(script, name, codes, obs, tile_b, tile_k):
    go, compat, macs = script.make_variant(
        name, jax_masks(codes), codes.shape[1], tile_b=tile_b, tile_k=tile_k
    )
    out = go(jnp.asarray(obs.T.astype(np.int32)), compat)
    return [np.asarray(x) for x in out], macs


def run_port(name, codes, obs, tile_b, tile_k):
    go, table, macs = lab.make_lab_variant(
        name, lab.masks_of(codes), codes.shape[1], tile_b=tile_b, tile_k=tile_k,
        device="cpu",
    )
    out = go(torch.from_numpy(lab.pack_bit2(obs)), table)
    return [x.numpy() for x in out], macs, go


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "K%d_L%d_tb%d_tk%d" % s)
@pytest.mark.parametrize("name", PORTED)
def test_variant_matches_jax_lab(script, interpret, name, shape):
    k, length, tile_b, tile_k = shape
    if name.startswith("v6_group") and -(-k // tile_k) % int(name[8:]):
        pytest.skip("n_k_tiles is not a multiple of P")
    codes = lab.unique_barcodes(k, length)
    obs = reads(codes, B, seed=k + length)
    want, want_macs = run_jax(script, name, codes, obs, tile_b, tile_k)
    lk.reset_counts()
    got, macs, go = run_port(name, codes, obs, tile_b, tile_k)
    assert macs == want_macs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (B,)
        np.testing.assert_array_equal(g, w)
    if name != "v0_colmerge":
        assert (go.kernel.launches, go.kernel.plain_calls) == (0, 1)
        assert lk.counts()[go.params.kernel] == (0, 1)


#: other ``wgmma`` widths and table depths of the tensor-core lab kernels:
#: tile_k 64 (N = 64) at KP 128, tile_k 96 (N = 32) at KP 32
TILED_SHAPES = [(1000, 31, 32, 64), (500, 7, 32, 96)]


def whole_groups(name, k, tile_k):
    """``k``, or for ``v6_group{P}`` the K of as many more K tiles as make
    their count a multiple of 8 (every P), with the same ragged last tile."""
    if not name.startswith("v6_group"):
        return k
    n = -(-k // tile_k)
    return k + (-(-n // 8) * 8 - n) * tile_k


@pytest.mark.parametrize("shape", TILED_SHAPES, ids=lambda s: "K%d_L%d_tb%d_tk%d" % s)
@pytest.mark.parametrize("name", [n for n in lk.TILED_VARIANTS if n != "v4_int4"])
def test_tiled_variant_matches_jax_lab(script, interpret, name, shape):
    """Every kernel that reads the tiled int8 table (``lab_probe``,
    ``clamp16_top2``, ``group_top2``, ``clamp8_top2``) at the slice widths
    64 and 32: equal to the JAX lab, tolerance 0 (``v4_int4``, whose JAX
    body XLA:CPU cannot run, at these shapes too:
    :func:`test_v4_int4_matches_numpy_oracle`)."""
    k, length, tile_b, tile_k = shape
    k = whole_groups(name, k, tile_k)
    codes = lab.unique_barcodes(k, length)
    obs = reads(codes, B, seed=k + length)
    want, want_macs = run_jax(script, name, codes, obs, tile_b, tile_k)
    got, macs, go = run_port(name, codes, obs, tile_b, tile_k)
    assert macs == want_macs and go.kernel.table_format == "tiled"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["v3_clamp8", "v3w_clamp8"])
def test_clamp8_ties_match_jax_lab(script, interpret, name):
    """The same clamped count at one position of three K tiles (the first
    tile wins) and a read that clamps to W everywhere (tile id 0 stays)."""
    codes, rows = lab.tie_case(tile_k=32)
    obs = np.concatenate([rows, reads(codes, 30, seed=4)])
    want, _ = run_jax(script, name, codes, obs, 32, 32)
    got, _, go = run_port(name, codes, obs, 32, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    idx, best, nxt = got
    assert (best[0], idx[0], nxt[0]) == (0, 5, 0)
    assert (best[1], idx[1], nxt[1]) == (go.params.w_clamp, 0, go.params.w_clamp)


@pytest.mark.parametrize("name", ["v5_clamp16", "v6_group2", "v6_group4", "v6_group8"])
def test_exact_ties_match_jax_lab(script, interpret, name):
    """Count 0 at position 5 of eight K tiles: the first tile wins within a
    group of ``v6_group{P}`` and across groups, and for ``v5_clamp16``
    against keys of later tiles; a read whose every count is above W
    (``v5_clamp16``: all clamp to W, tile 0 and position 0 win)."""
    codes, rows = lab.tie_case(tile_k=32, n_tiles=8)
    obs = np.concatenate([rows, reads(codes, 30, seed=5)])
    want, _ = run_jax(script, name, codes, obs, 32, 32)
    got, _, go = run_port(name, codes, obs, 32, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    idx, best, nxt = got
    assert (best[0], idx[0], nxt[0]) == (0, 5, 0)
    if name == "v5_clamp16":
        assert (best[1], idx[1], nxt[1]) == (go.params.w_clamp, 0, go.params.w_clamp)
    else:
        assert best[1] >= 5


@pytest.mark.parametrize(
    "name,k,length,tile_k,width,lanes16",
    [("v5_clamp16", 737_280, 16, 2048, 128, None), ("v6_group4", 737_280, 16, 2048, 64, True),
     ("v6_group2", 1100, 16, 96, 32, True), ("v3_clamp8", 1000, 16, 64, 64, None),
     ("v6_group8", 1024 * 256, 15, 256, 64, True),
     # keys of 15 bits or more: group_top2's int32 twin
     ("v6_group8", 33_019, 16, 32, 32, False), ("v6_group8", 2056 * 256, 15, 256, 32, False)],
)
def test_kernel_widths(name, k, length, tile_k, width, lanes16):
    """The CTA width each kernel runs at, as ``csrc/lab_mma.cuh``'s
    ``lab_width`` gives it (``group_top2``: at most 64 in 16x2 lanes, 32 in
    int32), and the partials' slices that follow from it."""
    p = lk.lab_params(name, k, length, tile_k)
    assert p.width == width
    assert lk.LAB_KERNELS[p.kernel].n_slices(p) == tile_k // width
    if p.kernel == "group_top2":
        assert lk.group_lanes16(length, p.nt_pow2) is lanes16
        assert lanes16 == (length * p.nt_pow2 + p.nt_pow2 - 1 < 1 << 15)


@pytest.mark.parametrize("tile_k", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("k,length", [(1000, 7), (1000, 16), (700, 31)])
def test_tiled_table_reads_back(k, length, tile_k):
    """The tiled int8 table: the columns reader gives back
    ``compat_classmajor4(...).T`` (pad columns all ones), and the N columns
    of (K tile, slice) are one contiguous block in ``wgmma``'s K-major
    core-matrix order, at every slice width N."""
    codes = lab.unique_barcodes(k, length)
    masks = lab.masks_of(codes)
    k_padded = -(-k // tile_k) * tile_k
    assert k_padded != k
    compat = lab.compat_classmajor4(masks, k_padded)
    table = lab.lab_table_tiled(masks, tile_k, "cpu")
    wl, kp = 4 * length, lk.mma_depth(length)
    assert table.dtype == torch.int8 and table.is_contiguous()
    assert tuple(table.shape) == (k_padded // 8, kp // 16, 8, 16)
    np.testing.assert_array_equal(
        lk.lab_table_columns(table, 0, k_padded, wl).numpy(), compat.astype(np.float32))
    assert (lk.lab_table_columns(table, k, k_padded, wl) == 1).all()
    np.testing.assert_array_equal(
        lk.lab_table_columns(table, 13, 77, wl).numpy(), compat[:, 13:77].astype(np.float32))
    n = lk.lab_width(tile_k)
    assert n == {32: 32, 64: 64, 96: 32, 128: 128, 256: 128}[tile_k]
    flat = table.flatten().numpy()
    full = np.zeros((k_padded, kp), np.int8)
    full[:, :wl] = compat.T
    for kb, sl in [(0, 0), (k_padded // tile_k - 1, tile_k // n - 1)]:
        c0 = kb * tile_k + sl * n
        block = flat[c0 * kp:(c0 + n) * kp].reshape(n // 8, kp // 16, 8, 16)
        # core matrix (group, depth chunk): 8 columns x 16 depth bytes
        want = full[c0:c0 + n].reshape(n // 8, 8, kp // 16, 16).transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(block, want)


def test_tiled_wrappers_reject_other_tables():
    """``lab_probe``, ``clamp16_top2``, ``group_top2``, ``clamp8_top2``
    and ``mma_probe`` take the tiled int8 table only: the bit table, the
    untiled int8 ``[k_padded, KP]`` table, another dtype, another depth and
    a misaligned view raise."""
    codes = lab.unique_barcodes(500, 16)
    masks = lab.masks_of(codes)
    obs = torch.from_numpy(lab.pack_bit2(codes[:32]))
    for name in ("v1_m1only", "v3_clamp8", "v5_clamp16", "v6_group4", "v4_int4"):
        p = lk.lab_params(name, 500, 16, 128)
        kern = lk.make_lab_kernels()[p.kernel]
        table = lab.table_for(p.kernel, masks, 128, "cpu")
        assert kern.table_spec(p) == (torch.int8, (64, 4, 8, 16))
        with pytest.raises(ValueError, match="tiled table"):
            kern(obs, lab.lab_table(masks, 128, "cpu"), p)
        with pytest.raises(ValueError, match="tiled table"):
            kern(obs, table.view(512, 64), p)
        with pytest.raises(ValueError, match="tiled table"):
            kern(obs, table.to(torch.int16), p)
        with pytest.raises(ValueError, match="tiled table"):
            kern(obs, lab.table_for(p.kernel, lab.masks_of(codes[:, :7]), 128, "cpu"), p)
        shifted = torch.empty(table.numel() + 1, dtype=torch.int8)[1:]
        shifted.copy_(table.flatten())
        with pytest.raises(ValueError, match="16-byte aligned"):
            kern(obs, shifted.view(table.shape), p)
        strided = torch.zeros((64, 4, 16, 8), dtype=torch.int8).transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous"):
            kern(obs, strided, p)
        assert (kern.launches, kern.plain_calls) == (0, 0)
        assert kern(obs, table, p) is not None and kern.plain_calls == 1


def test_stream_bytes_cover_the_tiled_variants():
    """Every variant of a kernel that reads the tiled table, and no other,
    states its stream bytes."""
    tiled = {n for n in (*PORTED, "v4_int4") if n != "v0_colmerge"
             and lk.TABLE_FORMAT[lk.lab_params(n, 1024, 16, 128).kernel] == "tiled"}
    assert set(lk.STREAM_BYTES) == set(lk.TILED_VARIANTS) == tiled
    assert set(lk.TABLE_FORMAT) == set(lk.LAB_KERNELS)
    assert all(kern.table_format == lk.TABLE_FORMAT[name] for name, kern in lk.LAB_KERNELS.items())


def test_mma_probe_runs_on_the_engine():
    """``mma_probe`` (kernel #3) is a design of the tensor-core lab walk: it
    reads the tiled table, runs at the engine's full width (128 columns at
    tile_k 2,048, the lab's default), states no stream bytes, and writes its
    output without per-slice partials."""
    assert lk.TABLE_FORMAT["mma_probe"] == "tiled"
    assert lk.MAX_WIDTH["mma_probe"] == 128 and lk.STREAM_BYTES["v4_int4"] == 0
    p = lk.lab_params("v4_int4", 737_280, 16, 2048)
    assert (p.kernel, p.width, p.n_k_tiles) == ("mma_probe", 128, 360)
    kern = lk.LAB_KERNELS["mma_probe"]
    assert kern.table_spec(p) == (torch.int8, (737_280 // 8, 4, 8, 16))
    assert kern.n_slices(p) == 0
    assert [lk.lab_params("v4_int4", 3000, 7, tk).width for tk in (64, 96, 256)] == [64, 32, 128]


def test_tables_match_script(script):
    for k, length in [(1000, 16), (1000, 7), (1024, 16)]:
        codes = lab.unique_barcodes(k, length)
        np.testing.assert_array_equal(codes, script.unique_barcodes(k, length))
        np.testing.assert_array_equal(lab.masks_of(codes), jax_masks(codes))
        obs = reads(codes, 50, seed=1)
        np.testing.assert_array_equal(lab.pack_bit2(obs), script.pack_bit2(obs))
        for k_padded, scale in [(k, 1), (1024, 1), (1152, 16)]:
            np.testing.assert_array_equal(
                lab.compat_classmajor4(lab.masks_of(codes), k_padded, scale),
                script.compat_classmajor4(jax_masks(codes), k_padded, scale),
            )
        bits = lab.lab_table(lab.masks_of(codes), 128, "cpu")
        compat = script.compat_classmajor4(jax_masks(codes), 1024)
        assert bits.shape == (1024, (4 * length + 31) // 32) and bits.dtype == torch.uint32
        assert torch.equal(bits, pack_compat_bits(torch.from_numpy(compat)))
        assert (compat[:, k:] == 1).all()
        tiled = lab.lab_table_tiled(lab.masks_of(codes), 128, "cpu")
        kp = 32 * -(-4 * length // 32)
        assert tiled.shape == (128, kp // 16, 8, 16) and tiled.dtype == torch.int8
        np.testing.assert_array_equal(
            lk.lab_table_columns(tiled, 0, 1024, 4 * length).numpy(), compat)
        depth_pad = tiled.permute(0, 2, 1, 3).reshape(1024, kp)[:, 4 * length:]
        assert (depth_pad == 0).all()


def _masks(k, length=4):
    return np.ones((k, length), dtype=np.uint8)


@pytest.mark.parametrize(
    "name,k,tile_k,match",
    [
        ("v3_clamp8", 256 * 32 + 1, 32, "uint8 tile ids"),  # 257 K tiles
        ("v3w_clamp8", 256 * 32 + 1, 32, "uint8 tile ids"),
        ("v5_clamp16", 4097 * 32, 32, "int16 keys"),  # nt_pow2 8,192
        ("v6_group1", 1000, 128, "P >= 2"),
        ("v6_group3", 1000, 128, "not a multiple of P"),  # 8 K tiles
        ("v1_m1only", 1000, 100, "multiple of 32"),
        ("v9_nothing", 1000, 128, "unknown lab variant"),
    ],
)
def test_value_errors(name, k, tile_k, match):
    with pytest.raises(ValueError, match=match):
        lab.make_lab_variant(name, _masks(k), 4, tile_b=32, tile_k=tile_k, device="cpu")


@pytest.mark.parametrize(
    "name,k,tile_k",
    [("v3_clamp8", 256 * 32 + 1, 32), ("v5_clamp16", 4097 * 32, 32),
     ("v6_group1", 1000, 128), ("v6_group3", 1000, 128)],
)
def test_jax_lab_asserts_where_the_port_raises(script, name, k, tile_k):
    with pytest.raises(AssertionError):
        script.make_variant(name, _masks(k), 4, tile_b=32, tile_k=tile_k)


def test_batch_must_be_a_multiple_of_tile_b():
    codes = lab.unique_barcodes(300, 8)
    go, table, _ = lab.make_lab_variant("v1_m1only", lab.masks_of(codes), 8,
                                        tile_b=32, tile_k=128, device="cpu")
    obs = torch.from_numpy(lab.pack_bit2(codes[:48]))
    with pytest.raises(ValueError, match="multiple of tile_b"):
        go(obs, table)
    with pytest.raises(ValueError, match="multiple of tile_b"):
        go.plain(obs, table)
    assert go(obs[:32], table)[0].shape == (32,)


@pytest.mark.parametrize("shape", SHAPES + TILED_SHAPES, ids=lambda s: "K%d_L%d_tb%d_tk%d" % s)
def test_v4_int4_matches_numpy_oracle(script, shape):
    """``v4_int4`` emits, per row, the int32 count of column 0 of the last K
    tile of the script's table (``kernel_lab.py:128-132``): here the one-hot
    times that column in NumPy."""
    k, length, tile_b, tile_k = shape
    codes = lab.unique_barcodes(k, length)
    obs = reads(codes, B, seed=k + length)
    n_k_tiles = -(-k // tile_k)
    compat = script.compat_classmajor4(jax_masks(codes), n_k_tiles * tile_k)
    onehot = (obs[:, None, :] == np.arange(4)[None, :, None]).reshape(B, 4 * length)
    want = onehot.astype(np.int32) @ compat[:, (n_k_tiles - 1) * tile_k].astype(np.int32)
    lk.reset_counts()
    got, macs, go = run_port("v4_int4", codes, obs, tile_b, tile_k)
    assert macs == n_k_tiles * tile_k * 4 * length  # the script's k_padded * wl
    assert len(got) == 1 and got[0].dtype == np.int32 and got[0].shape == (B,)
    np.testing.assert_array_equal(got[0], want)
    assert go.params.kernel == "mma_probe"
    assert go.kernel.table_format == "tiled"
    assert lk.counts()["mma_probe"] == (0, 1)


def test_int32_bounds_raise():
    # probes: (256 * ck) * tile_k must stay in int32
    with pytest.raises(ValueError, match="int32|int8"):
        lk.lab_params("v1_m1only", 4096 * 8192, 4, 8192)
    with pytest.raises(ValueError, match="int32"):
        lk.lab_params("v6_group2", 3 * 1024 * 4096, 255, 4096)  # nt_pow2 4,096


def test_wrapper_rejects_a_variant_of_another_kernel():
    p = lk.lab_params("v5_clamp16", 256, 4, 128)
    with pytest.raises(ValueError, match="clamp16_top2"):
        lk.LAB_KERNELS["group_top2"](torch.zeros((32, 1), dtype=torch.uint8),
                                     torch.zeros((256, 1), dtype=torch.uint32), p)


def _variants(codes, names, tile_b=32, tile_k=128):
    out = {}
    for name in names:
        go, table, _ = lab.make_lab_variant(name, lab.masks_of(codes), codes.shape[1],
                                            tile_b=tile_b, tile_k=tile_k, device="cpu")
        out[f"{name}({tile_b},{tile_k})"] = (go, table)
    return out


def test_spot_check_small_k():
    codes = lab.unique_barcodes(1024, 16)
    variants = _variants(codes, ["v0_colmerge", "v1_m1only", "v3_clamp8", "v3w_clamp8",
                                 "v5_clamp16", "v6_group2", "v6_group8"])
    checks = dict(lab.spot_check(variants, codes, rows=512))
    assert sorted(checks) == sorted(lab_ for lab_ in variants if lab_[:2] in ("v3", "v5", "v6"))
    for label, res in checks.items():
        assert res and all(res.values()), (label, res)
    assert set(checks["v6_group2(32,128)"]) == {"exact"}
    assert set(checks["v5_clamp16(32,128)"]) == {"gate", "idx", "clampcounts"}


def test_spot_check_reports_a_mismatch():
    codes = lab.unique_barcodes(1024, 16)
    variants = _variants(codes, ["v0_colmerge", "v6_group4", "v3_clamp8"])
    go6, t6 = variants["v6_group4(32,128)"]
    go3, t3 = variants["v3_clamp8(32,128)"]

    def off_by_one(go):
        def wrong(obs, table):
            idx, best, nxt = go(obs, table)
            return idx, best, nxt + 1
        return wrong

    variants["v6_group4(32,128)"] = (off_by_one(go6), t6)
    variants["v3_clamp8(32,128)"] = (off_by_one(go3), t3)
    checks = dict(lab.spot_check(variants, codes, rows=256))
    assert checks["v6_group4(32,128)"] == {"exact": False}
    assert checks["v3_clamp8(32,128)"]["clampcounts"] is False


def test_rate_of_on_cpu():
    codes = lab.unique_barcodes(512, 16)
    go, table, _ = lab.make_lab_variant("v6_group4", lab.masks_of(codes), 16,
                                        tile_b=32, tile_k=128, device="cpu")
    lk.reset_counts()
    rate, times = lab.rate_of(go, table, codes, batches=(64, 128))
    assert rate > 0 and len(times) == 2
    # (1 warm + ITERS timed) calls per batch size
    assert lk.counts()["group_top2"] == (0, 2 * (1 + lab.ITERS))
    ins = lab.rate_inputs(codes, (64, 128))
    assert [[r.shape for r in rows] for rows in ins] == [
        [(64, 4)] * (1 + lab.ITERS), [(128, 4)] * (1 + lab.ITERS)]


def test_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("FQTK_LAB_K", "1024")
    monkeypatch.setenv("FQTK_LAB_L", "16")
    argv = ["--device", "cpu"]
    specs = ["v0_colmerge:32:128", "v4_int4:32:128", "p_i8minmax:32:128",
             "v3w_clamp8:32:128", "v5_clamp16:32:128", "v6_group4:32:128"]
    assert lab.main(argv + specs) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "FAILED" not in out and "MISMATCH" not in out
    assert "check v6_group4(32,128): exact=OK" in out
    assert "check v5_clamp16(32,128): gate=OK idx=OK clampcounts=OK" in out
    # a variant that fails prints FAILED and makes the exit code non-zero
    assert lab.main(argv + ["v9_nothing:32:128", "v6_group4:32:128"]) == 1
    out = capsys.readouterr().out
    assert "v9_nothing(32,128)" in out and "FAILED: ValueError" in out
    assert "v6_group4(32,128)" in out


def test_cli_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        lab.main(["v6_group4:32:128"])


def test_default_specs_cover_every_ported_kernel():
    names = {lab.parse_spec(s)[0] for s in lab.DEFAULT_SPECS}
    assert names == {"v0_colmerge", "v4_int4", *lk.PROBES, "v5_clamp16", "v6_group4",
                     "v3_clamp8", "v3w_clamp8"}
    kernels = {lk.lab_params(n, 737_280, 16, lab.parse_spec(s)[2]).kernel
               for s in lab.DEFAULT_SPECS for n in [lab.parse_spec(s)[0]] if n != "v0_colmerge"}
    assert kernels == set(lk.LAB_KERNELS)


def test_jax_is_the_reference_here():
    # the JAX side of these tests runs on the CPU backend (interpret mode)
    assert jax.default_backend() == "cpu"
