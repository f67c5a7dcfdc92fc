"""fqtk_tpu_torch.ops.hopper_matcher against the JAX package's Pallas matcher
(interpret mode) and the NumPy spec, on the same seeded bit2 inputs.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that plain version by ``test_torch_kernels_gpu.py``
and by ``chip_smoke.py`` on the card.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqtk_tpu.ops.matcher import MAX_COUNT, ExpectedSet
from fqtk_tpu.ops.matcher import merge_top2 as jax_merge_top2
from fqtk_tpu.ops.pallas_matcher import (
    compat_for_plan,
    make_pallas_assign_fn,
    plan_local_kernel,
)
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import chunk_top2, merge_top2

from .test_torch_kernels_gpu import ACGT, spec, whitelist_case


def port(es, mm, delta, packed):
    fn = hm.make_hopper_assign_fn(es, mm, delta, device="cpu")
    idx, best, nxt = (t.numpy() for t in fn(packed))
    assert fn.launches == 0 and fn.plain_calls == 1
    return idx, best, nxt


def pallas(es, mm, delta, packed):
    fn = make_pallas_assign_fn(
        es, mm, delta, interpret=True, packed2=True, compact_output=True,
        tile_b=256, tile_k=128,
    )
    return tuple(np.asarray(x) for x in fn(packed))


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("mm,delta", [(1, 2), (0, 0), (2, 1)])
def test_matches_pallas_and_numpy(mm, delta):
    rng = np.random.default_rng(7)
    es, obs = whitelist_case(rng, k=43, length=11, b=300)
    packed = pack_bit2(obs)
    got = port(es, mm, delta, packed)
    assert got[0].dtype == np.uint8  # compact output, K < 255
    assert_same(got, pallas(es, mm, delta, packed))
    assert_same(got, spec(obs, es, mm, delta))


@pytest.mark.parametrize("chunk", [None, 7, 128])
def test_first_index_tie_across_k_chunks(monkeypatch, chunk):
    """Duplicated barcodes in different K ranges force cross-range ties:
    the first global index must win, and ``next`` equals ``best``."""
    rng = np.random.default_rng(23)
    seqs = rng.choice(ACGT, size=(300, 12)).astype(np.uint8)
    seqs[150] = seqs[3]
    seqs[299] = seqs[0]
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in seqs])
    obs = rng.choice(ACGT, size=(333, 12)).astype(np.uint8)
    obs[:300] = seqs
    packed = pack_bit2(obs)
    if chunk is not None:  # K chunks of `chunk` columns in the plain version
        monkeypatch.setattr(hm, "_PLAIN_CHUNK_ELEMS", chunk * len(obs))
    got = port(es, 2, 0, packed)
    assert got[0].dtype == np.int32  # K >= 255: no compact output
    assert got[0][150] == 3 and got[1][150] == 0 and got[2][150] == 0
    assert_same(got, spec(obs, es, 2, 0))
    assert_same(got, pallas(es, 2, 0, packed))


def test_single_barcode_next_is_maxcount():
    es = ExpectedSet.from_barcodes(["ACGTACGT"])
    obs = np.frombuffer(b"ACGTACGTACGTACGAACGTTCGT", dtype=np.uint8).reshape(3, 8)
    obs = np.tile(obs, (86, 1))[:257]
    packed = pack_bit2(obs)
    got = port(es, 1, 4, packed)
    assert (got[2] == MAX_COUNT).all()
    assert_same(got, spec(obs, es, 1, 4))
    assert_same(got, pallas(es, 1, 4, packed))


def test_iupac_whitelist_through_bit2():
    es = ExpectedSet.from_barcodes(["NNAAAAAA", "NNCCCCCC", "RYAAAAAA"])
    reads = [b"ACAAAAAA", b"GTCCCCCC", b"GCAAAAAA", b"TTTTTTTT"]
    obs = np.stack([np.frombuffer(r, dtype=np.uint8) for r in reads])
    packed = pack_bit2(obs)
    got = port(es, 0, 0, packed)
    assert list(got[0]) == [0, 1, 0, 3]
    assert_same(got, spec(obs, es, 0, 0))
    assert_same(got, pallas(es, 0, 0, packed))


@pytest.mark.parametrize("b", [1, 255, 513])
def test_b_not_a_tile_multiple(b):
    rng = np.random.default_rng(b)
    es, obs = whitelist_case(rng, k=96, length=17, b=b)
    packed = pack_bit2(obs)
    got = port(es, 1, 2, packed)
    assert got[0].shape == (b,)
    assert_same(got, spec(obs, es, 1, 2))


def test_merge_top2_matches_jax():
    rng = np.random.default_rng(5)
    n = 1000
    a_best = rng.integers(0, 20, n).astype(np.int32)
    a_next = a_best + rng.integers(0, 5, n).astype(np.int32)
    b_best = rng.integers(0, 20, n).astype(np.int32)
    b_next = b_best + rng.integers(0, 5, n).astype(np.int32)
    a = (a_best, rng.integers(0, 50, n).astype(np.int32), a_next)
    b = (b_best, rng.integers(50, 99, n).astype(np.int32), b_next)
    got = merge_top2(tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
    want = jax_merge_top2(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    assert_same([t.numpy() for t in got], want)


@pytest.mark.parametrize("k", [1, 2, 9])
def test_chunk_top2_matches_numpy(k):
    rng = np.random.default_rng(k)
    counts = rng.integers(0, 4, size=(200, k)).astype(np.int32)
    best, idx, nxt = (t.numpy() for t in chunk_top2(torch.from_numpy(counts)))
    np.testing.assert_array_equal(best, counts.min(1))
    np.testing.assert_array_equal(idx, counts.argmin(1))
    masked = counts.copy()
    masked[np.arange(200), counts.argmin(1)] = MAX_COUNT
    np.testing.assert_array_equal(nxt, masked.min(1) if k > 1 else MAX_COUNT)


@pytest.mark.parametrize("k", [1, 43, 300])
def test_state_matches_pallas_table(k):
    """The device table is the JAX kernel's compat table before its scale."""
    rng = np.random.default_rng(k)
    es, _ = whitelist_case(rng, k=k, length=13, b=1)
    state = hm.hopper_state_from_numpy(es, "cpu")
    plan = plan_local_kernel(k, 13, tile_k=hm.K_ALIGN, packed2=True)
    want = compat_for_plan(es.masks, plan) // plan.compat_scale
    assert state.scheme == "colmerge_top2"
    assert state.table.dtype == torch.int8
    assert want.shape == (4 * 13, plan.k_padded)
    # packed once for the tensor-core product: the [K_pad, KP] table,
    # zero-padded in depth, tiled in the order the product reads it
    assert hm.table_depth(13) == 64 and state.k_pad == plan.k_padded
    assert tuple(state.table.shape) == (plan.k_padded // 128, 1, 16, 4, 8, 16)
    np.testing.assert_array_equal(
        hm.table_columns(state.table, 0, plan.k_padded, 4 * 13).numpy(), want
    )
    assert int(state.table.sum()) == int(want.sum())  # the depth pad is zero
    assert (state.k, state.length) == (k, 13)
    assert state.max_ns_in_barcodes == es.max_ns_in_barcodes


def test_reference_signature_and_dtypes():
    rng = np.random.default_rng(3)
    es, obs = whitelist_case(rng, k=20, length=9, b=50)
    state = hm.hopper_state_from_numpy(es, "cpu")
    best, idx, nxt = hm.colmerge_top2_reference(
        torch.from_numpy(pack_bit2(obs)), state.table, es.count, es.length
    )
    assert best.dtype == idx.dtype == nxt.dtype == torch.int32
    _, s_best, s_next = spec(obs, es, 1, 2)
    np.testing.assert_array_equal(best.numpy(), s_best)
    np.testing.assert_array_equal(nxt.numpy(), s_next)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    es = ExpectedSet.from_barcodes(["ACGT"])
    with pytest.raises(RuntimeError, match="cuda"):
        hm.make_hopper_assign_fn(es, 1, 2, device="cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch):
    from fqtk_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build_kernels()


# --------------------------------------------------------------------------
# the grid of depths and whitelist sizes, and a model of the kernels' top-2
# --------------------------------------------------------------------------

from fqtk_tpu.ops.matcher import make_assign_fn  # noqa: E402

from .test_torch_kernels_gpu import GRID_KS, GRID_LENGTHS, grid_case  # noqa: E402


@pytest.mark.parametrize("length", GRID_LENGTHS)
@pytest.mark.parametrize("k", GRID_KS)
def test_grid_plain_versions_match_spec_pallas_and_xla(k, length):
    """Both plain versions on the tiled int8 table, at every depth (one k32
    step to eight slices of 128) and K around the sub-tile edges, with ties
    (duplicated barcodes) and a row that mismatches barcode 0 everywhere
    (count L: 255 at L = 255): equal to the NumPy spec, to the Pallas matcher
    in interpret mode and to the XLA bit2 matcher."""
    rng = np.random.default_rng(1000 * length + k)
    b = 256
    es, obs = grid_case(rng, k, length, b)
    packed = pack_bit2(obs)
    want = spec(obs, es, 1, 2)
    for scheme in hm.SCHEMES:
        state = hm.hopper_state_from_numpy(es, "cpu", scheme)
        fn = hm.HopperAssignFn(state, 1, 2, compact_output=True)
        got = tuple(t.numpy() for t in fn(packed))
        assert fn.kernels[scheme].plain_calls == 1 and fn.launches == 0
        assert_same(got, want)
        # ungated: idx is the first column of the smallest count, even at 255
        best, idx, nxt = fn.kernels[scheme].reference(
            torch.from_numpy(packed), state.table, k, length)
        s_idx, s_best, s_next = spec(obs, es, 255, 0)
        assert_same((best.numpy(), idx.numpy(), nxt.numpy()), (s_best, s_idx, s_next))
    assert_same(got, pallas(es, 1, 2, packed))
    xla = make_assign_fn(es, 1, 2, packed2=True, compact_output=True)
    assert_same(got, tuple(np.asarray(x) for x in xla(packed)))
    if k == 1:
        assert int(best[b - 1]) == length and int(nxt[b - 1]) == MAX_COUNT


def model_top2(counts, k, n_chunks, cols_per_cta, per_tile_key):
    """NumPy model of the kernels' top-2 (csrc/mma_count.cuh): per CTA column
    range, per thread of a quad (columns 8j + 2t + e of each 128-column
    sub-tile), the running two smallest keys behind the group tests against
    the running second count, the quad fold, then the chunk merge of
    ``colmerge_top2`` (global keys, any order) or ``tile_top2`` (per-tile
    keys, ordered merge).  ``counts`` is ``[B, K_pad]`` with all-L pad
    columns.  Returns (best, idx, next) and how many group tests fired."""
    b, k_pad = counts.shape
    init = 0x7FFFFFFF
    fired = 0
    chunks = []
    for c in range(n_chunks):
        c_begin = c * cols_per_cta
        c_end = min(-(-k // 128) * 128, c_begin + cols_per_cta)
        base = c_begin if per_tile_key else 0
        span = cols_per_cta if per_tile_key else k
        shift = max(7 if per_tile_key else 1, (span - 1).bit_length())
        m1 = np.full((b, 4), init, dtype=np.int64)
        m2 = np.full((b, 4), init, dtype=np.int64)
        thr = np.full((b, 4), init, dtype=np.int64)
        for cb in range(c_begin, c_end, 128):
            for t in range(4):
                cols = np.array([cb + 8 * j + 2 * t + e for j in range(16) for e in range(2)])
                for q in range(4):  # groups of 8 counts
                    gc = cols[8 * q:8 * q + 8]
                    cnt = counts[:, gc]
                    fire = cnt.min(axis=1) < thr[:, t]
                    fired += int(fire.sum())
                    for i in range(8):
                        ok = fire & (cnt[:, i] < thr[:, t]) & (gc[i] < k)
                        key = np.where(ok, (cnt[:, i] << shift) | (gc[i] - base), init)
                        m2[:, t] = np.minimum(m2[:, t], np.maximum(m1[:, t], key))
                        m1[:, t] = np.minimum(m1[:, t], key)
                    upd = fire
                    thr[upd, t] = np.where(m2[upd, t] == init, init, m2[upd, t] >> shift)
        f1, f2 = m1[:, 0], m2[:, 0]
        for t in range(1, 4):  # the quad fold (keys are unique)
            f2 = np.minimum(np.minimum(f2, m2[:, t]), np.maximum(f1, m1[:, t]))
            f1 = np.minimum(f1, m1[:, t])
        chunks.append((f1, f2, shift, c_begin))
    if not per_tile_key:
        f1, f2, shift, _ = chunks[0]
        for o1, o2, _, _ in chunks[1:]:
            f2 = np.minimum(np.minimum(f2, o2), np.maximum(f1, o1))
            f1 = np.minimum(f1, o1)
        out = (np.minimum(f1 >> shift, 255), f1 & ((1 << shift) - 1), np.minimum(f2 >> shift, 255))
        return out, fired
    best = np.full(b, 256, dtype=np.int64)
    idx = np.full(b, k, dtype=np.int64)
    nxt = np.full(b, 255, dtype=np.int64)
    for f1, f2, shift, c_begin in chunks:
        t_best, t_idx = f1 >> shift, c_begin + (f1 & ((1 << shift) - 1))
        t_next = np.minimum(f2 >> shift, 255)
        take = t_best < best
        nxt = np.where(take, np.minimum(best, t_next), np.minimum(nxt, t_best))
        idx = np.where(take, t_idx, idx)
        best = np.where(take, t_best, best)
    return (best, idx, nxt), fired


@pytest.mark.parametrize("per_tile_key", [False, True], ids=["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("k,length,slots", [(1, 8, 264), (96, 17, 264), (700, 6, 264),
                                            (2049, 5, 40), (4100, 9, 4000)])
def test_kernel_top2_model_is_exact(monkeypatch, k, length, slots, per_tile_key):
    """The kernels' arithmetic, modelled in NumPy on the launch geometry of
    :func:`plan_chunks`: the threshold tests never drop a key that matters,
    so the model equals the NumPy spec, ties and all (short barcodes: many
    equal counts)."""
    rng = np.random.default_rng(k + length)
    b = 40
    es, obs = grid_case(rng, k, length, b)
    monkeypatch.setattr(hm, "MIN_CHUNK_SUBS", 2)
    n_chunks, cols_per_cta = hm.plan_chunks(
        b, k, slots, hm.MAX_TILE_COLS if per_tile_key else None)
    assert n_chunks * cols_per_cta >= k > (n_chunks - 1) * cols_per_cta
    assert cols_per_cta % 128 == 0
    if k >= 2049:
        assert n_chunks > 1
    k_pad = -(-k // 128) * 128
    counts = np.full((b, k_pad), length, dtype=np.int64)
    counts[:, :k] = jnp_free_counts(obs, es)
    (best, idx, nxt), fired = model_top2(counts, k, n_chunks, cols_per_cta, per_tile_key)
    s_idx, s_best, s_next = spec(obs, es, 255, 0)
    assert_same((best, idx, nxt), (s_best, s_idx, s_next))
    if k >= 700:  # the tests skip most groups once the pair has warmed up
        assert fired < 0.5 * b * (k_pad // 8)


def jnp_free_counts(obs, es):
    from fqtk_tpu_torch.ops.matcher import mismatch_counts_np

    return mismatch_counts_np(obs, es)


@pytest.mark.parametrize("b,k,slots,max_cols,want", [
    (8192, 96, 264, None, (1, 128)),
    (131072, 8192, 264, None, (1, 8192)),
    (16384, 737280, 264, None, (2, 368640)),
    (32768, 6794880, 264, 1 << 23, (1, 6794880)),
    (16384, 6794880, 264, 1 << 23, (2, 3397504)),
    (100, 20_000_000, 264, 1 << 23, (264, 75776)),
    (100, 20_000_000, 1, 1 << 23, (3, 6666752)),
    (1, 1, 264, None, (1, 128)),
    # row tiles that fill a wave only in part (the window dedup's buckets):
    # split past one wave, at most MAX_SPLIT_WAVES (4096 rows at K 40M: 4)
    (23_040, 6794880, 264, 1 << 23, (5, 1358976)),
    (22_912, 737280, 264, None, (4, 184320)),
    (23_040, 3397440, 264, None, (5, 679552)),
    (38_400, 6794880, 264, 1 << 23, (3, 2264960)),
    (8192, 40_000_000, 264, 1 << 23, (8, 5000064)),
    (4096, 40_000_000, 264, 1 << 23, (33, 1212160)),
    (65_536, 6794880, 264, 1 << 23, (1, 6794880)),
    # never fewer than the one-wave count: a small K keeps it
    (8192, 8192, 264, None, (4, 2048)),
    (23_040, 8192, 264, None, (1, 8192)),
])
def test_plan_chunks(b, k, slots, max_cols, want):
    got = hm.plan_chunks(b, k, slots, max_cols)
    assert got == want
    n, cols = got
    assert cols % hm.K_ALIGN == 0 and n * cols >= k > (n - 1) * cols
    assert max_cols is None or cols <= max_cols


@pytest.mark.parametrize("k", [1, 96, 8192, 737_280, 6_794_880, (1 << 23) + 1, 40_000_000])
@pytest.mark.parametrize("b", [1, 8192, 131_072, 1 << 20, 1 << 22])
def test_partial_buffer_is_bounded(b, k):
    """The ``[2, n_chunks, B]`` int32 partials of a launch need no row
    chunking: K is split as far as the CTAs fill the card once, further
    only up to :data:`~hm.MAX_SPLIT_WAVES` waves of the card's slots (then
    the buffer is about 1 KiB per CTA slot and wave whatever B), or, for
    ``tile_top2``, into ceil(K / 2^23) tiles (8 bytes per row and tile:
    less than the 12 bytes per row of the outputs up to K = 2^23)."""
    slots = 264
    waves = hm.MAX_SPLIT_WAVES
    for max_cols in (None, hm.MAX_TILE_COLS):
        if max_cols is None and k > hm.MAX_K:
            continue
        n_chunks, _ = hm.plan_chunks(b, k, slots, max_cols)
        row_tiles = -(-b // hm.ROWS_PER_CTA)
        k_tiles = 1 if max_cols is None else -(-k // max_cols)
        partial_bytes = 2 * n_chunks * b * 4
        assert n_chunks <= max(waves * slots // row_tiles, k_tiles, 1)
        assert partial_bytes <= 1024 * max(waves * slots, row_tiles * k_tiles)
        if k <= 1 << 23:  # every list the demux path knows: at most the outputs' size
            assert partial_bytes <= max(1024 * waves * slots, 8 * b)
