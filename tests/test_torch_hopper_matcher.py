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
    assert tuple(state.table.shape) == want.shape == (4 * 13, plan.k_padded)
    np.testing.assert_array_equal(state.table.numpy(), want)
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


def test_unported_inputs_raise():
    es = ExpectedSet.from_barcodes(["ACGT"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hm.make_hopper_assign_fn(es, 1, 2, device="cpu", packed2=False)


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
