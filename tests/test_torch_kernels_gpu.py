"""The CUDA kernels ``colmerge_top2``, ``tile_top2`` (on bit2 rows and on
the 16-class input of nib4 rows and raw bytes) and the kernel lab's
(``mma_probe``, ``lab_probe``, ``clamp16_top2``, ``group_top2``,
``clamp8_top2``) against their plain PyTorch versions and the NumPy spec,
the scan route (``make_assign_fn``) against the NumPy spec, and the
device mesh (``parallel/mesh.py``, every tile on ``cuda:0``) against its
CPU run and the spec, the driver entry points (``graft_entry.py``) and the
harness's two kernel legs (``bench.py``: mid-K and the 737K device leg at
their full sizes), the device arms of the measuring tools
(``fqtk_tpu_torch.scripts``: ``profile_e2e``, ``ab_e2e`` at ``midk``) and the
differential campaign's matcher leg (``deep_campaign``), on the card.  Marked
``gpu``: each test skips without a CUDA device.  Run on the card with

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

This file imports no JAX (the machine with the card has none); its seeded
cases are shared with ``test_torch_hopper_matcher.py``."""

import numpy as np
import pytest
import torch

from fqtk_tpu.ops.matcher import ExpectedSet, assign_batch_np
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops import lab_kernels as lk
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import make_assign_fn

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def whitelist_case(rng, k, length, b, iupac=True):
    """Distinct ACGT barcodes (two IUPAC entries), reads with a third planted
    exact matches and a sixth one mismatch away."""
    barcodes = set()
    while len(barcodes) < k:
        barcodes.add(bytes(rng.choice(ACGT, size=length)).decode())
    barcodes = sorted(barcodes)
    if iupac and k > 7:
        barcodes[3] = barcodes[3][:2] + "N" + barcodes[3][3:]
        barcodes[7] = "R" + barcodes[7][1:]
    es = ExpectedSet.from_barcodes(barcodes)
    obs = rng.choice(ACGT, size=(b, length)).astype(np.uint8)
    for i in range(0, b, 3):
        bc = barcodes[(i * 7) % k].replace("N", "G").replace("R", "A")
        obs[i] = np.frombuffer(bc.encode(), dtype=np.uint8)
    for i in range(1, b, 6):
        obs[i] = obs[i - 1]
        obs[i, i % length] = ACGT[(np.searchsorted(ACGT, obs[i, i % length]) + 1) % 4]
    return es, obs


def spec(obs, es, mm, delta):
    idx, best, nxt = assign_batch_np(obs, es, mm, delta)
    return np.where(idx < 0, es.count, idx), best, nxt


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run with -m gpu on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "k,length,b",
    [(1, 8, 100), (96, 17, 4096), (300, 12, 1000), (8192, 16, 2000), (40, 33, 777)],
)
def test_kernel_matches_plain_on_card(k, length, b):
    _need_card()
    rng = np.random.default_rng(k + b)
    es, obs = whitelist_case(rng, k=k, length=length, b=b)
    state = hm.hopper_state_from_numpy(es, "cuda", "colmerge_top2")
    packed = torch.from_numpy(pack_bit2(obs)).cuda()
    kern = hm.ColmergeTop2()
    got = kern(packed, state.table, k, length)
    torch.cuda.synchronize()
    assert kern.launches == 1 and kern.plain_calls == 0
    want = hm.colmerge_top2_reference(packed, state.table, k, length)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, s_best, s_next = spec(obs, es, 1, 2)
    np.testing.assert_array_equal(got[0].cpu().numpy(), s_best)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)


@pytest.mark.gpu
@pytest.mark.parametrize("mm,delta", [(1, 2), (0, 0)])
def test_assign_fn_on_card(mm, delta):
    """numpy bit2 in -> gated (assigned, best, next) on the card, as the demux
    driver calls it; one kernel launch per call."""
    _need_card()
    rng = np.random.default_rng(9)
    es, obs = whitelist_case(rng, k=96, length=17, b=5000)
    fn = hm.make_hopper_assign_fn(es, mm, delta, device="cuda")
    got = [t.cpu().numpy() for t in fn(pack_bit2(obs))]
    assert fn.launches == 1 and fn.plain_calls == 0
    assert got[0].dtype == np.uint8
    for g, w in zip(got, spec(obs, es, mm, delta)):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


TILE_SHAPES = [
    (1, 8, 100), (96, 17, 4096), (300, 12, 1000), (8192, 16, 2000),
    (40, 33, 777), (50, 130, 300),  # L > 32: the depth walked in slices of 128
]


@pytest.mark.gpu
@pytest.mark.parametrize("k,length,b", TILE_SHAPES)
def test_tile_top2_matches_plain_on_card(k, length, b):
    _need_card()
    rng = np.random.default_rng(k + b + 1)
    es, obs = whitelist_case(rng, k=k, length=length, b=b)
    state = hm.hopper_state_from_numpy(es, "cuda", "tile_top2")
    packed = torch.from_numpy(pack_bit2(obs)).cuda()
    kern = hm.TileTop2()
    got = kern(packed, state.table, k, length)
    torch.cuda.synchronize()
    assert kern.launches == 1 and kern.plain_calls == 0
    want = hm.tile_top2_reference(packed, state.table, k, length)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s_idx, s_best, s_next = spec(obs, es, 255, 0)  # every row passes the gates
    np.testing.assert_array_equal(got[0].cpu().numpy(), s_best)
    np.testing.assert_array_equal(got[1].cpu().numpy(), s_idx)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [22_912, 23_040])
@pytest.mark.parametrize("kernel,k", [("colmerge_top2", 737_280), ("tile_top2", 6_794_880)])
def test_window_bucket_rows_on_card(kernel, k, b):
    """Each kernel at its single-cell whitelist's K on bit2 rows, at the
    window dedup's buckets (a multiple of 128 rows, not a power of two):
    row tiles that fill a wave of CTAs only in part, so K is split, equal
    to the plain version."""
    _need_card()
    rng = np.random.default_rng(b + k)
    length = 16
    codes = rng.integers(0, 4, size=(k, length), dtype=np.uint8)
    es = ExpectedSet(masks=np.left_shift(1, codes).astype(np.uint8), max_ns_in_barcodes=0,
                     length=length, count=k)
    reads = codes[rng.integers(0, k, size=b)]
    hit = rng.random(b) < 0.3
    reads[hit, rng.integers(0, length, size=int(hit.sum()))] = rng.integers(
        0, 4, size=int(hit.sum()), dtype=np.uint8)
    miss = rng.random(b) < 0.2
    reads[miss] = rng.integers(0, 4, size=(int(miss.sum()), length), dtype=np.uint8)
    packed = torch.from_numpy(pack_bit2(ACGT[reads])).cuda()
    state = hm.hopper_state_from_numpy(es, "cuda", kernel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_cols = hm.MAX_TILE_COLS if kernel == "tile_top2" else None
    assert hm.plan_chunks(b, k, 2 * sms, max_cols)[0] > 1
    kern = hm.ColmergeTop2() if kernel == "colmerge_top2" else hm.TileTop2()
    got = kern(packed, state.table, k, length)
    torch.cuda.synchronize()
    assert kern.launches == 1 and kern.plain_calls == 0
    want = kern.reference(packed, state.table, k, length)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] == 0).sum()) >= b // 3


@pytest.mark.gpu
def test_tile_top2_cross_tile_ties_on_card():
    """Duplicates in different K tiles (204 rows: the launch splits K into
    12 tiles of 2,048 columns): the first index wins, and the ragged last
    tile is masked."""
    _need_card()
    rng = np.random.default_rng(12)
    k, length = 3 * hm.TILE_K + 77, 16
    seqs = rng.choice(ACGT, size=(k, length)).astype(np.uint8)
    seqs[hm.TILE_K + 5] = seqs[3]
    seqs[k - 1] = seqs[hm.TILE_K + 9]
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in seqs])
    obs = np.concatenate([seqs[[3, hm.TILE_K + 9, k - 1, k - 2]],
                          rng.choice(ACGT, size=(200, length)).astype(np.uint8)])
    state = hm.hopper_state_from_numpy(es, "cuda", "tile_top2")
    packed = torch.from_numpy(pack_bit2(obs)).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert hm.plan_chunks(len(obs), k, 2 * sms, hm.MAX_TILE_COLS)[0] > 3
    got = hm.TileTop2()(packed, state.table, k, length)
    want = hm.tile_top2_reference(packed, state.table, k, length)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    idx = got[1].cpu().numpy()
    assert list(idx[:4]) == [3, hm.TILE_K + 9, hm.TILE_K + 9, k - 2]
    s_idx, s_best, s_next = spec(obs, es, 255, 0)
    np.testing.assert_array_equal(idx, s_idx)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)


@pytest.mark.gpu
def test_tile_top2_assign_fn_on_card():
    _need_card()
    rng = np.random.default_rng(10)
    es, obs = whitelist_case(rng, k=96, length=17, b=5000)
    state = hm.hopper_state_from_numpy(es, "cuda", "tile_top2")
    fn = hm.HopperAssignFn(state, 1, 2, compact_output=True)
    assert fn.scheme == "tile_top2"
    got = [t.cpu().numpy() for t in fn(pack_bit2(obs))]
    assert fn.kernels["tile_top2"].launches == 1
    assert fn.launches == 1 and fn.plain_calls == 0
    for g, w in zip(got, spec(obs, es, 1, 2)):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
def test_failing_kernel_load_raises_on_card(monkeypatch, kernel):
    """A CUDA tensor launches the kernel or raises: with no build to load,
    neither wrapper runs its plain version."""
    _need_card()
    from fqtk_tpu_torch.ops import _build

    es = ExpectedSet.from_barcodes(["ACGTACGT", "TTTTCCCC"])
    state = hm.hopper_state_from_numpy(es, "cuda", kernel)
    packed = torch.from_numpy(pack_bit2(np.frombuffer(b"ACGTACGT", np.uint8)[None])).cuda()
    monkeypatch.setattr(_build, "_KERNELS", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    kern = hm.ColmergeTop2() if kernel == "colmerge_top2" else hm.TileTop2()
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        kern(packed, state.table, 2, 8)
    assert kern.launches == 0 and kern.plain_calls == 0


def grid_case(rng, k, length, b):
    """Random barcodes with duplicates allowed (ties; 4^L may be below K), an
    IUPAC N and R where K > 7; reads: a third planted exact matches, a sixth
    one mismatch away, and a last row that mismatches barcode 0 at every
    position (count L: 255 at L = 255, the saturation bound)."""
    wl = ACGT[rng.integers(0, 4, size=(k, length))]
    if k > 2:
        wl[k - 1] = wl[1]  # the same barcode far apart: the first index wins
    planted = wl.copy()
    if k > 7:
        wl[3, length // 2] = ord("N")
        wl[7, 0] = ord("R")
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in wl])
    obs = ACGT[rng.integers(0, 4, size=(b, length))]
    obs[0::3] = planted[rng.integers(0, k, size=len(obs[0::3]))]
    obs[1::6] = obs[0::6][: len(obs[1::6])]
    rows = np.arange(1, b, 6)
    pos = rows % length
    obs[rows, pos] = ACGT[(np.searchsorted(ACGT, obs[rows, pos]) + 1) % 4]
    obs[b - 1] = ACGT[(np.searchsorted(ACGT, planted[0]) + 1) % 4]
    return es, obs


GRID_LENGTHS = [1, 8, 16, 17, 31, 64, 255]
GRID_KS = [1, 2, 96, 8191, 8193]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("length", GRID_LENGTHS)
@pytest.mark.parametrize("k", GRID_KS)
def test_kernel_grid_on_card(kernel, k, length):
    """Both kernels over every depth (one k-step to the sliced walk), K
    around the sub-tile and chunk edges, ties and the count L = 255: equal
    to the plain version and to the NumPy spec."""
    _need_card()
    rng = np.random.default_rng(1000 * length + k)
    b = 333
    es, obs = grid_case(rng, k, length, b)
    state = hm.hopper_state_from_numpy(es, "cuda", kernel)
    packed = torch.from_numpy(pack_bit2(obs)).cuda()
    kern = hm.ColmergeTop2() if kernel == "colmerge_top2" else hm.TileTop2()
    got = kern(packed, state.table, k, length)
    torch.cuda.synchronize()
    assert (kern.launches, kern.plain_calls) == (1, 0)
    want = kern.reference(packed, state.table, k, length)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s_idx, s_best, s_next = spec(obs, es, 255, 0)  # every row passes the gates
    np.testing.assert_array_equal(got[0].cpu().numpy(), s_best)
    np.testing.assert_array_equal(got[1].cpu().numpy(), s_idx)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)
    assert int(got[0][b - 1]) <= length and (k > 1 or int(got[0][b - 1]) == length)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("b", [1, 129, 1000])
def test_k_chunks_on_card(monkeypatch, kernel, b):
    """K split into many column ranges (one 128-column sub-tile per CTA at
    the least): the chunks' partial results merge to the plain version's."""
    _need_card()
    rng = np.random.default_rng(14 + b)
    k, length = 2 * 8192 + 5, 12
    es, obs = grid_case(rng, k, length, b)
    state = hm.hopper_state_from_numpy(es, "cuda", kernel)
    packed = torch.from_numpy(pack_bit2(obs)).cuda()
    monkeypatch.setattr(hm, "MIN_CHUNK_SUBS", 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert hm.plan_chunks(b, k, 2 * sms)[0] >= 16
    kern = hm.ColmergeTop2() if kernel == "colmerge_top2" else hm.TileTop2()
    got = kern(packed, state.table, k, length)
    assert kern.launches == 1
    want = kern.reference(packed, state.table, k, length)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s_idx, s_best, s_next = spec(obs, es, 255, 0)
    np.testing.assert_array_equal(got[1].cpu().numpy(), s_idx)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)


# --------------------------------------------------------------------------
# the 16-class input (nib4 masks, raw bytes) of colmerge_top2 and tile_top2
# --------------------------------------------------------------------------

BASES5 = np.frombuffer(b"ACGTN", dtype=np.uint8)


def mask_case(rng, k, length, b):
    """Barcodes over ACGTN (duplicates allowed: ties), reads over ACGTN with
    a third planted exact matches (lowercase in every ninth row), a no-call
    row and a row that mismatches barcode 0 at every position."""
    wl = BASES5[rng.integers(0, 5, size=(k, length))]
    wl[:, 0] = ACGT[rng.integers(0, 4, size=k)]  # keep some ACGT per barcode
    if k > 2:
        wl[k - 1] = wl[1]  # the same barcode far apart: the first index wins
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in wl])
    obs = BASES5[rng.integers(0, 5, size=(b, length))]
    obs[0::3] = wl[rng.integers(0, k, size=len(obs[0::3]))]
    obs[0::9] |= 0x20  # lowercase
    obs[1] = ord("N")
    obs[b - 1] = np.where(wl[0] == ord("A"), ord("C"), ord("A"))
    return es, obs


def nib4_rows(obs):
    from fqtk_tpu_torch.core.encoding import ENCODE_LUT
    from fqtk_tpu_torch.ops.device_encoding import pack_nib4

    return pack_nib4(torch.from_numpy(ENCODE_LUT[obs]))


#: L = 1-8 at each of the four depths of one slice (KP 32, 64, 96, 128:
#: NK1 1-4), then the sliced walk (KP 256 at L 16, 384 at 17, 1,024 at 64,
#: 1,152 at 65, 4,096 at 255)
MASK_LENGTHS = [1, 3, 5, 7, 8, 16, 17, 64, 65, 255]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("length", MASK_LENGTHS)
@pytest.mark.parametrize("k", [1, 96, 8193])
def test_kernel_16_classes_on_card(kernel, k, length):
    """Both kernels on nib4 rows against a 16-class table: equal to the plain
    version and to the NumPy spec, at every depth."""
    _need_card()
    rng = np.random.default_rng(2000 * length + k)
    b = 333
    es, obs = mask_case(rng, k, length, b)
    state = hm.hopper_state_from_numpy(es, "cuda", kernel, classes=16)
    assert state.table.shape[1] * state.table.shape[3] * 16 == hm.table_depth(length, 16)
    rows = nib4_rows(obs).cuda()
    kern = hm.ColmergeTop2() if kernel == "colmerge_top2" else hm.TileTop2()
    got = kern(rows, state.table, k, length, 16)
    torch.cuda.synchronize()
    assert (kern.launches, kern.plain_calls) == (1, 0)
    want = kern.reference(rows, state.table, k, length, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s_idx, s_best, s_next = spec(obs, es, 255, 0)  # every row passes the gates
    np.testing.assert_array_equal(got[0].cpu().numpy(), s_best)
    np.testing.assert_array_equal(got[1].cpu().numpy(), s_idx)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
def test_k_chunks_16_classes_on_card(monkeypatch, kernel):
    """K split into many column ranges on the sliced walk (L 17, KP 384)."""
    _need_card()
    rng = np.random.default_rng(31)
    k, length, b = 2 * 8192 + 5, 17, 700
    es, obs = mask_case(rng, k, length, b)
    state = hm.hopper_state_from_numpy(es, "cuda", kernel, classes=16)
    rows = nib4_rows(obs).cuda()
    monkeypatch.setattr(hm, "MIN_CHUNK_SUBS", 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert hm.plan_chunks(b, k, 2 * sms)[0] >= 16
    kern = hm.ColmergeTop2() if kernel == "colmerge_top2" else hm.TileTop2()
    got = kern(rows, state.table, k, length, 16)
    want = kern.reference(rows, state.table, k, length, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s_idx, _, s_next = spec(obs, es, 255, 0)
    np.testing.assert_array_equal(got[1].cpu().numpy(), s_idx)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)


# --------------------------------------------------------------------------
# the sliced depth walk (KP above 128: nib4 rows at L >= 9, bit2 rows at
# L 33-255), its ring's edges and its two CTAs an SM
# --------------------------------------------------------------------------

#: (classes, L) of the walk's two instantiations: KP 256 (one stage a
#: sub-tile, A built once: 16 classes at L 16, bit2 at L 33 and 64) and
#: deeper (A built per stage; 3 slices at 16 classes L 24 and bit2 L 90, 4
#: at bit2 L 100)
WALK_FORMS = [(16, 16), (4, 64), (16, 24), (4, 33), (4, 90), (4, 100)]


def walk_case(rng, k, length, b, classes):
    """``(es, obs bytes, kernel rows on the card)``: :func:`mask_case` (ACGTN
    reads) at 16 classes, :func:`grid_case` (ACGT) at 4."""
    if classes == 16:
        es, obs = mask_case(rng, k, length, b)
        return es, obs, nib4_rows(obs).cuda()
    es, obs = grid_case(rng, k, length, b)
    return es, obs, torch.from_numpy(pack_bit2(obs)).cuda()


def check_walk(kernel, es, obs, rows, length, classes):
    """One launch of ``kernel`` equal to its plain version and the spec."""
    k = es.count
    state = hm.hopper_state_from_numpy(es, "cuda", kernel, classes=classes)
    kern = hm.ColmergeTop2() if kernel == "colmerge_top2" else hm.TileTop2()
    got = kern(rows, state.table, k, length, classes)
    torch.cuda.synchronize()
    assert (kern.launches, kern.plain_calls) == (1, 0)
    want = kern.reference(rows, state.table, k, length, classes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s_idx, s_best, s_next = spec(obs, es, 255, 0)  # every row passes the gates
    np.testing.assert_array_equal(got[0].cpu().numpy(), s_best)
    np.testing.assert_array_equal(got[1].cpu().numpy(), s_idx)
    np.testing.assert_array_equal(got[2].cpu().numpy(), s_next)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("classes,length", WALK_FORMS)
def test_sliced_walk_two_ctas_per_sm_on_card(kernel, classes, length):
    """The walk's instantiations hold two CTAs an SM, with no spill."""
    _need_card()
    info = hm.walk_info(kernel, length, classes)
    assert info["ctas_per_sm"] == 2, info
    assert info["local_bytes"] == 0 and info["registers"] <= 128, info
    assert info["static_smem"] + info["dynamic_smem"] <= 115 * 1024, info


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("classes,length", WALK_FORMS)
@pytest.mark.parametrize("edge", ["one stage", "below the ring", "the ring", "one past"])
def test_sliced_walk_ring_edges_on_card(kernel, classes, length, edge):
    """A CTA's stage count below the ring's depth, equal to it and one past
    it (one column range: K under 16 sub-tiles is never split), the last
    sub-tile ragged."""
    _need_card()
    ring = hm.walk_info(kernel, length, classes)["ring_stages"]
    groups = -(-hm.table_depth(length, classes) // 256)  # stages a sub-tile
    stages = {"one stage": 1, "below the ring": ring - 1, "the ring": ring,
              "one past": ring + 1}[edge]
    n_sub = -(-stages // groups)
    k = max(1, hm.K_ALIGN * n_sub - 3)
    rng = np.random.default_rng(7 * length + stages)
    es, obs, rows = walk_case(rng, k, length, 333, classes)
    check_walk(kernel, es, obs, rows, length, classes)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("classes,length", WALK_FORMS)
@pytest.mark.parametrize("k", [1, 300, 8193])
def test_sliced_walk_depths_on_card(kernel, classes, length, k):
    """Odd and even slice counts, one column to a few chunks' worth."""
    _need_card()
    rng = np.random.default_rng(3000 * length + k + classes)
    es, obs, rows = walk_case(rng, k, length, 333, classes)
    check_walk(kernel, es, obs, rows, length, classes)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colmerge_top2", "tile_top2"])
@pytest.mark.parametrize("classes,length", [(16, 16), (16, 24), (4, 64), (4, 100)])
def test_sliced_walk_k_chunks_on_card(monkeypatch, kernel, classes, length):
    """K = 2 * 8,192 + 5 split into many column ranges on the walk."""
    _need_card()
    rng = np.random.default_rng(41 + length)
    k, b = 2 * 8192 + 5, 700
    es, obs, rows = walk_case(rng, k, length, b, classes)
    monkeypatch.setattr(hm, "MIN_CHUNK_SUBS", 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert hm.plan_chunks(b, k, 2 * sms)[0] >= 16
    check_walk(kernel, es, obs, rows, length, classes)


@pytest.mark.gpu
def test_tile_top2_cross_tile_ties_16_classes_on_card():
    """test_tile_top2_cross_tile_ties_on_card on nib4 rows (the walk at KP
    256): duplicates in different K tiles, the first index wins."""
    _need_card()
    rng = np.random.default_rng(13)
    k, length = 3 * hm.TILE_K + 77, 16
    seqs = rng.choice(ACGT, size=(k, length)).astype(np.uint8)
    seqs[hm.TILE_K + 5] = seqs[3]
    seqs[k - 1] = seqs[hm.TILE_K + 9]
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in seqs])
    obs = np.concatenate([seqs[[3, hm.TILE_K + 9, k - 1, k - 2]],
                          rng.choice(ACGT, size=(200, length)).astype(np.uint8)])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert hm.plan_chunks(len(obs), k, 2 * sms, hm.MAX_TILE_COLS)[0] > 3
    got = check_walk("tile_top2", es, obs, nib4_rows(obs).cuda(), length, 16)
    assert list(got[1].cpu().numpy()[:4]) == [3, hm.TILE_K + 9, hm.TILE_K + 9, k - 2]


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["nib4", "bytes"])
@pytest.mark.parametrize("k,length", [(96, 17), (1, 8), (300, 64)])
def test_mask_assign_fn_on_card(form, k, length):
    """nib4 or raw-byte rows in -> gated (assigned, best, next) on the card,
    the no-call gate included: one kernel launch per call, no plain call;
    equal to the plain version's run and the spec."""
    _need_card()
    rng = np.random.default_rng(k + length)
    es, obs = mask_case(rng, k, length, 3000)
    rows = nib4_rows(obs).numpy() if form == "nib4" else obs
    fn = hm.make_hopper_assign_fn(es, 1, 2, device="cuda", packed2=False,
                                  packed_masks=form == "nib4")
    got = [t.cpu().numpy() for t in fn(rows)]
    assert fn.launches == 1 and fn.plain_calls == 0
    assert got[0].dtype == (np.uint8 if k < 255 else np.int32)
    plain = hm.make_hopper_assign_fn(es, 1, 2, device="cpu", packed2=False,
                                     packed_masks=form == "nib4")
    for g, p, w in zip(got, plain(rows), spec(obs, es, 1, 2)):
        np.testing.assert_array_equal(g.astype(np.int64), p.numpy().astype(np.int64))
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["nib4", "bytes"])
def test_mask_scan_on_card(form):
    """make_assign_fn on nib4 / raw bytes on the card (plain PyTorch, no
    kernel): equal to the spec."""
    _need_card()
    rng = np.random.default_rng(77)
    es, obs = mask_case(rng, 300, 20, 1000)
    rows = nib4_rows(obs).numpy() if form == "nib4" else obs
    fn = make_assign_fn(es, 1, 2, k_chunk=128, packed_masks=form == "nib4", device="cuda")
    for g, w in zip(fn(rows), spec(obs, es, 1, 2)):
        np.testing.assert_array_equal(g.cpu().numpy().astype(np.int64), w.astype(np.int64))


# --------------------------------------------------------------------------
# the kernel lab's kernels (TPU kernels #3-#7)
# --------------------------------------------------------------------------

#: (variant, K, L, tile_k): K not a multiple of tile_k (pad columns of all
#: ones), every bit-word count NW = 1..4 (for ``v4_int4``: every mma depth
#: KP = 32..128)
LAB_CASES = [
    ("v4_int4", 5000, 16, 128),
    ("v4_int4", 3000, 7, 64),
    ("v4_int4", 3000, 24, 96),
    ("v4_int4", 5000, 31, 256),
    *[(name, 5000, 16, 128) for name in lk.PROBES],
    ("v5_clamp16", 5000, 16, 128),
    ("v6_group2", 5000, 16, 128),
    ("v6_group4", 5000, 7, 128),
    ("v6_group8", 5000, 24, 128),
    ("v3_clamp8", 5000, 31, 128),
    ("v3w_clamp8", 3000, 16, 256),
    ("p_i8minmax", 3000, 7, 64),
    ("v1_m1only", 3000, 31, 96),
]

#: each variant of the kernels that count on the tensor cores (``lab_probe``,
#: ``clamp16_top2``, ``group_top2``, ``clamp8_top2``) at every ``wgmma``
#: width (N = 32, 64, 128 at tile_k 96, 64, 128 / 256; ``group_top2`` at most
#: 64) and table depth (KP = 32, 64, 96, 128 at L 7, 16, 24, 31)
LAB_CASES += [
    (name, 3000, length, tile_k)
    for name in lk.TILED_VARIANTS
    for length, tile_k in [(7, 96), (16, 64), (24, 128), (31, 256), (16, 96), (31, 64)]
]


def whole_groups(name, k, tile_k):
    """``k``, or for ``v6_group{P}`` the K of as many more K tiles as make
    their count a multiple of 8 (every P), with the same ragged last tile."""
    if not name.startswith("v6_group"):
        return k
    n = -(-k // tile_k)
    return k + (-(-n // 8) * 8 - n) * tile_k


def lab_case(name, k, length, tile_k, b, seed):
    from fqtk_tpu_torch.lab import kernel_lab as lab

    k = whole_groups(name, k, tile_k)
    codes = lab.unique_barcodes(k, length)
    rng = np.random.default_rng(seed)
    obs = codes[rng.integers(0, k, size=b)].copy()
    mut = rng.random(b) < 0.5
    obs[mut, rng.integers(0, length, size=b)[mut]] = rng.integers(0, 4, size=int(mut.sum()))
    params = lk.lab_params(name, k, length, tile_k)
    bits = lab.table_for(params.kernel, lab.masks_of(codes), tile_k, "cuda")
    return params, bits, torch.from_numpy(lab.pack_bit2(obs)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("name,k,length,tile_k", LAB_CASES)
def test_lab_kernel_matches_plain_on_card(name, k, length, tile_k):
    _need_card()
    params, bits, obs = lab_case(name, k, length, tile_k, b=1024, seed=k + length)
    kern = lk.make_lab_kernels()[params.kernel]
    for rows in (1024, 1024 - 37):  # and a ragged row tile
        o = obs[:rows].contiguous()
        got = kern(o, bits, params)
        want = kern.reference(o, bits, params)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == (rows,)
            assert torch.equal(g, w)
    assert (kern.launches, kern.plain_calls) == (2, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", lk.TILED_VARIANTS)
def test_tiled_lab_kernel_one_row_on_card(name):
    """B = 1: one row of a 128-row CTA is real, the others neither write
    partials nor reach the fold."""
    _need_card()
    params, table, obs = lab_case(name, 3000, 16, 128, b=1, seed=5)
    kern = lk.make_lab_kernels()[params.kernel]
    got = kern(obs, table, params)
    want = kern.reference(obs, table, params)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == (1,) and torch.equal(g, w)
    assert (kern.launches, kern.plain_calls) == (1, 0)


@pytest.mark.gpu
def test_clamp8_255_k_tiles_on_card():
    """The most K tiles the uint8 tile ids hold: 255 steps per CTA."""
    _need_card()
    from fqtk_tpu_torch.lab import kernel_lab as lab

    k = 255 * 32 - 5
    params, table, obs = lab_case("v3_clamp8", k, 16, 32, b=300, seed=8)
    assert params.n_k_tiles == 255
    last = lab.unique_barcodes(k, 16)[k - 1:]  # a read whose best is in tile 254
    obs[0] = torch.from_numpy(lab.pack_bit2(last))[0]
    kern = lk.make_lab_kernels()["clamp8_top2"]
    got = kern(obs, table, params)
    want = kern.reference(obs, table, params)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (int(got[0][0]), int(got[1][0])) == (0, k - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["v3_clamp8", "v3w_clamp8"])
def test_clamp8_ties_on_card(name):
    _need_card()
    from fqtk_tpu_torch.lab import kernel_lab as lab

    tile_k = 32
    codes, rows = lab.tie_case(tile_k)
    params = lk.lab_params(name, len(codes), 16, tile_k)
    table = lab.table_for(params.kernel, lab.masks_of(codes), tile_k, "cuda")
    obs = torch.from_numpy(lab.pack_bit2(rows)).cuda()
    kern = lk.make_lab_kernels()["clamp8_top2"]
    best, idx, nxt = (x.cpu().tolist() for x in kern(obs, table, params))
    want = kern.reference(obs, table, params)
    assert [best, idx, nxt] == [x.cpu().tolist() for x in want]
    # the tie: count 0 at position 5 of tiles 0, 1, 2 -> tile 0; next 0
    assert (best[0], idx[0], nxt[0]) == (0, 5, 0)
    # every count clamps to W: tile id 0, position 0
    assert (best[1], idx[1], nxt[1]) == (params.w_clamp, 0, params.w_clamp)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["v5_clamp16", "v6_group2", "v6_group4", "v6_group8"])
def test_exact_ties_on_card(name):
    """Count 0 at position 5 of eight K tiles: the first tile wins, within a
    group and across groups; ``v5_clamp16``: a read whose every count is
    above W clamps to W everywhere (tile 0, position 0)."""
    _need_card()
    from fqtk_tpu_torch.lab import kernel_lab as lab

    tile_k = 32
    codes, rows = lab.tie_case(tile_k, n_tiles=8)
    params = lk.lab_params(name, len(codes), 16, tile_k)
    table = lab.table_for(params.kernel, lab.masks_of(codes), tile_k, "cuda")
    obs = torch.from_numpy(lab.pack_bit2(rows)).cuda()
    kern = lk.make_lab_kernels()[params.kernel]
    best, idx, nxt = (x.cpu().tolist() for x in kern(obs, table, params))
    want = kern.reference(obs, table, params)
    assert [best, idx, nxt] == [x.cpu().tolist() for x in want]
    assert (best[0], idx[0], nxt[0]) == (0, 5, 0)
    if name == "v5_clamp16":
        assert (best[1], idx[1], nxt[1]) == (params.w_clamp, 0, params.w_clamp)
    assert (kern.launches, kern.plain_calls) == (1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["v6_group2", "v6_group4", "v6_group8"])
def test_group_int32_twin_on_card(name):
    """Keys of 15 bits or more (L 16, 1,032 K tiles: nt_pow2 2,048): the
    int32 twin of ``group_top2``'s 16x2-lane ladder, at N = 32."""
    _need_card()
    params, table, obs = lab_case(name, 33_019, 16, 32, b=300, seed=6)
    assert params.n_k_tiles == 1032 and not lk.group_lanes16(16, params.nt_pow2)
    assert params.width == 32
    kern = lk.make_lab_kernels()["group_top2"]
    got = kern(obs, table, params)
    want = kern.reference(obs, table, params)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (kern.launches, kern.plain_calls) == (1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,length,mm,delta", [(96, 300, 1, 2), (1, 256, 0, 0), (300, 260, 2, 1)])
def test_long_barcode_route_on_card(k, length, mm, delta):
    """``make_assign_fn``, the route of barcodes longer than 255 bp, on CUDA
    tensors against the NumPy spec (uint8 ``assigned`` below 255 samples)."""
    _need_card()
    rng = np.random.default_rng(k + length)
    es, obs = whitelist_case(rng, k, length, 1024)
    fn = make_assign_fn(es, mm, delta, packed2=True, compact_output=True, device="cuda")
    assigned, best, nxt = fn(pack_bit2(obs))
    assert assigned.is_cuda and assigned.dtype == (torch.uint8 if k < 255 else torch.int32)
    for got, want in zip((assigned, best, nxt), spec(obs, es, mm, delta)):
        np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64), want)
    assert fn.scheme == "xla_scan" and fn.calls == 1


@pytest.mark.gpu
def test_tiled_lab_kernels_reject_other_tables_on_card():
    """A CUDA tensor launches the kernel or raises: the bit table, a table
    of another depth and a misaligned view are refused, none runs the plain
    version."""
    _need_card()
    from fqtk_tpu_torch.lab import kernel_lab as lab

    params, table, obs = lab_case("v3_clamp8", 512, 16, 128, b=64, seed=3)
    kern = lk.make_lab_kernels()["clamp8_top2"]
    codes = lab.unique_barcodes(512, 16)
    bits = lab.lab_table(lab.masks_of(codes), 128, "cuda")
    with pytest.raises(ValueError, match="tiled table"):
        kern(obs, bits, params)
    with pytest.raises(ValueError, match="tiled table"):
        kern(obs, table.to(torch.uint8), params)
    shifted = torch.empty(table.numel() + 1, dtype=torch.int8, device="cuda")[1:]
    shifted.copy_(table.flatten())
    with pytest.raises(ValueError, match="16-byte aligned"):
        kern(obs, shifted.view(table.shape), params)
    with pytest.raises(ValueError, match="obs on"):
        kern(obs, table.cpu(), params)
    assert (kern.launches, kern.plain_calls) == (0, 0)


@pytest.mark.gpu
def test_lab_variants_launch_on_card():
    """make_lab_variant on the card: every ported variant goes through its
    kernel (the shared wrappers count it), and the exact v6 equals v0."""
    _need_card()
    from fqtk_tpu_torch.lab import kernel_lab as lab

    codes = lab.unique_barcodes(4096, 16)
    obs = torch.from_numpy(lab.pack_bit2(codes[::4])).cuda()
    lk.reset_counts()
    outs = {}
    for name in ("v0_colmerge", "v4_int4", *lk.PROBES, "v5_clamp16", "v6_group4",
                 "v3_clamp8"):
        go, table, _ = lab.make_lab_variant(name, lab.masks_of(codes), 16, tile_b=256,
                                            tile_k=256, device="cuda")
        outs[name] = [t.cpu() for t in go(obs, table)]
    assert lk.counts() == {"mma_probe": (1, 0), "lab_probe": (5, 0), "clamp16_top2": (1, 0),
                           "group_top2": (1, 0), "clamp8_top2": (1, 0)}
    best, idx, nxt = outs["v0_colmerge"]
    assert torch.equal(best, torch.zeros_like(best))
    assert torch.equal(outs["v6_group4"][0], idx) and torch.equal(outs["v6_group4"][2], nxt)
    # v4_int4: mismatches against column 3,840 (column 0 of the last K tile)
    # of distinct barcodes: 0 only for the row that is that barcode
    (v4,) = outs["v4_int4"]
    assert torch.equal(torch.nonzero(v4 == 0).flatten(), torch.tensor([3840 // 4]))


@pytest.mark.gpu
def test_failing_lab_kernel_load_raises_on_card(monkeypatch):
    _need_card()
    from fqtk_tpu_torch.ops import _build

    params, bits, obs = lab_case("v6_group2", 512, 16, 128, b=64, seed=3)
    monkeypatch.setattr(_build, "_KERNELS", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    kern = lk.make_lab_kernels()["group_top2"]
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        kern(obs, bits, params)
    assert kern.launches == 0 and kern.plain_calls == 0


def _demux_dataset(tmp_path, k=96, length=17, n=3000, seed=12):
    """A seeded single-end dataset: ``k`` distinct barcodes of ``length``,
    ``n`` reads (a tenth one base off, one in fifty with an N)."""
    rng = np.random.default_rng(seed)
    barcodes = set()
    while len(barcodes) < k:
        barcodes.add(bytes(rng.choice(ACGT, size=length)).decode())
    barcodes = sorted(barcodes)
    meta = tmp_path / "meta.tsv"
    meta.write_text("sample_id\tbarcode\n" + "".join(f"S{i}\t{b}\n" for i, b in enumerate(barcodes)))
    lines = []
    for i in range(n):
        bc = bytearray(barcodes[int(rng.integers(0, k))].encode())
        if i % 10 == 0:
            bc[i % length] = ord("T") if bc[i % length] != ord("T") else ord("G")
        if i % 50 == 7:
            bc[(i + 3) % length] = ord("N")
        seq = bc.decode() + "ACGT" * 5
        lines.append(f"@r{i} 1:N:0:0\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp_path / "in.fastq"
    fq.write_text("".join(lines))
    return barcodes, meta, fq


@pytest.mark.gpu
def test_measured_placement_on_card(tmp_path, monkeypatch):
    """The real probe on the card at K 96: host window, device floor and
    (where the floor does not already lose) the device window, each finite
    and positive; the choice follows the rule; the decision lands in the
    port's own file, keyed by the card's name, and a second build reads it."""
    _need_card()
    from fqtk_tpu_torch.ops._build import ensure_native_engine
    from fqtk_tpu_torch.ops.matcher import ExpectedSet as PortExpectedSet
    from fqtk_tpu_torch.runtime import demux

    ensure_native_engine()  # as run_demux does: the host matcher needs it
    monkeypatch.setenv("FQTK_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    monkeypatch.delenv("FQTK_MEASURE_CROSSOVER", raising=False)
    demux._ASSIGN_FN_CACHE.clear()
    barcodes, meta, fq = _demux_dataset(tmp_path)
    es = PortExpectedSet.from_barcodes(barcodes)
    cfg = demux.DemuxConfig(inputs=[fq], read_structures=["17B+T"], sample_metadata=meta,
                            output=tmp_path / "out", device="cuda")
    assign, pack_mode, host = demux._build_device_assign_fn(cfg, es, barcodes)
    info = assign.crossover
    for name in ("crossover_host_s", "crossover_floor_s"):
        assert np.isfinite(info[name]) and info[name] > 0, info
    if info["crossover_device_chosen"]:
        assert not host and pack_mode == "bit2"
        assert info["crossover_device_s"] * 1.1 < info["crossover_host_s"]
    else:
        assert host and pack_mode == "nib4"
    import json

    data = json.loads((tmp_path / "cache" / "crossover-torch.json").read_text())
    (key,) = data
    assert torch.cuda.get_device_name() in key
    assert not (tmp_path / "cache" / "crossover.json").exists()
    monkeypatch.setattr(demux, "_time_host_window", lambda *a, **k: 1 / 0)
    again = demux._build_device_assign_fn(cfg, es, barcodes)
    assert again[0].crossover == info and again[2] == host


@pytest.mark.gpu
def test_pallas_engine_on_card(tmp_path):
    """``--engine pallas`` on ``cuda``: the Python-IO engine launches
    ``colmerge_top2`` on the 16-class input, calls no plain version, and
    writes the bytes of the numpy engine."""
    _need_card()
    import gzip

    from fqtk_tpu_torch.runtime import demux

    barcodes, meta, fq = _demux_dataset(tmp_path)
    outs = {}
    for engine in ("pallas", "numpy"):
        res = demux.run_demux(demux.DemuxConfig(
            inputs=[fq], read_structures=["17B+T"], sample_metadata=meta,
            output=tmp_path / engine, engine=engine, batch_size=1024, device="cuda"))
        outs[engine] = {p.name: gzip.open(p).read() for p in sorted((tmp_path / engine).glob("*.fq.gz"))}
        outs[engine]["metrics"] = (tmp_path / engine / "demux-metrics.txt").read_bytes()
        if engine == "pallas":
            assert res.matcher["colmerge_top2_launches"] == 3  # ceil(3000 / 1024)
            assert res.matcher["plain_calls"] == 0 and res.matcher["tile_top2_launches"] == 0
        assert res.total_templates == 3000
    assert outs["pallas"] == outs["numpy"]


def _nib4(obs):
    from fqtk_tpu.core.encoding import ENCODE_LUT

    masks = ENCODE_LUT[obs]
    b, length = masks.shape
    padded = np.zeros((b, length + length % 2), dtype=np.uint8)
    padded[:, :length] = masks
    return (padded[:, 0::2] | (padded[:, 1::2] << 4)).astype(np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["bit2", "nib4", "bytes"])
@pytest.mark.parametrize("n_batch,n_k", [(2, 1), (1, 2), (2, 3)])
def test_sharded_mesh_on_card(n_batch, n_k, form):
    """The mesh with every tile on ``cuda:0`` (the card's host has one GPU):
    each tile launches its shard's kernel once, no plain call, and
    ``(assigned, counts)`` equal the same mesh on the CPU (the plain
    versions) and the NumPy spec; the gate uses the whole whitelist's
    no-call budget (an N in one shard's barcode)."""
    _need_card()
    from fqtk_tpu_torch.parallel import mesh

    rng = np.random.default_rng(31 + n_batch * 10 + n_k)
    es, obs = whitelist_case(rng, k=301, length=12, b=1001)
    if form != "bit2":
        obs[5::40, 3] = ord("N")
        obs[9::40, 2:4] = ord("N")
    rows = pack_bit2(obs) if form == "bit2" else _nib4(obs) if form == "nib4" else obs
    flags = dict(packed2=form == "bit2", packed_masks=form == "nib4")
    got = {}
    for dev in ("cuda", "cpu"):
        devices = [torch.device(dev, 0) if dev == "cuda" else torch.device("cpu")] * (n_batch * n_k)
        fn = mesh.make_sharded_assign_fn(
            es, 1, 2, mesh.make_demux_mesh(n_batch, n_k, devices=devices), **flags)
        assigned, counts = fn(rows)
        torch.cuda.synchronize()
        if dev == "cuda":
            assert assigned.device.type == "cuda"
            assert (fn.launches, fn.plain_calls) == (n_batch * n_k, 0)
            assert fn.kernels["colmerge_top2"].launches == n_batch * n_k
        else:
            assert (fn.launches, fn.plain_calls) == (0, n_batch * n_k)
        got[dev] = (assigned.cpu().numpy(), counts.cpu().numpy())
    want = spec(obs, es, 1, 2)[0]
    for assigned, counts in got.values():
        np.testing.assert_array_equal(assigned, want)
        np.testing.assert_array_equal(counts, np.bincount(want, minlength=es.count + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [None, 8])
def test_mesh_demux_on_card(tmp_path, monkeypatch, threshold):
    """``run_demux`` with ``devices=2`` over ``[cuda:0] * 2``: the batch mesh,
    and the whitelist mesh with ``PALLAS_K_THRESHOLD`` set low; each
    launches ``colmerge_top2`` per tile, calls no plain version, and writes
    the bytes of the numpy engine."""
    _need_card()
    import gzip

    from fqtk_tpu_torch.parallel import mesh
    from fqtk_tpu_torch.runtime import demux

    monkeypatch.setattr(mesh, "local_devices", lambda device="cuda": [torch.device("cuda", 0)] * 2)
    if threshold is not None:
        monkeypatch.setattr(demux, "PALLAS_K_THRESHOLD", threshold)
    demux._ASSIGN_FN_CACHE.clear()
    barcodes, meta, fq = _demux_dataset(tmp_path)
    outs = {}
    for engine in ("native", "numpy"):
        res = demux.run_demux(demux.DemuxConfig(
            inputs=[fq], read_structures=["17B+T"], sample_metadata=meta,
            output=tmp_path / engine, engine=engine, batch_size=1024, devices=2,
            matcher="device", device="cuda"))
        outs[engine] = {p.name: gzip.open(p).read() for p in sorted((tmp_path / engine).glob("*.fq.gz"))}
        outs[engine]["metrics"] = (tmp_path / engine / "demux-metrics.txt").read_bytes()
        if engine == "native":
            assert res.matcher["colmerge_top2_launches"] == 2 * 3  # 2 tiles x ceil(3000 / 1024)
            assert res.matcher["plain_calls"] == 0 and res.matcher["tile_top2_launches"] == 0
    demux._ASSIGN_FN_CACHE.clear()
    assert outs["native"] == outs["numpy"]


def _check_device_leg(entry, k_counted):
    """A harness device leg: ``colmerge_top2`` launched, no plain call, a
    positive device-only rate and, on an H100, an MFU."""
    from fqtk_tpu_torch import bench

    assert entry["scheme"] == "colmerge_top2" and entry["launches"] > 0, entry
    assert entry["plain_calls"] == 0 and entry["k_counted"] == k_counted
    assert entry["device_only_reads_per_sec"] > 0 and entry["achieved_tops"] > 0
    if torch.cuda.get_device_name(0) in bench._PEAK_OPS:
        assert 0 < entry["device_mfu"] < 1


@pytest.mark.gpu
def test_bench_midk_leg_on_card():
    """``fqtk_tpu_torch.bench``'s mid-K leg at its full size (K 8,192, L 16,
    B 2^17, the rate between 2^18 and 2^19) through ``colmerge_top2``."""
    _need_card()
    from fqtk_tpu_torch import bench

    got = bench.bench_midk_config(device="cuda")
    assert got["name"] == "mid_K_8192_16bp_mm1_d2" and got["reads_per_sec"] > 0
    _check_device_leg(got, 8192)


@pytest.mark.gpu
def test_bench_bigk_device_leg_on_card():
    """The 737K config's device leg at its full size (K 737,280, the rate
    between B 2^17 and 2^18, the clustered windows through the dedup):
    ``colmerge_top2``, no error recorded."""
    _need_card()
    from fqtk_tpu_torch import bench

    got = bench.bench_bigk_config(device="cuda")
    dev = got["device_pallas"]
    assert "error" not in dev, dev
    _check_device_leg(dev, 737_280)
    assert dev["clustered_8k_cells_dedup_reads_per_sec"] > 0
    assert bench.failed_configs({"configs": [got]}) == []


@pytest.mark.gpu
def test_graft_entry_on_card(tmp_path, monkeypatch):
    """``graft_entry.entry()`` on the card equals its CPU run, and
    ``dryrun_multichip(2, [cuda:0] * 2)`` launches ``colmerge_top2`` in
    every sharded step with no plain call."""
    _need_card()
    monkeypatch.setenv("FQTK_CACHE_DIR", str(tmp_path / "cache"))
    from fqtk_tpu_torch import graft_entry

    fn, (obs,) = graft_entry.entry()
    cpu_fn, _ = graft_entry.entry(device="cpu")
    for got, want in zip(fn(obs), cpu_fn(obs)):
        assert torch.equal(got.cpu(), want)
    counts = graft_entry.dryrun_multichip(2, devices=[torch.device("cuda", 0)] * 2)
    for step in ("small_k", "bigk_sharded", "bigk_sharded_kernels", "driver"):
        assert counts[step]["launches"] > 0 and counts[step]["plain_calls"] == 0, (step, counts)


@pytest.mark.gpu
def test_profile_e2e_device_arm_on_card(tmp_path, monkeypatch):
    """``profile_e2e`` on ``headline`` at 100,000 reads: the device arm
    (``FQTK_HOST_MATCHER_MAX_K=0``) launches ``colmerge_top2`` with no plain
    call, and its outputs equal the ``as_is`` (host matcher) arm's."""
    _need_card()
    monkeypatch.setenv("FQTK_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    from fqtk_tpu_torch.scripts import profile_e2e

    rec = profile_e2e.run("headline", 100_000, "cuda", trials=1, record_path=tmp_path / "p.json")
    as_is, dev = rec["runs"]
    m = dev["matcher"]
    assert m["scheme"] == "colmerge_top2" and m["launches"] > 0 and m["plain_calls"] == 0, m
    assert dev["outputs_sha256"] == as_is["outputs_sha256"]
    assert dev["counted_io_s"] + dev["uncounted_cpu_s"] + dev["idle_s"] == pytest.approx(
        dev["cores_x_wall"])


@pytest.mark.gpu
def test_ab_e2e_midk_device_arm_on_card(tmp_path, monkeypatch):
    """``ab_e2e midk`` at 100,000 reads: the ``FQTK_HOST_MATCHER_MAX_K=0``
    arm launches ``colmerge_top2`` with no plain call, the ``=100000`` arm
    runs the host matcher, and their outputs are identical."""
    _need_card()
    monkeypatch.setenv("FQTK_CACHE_DIR", str(tmp_path / "cache"))
    from fqtk_tpu_torch.scripts import ab_e2e

    monkeypatch.setattr(ab_e2e, "N", 100_000)
    arms = ["FQTK_HOST_MATCHER_MAX_K=0", "FQTK_HOST_MATCHER_MAX_K=100000"]
    rec = ab_e2e.run("midk", 1, arms, "cuda", record_path=tmp_path / "ab.json")
    dev, host = (rec["arms"][a] for a in arms)
    m = dev["matcher"]
    assert m["scheme"] == "colmerge_top2" and m["launches"] > 0 and m["plain_calls"] == 0, m
    assert host["matcher"] == {}
    assert dev["outputs_sha256"] == host["outputs_sha256"]


@pytest.mark.gpu
def test_deep_campaign_matcher_leg_on_card(capsys):
    """The campaign's matcher leg at 4 cases: both kernels, forced, on raw
    bytes and bit2 rows, equal to the NumPy spec over (assigned, best, next);
    launched, no plain call."""
    _need_card()
    from fqtk_tpu_torch.scripts import deep_campaign

    r = deep_campaign.matcher_leg(4, 0, "cuda")
    assert r["failures"] == 0, capsys.readouterr().out
    for name, c in r["counts"].items():
        assert c["launches"] > 0 and c["plain_calls"] == 0, (name, c)
    assert r["max_abs_err"] == {k: {"bytes": 0, "bit2": 0} for k in hm.SCHEMES}


def test_every_cu_has_an_entry_point():
    """``load_kernel`` loads every ``csrc/*.cu`` and looks up its
    ``ENTRY_POINTS`` entry: each source needs one, with as many argument
    types as its ``extern "C"`` function has parameters."""
    import re

    from fqtk_tpu_torch.ops import _build

    stems = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert stems == sorted(_build.ENTRY_POINTS)
    for stem in stems:
        src = (_build.CSRC_DIR / f"{stem}.cu").read_text()
        m = re.search(r'extern "C" int fqtk_%s\(([^)]*)\)' % stem, src)
        assert m is not None, stem
        assert m.group(1).count(",") + 1 == len(_build.ENTRY_POINTS[stem]), stem
