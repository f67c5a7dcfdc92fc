"""The port's matchers on nib4 and raw-byte input (16 one-hot classes per
position, the no-call gate on the device) against the JAX package on the
same seeded inputs: ``fqtk_tpu_torch.ops.matcher.make_assign_fn`` against
the JAX ``make_assign_fn`` (XLA on the CPU), and
``fqtk_tpu_torch.ops.hopper_matcher.make_hopper_assign_fn`` (on the CPU:
the Hopper kernels' plain versions) against ``make_pallas_assign_fn`` in
interpret mode, both against the NumPy spec ``assign_batch_np`` /
``assign_batch_np_masks``.  Mirrors ``tests/test_matcher.py:156-221`` and
``tests/test_pallas_matcher.py:30-71, :160-180``.  The CUDA kernels' 16-class
input is held to the same plain versions by ``test_torch_kernels_gpu.py`` on
the card.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from fqtk_tpu.core.encoding import ENCODE_LUT
from fqtk_tpu.ops.matcher import ExpectedSet as JaxExpectedSet
from fqtk_tpu.ops.matcher import assign_batch_np, assign_batch_np_masks
from fqtk_tpu.ops.matcher import make_assign_fn as jax_make_assign_fn
from fqtk_tpu.ops.pallas_matcher import make_pallas_assign_fn
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_nib4, unpack_nib4
from fqtk_tpu_torch.ops.matcher import (
    MAX_COUNT,
    ExpectedSet,
    compat16_rows,
    input_form,
    make_assign_fn,
)

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)
LENGTHS = [1, 7, 16, 17, 64, 65]
FORMS = ["nib4", "bytes"]


def nib4_of(obs_bytes):
    """Two 4-bit masks per byte, low nibble = even position (the JAX tests'
    packing, ``tests/test_matcher.py:196-199``)."""
    masks = ENCODE_LUT[obs_bytes]
    b, length = masks.shape
    padded = np.zeros((b, length + length % 2), dtype=np.uint8)
    padded[:, :length] = masks
    return (padded[:, 0::2] | (padded[:, 1::2] << 4)).astype(np.uint8)


def rows_of(obs_bytes, form):
    return nib4_of(obs_bytes) if form == "nib4" else obs_bytes


def case(rng, k, length, b):
    """Distinct barcodes over ACGTN (IUPAC N in the whitelist), reads over
    ACGTN with every fourth an exact copy of a barcode and a lowercase
    row."""
    k = min(k, 5 ** length)  # distinct barcodes over ACGTN
    barcodes = set()
    while len(barcodes) < k:
        barcodes.add(bytes(rng.choice(BASES, size=length)).decode())
    barcodes = sorted(barcodes)
    obs = rng.choice(BASES, size=(b, length)).astype(np.uint8)
    for i in range(0, b, 4):
        obs[i] = np.frombuffer(barcodes[i % k].encode(), dtype=np.uint8)
    obs[1] = np.frombuffer(barcodes[0].lower().encode(), dtype=np.uint8)
    return barcodes, obs


def spec(obs_bytes, barcodes, mm, delta):
    es = JaxExpectedSet.from_barcodes(barcodes)
    idx, best, nxt = assign_batch_np(obs_bytes, es, mm, delta)
    return np.where(idx < 0, es.count, idx), best, nxt


def as_np(out):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in out]


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), np.asarray(w).astype(np.int64))


def port_scan(barcodes, mm, delta, form, **kw):
    return make_assign_fn(ExpectedSet.from_barcodes(barcodes), mm, delta,
                          packed_masks=form == "nib4", device="cpu", **kw)


def port_hopper(barcodes, mm, delta, form, **kw):
    return hm.make_hopper_assign_fn(ExpectedSet.from_barcodes(barcodes), mm, delta,
                                    packed2=False, packed_masks=form == "nib4",
                                    device="cpu", **kw)


def pallas(barcodes, mm, delta, form, **kw):
    return make_pallas_assign_fn(JaxExpectedSet.from_barcodes(barcodes), mm, delta,
                                 interpret=True, tile_b=256, tile_k=128,
                                 packed_masks=form == "nib4", **kw)


# --------------------------------------------------------------------------
# make_assign_fn (the scan, plain PyTorch) against the JAX scan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("length", LENGTHS)
def test_scan_matches_jax_scan_and_spec(form, length):
    rng = np.random.default_rng(100 + length)
    barcodes, obs = case(rng, 37, length, 257)  # K 5 at L 1
    rows = rows_of(obs, form)
    for mm, delta in [(1, 2), (0, 0), (2, 1)]:
        fn = port_scan(barcodes, mm, delta, form, k_chunk=16)
        got = as_np(fn(rows))
        jax_fn = jax_make_assign_fn(JaxExpectedSet.from_barcodes(barcodes), mm, delta,
                                    k_chunk=16, packed_masks=form == "nib4")
        assert_same(got, as_np(jax_fn(rows)))
        assert_same(got, spec(obs, barcodes, mm, delta))
        assert fn.scheme == "xla_scan" and fn.form == form


@pytest.mark.parametrize("k_chunk", [4, 16384])
def test_scan_matches_jax_random(k_chunk):
    """``tests/test_matcher.py:156-177`` on raw bytes, and on nib4."""
    rng = np.random.default_rng(42)
    barcodes, obs = case(rng, 37, 12, 257)
    for mm, delta in [(0, 0), (1, 2), (2, 1), (100, 3)]:
        want = spec(obs, barcodes, mm, delta)
        for form in FORMS:
            got = as_np(port_scan(barcodes, mm, delta, form, k_chunk=k_chunk)(rows_of(obs, form)))
            assert_same(got, want)


# --------------------------------------------------------------------------
# make_hopper_assign_fn (the kernels' plain versions) against Pallas
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("length", LENGTHS)
def test_hopper_matches_pallas_and_spec(form, length):
    rng = np.random.default_rng(200 + length)
    barcodes, obs = case(rng, 43, length, 300)
    rows = rows_of(obs, form)
    for mm, delta in [(1, 2), (0, 0)]:
        fn = port_hopper(barcodes, mm, delta, form)
        got = as_np(fn(rows))
        assert fn.launches == 0 and fn.plain_calls == 1
        assert fn.state.classes == 16 and fn.form == form
        assert got[0].dtype == np.uint8  # compact output, K < 255
        assert_same(got, as_np(pallas(barcodes, mm, delta, form, compact_output=True)(rows)))
        assert_same(got, spec(obs, barcodes, mm, delta))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("scheme", hm.SCHEMES)
def test_both_schemes_on_16_classes(form, scheme):
    """Both kernels' plain versions at 16 classes, on a state built for
    each: equal to each other, to Pallas and to the spec."""
    rng = np.random.default_rng(5)
    barcodes, obs = case(rng, 29, 9, 300)
    es = ExpectedSet.from_barcodes(barcodes)
    state = hm.hopper_state_from_numpy(es, "cpu", scheme, classes=16)
    fn = hm.HopperAssignFn(state, 1, 2, compact_output=True, form=form)
    got = as_np(fn(rows_of(obs, form)))
    assert fn.kernels[scheme].plain_calls == 1 and fn.launches == 0
    assert_same(got, spec(obs, barcodes, 1, 2))
    assert_same(got, as_np(pallas(barcodes, 1, 2, form, compact_output=True)(rows_of(obs, form))))


# --------------------------------------------------------------------------
# the gates, K = 1, ties, L = 255, the output type
# --------------------------------------------------------------------------


NOCALL_BARCODES = ["NNAAAAAA", "NNCCCCCC"]
#: budget = max_mm 0 + max_ns 2: two no-calls pass (``.`` is one), three
#: fail; lowercase matches; a row with the budget's no-calls but a mismatch
NOCALL_READS = [b"ANAAAAAA", b"ANCCCCCC", b"NNNAAAAA", b"anaaaaaa", b"NNAAAAAA",
                b"NNAAAAAC", b".NAAAAAA", b"nnnccccc"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("build", [port_scan, port_hopper], ids=["scan", "hopper"])
def test_iupac_and_nocall_gate_edge(build, form):
    obs = np.stack([np.frombuffer(r, dtype=np.uint8) for r in NOCALL_READS])
    got = as_np(build(NOCALL_BARCODES, 0, 0, form)(rows_of(obs, form)))
    assert list(got[0]) == [0, 1, 2, 0, 0, 2, 0, 2]
    assert_same(got, spec(obs, NOCALL_BARCODES, 0, 0))
    # the mask spec counts no-calls as mask == 15 on the same rows
    es = JaxExpectedSet.from_barcodes(NOCALL_BARCODES)
    idx, best, nxt = assign_batch_np_masks(ENCODE_LUT[obs], es, 0, 0)
    assert_same(got, (np.where(idx < 0, 2, idx), best, nxt))
    tiled = np.tile(obs, (32, 1))
    assert_same(as_np(build(NOCALL_BARCODES, 0, 0, form)(rows_of(tiled, form))),
                as_np(pallas(NOCALL_BARCODES, 0, 0, form)(rows_of(tiled, form))))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("build", [port_scan, port_hopper], ids=["scan", "hopper"])
def test_single_barcode_next_is_maxcount(build, form):
    obs = np.frombuffer(b"ACGTACGTACGTACGAACGTTCGTNNGTACGT", dtype=np.uint8).reshape(4, 8).copy()
    got = as_np(build(["ACGTACGT"], 2, 1, form)(rows_of(obs, form)))
    assert (got[2] == MAX_COUNT).all()
    assert list(got[1]) == [0, 1, 1, 2]
    assert_same(got, spec(obs, ["ACGTACGT"], 2, 1))
    tiled = np.tile(obs, (64, 1))
    assert_same(as_np(build(["ACGTACGT"], 2, 1, form)(rows_of(tiled, form))),
                as_np(pallas(["ACGTACGT"], 2, 1, form)(rows_of(tiled, form))))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("chunk", [7, 128])
def test_first_index_tie_across_k_chunks(monkeypatch, form, chunk):
    """Duplicated barcodes in different K chunks: the first global index
    wins and ``next`` equals ``best``, in the scan (K chunks of ``chunk``)
    and in both plain versions (K chunks of ``chunk`` columns, and TILE_K
    tiles of ``chunk`` columns)."""
    rng = np.random.default_rng(23)
    seqs = rng.choice(BASES[:4], size=(300, 12)).astype(np.uint8)
    seqs[150] = seqs[3]
    seqs[299] = seqs[0]
    barcodes = [bytes(r).decode() for r in seqs]
    obs = rng.choice(BASES, size=(333, 12)).astype(np.uint8)
    obs[:300] = seqs
    rows = rows_of(obs, form)
    want = spec(obs, barcodes, 2, 0)
    got = as_np(port_scan(barcodes, 2, 0, form, k_chunk=chunk)(rows))
    assert got[0].dtype == np.int32  # K >= 255: no compact output
    assert (got[0][150], got[1][150], got[2][150]) == (3, 0, 0)
    assert_same(got, want)
    monkeypatch.setattr(hm, "_PLAIN_CHUNK_ELEMS", chunk * len(obs))
    monkeypatch.setattr(hm, "TILE_K", chunk)
    es = ExpectedSet.from_barcodes(barcodes)
    for scheme in hm.SCHEMES:
        state = hm.hopper_state_from_numpy(es, "cpu", scheme, classes=16)
        got = as_np(hm.HopperAssignFn(state, 2, 0, True, form)(rows))
        assert (got[0][299], got[1][299]) == (0, 0)
        assert_same(got, want)
    assert_same(got, as_np(pallas(barcodes, 2, 0, form)(rows)))


@pytest.mark.parametrize("form", FORMS)
def test_length_255_small_k(form):
    """L = 255 (16L = 4,080 depth bytes, KP 4,096 on the card): a read that
    mismatches a barcode everywhere counts 255."""
    rng = np.random.default_rng(255)
    barcodes, obs = case(rng, 5, 255, 40)
    obs[2] = np.frombuffer(barcodes[0].encode(), dtype=np.uint8)
    obs[3] = np.where(obs[2] == ord("A"), ord("C"), ord("A")).astype(np.uint8)
    rows = rows_of(obs, form)
    want = spec(obs, barcodes, 3, 1)
    for build in (port_scan, port_hopper):
        assert_same(as_np(build(barcodes, 3, 1, form)(rows)), want)
    assert_same(as_np(pallas(barcodes, 3, 1, form)(rows)), want)
    assert hm.table_depth(255, 16) == 4096


@pytest.mark.parametrize("form", FORMS)
def test_compact_output(form):
    """``tests/test_matcher.py:196-221`` / ``test_pallas_matcher.py:160-180``:
    uint8 ``assigned`` when asked and K < 255; int32 otherwise."""
    rng = np.random.default_rng(3)
    barcodes, obs = case(rng, 29, 9, 300)
    rows = rows_of(obs, form)
    want = spec(obs, barcodes, 1, 2)
    for build in (port_scan, port_hopper):
        packed = as_np(build(barcodes, 1, 2, form, compact_output=True)(rows))
        plain = as_np(build(barcodes, 1, 2, form, compact_output=False)(rows))
        assert packed[0].dtype == np.uint8 and plain[0].dtype == np.int32
        assert_same(packed, want)
        assert_same(plain, want)
    jax_fn = jax_make_assign_fn(JaxExpectedSet.from_barcodes(barcodes), 1, 2,
                                packed_masks=form == "nib4", compact_output=True)
    assert_same(as_np(port_scan(barcodes, 1, 2, form, compact_output=True)(rows)),
                as_np(jax_fn(rows)))


# --------------------------------------------------------------------------
# the table, the packing, the refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 9, 17])
def test_compat16_rows_is_the_jax_compat(length):
    rng = np.random.default_rng(length)
    barcodes, _ = case(rng, 20, length, 4)
    jes = JaxExpectedSet.from_barcodes(barcodes)
    k = len(barcodes)  # 5 at L 1
    rows = compat16_rows(ExpectedSet.from_barcodes(barcodes).masks, 128, "cpu")
    assert rows.shape == (128, 16 * length) and rows.dtype == torch.int8
    np.testing.assert_array_equal(rows[:k].numpy().T, jes.compat)
    assert (rows[k:] == 1).all()
    state = hm.hopper_state_from_numpy(ExpectedSet.from_barcodes(barcodes), "cpu", classes=16)
    kp = hm.table_depth(length, 16)
    assert kp == {1: 32, 9: 256, 17: 384}[length]
    np.testing.assert_array_equal(
        hm.table_columns(state.table, 0, k, 16 * length).numpy(), jes.compat)


def test_pack_nib4_round_trip():
    rng = np.random.default_rng(9)
    obs = rng.choice(BASES, size=(50, 11)).astype(np.uint8)
    masks = torch.from_numpy(ENCODE_LUT[obs].astype(np.int32))
    packed = pack_nib4(masks)
    assert packed.dtype == torch.uint8 and packed.shape == (50, 6)
    np.testing.assert_array_equal(packed.numpy(), nib4_of(obs))
    assert torch.equal(unpack_nib4(packed, 11), masks)


def test_input_forms_and_refusals():
    assert [input_form(m, p) for m, p in [(False, True), (True, False), (False, False)]] == [
        "bit2", "nib4", "bytes"]
    es = ExpectedSet.from_barcodes(["ACGTA", "TTTTT"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_assign_fn(es, 1, 2, packed_masks=True, packed2=True, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        hm.make_hopper_assign_fn(es, 1, 2, packed_masks=True, device="cpu")
    for fn, width in [(make_assign_fn(es, 1, 2, device="cpu"), 5),
                      (make_assign_fn(es, 1, 2, packed_masks=True, device="cpu"), 3),
                      (hm.make_hopper_assign_fn(es, 1, 2, packed2=False, device="cpu"), 5),
                      (hm.make_hopper_assign_fn(es, 1, 2, packed2=False, packed_masks=True,
                                                device="cpu"), 3)]:
        with pytest.raises(ValueError, match=f"\\[B, {width}\\] uint8"):
            fn(np.zeros((4, width + 1), dtype=np.uint8))
    bit2_state = hm.hopper_state_from_numpy(es, "cpu")
    with pytest.raises(ValueError, match="16-class state"):
        hm.HopperAssignFn(bit2_state, 1, 2, True, form="nib4")
    with pytest.raises(ValueError, match="classes"):
        hm.hopper_state_from_numpy(es, "cpu", classes=8)
    kern = hm.ColmergeTop2()
    with pytest.raises(ValueError, match="classes"):
        kern(torch.zeros((1, 3), dtype=torch.uint8), bit2_state.table, 2, 5, classes=2)
