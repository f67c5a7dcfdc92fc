"""The port's ``BitEnc`` and single-read ``BarcodeMatcher``
(``fqtk_tpu_torch/core/{bitenc,barcode_matcher}.py``): every case of
``tests/test_bitenc.py`` run against the port's copies, then seeded
differential cases against ``fqtk_tpu``'s originals (exact: integers and
match records)."""

import numpy as np
import pytest

import fqtk_tpu.core.barcode_matcher as jax_bm
import fqtk_tpu.core.bitenc as jax_bitenc
import fqtk_tpu.core.samples as jax_samples
from fqtk_tpu_torch.core.barcode_matcher import BarcodeMatch, BarcodeMatcher
from fqtk_tpu_torch.core.bitenc import BitEnc, encode_bitenc
from fqtk_tpu_torch.core.samples import Sample


def _samples(barcodes):
    return [Sample(f"sample_{i}", b, i) for i, b in enumerate(barcodes)]


# ---------------------------------------------------------------------------
# BitEnc (bitenc.rs test block)
# ---------------------------------------------------------------------------


def test_bitenc_push_set_iter():
    enc = BitEnc(2)
    enc.push(0)
    enc.push(2)
    enc.push(1)
    assert list(enc) == [0, 2, 1]
    enc.set(1, 3)
    assert list(enc) == [0, 3, 1]


def test_bitenc_push_values():
    enc = BitEnc(2)
    enc.push_values(32, 0)
    assert list(enc) == [0] * 32
    assert enc.nr_blocks() == 2
    assert enc.nr_symbols() == 32


def test_bitenc_widths():
    for width in range(1, 9):
        enc = BitEnc(width)
        maxv = (1 << width) - 1
        for v in (0, 1, maxv):
            enc.push(v)
        assert list(enc) == [0, 1, maxv]


def test_bitenc_invalid_width():
    with pytest.raises(ValueError):
        BitEnc(9)


def test_bitenc_many_pushes_all_widths():
    """Bulk pushes across every width never corrupt earlier symbols
    (reference regression test ``bitenc.rs:549`` / rust-bio issue 29)."""
    for width in range(2, 9):
        enc = BitEnc(width)
        for _ in range(1000):
            enc.push(1)
        assert enc.nr_symbols() == 1000
        assert all(v == 1 for v in enc)


def test_bitenc_clear_empty():
    enc = BitEnc(2)
    assert enc.is_empty()
    enc.push(2)
    assert not enc.is_empty()
    enc.clear()
    assert enc.is_empty()


def test_bitenc_get_out_of_range():
    enc = BitEnc(4)
    enc.push(7)
    assert enc.get(1) is None


def test_hamming_asymmetric_iupac():
    # observed ⊆ expected → no mismatch (bitenc.rs:420-427)
    assert encode_bitenc(b"R").hamming(encode_bitenc(b"N"), 255) == 0
    assert encode_bitenc(b"N").hamming(encode_bitenc(b"R"), 255) == 1
    assert encode_bitenc(b"GATTACA").hamming(encode_bitenc(b"GANNACA"), 255) == 0
    assert encode_bitenc(b"GATTACA").hamming(encode_bitenc(b"CTAATGT"), 255) == 7


def test_hamming_early_exit_clamp():
    a = encode_bitenc(b"AAAAAAAA")
    b = encode_bitenc(b"CCCCCCCC")
    assert a.hamming(b, 3) == 3


def test_hamming_length_mismatch_raises():
    with pytest.raises(ValueError, match="same length"):
        encode_bitenc(b"AA").hamming(encode_bitenc(b"AAA"), 255)


# ---------------------------------------------------------------------------
# BarcodeMatcher single-read API (barcode_matching.rs test block)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_cache", [True, False])
def test_matcher_assign_exact(use_cache):
    m = BarcodeMatcher(_samples(["ACGT", "AAAG", "CACA"]), 2, 2, use_cache)
    assert m.assign(b"ACGT") == BarcodeMatch(0, 0, 3)


@pytest.mark.parametrize("use_cache", [True, False])
def test_matcher_imprecise(use_cache):
    m = BarcodeMatcher(_samples(["AAAT", "AGAG", "CACA"]), 2, 2, use_cache)
    assert m.assign(b"GAAT") == BarcodeMatch(0, 1, 3)


@pytest.mark.parametrize("use_cache", [True, False])
def test_matcher_no_call_prefilter(use_cache):
    m = BarcodeMatcher(
        _samples(["AAAAAAAA", "CCCCCCCC", "GGGGGGGG", "GGGGGGTT"]), 0, 100, use_cache
    )
    assert m.assign(b"GGGGGGTN") is None


@pytest.mark.parametrize("use_cache", [True, False])
def test_matcher_delta_gate(use_cache):
    m = BarcodeMatcher(
        _samples(["AAAAAAAA", "CCCCCCCC", "GGGGGGGG", "GGGGGGTT"]), 100, 3, use_cache
    )
    assert m.assign(b"GGGGGGTT") is None


def test_matcher_short_read_none():
    m = BarcodeMatcher(_samples(["ACGT"]), 2, 2)
    assert m.assign(b"ACG") is None


def test_matcher_long_read_raises():
    m = BarcodeMatcher(_samples(["ACGT"]), 2, 2)
    with pytest.raises(ValueError, match="differs from expected barcode"):
        m.assign(b"ACGTA")


def test_matcher_cache_hits():
    m = BarcodeMatcher(_samples(["ACGT", "TTTT"]), 2, 2, use_cache=True)
    r1 = m.assign(b"ACGT")
    assert b"ACGT" in m._cache
    assert m.assign(b"ACGT") == r1
    # misses (None) are not cached (barcode_matching.rs:178-180)
    m2 = BarcodeMatcher(_samples(["ACGT", "ACGA"]), 0, 2, use_cache=True)
    assert m2.assign(b"AGGA") is None
    assert b"AGGA" not in m2._cache


def test_matcher_lowercases_uppercased():
    m = BarcodeMatcher(_samples(["ACGT"]), 0, 0)
    assert m.samples[0].barcode == "ACGT"


def test_matcher_empty_samples_raises():
    with pytest.raises(ValueError, match="at least one sample"):
        BarcodeMatcher([], 2, 2)


def test_bitenc_set_rejects_negative_index():
    """set(-1) would write into the last block's unused tail bits and
    corrupt hamming(); the Rust reference takes usize."""
    enc = BitEnc(4)
    enc.push_values(4, 1)
    with pytest.raises(IndexError):
        enc.set(-1, 15)
    other = BitEnc(4)
    other.push_values(4, 1)
    assert enc.hamming(other, 10) == 0


# ---------------------------------------------------------------------------
# the port against the JAX package's originals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", range(1, 9))
def test_bitenc_matches_original(width):
    rng = np.random.default_rng(width)
    ours, theirs = BitEnc(width), jax_bitenc.BitEnc(width)
    vals = rng.integers(0, 1 << 9, size=300)
    for v in vals:
        ours.push(int(v))
        theirs.push(int(v))
    for i in rng.integers(0, 300, size=50):
        ours.set(int(i), int(vals[i]) ^ 5)
        theirs.set(int(i), int(vals[i]) ^ 5)
    assert list(ours) == list(theirs)
    assert (ours.nr_blocks(), ours.nr_symbols(), len(ours)) == (
        theirs.nr_blocks(), theirs.nr_symbols(), len(theirs))
    assert ours._storage == theirs._storage
    cap_ours, cap_theirs = BitEnc.with_capacity(width, 100), jax_bitenc.BitEnc.with_capacity(width, 100)
    assert (cap_ours.nr_blocks(), len(cap_ours._storage)) == (
        cap_theirs.nr_blocks(), len(cap_theirs._storage))


@pytest.mark.parametrize("seed", range(4))
def test_hamming_matches_original(seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTNRYKMSWBDHV", dtype=np.uint8)
    for _ in range(100):
        n = int(rng.integers(1, 40))
        a = bytes(alphabet[rng.integers(0, 15, size=n)])
        b = bytes(alphabet[rng.integers(0, 15, size=n)])
        cap = int(rng.integers(1, 50))
        assert encode_bitenc(a).hamming(encode_bitenc(b), cap) == jax_bitenc.encode_bitenc(
            a).hamming(jax_bitenc.encode_bitenc(b), cap)


@pytest.mark.parametrize("mm,delta", [(1, 2), (0, 0), (2, 1), (3, 3)])
def test_barcode_matcher_matches_original(mm, delta):
    rng = np.random.default_rng(mm * 10 + delta)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    barcodes = sorted({bytes(acgt[rng.integers(0, 4, size=8)]).decode() for _ in range(12)})
    barcodes[2] = "NN" + barcodes[2][2:]
    ours = BarcodeMatcher([Sample(f"s{i}", b.lower() if i == 3 else b, i)
                           for i, b in enumerate(barcodes)], mm, delta)
    theirs = jax_bm.BarcodeMatcher([jax_samples.Sample(f"s{i}", b.lower() if i == 3 else b, i)
                                    for i, b in enumerate(barcodes)], mm, delta)
    reads = np.frombuffer(b"ACGTN.a", dtype=np.uint8)[rng.integers(0, 7, size=(300, 8))]
    planted = np.frombuffer("".join(barcodes).encode(), np.uint8).reshape(-1, 8)
    reads[::3] = planted[rng.integers(0, len(barcodes), size=len(reads[::3]))]
    for row in list(reads) + list(reads[:50]):  # repeats go through the cache
        read = bytes(row)
        got, want = ours.assign(read), theirs.assign(read)
        assert (got is None) == (want is None), read
        if got is not None:
            assert (got.best_match, got.best_mismatches, got.next_best_mismatches) == (
                want.best_match, want.best_mismatches, want.next_best_mismatches)
    assert ours._cache.keys() == theirs._cache.keys()
    assert ours.count_mismatches(b"ACGTN", b"ACGTA") == theirs.count_mismatches(b"ACGTN", b"ACGTA")
    for call in (ours.assign, theirs.assign):
        with pytest.raises(ValueError, match="differs from expected barcode"):
            call(b"ACGTACGTA")
