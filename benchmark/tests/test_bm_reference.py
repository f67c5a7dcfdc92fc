"""The plain reference against a brute-force loop at tiny K."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference.assign import assign_ball, bit2_codes, codes_of_acgt

BASES = b"ACGT"


def loop_assign(reads, whitelist, mm, delta):
    """fqtk's rule for ACGT reads, one read and one barcode at a time."""
    k = len(whitelist)
    out = []
    for r in reads:
        counts = [sum(1 for a, b in zip(r, bc) if a != b) for bc in whitelist]
        best = min(counts)
        idx = counts.index(best)
        nxt = 255 if k == 1 else min(c for j, c in enumerate(counts) if j != idx)
        ok = best <= mm and nxt - best >= delta
        out.append((idx if ok else k, best, nxt))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def _reads_near(wl, n, rng, alphabet=BASES, max_changes=3):
    """Reads at a few changes from random barcodes of ``wl``."""
    reads = wl[rng.integers(0, len(wl), n)].copy()
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    for row in reads:
        for _ in range(rng.integers(0, max_changes + 1)):
            row[rng.integers(0, len(row))] = letters[rng.integers(0, len(letters))]
    return reads


@pytest.mark.parametrize("mm,delta", [(1, 2), (0, 1), (2, 1), (1, 0), (1, 3)])
@pytest.mark.parametrize("k", [1, 2, 64])
def test_ball_matches_loop(mm, delta, k):
    rng = np.random.default_rng(k * 10 + mm)
    letters = np.frombuffer(BASES, dtype=np.uint8)
    wl = np.unique(letters[rng.integers(0, 4, size=(k * 3, 7))].view("S7")).view(
        np.uint8).reshape(-1, 7)[:k]
    reads = _reads_near(wl, 400, rng)
    got = assign_ball(codes_of_acgt(torch.from_numpy(reads)), wl, mm, delta)
    want = loop_assign(reads, wl, mm, delta)
    np.testing.assert_array_equal(got[0].numpy(), want[:, 0])
    radius = max(mm, mm + delta - 1)
    np.testing.assert_array_equal(got[1].numpy(), np.minimum(want[:, 1], radius + 1))


def test_ball_ties_to_first_index():
    wl = np.frombuffer(b"AAAA" b"AAAC" b"AACA", dtype=np.uint8).reshape(3, 4)
    reads = np.frombuffer(b"AACC", dtype=np.uint8).reshape(1, 4)
    codes = codes_of_acgt(torch.from_numpy(reads))
    # AAAC and AACA are both one away: without a delta the first wins
    assert assign_ball(codes, wl, 1, 0)[0].tolist() == [1]
    assert assign_ball(codes, wl, 1, 1)[0].tolist() == [3]


def test_control_breaks_the_delta_guarantee():
    wl = np.frombuffer(b"AAAAAA" b"AAACCA", dtype=np.uint8).reshape(2, 6)
    reads = np.frombuffer(b"AAAACA", dtype=np.uint8).reshape(1, 6)  # 1 and 1 away
    reads2 = np.frombuffer(b"AAAAAC", dtype=np.uint8).reshape(1, 6)  # 1 and 3 away
    near = np.frombuffer(b"AAAAAG", dtype=np.uint8).reshape(1, 6)  # 1 and 3
    far = np.frombuffer(b"AAAAGA", dtype=np.uint8).reshape(1, 6)  # 1 and 2 away
    for r, exact in ((reads, 2), (reads2, 0), (near, 0), (far, 2)):
        assert loop_assign(r, wl, 1, 2)[0, 0] == exact
        assert assign_ball(codes_of_acgt(torch.from_numpy(r)), wl, 1, 2)[0].tolist() == [exact]
    # the control looks for rivals within one base only: AAAAGA is assigned
    codes = codes_of_acgt(torch.from_numpy(far))
    assert assign_ball(codes, wl, 1, 2)[0].tolist() == [2]
    assert assign_ball(codes, wl, 1, 2, rival_radius=1)[0].tolist() == [0]


def test_bit2_codes_read_the_engine_packing():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(50, 10), dtype=np.uint8)
    padded = np.zeros((50, 12), dtype=np.uint8)
    padded[:, :10] = codes
    rows = padded[:, 0::4] | padded[:, 1::4] << 2 | padded[:, 2::4] << 4 | padded[:, 3::4] << 6
    np.testing.assert_array_equal(bit2_codes(rows, 10).numpy(), codes)
