"""fqtk's barcode assignment, in plain PyTorch (``src/lib/barcode_matching.rs``
of fulcrumgenomics/fqtk):

- a read base mismatches a sample base iff the read's IUPAC mask has a bit
  outside the sample's (for the ACGT reads and barcodes here: iff the
  bases differ);
- per read, ``best`` is the smallest mismatch count over the samples (255
  at most), ``idx`` the first sample that reaches it, ``next`` the smallest
  count over every other sample (255 for a single sample);
- a read is assigned to ``idx`` iff ``best <= max_mismatches`` and
  ``next - best >= min_mismatch_delta`` (the no-call gate never binds: ACGT
  reads have no no-calls); else it is unmatched, index ``K``.

:func:`assign_ball` gives this assignment for ACGT reads against a large
ACGT whitelist by looking up every sequence within ``max_mismatches +
min_mismatch_delta - 1`` of each distinct read: a rival farther than that
cannot change the decision.

``rival_radius`` is the control: rivals farther than it from the read are
treated as absent, a shortcut that breaks the ``min_mismatch_delta``
guarantee when it is below ``max_mismatches + min_mismatch_delta - 1``."""

from __future__ import annotations

from itertools import combinations, product
from typing import Optional, Tuple

import numpy as np
import torch

MAX_COUNT = 255

#: 2-bit code of each ACGT byte, 255 for any other byte
CODE = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    CODE[ord(_ch)] = _i
    CODE[ord(_ch.lower())] = _i


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy()).to(device)


def _decide(best, idx, nxt, k, max_mismatches, min_mismatch_delta):
    ok = (best <= max_mismatches) & (nxt - best >= min_mismatch_delta)
    return torch.where(ok, idx, torch.full_like(idx, k))


def ball_masks(length: int, radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every XOR mask of a ``length``-base key (2 bits a base) that changes
    at most ``radius`` bases, and the number it changes."""
    masks, dists = [0], [0]
    for r in range(1, radius + 1):
        for pos in combinations(range(length), r):
            for vals in product((1, 2, 3), repeat=r):
                masks.append(sum(v << (2 * p) for v, p in zip(vals, pos)))
                dists.append(r)
    return np.array(masks, dtype=np.int64), np.array(dists, dtype=np.int64)


def keys_of_codes(codes: torch.Tensor) -> torch.Tensor:
    """int64 key of each row of 2-bit codes ``[R, L]`` (L <= 31): base j in
    bits ``2j``."""
    shifts = 2 * torch.arange(codes.shape[1], device=codes.device, dtype=torch.int64)
    return (codes.long() << shifts).sum(dim=1)


def codes_of_acgt(seqs: torch.Tensor) -> torch.Tensor:
    lut = torch.from_numpy(CODE).to(seqs.device)
    codes = lut[seqs.long()]
    if bool((codes == 255).any()):
        raise ValueError("assign_ball takes ACGT sequences only")
    return codes


class BallIndex:
    """A distinct ACGT whitelist ``[K, L]`` (ASCII) sorted by key on
    ``device``, for :meth:`assign`."""

    def __init__(self, whitelist, device="cpu") -> None:
        wl = _as_tensor(whitelist, device)
        self.k, self.length = wl.shape
        if self.length > 31:
            raise ValueError("assign_ball keys barcodes of at most 31 bases")
        self.sorted_keys, self.order = torch.sort(keys_of_codes(codes_of_acgt(wl)), stable=True)
        if self.k > 1 and bool((self.sorted_keys[1:] == self.sorted_keys[:-1]).any()):
            raise ValueError("assign_ball needs distinct barcodes")

    def assign(self, read_codes, max_mismatches: int, min_mismatch_delta: int,
               rival_radius: Optional[int] = None):
        """:func:`assign_ball` against this whitelist."""
        k, dev = self.k, self.sorted_keys.device
        codes = _as_tensor(read_codes, dev)
        if codes.shape[1] != self.length:
            raise ValueError(
                f"reads of {codes.shape[1]} bases against barcodes of {self.length}")
        radius = max(max_mismatches, max_mismatches + min_mismatch_delta - 1)
        if rival_radius is not None:
            # rivals beyond rival_radius are not looked for; a best match
            # within max_mismatches still is
            radius = max(rival_radius, max_mismatches)
        m_np, d_np = ball_masks(self.length, radius)
        masks = torch.from_numpy(m_np).to(dev)
        dists = torch.from_numpy(d_np).to(dev)
        uniq, inv = torch.unique(keys_of_codes(codes), return_inverse=True)
        block = max(1, (1 << 24) // len(masks))
        out = []
        for u0 in range(0, len(uniq), block):
            cand = uniq[u0:u0 + block, None] ^ masks[None, :]
            pos = torch.searchsorted(self.sorted_keys, cand).clamp(max=k - 1)
            hit = self.sorted_keys[pos] == cand
            idx_all = torch.where(hit, self.order[pos], k)
            dist = torch.where(hit, dists[None, :], radius + 1)
            best = dist.min(dim=1).values
            idx = torch.where(dist == best[:, None], idx_all, k).min(dim=1).values
            rival = hit & (idx_all != idx[:, None])
            nxt = torch.where(rival, dist, MAX_COUNT).min(dim=1).values
            out.append((best, idx, nxt))
        best, idx, nxt = (torch.cat(p) for p in zip(*out))
        assigned = _decide(best, idx, nxt, k, max_mismatches, min_mismatch_delta)
        return assigned[inv], best[inv], nxt[inv]


def assign_ball(
    read_codes, whitelist, max_mismatches: int, min_mismatch_delta: int,
    device="cpu", rival_radius: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(assigned, best, next)`` of reads given as 2-bit codes ``[R, L]``
    (A 0, C 1, G 2, T 3) against the distinct ACGT barcodes ``whitelist
    [K, L]`` (ASCII), int64 on ``device``.  ``best`` and ``next`` are
    exact up to the search radius ``max(max_mismatches, max_mismatches +
    min_mismatch_delta - 1)``; beyond it ``best`` reads ``radius + 1`` and
    ``next`` 255.  The assignment is exact."""
    return BallIndex(whitelist, device).assign(
        read_codes, max_mismatches, min_mismatch_delta, rival_radius)


def bit2_codes(rows, length: int, device="cpu") -> torch.Tensor:
    """2-bit codes ``[R, L]`` of bit2 rows ``[R, ceil(L/4)]`` uint8 (base j
    in bits ``2 * (j % 4)`` of byte ``j // 4``), the form the benchmark
    hands the window entry."""
    rows = _as_tensor(rows, device)
    j = torch.arange(length, device=rows.device)
    return (rows[:, j // 4].long() >> (2 * (j % 4))) & 3
