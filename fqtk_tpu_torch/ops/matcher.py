"""The whitelist, the NumPy spec of barcode assignment, and top-2 reductions
of per-sample mismatch counts in plain PyTorch.

:class:`ExpectedSet`, :func:`mismatch_counts_np`, :func:`assign_batch_np`
and :func:`assign_batch_np_masks` are the port's own copy of the NumPy spec
in ``fqtk_tpu/ops/matcher.py`` (``:42-159``); the XLA ``make_assign_fn`` of
that module is not ported yet (ROADMAP.md).  :func:`merge_top2` and
:func:`chunk_top2` are the counterparts of its ``merge_top2`` and
``_chunk_top2``.  A ``(best, idx, next)`` triple is the smallest count, the
first column that reaches it, and the smallest count over every other
column.  The plain version of the Hopper kernel
(:func:`fqtk_tpu_torch.ops.hopper_matcher.colmerge_top2_reference`) is
built from these two.  The C++ pigeonhole host matcher is
:class:`fqtk_tpu_torch.io.native.NativeBigKMatcher`.

Semantics of the spec (the reference's ``src/lib/barcode_matching.rs``):
mismatch(obs, exp) = 1 iff ``obs_mask & ~exp_mask != 0`` (asymmetric IUPAC
containment); a read is assigned iff ``best <= max_mismatches`` and
``next_best - best >= min_mismatch_delta`` (``:149-159``), ``next_best`` 255
for a single sample; reads whose no-call count exceeds ``max_mismatches +
max_ns_in_barcodes`` are unassigned (``:170-172``); counts saturate at 255.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.encoding import ENCODE_LUT, NOCALL_LUT, count_nocalls
from ..io.native import NativeBigKMatcher, NativeDemuxError

__all__ = [
    "MAX_COUNT", "UNMATCHED", "ExpectedSet", "NativeBigKMatcher",
    "NativeDemuxError", "Top2", "assign_batch_np", "assign_batch_np_masks",
    "chunk_top2", "merge_top2", "mismatch_counts_np",
]

UNMATCHED = -1  # sentinel in *logical* output; device uses index K
MAX_COUNT = 255  # u8 saturation of the reference


@dataclass(frozen=True)
class ExpectedSet:
    """Pre-encoded expected-barcode whitelist (device-ready constants)."""

    masks: np.ndarray  # [K, L] uint8 4-bit masks of uppercased barcodes
    max_ns_in_barcodes: int
    length: int
    count: int

    @classmethod
    def from_barcodes(cls, barcodes: Sequence[str]) -> "ExpectedSet":
        if not barcodes:
            raise ValueError("Must provide at least one sample")
        if any(len(b) == 0 for b in barcodes):
            raise ValueError("Sample barcode cannot be empty string")
        upper = [b.upper().encode("ascii") for b in barcodes]
        length = len(upper[0])
        if any(len(b) != length for b in upper):
            raise ValueError("All barcodes must have the same length")
        max_ns = max(count_nocalls(b) for b in upper)
        arr = np.frombuffer(b"".join(upper), dtype=np.uint8).reshape(len(upper), length)
        masks = ENCODE_LUT[arr]  # [K, L]
        return cls(
            masks=masks,
            max_ns_in_barcodes=max_ns,
            length=length,
            count=len(upper),
        )

    @property
    def compat(self) -> np.ndarray:
        """[L*16, K] int8 mismatch-indicator table, built on first use.

        Lazy because only the XLA nib4/raw contraction reads it: at the
        737K-barcode single-cell scale it is ~189 MB (plus a same-sized
        transient), pure waste for the pigeonhole/small-K host matchers,
        the packed2 path (compat4), and the Pallas kernel (class-major)."""
        cached = getattr(self, "_compat", None)
        if cached is None:
            # compat[l, c, k] = 1 iff mask value c has a bit outside
            # masks[k, l]
            c = np.arange(16, dtype=np.uint8)  # all observed mask values
            viol = (c[None, None, :] & ~self.masks.T[:, :, None]) & 0xF
            cached = np.ascontiguousarray(
                (viol != 0)
                .astype(np.int8)
                .transpose(0, 2, 1)
                .reshape(self.length * 16, self.count)
            )
            object.__setattr__(self, "_compat", cached)
        return cached


def mismatch_counts_np(obs_bytes: np.ndarray, expected: ExpectedSet) -> np.ndarray:
    """NumPy executable spec: exact mismatch counts [B, K], saturated at 255."""
    obs_masks = ENCODE_LUT[np.asarray(obs_bytes, dtype=np.uint8)]  # [B, L]
    # obs & ~exp per (b, k, l) without one-hot (fine at test scale)
    diff = (obs_masks[:, None, :] & ~expected.masks[None, :, :]) & 0xF
    counts = (diff != 0).sum(axis=2)
    return np.minimum(counts, MAX_COUNT).astype(np.int32)


def assign_batch_np(
    obs_bytes: np.ndarray,
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy spec of the full assignment: (assigned_idx, best_mm, next_mm).

    ``assigned_idx`` is ``UNMATCHED`` (-1) for unassigned reads.
    """
    obs_bytes = np.asarray(obs_bytes, dtype=np.uint8)
    obs_masks = ENCODE_LUT[obs_bytes]
    nocalls = NOCALL_LUT[obs_bytes].sum(axis=1)
    return assign_batch_np_masks(
        obs_masks, expected, max_mismatches, min_mismatch_delta, nocalls=nocalls
    )


def assign_batch_np_masks(
    obs_masks: np.ndarray,
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    nocalls: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``assign_batch_np`` over pre-encoded 4-bit IUPAC masks ``[B, L]``
    (the native engine's nib4 transfer payload).  ``mask == 15`` is exactly
    the no-call indicator (N/n/. and nothing else encode to 15), so the
    no-call prefilter needs no byte-level view."""
    obs_masks = np.asarray(obs_masks)
    diff = (obs_masks[:, None, :] & ~expected.masks[None, :, :]) & 0xF
    counts = np.minimum((diff != 0).sum(axis=2), MAX_COUNT).astype(np.int32)
    b = counts.shape[0]
    best_idx = counts.argmin(axis=1).astype(np.int32)
    best = counts[np.arange(b), best_idx]
    masked = counts.copy()
    masked[np.arange(b), best_idx] = MAX_COUNT
    if expected.count == 1:
        next_best = np.full(b, MAX_COUNT, dtype=np.int32)
    else:
        next_best = np.minimum(masked.min(axis=1), MAX_COUNT)
    if nocalls is None:
        nocalls = (obs_masks == 15).sum(axis=1)
    ok = (
        (nocalls <= max_mismatches + expected.max_ns_in_barcodes)
        & (best <= max_mismatches)
        & (next_best - best >= min_mismatch_delta)
    )
    assigned = np.where(ok, best_idx, UNMATCHED).astype(np.int32)
    return assigned, best.astype(np.int32), next_best.astype(np.int32)


Top2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def merge_top2(a: Top2, b: Top2) -> Top2:
    """Associative merge of (best, idx, next) triples.

    All indices in ``a`` must precede all indices in ``b``: on equal best
    counts the earlier candidate wins (the reference's strict ``<`` at
    ``barcode_matching.rs:132``)."""
    a_best, a_idx, a_next = a
    b_best, b_idx, b_next = b
    take_b = b_best < a_best
    best = torch.where(take_b, b_best, a_best)
    idx = torch.where(take_b, b_idx, a_idx)
    nxt = torch.where(
        take_b, torch.minimum(a_best, b_next), torch.minimum(a_next, b_best)
    )
    return best, idx, nxt


def chunk_top2(counts: torch.Tensor) -> Top2:
    """Top-2 (best, argmin-first, next) over the last axis of int32
    ``counts [B, k]``."""
    best, best_idx = torch.min(counts, dim=-1)  # first occurrence on ties
    best_idx = best_idx.to(torch.int32)
    k = counts.shape[-1]
    if k == 1:
        return best, best_idx, torch.full_like(best, MAX_COUNT)
    col = torch.arange(k, dtype=torch.int32, device=counts.device)
    masked = torch.where(col[None, :] == best_idx[:, None], MAX_COUNT, counts)
    return best, best_idx, torch.min(masked, dim=-1).values
