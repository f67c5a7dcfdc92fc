"""Top-2 reductions of per-sample mismatch counts, in plain PyTorch.

Counterparts of :func:`fqtk_tpu.ops.matcher.merge_top2` and
``_chunk_top2``.  A ``(best, idx, next)`` triple is the smallest count, the
first column that reaches it, and the smallest count over every other
column.  The plain version of the Hopper kernel
(:func:`fqtk_tpu_torch.ops.hopper_matcher.colmerge_top2_reference`) is
built from these two.  Whitelists, the NumPy spec and the C++ pigeonhole
host matcher are shared with the JAX package
(:class:`fqtk_tpu.ops.matcher.ExpectedSet`,
:func:`fqtk_tpu.ops.matcher.assign_batch_np`,
:class:`fqtk_tpu.io.native.NativeBigKMatcher`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from fqtk_tpu.io.native import NativeBigKMatcher, NativeDemuxError
from fqtk_tpu.ops.matcher import MAX_COUNT, ExpectedSet, assign_batch_np

__all__ = [
    "MAX_COUNT", "ExpectedSet", "NativeBigKMatcher", "NativeDemuxError",
    "Top2", "assign_batch_np", "chunk_top2", "merge_top2",
]

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
