"""A whitelist of distinct random barcodes made from a seed, on the device
in a few large calls."""

from __future__ import annotations

import numpy as np
import torch

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_whitelist(k: int, length: int, gen: torch.Generator) -> torch.Tensor:
    """``k`` distinct random barcodes of ``length`` bases as 2-bit codes
    ``[k, length]`` uint8 (A 0, C 1, G 2, T 3) on ``gen``'s device, in
    lexicographic order, as whitelists are published."""
    if length > 31 or k > 4 ** length:
        raise ValueError(f"cannot draw {k} distinct {length}-base barcodes")
    dev = gen.device
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    while keys.numel() < k:
        draw = torch.randint(0, 4 ** length, (k + k // 64 + 1024,), generator=gen,
                             device=dev, dtype=torch.int64)
        keys = torch.unique(torch.cat([keys, draw]))
    pick = torch.randperm(keys.numel(), generator=gen, device=dev)[:k]
    keys = torch.sort(keys[pick]).values
    # base j in bits 2 * (length - 1 - j): numeric order is lexicographic
    shifts = 2 * torch.arange(length - 1, -1, -1, device=dev, dtype=torch.int64)
    return ((keys[:, None] >> shifts) & 3).to(torch.uint8)


def ascii_of_codes(codes: np.ndarray) -> np.ndarray:
    return ACGT[codes]


def strings_of_ascii(seqs: np.ndarray) -> list:
    """Python strings of ASCII rows ``[K, L]`` (the sample sheet's form)."""
    return np.ascontiguousarray(seqs).view(f"S{seqs.shape[1]}").ravel().astype(
        f"U{seqs.shape[1]}").tolist()
