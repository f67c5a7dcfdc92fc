"""Windows of single-cell barcode reads, made on the device.

Parameters (a traffic file whose ``generator`` is ``windows``):

- ``window_reads``: reads a window (the demux path's window);
- ``cells``, ``cell_share``, ``cell_sigma``: the share of reads from
  ``cells`` barcodes drawn from the whitelist, each with a log-normal read
  share of sigma ``cell_sigma`` (0 cells: every read is background);
- the rest of the reads (background) drawn uniformly from the whole
  whitelist;
- ``substitution_share``: then, independently, the share of all reads with
  one base substituted at a uniform position by a different base;
- ``pool_reads_per_s``: the pool holds this rate times the run's seconds
  of windows, none handed in twice, and ``warmup_windows`` more for the
  warm-up;
- ``assumed``: what each share rests on, and what it drives (no code
  reads it).

Reads are 2-bit codes keyed as the window entry's bit2 rows take them: base
j in bits ``2j`` of a little-endian word (no N: bit2 rows have none)."""

from __future__ import annotations

import math

import numpy as np
import torch

#: reads made per device call
CHUNK = 1 << 23


def pool_windows(traffic: dict, seconds: float) -> int:
    need = traffic["pool_reads_per_s"] * seconds / traffic["window_reads"]
    return int(math.ceil(need)) + int(traffic["warmup_windows"])


def make_pool(wl_codes: torch.Tensor, traffic: dict, n_windows: int,
              gen: torch.Generator) -> np.ndarray:
    """``[n_windows, window_reads, ceil(L/4)]`` uint8 bit2 rows on the
    host, from the whitelist ``wl_codes [K, L]`` (2-bit codes on ``gen``'s
    device)."""
    dev = gen.device
    k, length = wl_codes.shape
    if length > 32:
        raise ValueError("windows of barcodes longer than 32 bases are not made")
    width = -(-length // 4)
    shifts = 2 * torch.arange(length, device=dev, dtype=torch.int64)
    wl_keys = (wl_codes.long() << shifts).sum(dim=1)
    n_cells = int(traffic["cells"])
    cells = cdf = None
    if n_cells:
        cells = torch.randperm(k, generator=gen, device=dev)[:n_cells]
        shares = torch.exp(traffic["cell_sigma"] * torch.randn(
            n_cells, generator=gen, device=dev, dtype=torch.float64))
        cdf = torch.cumsum(shares / shares.sum(), 0)
        cdf[-1] = 1.0
    b = int(traffic["window_reads"])
    pool = np.empty((n_windows, b, width), dtype=np.uint8)
    flat = pool.reshape(n_windows * b, width)
    total = n_windows * b
    for r0 in range(0, total, CHUNK):
        n = min(CHUNK, total - r0)
        idx = torch.randint(0, k, (n,), generator=gen, device=dev)
        if n_cells:
            u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
            pick = torch.searchsorted(cdf, u).clamp(max=n_cells - 1)
            from_cell = torch.rand(n, generator=gen, device=dev) < traffic["cell_share"]
            idx = torch.where(from_cell, cells[pick], idx)
        keys = wl_keys[idx]
        sub = torch.rand(n, generator=gen, device=dev) < traffic["substitution_share"]
        pos = torch.randint(0, length, (n,), generator=gen, device=dev)
        val = torch.randint(1, 4, (n,), generator=gen, device=dev)
        keys = keys ^ torch.where(sub, val << (2 * pos), 0)
        rows = keys.view(torch.uint8).view(n, 8)[:, :width]  # little-endian
        flat[r0:r0 + n] = rows.cpu().numpy()
    return pool
