"""Big-K matcher kernel lab on the GPU: the counterpart of
``scripts/kernel_lab.py``.

Times each design of the K = 737,280 barcode matcher (``FQTK_LAB_K``,
``FQTK_LAB_L``; L = 16) and spot-checks the exact ones against the
production kernel.  Every variant is a hand-written Hopper kernel
(:mod:`fqtk_tpu_torch.ops.lab_kernels`) reading the lab's own table:

- ``v0_colmerge``  — the production kernel ``colmerge_top2`` (exact top-2);
- ``v4_int4``      — the tensor-core probe (``mma_probe``): the one-hot
  times the table by int8 ``wgmma``, the nearest Hopper type to the
  TPU's int4 (exact for 0/1 operands);
- ``v1_m1only``, ``v2_matmul``, ``v2b_store``, ``p_i8min``, ``p_i8minmax``
  — bound probes (``lab_probe``: one accumulator stream, int32 or int8);
- ``v5_clamp16``   — top-2 over int16 clamped keys (``clamp16_top2``);
- ``v6_group{P}``  — exact top-2 with a register ladder over P K tiles
  (``group_top2``, P = 2, 4, 8);
- ``v3_clamp8``, ``v3w_clamp8`` — top-2 over int8 clamped counts and a
  uint8 first-tile id (``clamp8_top2``).  The two differ on the TPU only in
  the MXU's output type;
  ``wgmma``'s s8 product accumulates in s32 only, so both run the same
  kernel.

All count by ``wgmma`` on the engine of ``colmerge_top2``, the lab's
kernels through ``csrc/lab_mma.cuh``.

Run on the card::

    python -m fqtk_tpu_torch.lab.kernel_lab [name:tile_b:tile_k ...]

or on the CPU through the plain PyTorch versions, at a small K::

    FQTK_LAB_K=2048 python -m fqtk_tpu_torch.lab.kernel_lab --device cpu \\
        v0_colmerge:256:128 v6_group4:256:128

A variant that fails prints ``FAILED`` and the run goes on; the exit code is
non-zero when any variant failed or any spot check mismatched.  Rates are
reads/s by the slope between two batch sizes (:data:`BATCHES`: B = 65,536
and 131,072 on the card as in the JAX lab, 512 and 1,024 on the CPU);
"TOPS" is the rate of the equivalent dense one-hot MACs (``2 * k_padded *
4L`` per read), which only ``v4_int4`` issues as such.  On the CPU the
times are host-clock times of the plain versions, not a device metric.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.hopper_matcher import (
    ColmergeTop2,
    colmerge_top2_reference,
    hopper_state_from_numpy,
    resolve_device,
)
from ..ops.lab_kernels import (
    LAB_KERNELS,
    LabKernel,
    LabParams,
    lab_params,
    pack_compat_bits,
    pack_lab_table_i8,
)
from ..ops.matcher import ExpectedSet
from ..ops.plan import plan_local_kernel

#: the JAX lab's default specs (``kernel_lab.py:590-597``), then every other
#: ported variant
DEFAULT_SPECS = (
    "v0_colmerge:512:2048",
    "v2_matmul:512:4096",
    "v4_int4:512:2048",
    "v1_m1only:512:4096",
    "v3_clamp8:256:4096",
    "v3_clamp8:512:4096",
    "v2b_store:512:4096",
    "p_i8min:512:4096",
    "p_i8minmax:512:4096",
    "v3w_clamp8:512:4096",
    "v5_clamp16:512:2048",
    "v6_group4:512:2048",
)

#: the two batch sizes of the rate slope, by device type
BATCHES = {"cuda": (1 << 16, 1 << 17), "cpu": (1 << 9, 1 << 10)}

#: timed calls per batch size (after one warm call)
ITERS = 3

Outputs = Tuple[torch.Tensor, ...]


def unique_barcodes(k: int, length: int) -> np.ndarray:
    """``k`` distinct seeded barcodes as ``[k, length]`` 2-bit codes
    (``kernel_lab.py:36-48``)."""
    vals = (np.arange(k, dtype=np.uint64) * 2654435761) % (1 << (2 * length))
    vals = np.unique(vals)
    extra = np.setdiff1d(np.arange(k + 65536, dtype=np.uint64), vals, assume_unique=False)
    vals = np.concatenate([vals, extra])[:k]
    codes = np.zeros((k, length), dtype=np.uint8)
    v = vals.copy()
    for j in range(length):
        codes[:, j] = v & 3
        v >>= 2
    return codes


def pack_bit2(obs_codes: np.ndarray) -> np.ndarray:
    """``[B, L]`` 2-bit codes -> ``[B, ceil(L/4)]`` uint8, lowest bit pair
    first (``kernel_lab.py:51-59``)."""
    b, length = obs_codes.shape
    w = -(-length // 4) * 4
    padded = np.zeros((b, w), dtype=np.uint8)
    padded[:, :length] = obs_codes
    return (
        padded[:, 0::4] | (padded[:, 1::4] << 2) | (padded[:, 2::4] << 4)
        | (padded[:, 3::4] << 6)
    ).astype(np.uint8)


def masks_of(codes: np.ndarray) -> np.ndarray:
    """4-bit IUPAC masks of 2-bit codes (A, C, G, T -> 1, 2, 4, 8)."""
    return np.left_shift(1, codes).astype(np.uint8)


def compat_classmajor4(masks: np.ndarray, k_padded: int, scale: int = 1) -> np.ndarray:
    """``[4L, k_padded]`` int8 class-major mismatch table, padded with
    all-ones columns (``kernel_lab.py:62-71``)."""
    k, length = masks.shape
    c = np.array([1, 2, 4, 8], dtype=np.uint8)
    viol = (c[:, None, None] & ~masks.T[None, :, :]) & 0xF
    compat = (viol != 0).astype(np.int8).reshape(4 * length, k)
    if k_padded != k:
        compat = np.concatenate(
            [compat, np.ones((compat.shape[0], k_padded - k), np.int8)], axis=1
        )
    return compat * np.int8(scale)


def lab_table(masks: np.ndarray, tile_k: int, device: Union[str, torch.device]) -> torch.Tensor:
    """The lab's table on ``device``: :func:`compat_classmajor4` at
    ``k_padded = ceil(K / tile_k) * tile_k`` (unscaled), bit-packed to
    ``[k_padded, ceil(4L/32)]`` uint32 (no kernel reads it: the tests'
    oracle of the table's bits)."""
    k_padded = -(-masks.shape[0] // tile_k) * tile_k
    compat = torch.from_numpy(compat_classmajor4(masks, k_padded)).to(device)
    return pack_compat_bits(compat)


def lab_table_tiled(masks: np.ndarray, tile_k: int, device: Union[str, torch.device]) -> torch.Tensor:
    """The lab's table for the tensor-core kernels ``mma_probe``,
    ``lab_probe``, ``clamp16_top2``, ``group_top2`` and ``clamp8_top2``:
    :func:`compat_classmajor4` at ``k_padded`` (unscaled,
    pad columns all ones), tiled once by
    :func:`~fqtk_tpu_torch.ops.lab_kernels.pack_lab_table_i8` into int8
    ``[k_padded/8, KP/16, 8, 16]``, the order the product reads it."""
    k_padded = -(-masks.shape[0] // tile_k) * tile_k
    compat = torch.from_numpy(compat_classmajor4(masks, k_padded)).to(device)
    return pack_lab_table_i8(compat)


def table_for(kernel: str, masks: np.ndarray, tile_k: int,
              device: Union[str, torch.device]) -> torch.Tensor:
    """The lab table lab kernel ``kernel`` reads: :func:`lab_table_tiled`,
    the ``TABLE_FORMAT`` of every lab kernel."""
    return lab_table_tiled(masks, tile_k, device)


class LabGo:
    """``go(obs_bit2, table) -> outputs`` of one lab variant, in the JAX
    lab's order: ``(out,)`` for a probe, ``(idx, best, next)`` for v3 / v5
    / v6, ``(best, idx, next)`` for ``v0_colmerge``.  ``kernel`` is the
    wrapper it launches through; :meth:`plain` runs the plain version on
    the same inputs whatever their device."""

    def __init__(self, name: str, tile_b: int, kernel: Union[LabKernel, ColmergeTop2],
                 params: Optional[LabParams], k: int, length: int) -> None:
        self.name = name
        self.tile_b = tile_b
        self.kernel = kernel
        self.params = params
        self.k = k
        self.length = length

    @property
    def fields(self) -> Tuple[str, ...]:
        """Names of the outputs, in order."""
        if self.params is None:
            return ("best", "idx", "next")
        return ("idx", "best", "next") if self.kernel.exact else ("out",)

    def _order(self, out) -> Outputs:
        if self.params is None:  # v0: (best, idx, next) as run_kernel gives it
            return tuple(out)
        if isinstance(out, torch.Tensor):
            return (out,)
        best, idx, nxt = out
        return idx, best, nxt

    def _check(self, obs: torch.Tensor) -> None:
        if obs.shape[0] % self.tile_b:
            raise ValueError(f"B={obs.shape[0]} is not a multiple of tile_b={self.tile_b}")

    def __call__(self, obs_bit2: torch.Tensor, table: torch.Tensor) -> Outputs:
        self._check(obs_bit2)
        if self.params is None:
            return self._order(self.kernel(obs_bit2, table, self.k, self.length))
        return self._order(self.kernel(obs_bit2, table, self.params))

    def plain(self, obs_bit2: torch.Tensor, table: torch.Tensor) -> Outputs:
        self._check(obs_bit2)
        if self.params is None:
            return self._order(colmerge_top2_reference(obs_bit2, table, self.k, self.length))
        return self._order(self.kernel.reference(obs_bit2, table, self.params))


def make_lab_variant(
    name: str,
    masks: np.ndarray,
    length: int,
    *,
    max_mm: int = 1,
    delta: int = 2,
    tile_b: int = 512,
    tile_k: int = 2048,
    device: Union[str, torch.device],
) -> Tuple[LabGo, torch.Tensor, int]:
    """``(go, table, macs_per_row)`` of lab variant ``name``, the
    counterpart of ``make_variant`` (``kernel_lab.py:74-542``); ``table``
    lives on ``device``.  ``go`` takes bit2 rows (``[B, ceil(L/4)]`` uint8,
    B a multiple of ``tile_b``).  The kernels keep their own CTA tiling:
    ``tile_b`` only constrains B, ``tile_k`` sets the lab's K tile."""
    dev = resolve_device(device)
    k = masks.shape[0]
    if tile_b < 1:
        raise ValueError(f"tile_b must be >= 1, got {tile_b}")
    if name == "v0_colmerge":
        plan = plan_local_kernel(
            k, length, tile_b=tile_b, tile_k=tile_k, packed2=True, mxu_dtype="int8"
        )
        es = ExpectedSet(masks=masks, max_ns_in_barcodes=0, length=length, count=k)
        state = hopper_state_from_numpy(es, dev, "colmerge_top2")
        return LabGo(name, tile_b, ColmergeTop2(), None, k, length), state.table, plan.macs_per_row
    params = lab_params(name, k, length, tile_k, max_mm, delta)
    table = table_for(params.kernel, masks, tile_k, dev)
    go = LabGo(name, tile_b, LAB_KERNELS[params.kernel], params, k, length)
    return go, table, params.k_padded * 4 * length


def rate_inputs(codes: np.ndarray, batches: Sequence[int]) -> List[List[np.ndarray]]:
    """The bit2 rows :func:`rate_of` feeds ``go``: for each batch size,
    ``ITERS + 1`` batches of barcodes drawn uniformly from the list (seed
    999, ``kernel_lab.py:552-563``); the last of each is the warm call's."""
    k = codes.shape[0]
    rng = np.random.default_rng(999)
    return [
        [pack_bit2(codes[rng.integers(0, k, size=b)]) for _ in range(ITERS + 1)]
        for b in batches
    ]


def rate_of(
    go: Callable[[torch.Tensor, torch.Tensor], Outputs],
    table: torch.Tensor,
    codes: np.ndarray,
    batches: Sequence[int] = BATCHES["cuda"],
) -> Tuple[float, List[float]]:
    """Reads/s of ``go`` by the slope between two batch sizes, and the
    per-call seconds at each (``kernel_lab.py:545-572``).  Each call takes
    fresh bit2 rows (:func:`rate_inputs`) and fetches a reduction of its
    first output.  On a CUDA table the calls are timed with CUDA events, on
    the CPU with the host clock."""
    cuda = table.device.type == "cuda"

    def run(obs):
        return int(go(obs, table)[0].to(torch.int64).sum())

    times = []
    for rows in rate_inputs(codes, batches):
        ins = [torch.from_numpy(r).to(table.device) for r in rows]
        run(ins[-1])
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(ITERS):
                run(ins[i])
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3 / ITERS)
        else:
            t0 = time.perf_counter()
            for i in range(ITERS):
                run(ins[i])
            times.append((time.perf_counter() - t0) / ITERS)
    (b1, b2), (t1, t2) = batches, times
    slope = (t2 - t1) / (b2 - b1)
    return (1.0 / slope if slope > 0 else b2 / t2), times


def parse_spec(spec: str) -> Tuple[str, int, int, str]:
    """``name[:tile_b[:tile_k]]`` -> (name, tile_b, tile_k, label)."""
    parts = spec.split(":")
    name = parts[0]
    tb = int(parts[1]) if len(parts) > 1 else 512
    tk = int(parts[2]) if len(parts) > 2 else 2048
    return name, tb, tk, f"{name}({tb},{tk})"


def spot_rows(codes: np.ndarray, rows: int = 4096) -> np.ndarray:
    """The spot check's reads (``kernel_lab.py:624-629``): barcodes drawn
    from the list, half of them with one random base."""
    k, length = codes.shape
    rng = np.random.default_rng(7)
    obs_codes = codes[rng.integers(0, k, size=rows)].copy()
    mut = rng.integers(0, 2, size=rows) == 0
    obs_codes[mut, rng.integers(0, length, size=rows)[mut]] = rng.integers(
        0, 4, size=int(mut.sum())
    )
    return obs_codes


def tie_case(tile_k: int = 32, n_tiles: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """``(codes, reads)`` that exercise the exact and clamped variants' ties:
    barcodes of ``n_tiles`` K tiles in which every later tile repeats tile
    0's position 5, and two reads: that barcode (the same count 0 at
    position 5 of every tile: the first tile must win, within a group of
    ``v6_group{P}`` and across groups) and one that is >= W away from every
    barcode (``v3`` / ``v5``: every count clamps to W, so tile 0 and
    position 0 win)."""
    length = 16
    codes = unique_barcodes(n_tiles * tile_k, length)
    codes[:, 0] = np.minimum(codes[:, 0], 2)  # no barcode starts with T ...
    codes[:, 1:5] = np.minimum(codes[:, 1:5], 2)
    for kb in range(1, n_tiles):
        codes[kb * tile_k + 5] = codes[5]
    far = np.full(length, 3, dtype=np.uint8)  # ... so TTTTT... is >= 5 away
    far[5:] = (codes[:, 5:].max(axis=0) + 1) % 4
    obs = np.stack([codes[5], far])
    assert ((codes != far).sum(axis=1) >= 5).all()
    return codes, obs


def spot_check(
    variants: Dict[str, Tuple[Callable, torch.Tensor]],
    codes: np.ndarray,
    rows: int = 4096,
) -> List[Tuple[str, Dict[str, bool]]]:
    """``kernel_lab.py:620-663``: on one batch of :func:`spot_rows`, the v6
    variants must equal ``v0_colmerge`` exactly; v3 / v5 must agree with it
    on the gate (best <= 1, next - best >= 2), on idx where the gate passes
    and on counts clamped at W = 4 (the JAX lab's fixed W, that of the
    defaults max_mm 1, delta 2).  ``variants`` maps labels to ``(go,
    table)`` and must hold a ``v0_colmerge`` label; returns ``[(label,
    {check: ok})]`` for every label checked."""
    w_clamp = 4
    ref_label = next(lab for lab in variants if lab.startswith("v0_colmerge"))
    go0, table0 = variants[ref_label]
    packed = torch.from_numpy(pack_bit2(spot_rows(codes, rows))).to(table0.device)
    ref_best, ref_idx, ref_next = (x.cpu().numpy() for x in go0(packed, table0))
    out = []
    for label, (go, table) in variants.items():
        if not label.startswith(("v6", "v3", "v5")):
            continue
        got_idx, got_best, got_next = (x.cpu().numpy() for x in go(packed, table))
        if label.startswith("v6"):
            same = (
                (got_best == ref_best).all() and (got_next == ref_next).all()
                and (got_idx == ref_idx).all()
            )
            out.append((label, {"exact": bool(same)}))
            continue
        ok_ref = (ref_best <= 1) & (ref_next - ref_best >= 2)
        ok_got = (got_best <= 1) & (got_next - got_best >= 2)
        same_gate = bool((ok_ref == ok_got).all())
        same_idx = bool((got_idx[ok_got] == ref_idx[ok_ref]).all()) if same_gate else False
        same_clamp = bool(
            (np.minimum(ref_best, w_clamp) == got_best).all()
            and (np.minimum(ref_next, w_clamp) == got_next).all()
        )
        out.append((label, {"gate": same_gate, "idx": same_idx, "clampcounts": same_clamp}))
    return out


def card_line() -> str:
    """The card as ``nvidia-smi`` names it: ``name, power limit``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def lab_inputs(k: int, length: int) -> Tuple[np.ndarray, np.ndarray]:
    """The lab's whitelist: (codes, masks) of :func:`unique_barcodes`."""
    codes = unique_barcodes(k, length)
    return codes, masks_of(codes)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fqtk_tpu_torch.lab.kernel_lab",
        description="Time the big-K matcher designs on one GPU (K from "
        "FQTK_LAB_K, L from FQTK_LAB_L).",
    )
    ap.add_argument("specs", nargs="*", help="name[:tile_b[:tile_k]] (default: every ported variant)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batches = BATCHES[dev.type]
    k = int(os.environ.get("FQTK_LAB_K", "737280"))
    length = int(os.environ.get("FQTK_LAB_L", "16"))
    codes, masks = lab_inputs(k, length)

    if dev.type == "cuda":
        where = f"{torch.cuda.get_device_name(dev)} ({card_line()}), CUDA-event times"
    else:
        where = "cpu: plain PyTorch versions, host-clock times (not a device metric)"
    print(f"device={where} K={k} L={length} batches={batches}", flush=True)
    failed = False
    fulls: Dict[str, Tuple[Callable, torch.Tensor]] = {}
    for spec in args.specs or DEFAULT_SPECS:
        name, tb, tk, label = parse_spec(spec)
        try:
            go, table, macs = make_lab_variant(name, masks, length, tile_b=tb, tile_k=tk, device=dev)
            rate, times = rate_of(go, table, codes, batches)
            fulls[label] = (go, table)
            tops = 2.0 * macs * rate / 1e12
            print(
                f"{label:28s} {rate:12.1f} reads/s  {tops:7.2f} TOPS (equiv. dense "
                f"MACs)  times={['%.4f' % t for t in times]}"
            )
        except Exception as e:  # the lab reports a failed design and goes on
            failed = True
            print(f"{label:28s} FAILED: {type(e).__name__}: {str(e)[:300]}")
        sys.stdout.flush()

    if any(lab.startswith("v0_colmerge") for lab in fulls):
        for label, checks in spot_check(fulls, codes):
            failed |= not all(checks.values())
            print(f"check {label}: " + " ".join(
                f"{c}={'OK' if ok else 'MISMATCH'}" for c, ok in checks.items()
            ))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
