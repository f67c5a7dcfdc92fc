"""The device barcode matcher: the Hopper ``colmerge_top2`` kernel, its plain
PyTorch version, and the assignment function built on them.

Counterpart of :func:`fqtk_tpu.ops.pallas_matcher.make_pallas_assign_fn`
on the demux main path (``packed2=True``, ``compact_output=True``): the
native engine packs each read's sample barcode as 2-bit codes
(``[B, ceil(L/4)]`` uint8, "bit2"); rows that are not pure ACGT never reach
the device (the engine flags them and the driver resolves them on the host,
no-call gate included).

- :func:`hopper_state_from_numpy` — the whitelist as device state: the
  class-major int8 mismatch table, moved to the device once.
- :func:`colmerge_top2_reference` — the plain version (float32 one-hot
  matmul in K chunks + :func:`~fqtk_tpu_torch.ops.matcher.chunk_top2` /
  :func:`~fqtk_tpu_torch.ops.matcher.merge_top2`).
- :class:`ColmergeTop2` — the kernel's wrapper: on a CUDA tensor it launches
  ``csrc/colmerge_top2.cu`` (counting launches), on a CPU tensor it runs the
  plain version (counting plain calls).  The choice is made by the input's
  device, never by catching an error.
- :func:`make_hopper_assign_fn` — ``obs -> (assigned, best, next)`` with the
  assignment gates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from fqtk_tpu.ops.matcher import MAX_COUNT, ExpectedSet
from fqtk_tpu.ops.pallas_matcher import _compat_classmajor

from ._build import load_kernels
from .device_encoding import unpack_bit2
from .matcher import Top2, chunk_top2, merge_top2

#: whitelist columns are padded to a multiple of this in the device table
#: (row alignment only: the kernel never reads a column >= K)
K_ALIGN = 128

#: the kernel's key holds count (8 bits) << column bits in an int32
MAX_K = 1 << 23

#: largest [B, kc] float32 block the plain version materializes
_PLAIN_CHUNK_ELEMS = 1 << 27  # 512 MiB of float32

_THREADS = 256  # csrc/colmerge_top2.cu kThreads

_ROADMAP_INPUTS = (
    "only packed2 (bit2) input is ported; nib4 and raw-byte inputs are "
    "ROADMAP.md item 'torch make_assign_fn for nib4 and raw-byte inputs'"
)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` without a card raises."""
    try:
        dev = torch.device(device)
    except RuntimeError:
        raise ValueError(f"device must be cuda or cpu, got {device!r}") from None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            f"(torch {torch.__version__}); pass device='cpu' to run the "
            "plain PyTorch version"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


@dataclass(frozen=True)
class HopperState:
    """Device-resident whitelist for the bit2 matcher."""

    compat: torch.Tensor  # [4L, k_pad] int8, class-major rows c*L + l
    k: int
    length: int
    max_ns_in_barcodes: int
    device: torch.device

    @property
    def k_pad(self) -> int:
        return int(self.compat.shape[1])


def hopper_state_from_numpy(
    expected: ExpectedSet, device: Union[str, torch.device]
) -> HopperState:
    """Class-major 0/1 int8 mismatch table of ``expected.masks`` (the JAX
    kernel's ``compat_for_plan`` table before its ``ck_s2`` scale), padded
    with all-ones columns to a multiple of :data:`K_ALIGN`, moved to
    ``device`` once."""
    dev = resolve_device(device)
    k, length = expected.count, expected.length
    k_pad = -(-k // K_ALIGN) * K_ALIGN
    compat = _compat_classmajor(expected.masks, k_pad, 4)
    return HopperState(
        compat=torch.from_numpy(np.ascontiguousarray(compat)).to(dev),
        k=k,
        length=length,
        max_ns_in_barcodes=expected.max_ns_in_barcodes,
        device=dev,
    )


def colmerge_top2_reference(
    obs_bit2: torch.Tensor, compat: torch.Tensor, k: int, length: int
) -> Top2:
    """Plain PyTorch version of the kernel (same signature and results).

    One-hot ``[B, 4L]`` (class-major, float32) times compat columns in
    chunks of K with ``torch.matmul`` in float32: exact, since every product
    is 0 or 1 (even in TF32) and sums stay <= L <= 255.  Top-2 per chunk,
    merged across chunks in ascending order."""
    b = obs_bit2.shape[0]
    dev = obs_bit2.device
    codes = unpack_bit2(obs_bit2, length)  # [B, L] int32
    cls = torch.arange(4, dtype=torch.int32, device=dev)
    # onehot[b, c*L + l] = (codes[b, l] == c)
    onehot = (codes[:, None, :] == cls[None, :, None]).reshape(b, 4 * length)
    onehot = onehot.to(torch.float32)
    kc = max(1, min(k, _PLAIN_CHUNK_ELEMS // max(b, 1)))
    acc = (
        torch.full((b,), MAX_COUNT, dtype=torch.int32, device=dev),
        torch.full((b,), k, dtype=torch.int32, device=dev),
        torch.full((b,), MAX_COUNT, dtype=torch.int32, device=dev),
    )
    for k0 in range(0, k, kc):
        k1 = min(k, k0 + kc)
        cols = compat[:, k0:k1].to(torch.float32)
        counts = torch.matmul(onehot, cols).to(torch.int32)
        cb, ci, cn = chunk_top2(torch.clamp(counts, max=MAX_COUNT))
        acc = merge_top2(acc, (cb, ci + k0, cn))
    return acc


def _ksplit(b: int, device: torch.device) -> int:
    """Column groups per CTA: the smallest split that gives >= 2 CTAs per
    SM (rows per CTA = 256 / ksplit), 8 at most."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for ks in (1, 2, 4, 8):
        if -(-b // (_THREADS // ks)) >= 2 * sms:
            return ks
    return 8


class ColmergeTop2:
    """Wrapper of ``csrc/colmerge_top2.cu``.

    ``launches`` counts kernel launches and ``plain_calls`` runs of the plain
    version; each is incremented only where that work is issued."""

    def __init__(self) -> None:
        self.launches = 0
        self.plain_calls = 0

    def __call__(
        self, obs_bit2: torch.Tensor, compat: torch.Tensor, k: int, length: int
    ) -> Top2:
        if obs_bit2.device.type == "cpu":
            self.plain_calls += 1
            return colmerge_top2_reference(obs_bit2, compat, k, length)
        if obs_bit2.device.type != "cuda":
            raise ValueError(f"unsupported device {obs_bit2.device}")
        return self._launch(obs_bit2, compat, k, length)

    def _launch(self, obs, compat, k, length) -> Top2:
        if obs.dtype != torch.uint8 or obs.dim() != 2:
            raise ValueError(
                f"obs_bit2 must be [B, W] uint8, got {obs.dtype} {tuple(obs.shape)}"
            )
        b, width = obs.shape
        if not 1 <= length <= 255 or width != (length + 3) // 4:
            raise ValueError(f"obs_bit2 width {width} does not match length {length}")
        if compat.dtype != torch.int8 or compat.dim() != 2 or compat.shape[0] != 4 * length:
            raise ValueError(
                f"compat must be [4L={4 * length}, K_pad] int8, got "
                f"{compat.dtype} {tuple(compat.shape)}"
            )
        if not 1 <= k <= compat.shape[1] or k > MAX_K:
            raise ValueError(f"k={k} outside 1..min(K_pad={compat.shape[1]}, {MAX_K})")
        if compat.device != obs.device:
            raise ValueError(f"compat on {compat.device}, obs on {obs.device}")
        if not (obs.is_contiguous() and compat.is_contiguous()):
            raise ValueError("obs_bit2 and compat must be contiguous")
        out = torch.empty((3, b), dtype=torch.int32, device=obs.device)
        if b == 0:
            return out[0], out[1], out[2]
        lib = load_kernels()
        with torch.cuda.device(obs.device):
            stream = torch.cuda.current_stream(obs.device).cuda_stream
            rc = lib.fqtk_colmerge_top2(
                obs.data_ptr(), b, width,
                compat.data_ptr(), compat.shape[1], k, length,
                _ksplit(b, obs.device),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"colmerge_top2 launch failed: code {rc} "
                f"(B={b}, K={k}, L={length})"
            )
        self.launches += 1
        return out[0], out[1], out[2]


class HopperAssignFn:
    """``obs [B, ceil(L/4)] uint8 (numpy or torch) -> (assigned, best, next)``
    as tensors on the state's device.

    ``assigned[b] == K`` is unmatched; it is uint8 when ``compact_output``
    and ``K < 255``, else int32.  The gates are those of
    ``make_pallas_assign_fn`` for bit2 input: ``best <= max_mismatches`` and
    ``next - best >= min_mismatch_delta``, no no-call gate (the engine ran
    it), and ``next = 255`` when ``K == 1``."""

    def __init__(
        self,
        state: HopperState,
        max_mismatches: int,
        min_mismatch_delta: int,
        compact_output: bool,
    ) -> None:
        self.state = state
        self.max_mismatches = max_mismatches
        self.min_mismatch_delta = min_mismatch_delta
        self.out_dtype = (
            torch.uint8 if compact_output and state.k < 255 else torch.int32
        )
        self.top2 = ColmergeTop2()
        if state.device.type == "cuda":
            load_kernels()  # build now: a failure surfaces before the run
        # MACs of the equivalent dense one-hot contraction (bench accounting)
        self.macs_per_row = state.k_pad * 4 * state.length

    @property
    def launches(self) -> int:
        return self.top2.launches

    @property
    def plain_calls(self) -> int:
        return self.top2.plain_calls

    def __call__(
        self, obs: Union[np.ndarray, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        st = self.state
        if isinstance(obs, np.ndarray):
            obs = torch.from_numpy(np.ascontiguousarray(obs))
        # H2D is asynchronous for a CUDA state: the caller keeps the host
        # buffer alive until it has fetched this call's result
        obs = obs.to(st.device, non_blocking=True)
        best, idx, nxt = self.top2(obs, st.compat, st.k, st.length)
        if st.k == 1:
            nxt = torch.full_like(nxt, MAX_COUNT)
        ok = (best <= self.max_mismatches) & (
            nxt - best >= self.min_mismatch_delta
        )
        assigned = torch.where(ok, idx, st.k).to(self.out_dtype)
        return assigned, best, nxt


def make_hopper_assign_fn(
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    *,
    device: Union[str, torch.device],
    packed2: bool = True,
    compact_output: bool = True,
) -> HopperAssignFn:
    """Build the bit2 device matcher for ``expected`` on ``device``."""
    if not packed2:
        raise NotImplementedError(_ROADMAP_INPUTS)
    if expected.length > 255:
        raise ValueError(
            "the Hopper matcher supports barcode lengths <= 255 (8-bit "
            f"count in the top-2 key), got {expected.length}"
        )
    if expected.count > MAX_K:
        raise ValueError(
            f"the Hopper matcher supports up to {MAX_K} barcodes, got "
            f"{expected.count}"
        )
    state = hopper_state_from_numpy(expected, device)
    return HopperAssignFn(
        state, max_mismatches, min_mismatch_delta, compact_output
    )
