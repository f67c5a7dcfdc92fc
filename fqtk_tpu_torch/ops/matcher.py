"""The whitelist, the NumPy spec of barcode assignment, top-2 reductions
of per-sample mismatch counts in plain PyTorch, and the chunked-scan matcher
built on them.

:class:`ExpectedSet`, :func:`mismatch_counts_np`, :func:`assign_batch_np`
and :func:`assign_batch_np_masks` are the port's own copy of the NumPy spec
in ``fqtk_tpu/ops/matcher.py`` (``:42-159``).  :func:`merge_top2` and
:func:`chunk_top2` are the counterparts of its ``merge_top2`` and
``_chunk_top2``.  A ``(best, idx, next)`` triple is the smallest count, the
first column that reaches it, and the smallest count over every other
column.  The plain version of the Hopper kernel
(:func:`fqtk_tpu_torch.ops.hopper_matcher.colmerge_top2_reference`) is
built from these two, and so is :func:`make_assign_fn`, the counterpart of
that module's XLA scan for its three input forms (:data:`INPUT_FORMS`): the
matcher of barcodes longer than 255 bp.  The C++ pigeonhole host matcher is
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
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.encoding import ENCODE_LUT, NOCALL_LUT
from ..io.native import NativeBigKMatcher, NativeDemuxError
from ..utils.profiling import TRACER
from .device_encoding import byte_is_nocall, byte_to_mask, unpack_bit2, unpack_nib4

__all__ = [
    "INPUT_FORMS", "MAX_COUNT", "UNMATCHED", "ExpectedSet", "NativeBigKMatcher",
    "NativeDemuxError", "ScanAssignFn", "Top2", "assign_batch_np",
    "assign_batch_np_masks", "chunk_top2", "compat16_rows", "input_form",
    "make_assign_fn", "merge_top2", "mismatch_counts_np", "resolve_device",
]

UNMATCHED = -1  # sentinel in *logical* output; device uses index K
MAX_COUNT = 255  # u8 saturation of the reference

#: largest [rows, columns] float32 block a plain version materializes
_PLAIN_CHUNK_ELEMS = 1 << 27  # 512 MiB of float32

#: the matchers' input forms: ``bit2`` ``[B, ceil(L/4)]`` uint8, four 2-bit
#: ACGT codes per byte (pure-ACGT rows only; 4 one-hot classes); ``nib4``
#: ``[B, ceil(L/2)]`` uint8, two 4-bit IUPAC masks per byte, low nibble the
#: even position; ``bytes`` ``[B, L]`` ASCII.  The last two have 16 one-hot
#: classes (the mask values) and the no-call gate.
INPUT_FORMS = ("bit2", "nib4", "bytes")


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
        span = TRACER.setup_span
        with span("fqtk.setup.expected"):
            with span("fqtk.setup.expected.empty"):
                if any(len(b) == 0 for b in barcodes):
                    raise ValueError("Sample barcode cannot be empty string")
            with span("fqtk.setup.expected.encode"):
                upper = [b.upper().encode("ascii") for b in barcodes]
            length = len(upper[0])
            with span("fqtk.setup.expected.lengths"):
                if any(len(b) != length for b in upper):
                    raise ValueError("All barcodes must have the same length")
            with span("fqtk.setup.expected.masks"):
                arr = np.frombuffer(b"".join(upper), dtype=np.uint8).reshape(
                    len(upper), length)
                masks = ENCODE_LUT[arr]  # [K, L]
            with span("fqtk.setup.expected.nocalls"):
                # one pass over [K, L], not one array per barcode
                max_ns = int(NOCALL_LUT[arr].sum(axis=1, dtype=np.int64).max())
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


def _onehot_f32(obs_bit2: torch.Tensor, length: int) -> torch.Tensor:
    """``[B, 4L]`` float32 class-major one-hot of the bit2 rows:
    ``onehot[b, c*L + l] = (code[b, l] == c)``."""
    codes = unpack_bit2(obs_bit2, length)  # [B, L] int32
    cls = torch.arange(4, dtype=torch.int32, device=obs_bit2.device)
    onehot = (codes[:, None, :] == cls[None, :, None]).reshape(-1, 4 * length)
    return onehot.to(torch.float32)


def input_form(packed_masks: bool, packed2: bool) -> str:
    """The :data:`INPUT_FORMS` entry that the JAX functions' flags name:
    ``packed2`` bit2, ``packed_masks`` nib4, neither raw bytes."""
    if packed_masks and packed2:
        raise ValueError("packed_masks and packed2 are mutually exclusive")
    return "bit2" if packed2 else "nib4" if packed_masks else "bytes"


def row_bytes(form: str, length: int) -> int:
    """Bytes per row of input form ``form`` for barcode length ``length``."""
    return {"bit2": -(-length // 4), "nib4": -(-length // 2), "bytes": length}[form]


def check_rows(obs: torch.Tensor, form: str, length: int) -> None:
    """``ValueError`` unless ``obs`` is ``[B, row_bytes]`` uint8 of ``form``."""
    width = row_bytes(form, length)
    if obs.dtype != torch.uint8 or obs.dim() != 2 or obs.shape[1] != width:
        raise ValueError(
            f"obs must be [B, {width}] uint8 {form} rows, got {obs.dtype} "
            f"{tuple(obs.shape)}"
        )


def masks_and_nocalls(obs: torch.Tensor, form: str, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([B, L] int32 masks, [B] int32 no-call counts)`` of nib4 or raw-byte
    rows, on their device: the no-call count is ``mask == 15`` for nib4 and
    :func:`byte_is_nocall` for bytes (``fqtk_tpu/ops/matcher.py:365-378``)."""
    if form == "nib4":
        masks = unpack_nib4(obs, length)
        return masks, (masks == 15).sum(dim=1, dtype=torch.int32)
    if form == "bytes":
        return byte_to_mask(obs), byte_is_nocall(obs).sum(dim=1, dtype=torch.int32)
    raise ValueError(f"{form} rows carry no masks")


def _onehot16_f32(masks: torch.Tensor) -> torch.Tensor:
    """``[B, 16L]`` float32 position-major one-hot of ``[B, L]`` masks:
    ``onehot[b, l*16 + c] = (masks[b, l] == c)``."""
    cls = torch.arange(16, dtype=masks.dtype, device=masks.device)
    onehot = masks[:, :, None] == cls[None, None, :]
    return onehot.reshape(masks.shape[0], -1).to(torch.float32)


def compat16_rows(masks: np.ndarray, k_pad: int, device: Union[str, torch.device]) -> torch.Tensor:
    """``[k_pad, 16L]`` int8 on ``device``: row k is column k of
    :attr:`ExpectedSet.compat` (entry ``l*16 + c`` is 1 iff mask value c has
    a bit outside ``masks[k, l]``), rows from ``K`` on all ones (pad
    columns).  Built on ``device`` in blocks of barcodes, so the host never
    holds the table."""
    k, length = masks.shape
    dev = torch.device(device)
    out = torch.ones((k_pad, 16 * length), dtype=torch.int8, device=dev)
    cls = torch.arange(16, dtype=torch.uint8, device=dev)
    step = max(1, (1 << 24) // (16 * length))
    for k0 in range(0, k, step):
        m = torch.from_numpy(np.ascontiguousarray(masks[k0:k0 + step])).to(dev)
        viol = (cls[None, None, :] & ~m[:, :, None]) & 15
        out[k0:k0 + len(m)] = (viol != 0).reshape(len(m), -1).to(torch.int8)
    return out


class ScanAssignFn:
    """``obs (numpy or torch) -> (assigned, best, next)`` as tensors on
    ``device``: :func:`make_assign_fn`'s matcher for rows of input form
    ``form`` (:data:`INPUT_FORMS`).

    ``chunks`` is the whitelist as the int8 ``[n_chunks, W*L, kc]`` mismatch
    table (W = 4 classes, class-major rows ``c*L + l``, for bit2; W = 16,
    position-major rows ``l*16 + c``, for nib4 and raw bytes; pad columns
    all ones) on ``device``; ``calls`` counts calls.  ``nocall_budget`` is
    ``max_mismatches + max_ns_in_barcodes`` for the 16-class forms, ``None``
    for bit2 (no no-call gate).  No kernel runs here: ``scheme`` is
    ``"xla_scan"``, the route's name in the demux log and matcher counts."""

    scheme = "xla_scan"

    def __init__(self, chunks: torch.Tensor, k: int, length: int,
                 max_mismatches: int, min_mismatch_delta: int,
                 compact_output: bool, form: str = "bit2",
                 nocall_budget: Optional[int] = None) -> None:
        self.chunks = chunks
        self.k = k
        self.length = length
        self.form = form
        self.nocall_budget = nocall_budget
        self.device = chunks.device
        self.max_mismatches = max_mismatches
        self.min_mismatch_delta = min_mismatch_delta
        self.out_dtype = torch.uint8 if compact_output and k < 255 else torch.int32
        self.calls = 0
        # MACs of the dense one-hot contraction (bench accounting)
        self.macs_per_row = int(chunks.shape[0]) * int(chunks.shape[2]) * int(chunks.shape[1])

    def _top2(self, onehot: torch.Tensor) -> Top2:
        """The ``lax.scan`` of ``make_assign_fn``'s counts branch
        (``fqtk_tpu/ops/matcher.py:332-356``) over ``onehot``'s rows."""
        b = onehot.shape[0]
        n_chunks, _, kc = self.chunks.shape
        acc = (
            torch.full((b,), MAX_COUNT, dtype=torch.int32, device=self.device),
            torch.full((b,), self.k, dtype=torch.int32, device=self.device),
            torch.full((b,), MAX_COUNT, dtype=torch.int32, device=self.device),
        )
        local = torch.arange(kc, dtype=torch.int32, device=self.device)
        for i in range(n_chunks):
            counts = torch.matmul(onehot, self.chunks[i].to(torch.float32))
            counts = torch.clamp(counts.to(torch.int32), max=MAX_COUNT)
            # columns >= K (all-ones pad) never win
            counts = torch.where(local[None, :] + i * kc < self.k, counts, MAX_COUNT)
            cb, ci, cn = chunk_top2(counts)
            acc = merge_top2(acc, (cb, ci + i * kc, cn))
        return acc

    def top2(self, obs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``(best, idx, next, nocalls)`` of rows of this matcher's form
        already on ``device``: the scan's raw top-2, before any gate, and the
        rows' no-call counts (``None`` for bit2 rows).  Counts one call."""
        nocalls = None
        if self.form == "bit2":
            onehot = _onehot_f32(obs, self.length)
        else:
            masks, nocalls = masks_and_nocalls(obs, self.form, self.length)
            onehot = _onehot16_f32(masks)
        rows = max(1, _PLAIN_CHUNK_ELEMS // int(self.chunks.shape[2]))
        parts = [self._top2(onehot[r0:r0 + rows]) for r0 in range(0, max(1, len(onehot)), rows)]
        best, idx, nxt = (
            parts[0] if len(parts) == 1 else tuple(torch.cat(f) for f in zip(*parts))
        )
        self.calls += 1
        return best, idx, nxt, nocalls

    def __call__(
        self, obs: Union[np.ndarray, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if isinstance(obs, np.ndarray):
            obs = torch.from_numpy(np.ascontiguousarray(obs))
        check_rows(obs, self.form, self.length)
        # H2D is asynchronous for a CUDA device: the caller keeps the host
        # buffer alive until it has fetched this call's result
        best, idx, nxt, nocalls = self.top2(obs.to(self.device, non_blocking=True))
        ok = (best <= self.max_mismatches) & (nxt - best >= self.min_mismatch_delta)
        if nocalls is not None:
            ok = ok & (nocalls <= self.nocall_budget)
        # bit2 rows are pure ACGT by construction: the engine ran their gate
        assigned = torch.where(ok, idx, self.k).to(self.out_dtype)
        return assigned, best, nxt


def make_assign_fn(
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    k_chunk: int = 16384,
    packed_masks: bool = False,
    packed2: bool = False,
    compact_output: bool = False,
    *,
    device: Union[str, torch.device],
) -> ScanAssignFn:
    """The counterpart of ``fqtk_tpu.ops.matcher.make_assign_fn``
    (``:199-384``): ``obs -> (assigned, best, next)`` for any barcode
    length, on ``device``, for the input form the flags name
    (:func:`input_form`): ``packed2`` bit2 ``[B, ceil(L/4)]``,
    ``packed_masks`` nib4 ``[B, ceil(L/2)]``, neither raw bytes ``[B, L]``.

    ``assigned[b] == K`` is unmatched; uint8 when ``compact_output`` and
    ``K < 255``.  K is walked in chunks of ``k_chunk`` columns, as the JAX
    ``lax.scan`` does: per chunk the counts are a float32 ``torch.matmul``
    of the one-hot (``[B, 4L]`` class-major for bit2; ``[B, 16L]``
    position-major, ``l*16 + c``, for the mask forms) with the chunk's
    columns of the mismatch table (``[4L, K]`` or ``ExpectedSet.compat``'s
    ``[16L, K]``, pad columns all ones).  Exact: 0/1 entries are exact in
    float32, and in TF32 or bf16 too, and sums stay <= L, far below 2^24.
    The counts are clamped at 255, columns >= K set to 255, reduced by
    :func:`chunk_top2` and merged in ascending order by :func:`merge_top2`
    from ``(255, K, 255)``; so ``next`` is 255 when ``K == 1``.  Gate:
    ``best <= max_mismatches`` and ``next - best >= min_mismatch_delta``;
    for nib4 and raw bytes also ``nocalls <= max_mismatches +
    max_ns_in_barcodes`` on the device (``mask == 15``, or
    :func:`~fqtk_tpu_torch.ops.device_encoding.byte_is_nocall`); bit2 rows
    have none (they are pure ACGT: the engine resolved the others).

    Not a port of a TPU kernel: the JAX package computes this in XLA outside
    any Pallas kernel, so plain PyTorch and ``torch.matmul`` run it here on
    the card as on the CPU.  Only the counts branch of the JAX scan
    (``:340-351``) is ported; its combined float-key branch (``:318-339``,
    taken there for ``L <= 255``) gives the same results and is an XLA-side
    speed trick."""
    from .plan import _compat_classmajor  # plan imports this module

    form = input_form(packed_masks, packed2)
    if k_chunk < 1:
        raise ValueError(f"k_chunk must be >= 1, got {k_chunk}")
    dev = resolve_device(device)
    k, length = expected.count, expected.length
    kc = min(k_chunk, k)
    n_chunks = -(-k // kc)
    if form == "bit2":
        compat = _compat_classmajor(expected.masks, n_chunks * kc, 4)  # [4L, k_pad]
        chunks = torch.from_numpy(np.ascontiguousarray(
            compat.reshape(4 * length, n_chunks, kc).transpose(1, 0, 2))).to(dev)
        budget = None
    else:
        rows = compat16_rows(expected.masks, n_chunks * kc, dev)  # [k_pad, 16L]
        chunks = rows.view(n_chunks, kc, 16 * length).transpose(1, 2).contiguous()
        budget = max_mismatches + expected.max_ns_in_barcodes
    return ScanAssignFn(
        chunks, k, length, max_mismatches, min_mismatch_delta, compact_output,
        form=form, nocall_budget=budget,
    )
