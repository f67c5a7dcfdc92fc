"""The device barcode matcher: the Hopper kernels ``colmerge_top2`` and
``tile_top2``, their plain PyTorch versions, and the assignment function
built on them.

Counterpart of :func:`fqtk_tpu.ops.pallas_matcher.make_pallas_assign_fn`
on the demux main path (``packed2=True``, ``compact_output=True``): the
native engine packs each read's sample barcode as 2-bit codes
(``[B, ceil(L/4)]`` uint8, "bit2"); rows that are not pure ACGT never reach
the device (the engine flags them and the driver resolves them on the host,
no-call gate included).

- :func:`hopper_scheme` — which kernel runs, chosen as
  :func:`~fqtk_tpu.ops.pallas_matcher.plan_local_kernel` chooses the TPU
  kernel's top-2 scheme at the JAX package's single-chip tiling.
- :func:`hopper_state_from_numpy` — the whitelist as device state: the one
  table that the scheme's kernel reads (the class-major int8 mismatch
  table, or its bit-packed copy), built on the device once.
- :func:`colmerge_top2_reference` / :func:`tile_top2_reference` — the plain
  versions (float32 one-hot matmul + top-2 merges).
- :class:`ColmergeTop2` / :class:`TileTop2` — the kernels' wrappers: on a
  CUDA tensor each launches its ``csrc/*.cu`` kernel (counting launches),
  on a CPU tensor it runs the plain version (counting plain calls).  The
  choice is made by the input's device, never by catching an error.
- :func:`make_hopper_assign_fn` — ``obs -> (assigned, best, next)`` with the
  assignment gates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from fqtk_tpu.ops.matcher import MAX_COUNT, ExpectedSet
from fqtk_tpu.ops.pallas_matcher import _compat_classmajor, plan_local_kernel

from ._build import load_kernel
from .device_encoding import unpack_bit2
from .matcher import Top2, chunk_top2, merge_top2

#: whitelist columns are padded to a multiple of this in the device tables
#: (row alignment only: the kernels never read a column >= K)
K_ALIGN = 128

#: colmerge_top2's key holds count (8 bits) << column bits in an int32
MAX_K = 1 << 23

#: the JAX package's single-chip tiling (``fqtk_tpu.runtime.demux``,
#: ``_build_device_assign_fn``): the plan at this tiling picks the kernel
_PLAN = dict(tile_b=512, tile_k=2048, packed2=True, mxu_dtype="int8")

SCHEMES = ("colmerge_top2", "tile_top2")

#: tile_top2's K tile (csrc/tile_top2.cu kTileK); its plain version uses the
#: same tiles
TILE_K = 1 << 13

#: largest [B, kc] float32 block a plain version materializes
_PLAIN_CHUNK_ELEMS = 1 << 27  # 512 MiB of float32

#: largest tile_top2 partial buffer ([n_tiles, rows] uint32) per launch;
#: larger batches launch in row chunks
_PARTIAL_MAX_BYTES = 1 << 30

_THREADS = 256  # kThreads of both kernels

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


def hopper_scheme(k: int, length: int) -> str:
    """``"colmerge_top2"`` where :func:`plan_local_kernel` keeps the TPU
    kernel's column-merge scheme (kernel #1) at the JAX package's
    single-chip tiling, else ``"tile_top2"`` (kernel #2's per-step lane
    reduce): column merge up to 4,194,304 barcodes.  Plans only: builds no
    table."""
    plan = plan_local_kernel(k, length, **_PLAN)
    return "colmerge_top2" if plan.colmerge else "tile_top2"


@dataclass(frozen=True)
class HopperState:
    """Device-resident whitelist for the bit2 matcher: the one table that
    ``scheme``'s kernel and its plain version read."""

    scheme: str
    #: ``colmerge_top2``: ``[4L, k_pad]`` int8, class-major rows ``c*L + l``;
    #: ``tile_top2``: ``[k_pad, ceil(4L/32)]`` uint32, bit ``c*L + l`` of
    #: the same table
    table: torch.Tensor
    k: int
    length: int
    max_ns_in_barcodes: int
    device: torch.device

    @property
    def k_pad(self) -> int:
        return int(self.table.shape[1 if self.scheme == "colmerge_top2" else 0])


def pack_compat_bits(compat: torch.Tensor) -> torch.Tensor:
    """``[4L, K_pad]`` 0/1 int8 -> ``[K_pad, ceil(4L/32)]`` uint32 with bit
    ``j % 32`` of word ``j // 32`` of column k equal to ``compat[j, k]``
    (plain torch ops on ``compat``'s device, once per state)."""
    wl, k_pad = compat.shape
    words = []
    for w0 in range(0, wl, 32):
        acc = torch.zeros(k_pad, dtype=torch.int64, device=compat.device)
        for j in range(w0, min(wl, w0 + 32)):
            acc |= compat[j].to(torch.int64) << (j - w0)
        words.append(acc)
    words = torch.stack(words, dim=1)
    # the same 32 bits as int32 (two's complement), viewed as uint32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).view(torch.uint32)


def hopper_state_from_numpy(
    expected: ExpectedSet,
    device: Union[str, torch.device],
    scheme: Optional[str] = None,
) -> HopperState:
    """The table ``scheme``'s kernel reads (default: :func:`hopper_scheme`),
    built on ``device`` once from the class-major 0/1 int8 mismatch table of
    ``expected.masks`` (the JAX kernel's ``compat_for_plan`` table before
    its ``ck_s2`` scale), padded with all-ones columns to a multiple of
    :data:`K_ALIGN`: that table for ``colmerge_top2``, its
    :func:`pack_compat_bits` copy for ``tile_top2``."""
    dev = resolve_device(device)
    k, length = expected.count, expected.length
    scheme = scheme or hopper_scheme(k, length)
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    k_pad = -(-k // K_ALIGN) * K_ALIGN
    table = torch.from_numpy(
        np.ascontiguousarray(_compat_classmajor(expected.masks, k_pad, 4))
    ).to(dev)
    if scheme == "tile_top2":
        table = pack_compat_bits(table)
    return HopperState(
        scheme=scheme,
        table=table,
        k=k,
        length=length,
        max_ns_in_barcodes=expected.max_ns_in_barcodes,
        device=dev,
    )


def _onehot_f32(obs_bit2: torch.Tensor, length: int) -> torch.Tensor:
    """``[B, 4L]`` float32 class-major one-hot of the bit2 rows:
    ``onehot[b, c*L + l] = (code[b, l] == c)``."""
    codes = unpack_bit2(obs_bit2, length)  # [B, L] int32
    cls = torch.arange(4, dtype=torch.int32, device=obs_bit2.device)
    onehot = (codes[:, None, :] == cls[None, :, None]).reshape(-1, 4 * length)
    return onehot.to(torch.float32)


def _top2_init(b: int, k: int, dev: torch.device) -> Top2:
    return (
        torch.full((b,), MAX_COUNT, dtype=torch.int32, device=dev),
        torch.full((b,), k, dtype=torch.int32, device=dev),
        torch.full((b,), MAX_COUNT, dtype=torch.int32, device=dev),
    )


def colmerge_top2_reference(
    obs_bit2: torch.Tensor, compat: torch.Tensor, k: int, length: int
) -> Top2:
    """Plain PyTorch version of ``colmerge_top2`` (same signature and
    results).

    One-hot ``[B, 4L]`` (class-major, float32) times compat columns in
    chunks of K with ``torch.matmul`` in float32: exact, since every product
    is 0 or 1 (even in TF32) and sums stay <= L <= 255.  Top-2 per chunk,
    merged across chunks in ascending order."""
    b = obs_bit2.shape[0]
    onehot = _onehot_f32(obs_bit2, length)
    kc = max(1, min(k, _PLAIN_CHUNK_ELEMS // max(b, 1)))
    acc = _top2_init(b, k, obs_bit2.device)
    for k0 in range(0, k, kc):
        k1 = min(k, k0 + kc)
        cols = compat[:, k0:k1].to(torch.float32)
        counts = torch.matmul(onehot, cols).to(torch.int32)
        cb, ci, cn = chunk_top2(torch.clamp(counts, max=MAX_COUNT))
        acc = merge_top2(acc, (cb, ci + k0, cn))
    return acc


def _unpack_bits(bits: torch.Tensor, wl: int) -> torch.Tensor:
    """``[n, NW]`` uint32 bit table -> ``[wl, n]`` float32 0/1 (the
    class-major compat columns it packs)."""
    j = torch.arange(wl, dtype=torch.int32, device=bits.device)
    words = bits.view(torch.int32)[:, (j // 32).long()]  # [n, wl]
    return ((words >> (j % 32)) & 1).T.to(torch.float32)


def tile_top2_reference(
    obs_bit2: torch.Tensor, bits: torch.Tensor, k: int, length: int
) -> Top2:
    """Plain PyTorch version of ``tile_top2`` (same signature and results),
    written as the TPU kernel #2 (``pallas_matcher.py:285-371``) computes,
    tile by tile.

    Per tile of :data:`TILE_K` columns: the tile's compat columns unpacked
    from ``bits``, counts by a float32 one-hot matmul (exact, as in
    :func:`colmerge_top2_reference`), the combined key
    ``count * TILE_K + column``, its min (best and the first index) and the
    min over the other keys (next); then the ordered running merge
    (:func:`~fqtk_tpu_torch.ops.matcher.merge_top2`: strict ``<``, so the
    earlier tile wins ties).  Rows go in chunks so that one ``[rows,
    TILE_K]`` block stays under :data:`_PLAIN_CHUNK_ELEMS`."""
    tk = TILE_K
    b = obs_bit2.shape[0]
    dev = obs_bit2.device
    onehot = _onehot_f32(obs_bit2, length)
    big = MAX_COUNT * tk
    rows = max(1, _PLAIN_CHUNK_ELEMS // tk)
    out = []
    for r0 in range(0, b, rows):
        oh = onehot[r0:r0 + rows]
        acc = _top2_init(oh.shape[0], k, dev)
        for k0 in range(0, k, tk):
            k1 = min(k, k0 + tk)
            counts = torch.matmul(oh, _unpack_bits(bits[k0:k1], 4 * length))
            col = torch.arange(k1 - k0, dtype=torch.int32, device=dev)
            key = counts.to(torch.int32) * tk + col
            m1 = key.min(dim=1).values
            m2 = torch.where(key == m1[:, None], big, key).min(dim=1).values
            tile = (
                torch.clamp(m1 // tk, max=MAX_COUNT),
                m1 % tk + k0,
                torch.clamp(m2 // tk, max=MAX_COUNT),
            )
            acc = merge_top2(acc, tile)
        out.append(acc)
    if len(out) == 1:
        return out[0]
    return tuple(torch.cat(parts) for parts in zip(*out))


def _ksplit(b: int, device: torch.device) -> int:
    """Column groups per CTA: the smallest split that gives >= 2 CTAs per
    SM (rows per CTA = 256 / ksplit), 8 at most."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for ks in (1, 2, 4, 8):
        if -(-b // (_THREADS // ks)) >= 2 * sms:
            return ks
    return 8


def _check_obs(obs: torch.Tensor, length: int) -> Tuple[int, int]:
    if obs.dtype != torch.uint8 or obs.dim() != 2:
        raise ValueError(
            f"obs_bit2 must be [B, W] uint8, got {obs.dtype} {tuple(obs.shape)}"
        )
    b, width = obs.shape
    if not 1 <= length <= 255 or width != (length + 3) // 4:
        raise ValueError(f"obs_bit2 width {width} does not match length {length}")
    if not obs.is_contiguous():
        raise ValueError("obs_bit2 must be contiguous")
    return b, width


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
        b, width = _check_obs(obs, length)
        if compat.dtype != torch.int8 or compat.dim() != 2 or compat.shape[0] != 4 * length:
            raise ValueError(
                f"compat must be [4L={4 * length}, K_pad] int8, got "
                f"{compat.dtype} {tuple(compat.shape)}"
            )
        if not 1 <= k <= compat.shape[1] or k > MAX_K:
            raise ValueError(f"k={k} outside 1..min(K_pad={compat.shape[1]}, {MAX_K})")
        if compat.device != obs.device:
            raise ValueError(f"compat on {compat.device}, obs on {obs.device}")
        if not compat.is_contiguous():
            raise ValueError("compat must be contiguous")
        out = torch.empty((3, b), dtype=torch.int32, device=obs.device)
        if b == 0:
            return out[0], out[1], out[2]
        launch = load_kernel("colmerge_top2")
        with torch.cuda.device(obs.device):
            stream = torch.cuda.current_stream(obs.device).cuda_stream
            rc = launch(
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


class TileTop2:
    """Wrapper of ``csrc/tile_top2.cu``; the kernel and its plain version
    read the bit table of a ``tile_top2`` state.

    ``launches`` counts kernel launches (one per pass-1 + pass-2 pair: one
    per call unless the batch is split into row chunks to keep the partial
    buffer under :data:`_PARTIAL_MAX_BYTES`) and ``plain_calls`` runs of the
    plain version; each is incremented only where that work is issued."""

    def __init__(self) -> None:
        self.launches = 0
        self.plain_calls = 0

    def __call__(
        self, obs_bit2: torch.Tensor, bits: torch.Tensor, k: int, length: int
    ) -> Top2:
        if obs_bit2.device.type == "cpu":
            self.plain_calls += 1
            return tile_top2_reference(obs_bit2, bits, k, length)
        if obs_bit2.device.type != "cuda":
            raise ValueError(f"unsupported device {obs_bit2.device}")
        return self._launch(obs_bit2, bits, k, length)

    def _launch(self, obs, bits, k, length) -> Top2:
        b, width = _check_obs(obs, length)
        nw = (4 * length + 31) // 32
        if bits.dtype != torch.uint32 or bits.dim() != 2 or bits.shape[1] != nw:
            raise ValueError(
                f"bits must be [K_pad, {nw}] uint32, got {bits.dtype} "
                f"{tuple(bits.shape)}"
            )
        k_pad = bits.shape[0]
        if not 1 <= k <= k_pad or k_pad % 4 or k >= 1 << 31:
            raise ValueError(
                f"k={k} outside 1..K_pad={k_pad} (K_pad a multiple of 4, "
                "K < 2^31)"
            )
        if bits.device != obs.device:
            raise ValueError(f"bits on {bits.device}, obs on {obs.device}")
        if not bits.is_contiguous() or bits.data_ptr() % 16:
            raise ValueError("bits must be contiguous and 16-byte aligned")
        out = torch.empty((3, b), dtype=torch.int32, device=obs.device)
        if b == 0:
            return out[0], out[1], out[2]
        n_tiles = -(-k // TILE_K)
        chunk = _PARTIAL_MAX_BYTES // (4 * n_tiles) // _THREADS * _THREADS
        chunk = min(b, max(_THREADS, chunk))
        partial = torch.empty(n_tiles * chunk, dtype=torch.uint32, device=obs.device)
        launch = load_kernel("tile_top2")
        with torch.cuda.device(obs.device):
            stream = torch.cuda.current_stream(obs.device).cuda_stream
            for r0 in range(0, b, chunk):
                rows = min(chunk, b - r0)
                rc = launch(
                    obs.data_ptr() + r0 * width, rows, width,
                    bits.data_ptr(), k_pad, nw, k, length,
                    partial.data_ptr(),
                    out[0].data_ptr() + 4 * r0, out[1].data_ptr() + 4 * r0,
                    out[2].data_ptr() + 4 * r0,
                    stream,
                )
                if rc != 0:
                    raise RuntimeError(
                        f"tile_top2 launch failed: code {rc} "
                        f"(B={rows}, K={k}, L={length})"
                    )
                self.launches += 1
        return out[0], out[1], out[2]


class HopperAssignFn:
    """``obs [B, ceil(L/4)] uint8 (numpy or torch) -> (assigned, best, next)``
    as tensors on the state's device, through the kernel of the state's
    ``scheme``.

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
        self.scheme = state.scheme
        self.kernels: Dict[str, Union[ColmergeTop2, TileTop2]] = {
            "colmerge_top2": ColmergeTop2(),
            "tile_top2": TileTop2(),
        }
        if state.device.type == "cuda":
            load_kernel(self.scheme)  # build now: a failure surfaces before the run
        # MACs of the equivalent dense one-hot contraction (bench accounting)
        self.macs_per_row = state.k_pad * 4 * state.length

    @property
    def launches(self) -> int:
        return sum(kern.launches for kern in self.kernels.values())

    @property
    def plain_calls(self) -> int:
        return sum(kern.plain_calls for kern in self.kernels.values())

    def __call__(
        self, obs: Union[np.ndarray, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        st = self.state
        if isinstance(obs, np.ndarray):
            obs = torch.from_numpy(np.ascontiguousarray(obs))
        # H2D is asynchronous for a CUDA state: the caller keeps the host
        # buffer alive until it has fetched this call's result
        obs = obs.to(st.device, non_blocking=True)
        best, idx, nxt = self.kernels[self.scheme](obs, st.table, st.k, st.length)
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
    """Build the bit2 device matcher for ``expected`` on ``device``.

    The kernel is the one :func:`hopper_scheme` names: ``colmerge_top2``
    where the JAX package's device path runs the TPU kernel's column-merge
    scheme, ``tile_top2`` where it runs the per-step lane reduce.  The
    Hopper kernels keep their own tiling (256 rows per CTA; all of K per
    CTA, or K tiles of :data:`TILE_K` columns)."""
    if not packed2:
        raise NotImplementedError(_ROADMAP_INPUTS)
    if expected.length > 255:
        raise ValueError(
            "the Hopper matcher supports barcode lengths <= 255 (8-bit "
            f"count in the top-2 key), got {expected.length}"
        )
    state = hopper_state_from_numpy(expected, device)
    return HopperAssignFn(state, max_mismatches, min_mismatch_delta, compact_output)
