"""The device barcode matcher: the Hopper kernels ``colmerge_top2`` and
``tile_top2``, their plain PyTorch versions, and the assignment function
built on them.

Counterpart of :func:`fqtk_tpu.ops.pallas_matcher.make_pallas_assign_fn`
for its three input forms (:data:`~fqtk_tpu_torch.ops.matcher.INPUT_FORMS`).
On the demux main path (``packed2=True``, ``compact_output=True``) the
native engine packs each read's sample barcode as 2-bit codes
(``[B, ceil(L/4)]`` uint8, "bit2"); rows that are not pure ACGT never reach
the device (the engine flags them and the driver resolves them on the host,
no-call gate included).  nib4 rows (``packed_masks=True``) and raw bytes
(the default) go through the kernels' 16-class input: one 4-bit mask per
position, against a position-major table of 16 classes per position, with
the no-call gate on the device.

- :func:`hopper_scheme` — which kernel runs, chosen as
  :func:`~fqtk_tpu_torch.ops.plan.plan_local_kernel` chooses the TPU
  kernel's top-2 scheme at the JAX package's single-chip tiling.
- :func:`hopper_state_from_numpy` — the whitelist as device state: the
  table both kernels' tensor-core product reads (the int8 ``[K_pad, KP]``
  mismatch table, class-major at 4 classes, position-major at 16,
  zero-padded in depth, tiled in the order the product reads it from shared
  memory), packed on the device once.
- :func:`plan_chunks` — how a launch splits K across CTAs.
- :func:`colmerge_top2_reference` / :func:`tile_top2_reference` — the plain
  versions (float32 one-hot matmul + top-2 merges).
- :class:`ColmergeTop2` / :class:`TileTop2` — the kernels' wrappers: on a
  CUDA tensor each launches its ``csrc/*.cu`` kernel (counting launches),
  on a CPU tensor it runs the plain version (counting plain calls).  The
  choice is made by the input's device, never by catching an error.
- :func:`walk_info` — registers, shared bytes and CTAs per SM of the
  sliced depth walk's instantiation a launch at a length runs, as the card
  reports them.
- :func:`make_hopper_assign_fn` — ``obs -> (assigned, best, next)`` with the
  assignment gates.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.profiling import TRACER
from ._build import load_kernel, load_walk_info
from .device_encoding import pack_nib4, unpack_nib4
from .matcher import (
    _PLAIN_CHUNK_ELEMS,
    MAX_COUNT,
    ExpectedSet,
    Top2,
    _onehot16_f32,
    _onehot_f32,
    check_rows,
    chunk_top2,
    compat16_rows,
    input_form,
    masks_and_nocalls,
    merge_top2,
    resolve_device,
    row_bytes,
)
from .plan import _compat_classmajor, plan_local_kernel

#: whitelist columns are padded to a multiple of this in the device table:
#: the columns of one ``wgmma`` (csrc/mma_count.cuh kSub).  Pad columns are
#: all ones; the kernels read them but mask every column >= K
K_ALIGN = 128

#: colmerge_top2's key holds count (8 bits) << column bits in an int32
MAX_K = 1 << 23

#: tile_top2's key holds count (8 bits) << the bits of the column inside a
#: CTA's K tile: the largest K tile
MAX_TILE_COLS = 1 << 23

#: rows per CTA of both kernels (csrc/mma_count.cuh kRows); the window
#: dedup rounds its bucket up to it
ROWS_PER_CTA = 128

#: CTAs of either kernel that share an SM (registers and shared memory)
CTAS_PER_SM = 2

#: fewest 128-column sub-tiles a CTA keeps when K is split: below that the
#: split's second pass costs more than the idle SMs
MIN_CHUNK_SUBS = 16

#: the time a CTA alone on an SM takes, as a share of two co-resident ones'
#: (tile_top2 at K 6,794,880 on an H100 SXM, 700 W: B 16,384 in one chunk
#: 20.37 ms, B 32,768 in one chunk 29.66 ms)
LONE_CTA_SHARE = 0.69

#: what a CTA costs beyond its columns, in 128-column sub-tiles: each wave
#: of CTAs a split adds took ~0.17 ms more there (B 23,040 and B 131,072
#: in 33 chunks: 24.32 and 136.81 ms).  With :data:`LONE_CTA_SHARE` it
#: ranks colmerge_top2's splits at K 737,280 and B 22,912 as the card does
#: (4 = 5 < 2 < 7 < 1 chunks: 3.19, 3.17, 3.25, 3.34, 3.63 ms)
CTA_START_SUBS = 300

#: most waves of CTAs a split of K past one wave may take (bounds the
#: partial buffer)
MAX_SPLIT_WAVES = 4

#: the JAX package's single-chip tiling (``fqtk_tpu.runtime.demux``,
#: ``_build_device_assign_fn``): the plan at this tiling picks the kernel
_PLAN = dict(tile_b=512, tile_k=2048, packed2=True, mxu_dtype="int8")

SCHEMES = ("colmerge_top2", "tile_top2")

#: one-hot classes per position of the kernels' two input forms: bit2 codes
#: (4, class-major table rows ``c*L + l``) and nib4 masks (16,
#: position-major rows ``l*16 + c``)
CLASSES = (4, 16)

#: the K tile of tile_top2's plain version (the kernel's K tile is the
#: launch's ``cols_per_cta``, :func:`plan_chunks`; the result does not depend
#: on the tiling)
TILE_K = 1 << 13

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
    """Device-resident whitelist: the one table that ``scheme``'s kernel
    and its plain version read, for input rows of ``classes`` one-hot
    classes per position."""

    scheme: str
    #: int8, the ``[k_pad, KP]`` mismatch table in the tiled order of
    #: :func:`pack_table_i8` (:func:`table_columns` reads it back).  At 4
    #: classes entry ``c*L + l`` of column k is 1 iff code c mismatches
    #: barcode k at position l; at 16 entry ``l*16 + c`` is 1 iff mask value
    #: c has a bit outside barcode k's mask at l (``ExpectedSet.compat``).
    #: ``KP`` is :func:`table_depth`; the entries from ``classes * L`` on
    #: are 0
    table: torch.Tensor
    k: int
    length: int
    max_ns_in_barcodes: int
    device: torch.device
    classes: int = 4

    @property
    def k_pad(self) -> int:
        return int(self.table.shape[0]) * K_ALIGN


def _pad_depth(wl: int) -> int:
    """``wl`` table rows rounded up to the 32 bytes of one ``wgmma`` k-step,
    and above 128 to a multiple of 128."""
    d = -(-wl // 32) * 32
    return d if d <= 128 else -(-d // 128) * 128


def table_depth(length: int, classes: int = 4) -> int:
    """Depth ``KP`` of the device table for barcode length ``length`` at
    ``classes`` one-hot classes per position: ``classes * L`` rounded up to
    the 32 bytes of one ``wgmma`` k-step, and above 128 to a multiple of 128
    (the kernels then walk the depth in slices of 128; csrc/mma_count.cuh
    ``depth_of``)."""
    return _pad_depth(classes * length)


def _slice_bytes(kp: int) -> int:
    """Depth bytes of one staged slice: all of ``KP`` up to 128, else 128."""
    return kp if kp <= 128 else 128


def pack_table_i8(compat: torch.Tensor) -> torch.Tensor:
    """``[W*L, K_pad]`` 0/1 int8 (the mismatch table's ``W*L`` rows at W
    classes per position; ``K_pad`` a multiple of :data:`K_ALIGN`) -> the
    kernels' table, int8 ``[K_pad/128, KP/SB, 16, SB/16, 8, 16]``,
    contiguous.

    It is the ``[K_pad, KP]`` table (column k's ``W*L`` entries in a row,
    zero-padded to :func:`table_depth`) cut into sub-tiles of 128 columns and
    depth slices of ``SB`` bytes, each stored as ``wgmma`` reads a K-major
    B tile without swizzle: 16 groups of 8 columns, each ``SB/16`` core
    matrices of 8 columns x 16 depth bytes.  Entry ``j`` of column ``k`` is
    ``table[k // 128, j // SB, k % 128 // 8, j % SB // 16, k % 8, j % 16]``.
    A stage of the kernels' ring is then one contiguous block (plain torch
    ops on ``compat``'s device, once per state)."""
    wl, k_pad = compat.shape
    if k_pad % K_ALIGN:
        raise ValueError(f"K_pad={k_pad} is not a multiple of {K_ALIGN}")
    kp = _pad_depth(wl)
    sb = _slice_bytes(kp)
    flat = torch.zeros((k_pad, kp), dtype=torch.int8, device=compat.device)
    flat[:, :wl] = compat.T
    tiled = flat.view(k_pad // K_ALIGN, 16, 8, kp // sb, sb // 16, 16)
    return tiled.permute(0, 3, 1, 4, 2, 5).contiguous()


def table_columns(table: torch.Tensor, k0: int, k1: int, wl: int) -> torch.Tensor:
    """``[wl, k1 - k0]`` float32 0/1: columns ``k0 .. k1 - 1`` of the
    mismatch table that ``table`` (:func:`pack_table_i8`) holds."""
    s0, s1 = k0 // K_ALIGN, -(-k1 // K_ALIGN)
    n_sub, n_slices, _, chunks, _, _ = table.shape
    flat = table[s0:s1].permute(0, 2, 4, 1, 3, 5).reshape(
        (s1 - s0) * K_ALIGN, n_slices * chunks * 16
    )
    return flat[k0 - s0 * K_ALIGN:k1 - s0 * K_ALIGN, :wl].T.to(torch.float32)


def hopper_state_from_numpy(
    expected: ExpectedSet,
    device: Union[str, torch.device],
    scheme: Optional[str] = None,
    classes: int = 4,
) -> HopperState:
    """The state of ``scheme`` (default: :func:`hopper_scheme`) for input
    rows of ``classes`` one-hot classes per position: the table both
    kernels read, packed on ``device`` once (:func:`pack_table_i8`) from
    the 0/1 int8 mismatch table of ``expected.masks``, padded with all-ones
    columns to a multiple of :data:`K_ALIGN`.  At 4 classes (bit2 rows) it
    is class-major, the JAX kernel's ``compat_for_plan`` table before its
    ``ck_s2`` scale; at 16 (nib4 rows, raw bytes) position-major,
    ``ExpectedSet.compat``, built on ``device``
    (:func:`~fqtk_tpu_torch.ops.matcher.compat16_rows`).  ``expected`` is
    this package's ``ExpectedSet`` or any object with its ``masks`` (numpy
    ``[K, L]`` uint8), ``count``, ``length`` and ``max_ns_in_barcodes``,
    e.g. the JAX package's."""
    dev = resolve_device(device)
    k, length = expected.count, expected.length
    scheme = scheme or hopper_scheme(k, length)
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if classes not in CLASSES:
        raise ValueError(f"classes must be one of {CLASSES}, got {classes}")
    k_pad = -(-k // K_ALIGN) * K_ALIGN
    span = TRACER.setup_span
    with span("fqtk.setup.table", dev):
        if classes == 4:
            with span("fqtk.setup.table.compat"):
                host = np.ascontiguousarray(_compat_classmajor(expected.masks, k_pad, 4))
            with span("fqtk.setup.table.upload"):
                compat = torch.from_numpy(host).to(dev)
        else:
            with span("fqtk.setup.table.compat", dev):
                compat = compat16_rows(expected.masks, k_pad, dev).T
        with span("fqtk.setup.table.pack", dev):
            table = pack_table_i8(compat)
    return HopperState(
        scheme=scheme,
        table=table,
        k=k,
        length=length,
        max_ns_in_barcodes=expected.max_ns_in_barcodes,
        device=dev,
        classes=classes,
    )


def _top2_init(b: int, k: int, dev: torch.device) -> Top2:
    """The running triple before the first chunk.  ``best`` starts above any
    count, so the first chunk is always taken (a row whose smallest count is
    255 still reports that count's first column, as the NumPy spec does)."""
    return (
        torch.full((b,), MAX_COUNT + 1, dtype=torch.int32, device=dev),
        torch.full((b,), k, dtype=torch.int32, device=dev),
        torch.full((b,), MAX_COUNT, dtype=torch.int32, device=dev),
    )


def _onehot_of(obs: torch.Tensor, length: int, classes: int) -> torch.Tensor:
    """The float32 one-hot of the kernels' input rows: ``[B, 4L]``
    class-major of bit2 rows, ``[B, 16L]`` position-major of nib4 rows."""
    if classes == 4:
        return _onehot_f32(obs, length)
    return _onehot16_f32(unpack_nib4(obs, length))


def colmerge_top2_reference(
    obs: torch.Tensor, table: torch.Tensor, k: int, length: int, classes: int = 4
) -> Top2:
    """Plain PyTorch version of ``colmerge_top2`` (same signature and
    results): ``obs`` is bit2 rows (``classes`` 4) or nib4 rows (16).

    One-hot ``[B, classes * L]`` (float32) times table columns in chunks of
    K with ``torch.matmul`` in float32: exact, since every product is 0 or 1
    (even in TF32) and sums stay <= L <= 255 (one class per position).
    Top-2 per chunk, merged across chunks in ascending order."""
    b = obs.shape[0]
    onehot = _onehot_of(obs, length, classes)
    kc = max(1, min(k, _PLAIN_CHUNK_ELEMS // max(b, 1)))
    acc = _top2_init(b, k, obs.device)
    for k0 in range(0, k, kc):
        k1 = min(k, k0 + kc)
        cols = table_columns(table, k0, k1, classes * length)
        counts = torch.matmul(onehot, cols).to(torch.int32)
        cb, ci, cn = chunk_top2(torch.clamp(counts, max=MAX_COUNT))
        acc = merge_top2(acc, (cb, ci + k0, cn))
    return acc


def tile_top2_reference(
    obs: torch.Tensor, table: torch.Tensor, k: int, length: int, classes: int = 4
) -> Top2:
    """Plain PyTorch version of ``tile_top2`` (same signature and results;
    bit2 or nib4 rows as for :func:`colmerge_top2_reference`), written as
    the TPU kernel #2 (``pallas_matcher.py:285-371``) computes, tile by
    tile.

    Per tile of :data:`TILE_K` columns: the tile's columns of ``table``,
    counts by a float32 one-hot matmul (exact, as in
    :func:`colmerge_top2_reference`), the combined key
    ``count * TILE_K + column``, its min (best and the first index) and the
    min over the other keys (next); then the ordered running merge
    (:func:`~fqtk_tpu_torch.ops.matcher.merge_top2`: strict ``<``, so the
    earlier tile wins ties).  Rows go in chunks so that one ``[rows,
    TILE_K]`` block stays under :data:`_PLAIN_CHUNK_ELEMS`."""
    tk = TILE_K
    b = obs.shape[0]
    dev = obs.device
    onehot = _onehot_of(obs, length, classes)
    big = MAX_COUNT * tk
    rows = max(1, _PLAIN_CHUNK_ELEMS // tk)
    out = []
    for r0 in range(0, b, rows):
        oh = onehot[r0:r0 + rows]
        acc = _top2_init(oh.shape[0], k, dev)
        for k0 in range(0, k, tk):
            k1 = min(k, k0 + tk)
            counts = torch.matmul(oh, table_columns(table, k0, k1, classes * length))
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


def plan_chunks(b: int, k: int, slots: int, max_cols: Optional[int] = None) -> Tuple[int, int]:
    """``(n_chunks, cols_per_cta)``: how a launch over ``b`` rows splits the
    ``k`` columns across CTAs on a card that runs ``slots`` CTAs of
    :data:`ROWS_PER_CTA` rows at a time (:data:`CTAS_PER_SM` per SM).

    At least the one-wave count: one chunk wherever the row tiles fill the
    SMs, else as many chunks as fill them once, each at least
    :data:`MIN_CHUNK_SUBS` sub-tiles of :data:`K_ALIGN` columns (a small K
    is never split), and at least as many as keep a chunk within
    ``max_cols`` columns.  Past that, K is split further where a model of
    the card says it ends sooner: the ``row_tiles * n_chunks`` CTAs run in
    waves of ``slots``; a last wave that leaves at most one CTA on each SM
    costs :data:`LONE_CTA_SHARE` of a full one; a wave costs a chunk's
    sub-tiles plus :data:`CTA_START_SUBS`.  So row tiles that leave much of
    a wave empty (180 of 264 slots at B 23,040) split K into a few waves,
    and row tiles that fill theirs (B 16,384, 32,768, 131,072) keep that
    count; the split stops at :data:`MAX_SPLIT_WAVES` waves.
    ``cols_per_cta`` is a multiple of :data:`K_ALIGN`; every chunk holds a
    column < k."""
    n_sub = -(-k // K_ALIGN)
    row_tiles = max(1, -(-b // ROWS_PER_CTA))
    sms = max(1, slots // CTAS_PER_SM)

    def chunks(want: int) -> int:  # the count a split into ``want`` comes to
        return -(-n_sub // -(-n_sub // want))

    def cost(n: int) -> float:
        waves, last = divmod(row_tiles * n, slots)
        tail = 0 if last == 0 else LONE_CTA_SHARE if last <= sms else 1
        return (waves + tail) * (-(-n_sub // n) + CTA_START_SUBS)

    least = min(max(1, slots // row_tiles), max(1, n_sub // MIN_CHUNK_SUBS))
    if max_cols is not None:
        least = max(least, -(-n_sub // (max_cols // K_ALIGN)))
    most = min(n_sub // MIN_CHUNK_SUBS, MAX_SPLIT_WAVES * slots // row_tiles)
    n = min({chunks(w) for w in range(least, max(least, most) + 1)}, key=lambda n: (cost(n), n))
    subs_per = -(-n_sub // n)
    return n, subs_per * K_ALIGN


def _check_obs(obs: torch.Tensor, length: int, classes: int = 4) -> Tuple[int, int]:
    """``(B, W)`` of a kernel's rows: bit2 at 4 classes, nib4 at 16."""
    form = "bit2" if classes == 4 else "nib4"
    if obs.dtype != torch.uint8 or obs.dim() != 2:
        raise ValueError(
            f"obs must be [B, W] uint8 {form} rows, got {obs.dtype} {tuple(obs.shape)}"
        )
    b, width = obs.shape
    if not 1 <= length <= 255 or width != row_bytes(form, length):
        raise ValueError(f"{form} rows of width {width} do not match length {length}")
    if not obs.is_contiguous():
        raise ValueError(f"{form} rows must be contiguous")
    return b, width


def _check_table(table: torch.Tensor, obs: torch.Tensor, k: int, length: int,
                 k_max: int, classes: int = 4) -> Tuple[int, int]:
    """``(K_pad, KP)`` of a kernel's table argument, or ``ValueError``."""
    kp = table_depth(length, classes)
    sb = _slice_bytes(kp)
    if (
        table.dtype != torch.int8
        or table.dim() != 6
        or tuple(table.shape[1:]) != (kp // sb, 16, sb // 16, 8, 16)
    ):
        raise ValueError(
            f"table must be the int8 [K_pad/128, {kp // sb}, 16, {sb // 16}, "
            f"8, 16] tiling of pack_table_i8 (KP={kp}), got {table.dtype} "
            f"{tuple(table.shape)}"
        )
    k_pad = int(table.shape[0]) * K_ALIGN
    if not 1 <= k <= k_pad or k > k_max:
        raise ValueError(f"k={k} outside 1..min(K_pad={k_pad}, {k_max})")
    if table.device != obs.device:
        raise ValueError(f"table on {table.device}, obs on {obs.device}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be contiguous and 16-byte aligned")
    return k_pad, kp


class _Top2Kernel:
    """Wrapper of one of the two kernels: on a CUDA tensor it launches
    ``csrc/<name>.cu``, on a CPU tensor it runs the plain version.

    ``launches`` counts kernel launches (one per call: the counting pass and,
    where K is split, its merge pass) and ``plain_calls`` runs of the plain
    version; each is incremented only where that work is issued."""

    name = ""
    #: largest K the kernel's key holds, and the largest chunk of columns
    k_max = (1 << 31) - 1
    max_cols: Optional[int] = None
    #: whether a single chunk still goes through the partial buffer
    always_partial = False

    def __init__(self) -> None:
        self.launches = 0
        self.plain_calls = 0

    @staticmethod
    def reference(obs, table, k, length, classes=4) -> Top2:
        raise NotImplementedError

    def __call__(
        self, obs: torch.Tensor, table: torch.Tensor, k: int, length: int,
        classes: int = 4,
    ) -> Top2:
        """``(best, idx, next)`` of bit2 rows (``classes`` 4) or nib4 rows
        (16) against ``table`` (:func:`pack_table_i8` of the same classes)."""
        if classes not in CLASSES:
            raise ValueError(f"classes must be one of {CLASSES}, got {classes}")
        if obs.device.type == "cpu":
            self.plain_calls += 1
            return self.reference(obs, table, k, length, classes)
        if obs.device.type != "cuda":
            raise ValueError(f"unsupported device {obs.device}")
        return self._launch(obs, table, k, length, classes)

    def _launch(self, obs, table, k, length, classes=4) -> Top2:
        b, width = _check_obs(obs, length, classes)
        k_pad, kp = _check_table(table, obs, k, length, self.k_max, classes)
        out = torch.empty((3, b), dtype=torch.int32, device=obs.device)
        if b == 0:
            return out[0], out[1], out[2]
        sms = torch.cuda.get_device_properties(obs.device).multi_processor_count
        n_chunks, cols_per_cta = plan_chunks(b, k, CTAS_PER_SM * sms, self.max_cols)
        partial = None
        if n_chunks > 1 or self.always_partial:
            partial = torch.empty((2, n_chunks, b), dtype=torch.int32, device=obs.device)
        launch = load_kernel(self.name)
        with torch.cuda.device(obs.device):
            stream = torch.cuda.current_stream(obs.device).cuda_stream
            rc = launch(
                obs.data_ptr(), b, width,
                table.data_ptr(), k_pad, kp, k, length, classes,
                n_chunks, cols_per_cta,
                None if partial is None else partial.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"{self.name} launch failed: code {rc} "
                f"(B={b}, K={k}, L={length}, {classes} classes, {n_chunks} x "
                f"{cols_per_cta} columns)"
            )
        self.launches += 1
        return out[0], out[1], out[2]


#: the fields of :func:`walk_info`, in the order ``fqtk_<kernel>_walk_info``
#: writes them
WALK_INFO = ("registers", "static_smem", "dynamic_smem", "ctas_per_sm",
             "local_bytes", "ring_stages")


def walk_info(name: str, length: int, classes: int = 4) -> Dict[str, int]:
    """What the card makes of the counting kernel of ``name`` (a scheme)
    that a launch at barcode length ``length`` and ``classes`` runs, where
    the table is deeper than 128 bytes (the sliced depth walk: nib4 rows at
    L >= 9, bit2 rows at L >= 33): :data:`WALK_INFO`, with the launch's own
    attributes set; ``ctas_per_sm`` is
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``'s.  Builds the kernels
    on first use; needs the card (raises without one)."""
    if name not in SCHEMES or classes not in CLASSES or table_depth(length, classes) <= 128:
        raise ValueError(f"no sliced walk of {name!r} at L={length}, {classes} classes")
    if not torch.cuda.is_available():
        raise RuntimeError(f"walk_info({name!r}) needs an NVIDIA GPU")
    out = (ctypes.c_int32 * len(WALK_INFO))()
    rc = load_walk_info(name)(classes, table_depth(length, classes), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{name} walk_info failed: code {rc} (L={length}, {classes} classes)")
    return dict(zip(WALK_INFO, out))


class ColmergeTop2(_Top2Kernel):
    """Wrapper of ``csrc/colmerge_top2.cu`` (TPU kernel #1): the global
    column rides in the key, so K <= :data:`MAX_K`."""

    name = "colmerge_top2"
    k_max = MAX_K
    reference = staticmethod(colmerge_top2_reference)


class TileTop2(_Top2Kernel):
    """Wrapper of ``csrc/tile_top2.cu`` (TPU kernel #2): each K tile of at
    most :data:`MAX_TILE_COLS` columns is reduced on its own and the tiles
    merge in ascending order, so K is bounded only by the int32 idx."""

    name = "tile_top2"
    max_cols = MAX_TILE_COLS
    always_partial = True
    reference = staticmethod(tile_top2_reference)


class HopperAssignFn:
    """``obs (numpy or torch) -> (assigned, best, next)`` as tensors on the
    state's device, through the kernel of the state's ``scheme``, for rows
    of input form ``form`` (:data:`~fqtk_tpu_torch.ops.matcher.INPUT_FORMS`;
    bit2 needs a 4-class state, nib4 and raw bytes a 16-class one).

    ``assigned[b] == K`` is unmatched; it is uint8 when ``compact_output``
    and ``K < 255``, else int32.  The gates are those of
    ``make_pallas_assign_fn`` (``pallas_matcher.py:559-568``):
    ``best <= max_mismatches`` and ``next - best >= min_mismatch_delta``;
    for nib4 and raw bytes also ``nocalls <= max_mismatches +
    max_ns_in_barcodes``, counted on the device (bit2 rows have none: the
    engine ran it); and ``next = 255`` when ``K == 1``.  Raw bytes become
    masks (:func:`~fqtk_tpu_torch.ops.device_encoding.byte_to_mask`) packed
    as nib4 on the device before the launch, as the JAX package converts
    them in XLA before its kernel (``pallas_matcher.py:556-558``)."""

    def __init__(
        self,
        state: HopperState,
        max_mismatches: int,
        min_mismatch_delta: int,
        compact_output: bool,
        form: str = "bit2",
        kernels: Optional[Dict[str, _Top2Kernel]] = None,
    ) -> None:
        want = 4 if form == "bit2" else 16
        if state.classes != want:
            raise ValueError(f"{form} rows need a {want}-class state, got {state.classes}")
        self.state = state
        self.form = form
        self.max_mismatches = max_mismatches
        self.min_mismatch_delta = min_mismatch_delta
        self.nocall_budget = max_mismatches + state.max_ns_in_barcodes
        self.out_dtype = (
            torch.uint8 if compact_output and state.k < 255 else torch.int32
        )
        self.scheme = state.scheme
        # a mesh passes one set to all its shards, so that their counts add up
        self.kernels: Dict[str, _Top2Kernel] = kernels if kernels is not None else {
            "colmerge_top2": ColmergeTop2(),
            "tile_top2": TileTop2(),
        }
        if state.device.type == "cuda":
            load_kernel(self.scheme)  # build now: a failure surfaces before the run
        # MACs of the equivalent dense one-hot contraction (bench accounting)
        self.macs_per_row = state.k_pad * state.classes * state.length

    @property
    def launches(self) -> int:
        return sum(kern.launches for kern in self.kernels.values())

    @property
    def plain_calls(self) -> int:
        return sum(kern.plain_calls for kern in self.kernels.values())

    def top2(self, obs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``(best, idx, next, nocalls)`` of rows of this matcher's form
        already on the state's device: the kernel's raw top-2, before any
        gate (raw bytes packed to nib4 on the device first), and the rows'
        no-call counts (``None`` for bit2 rows)."""
        st = self.state
        nocalls = None
        if self.form == "bytes":
            masks, nocalls = masks_and_nocalls(obs, "bytes", st.length)
            obs = pack_nib4(masks)
        elif self.form == "nib4":
            _, nocalls = masks_and_nocalls(obs, "nib4", st.length)
        best, idx, nxt = self.kernels[self.scheme](
            obs.contiguous(), st.table, st.k, st.length, st.classes)
        return best, idx, nxt, nocalls

    def __call__(
        self, obs: Union[np.ndarray, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        st = self.state
        with TRACER.span("fqtk.matcher.h2d"):
            if isinstance(obs, np.ndarray):
                obs = torch.from_numpy(np.ascontiguousarray(obs))
            check_rows(obs, self.form, st.length)
            # H2D is asynchronous for a CUDA state: the caller keeps the host
            # buffer alive until it has fetched this call's result
            obs = obs.to(st.device, non_blocking=True)
        with TRACER.span("fqtk.matcher.launch"):
            best, idx, nxt, nocalls = self.top2(obs)
        with TRACER.span("fqtk.matcher.gate"):
            if st.k == 1:
                nxt = torch.full_like(nxt, MAX_COUNT)
            ok = (best <= self.max_mismatches) & (
                nxt - best >= self.min_mismatch_delta
            )
            if nocalls is not None:
                ok = ok & (nocalls <= self.nocall_budget)
            assigned = torch.where(ok, idx, st.k).to(self.out_dtype)
        return assigned, best, nxt


def make_hopper_assign_fn(
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    *,
    device: Union[str, torch.device],
    packed_masks: bool = False,
    packed2: bool = True,
    compact_output: bool = True,
) -> HopperAssignFn:
    """Build the device matcher for ``expected`` on ``device``, for the
    input form the flags name (as ``make_pallas_assign_fn``'s:
    ``packed2`` bit2, ``packed_masks`` nib4, neither raw bytes; the default
    is bit2, the demux main path's).

    The kernel is the one :func:`hopper_scheme` names: ``colmerge_top2``
    where the JAX package's device path runs the TPU kernel's column-merge
    scheme, ``tile_top2`` where it runs the per-step lane reduce; the choice
    does not depend on the input form.  The Hopper kernels keep their own
    tiling (:data:`ROWS_PER_CTA` rows per CTA; K split by
    :func:`plan_chunks`)."""
    form = input_form(packed_masks, packed2)
    if expected.length > 255:
        raise ValueError(
            "the Hopper matcher supports barcode lengths <= 255 (8-bit "
            f"count in the top-2 key), got {expected.length}"
        )
    state = hopper_state_from_numpy(
        expected, device, classes=4 if form == "bit2" else 16)
    return HopperAssignFn(state, max_mismatches, min_mismatch_delta, compact_output, form)
