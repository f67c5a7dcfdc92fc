"""The kernel lab's Hopper kernels and their plain PyTorch versions.

Counterparts of the Pallas bodies of ``scripts/kernel_lab.py`` (TPU kernels
#3-#7), each a design of the K = 737,280 barcode matcher:

- ``csrc/mma_probe.cu`` (#3, ``make_variant`` -> ``go_raw``, call ``:139``)
  — ``v4_int4``, the tensor-core probe: the one-hot times the 0/1 table on
  the tensor cores (int8 ``wgmma``: Hopper has no int4 product), emit
  the count of column 0 of the last K tile;
- ``csrc/lab_probe.cu`` (#4, ``make_variant`` -> ``build``, call ``:222``)
  — the bound probes ``v1_m1only``, ``v2_matmul``, ``v2b_store``,
  ``p_i8min`` and ``p_i8minmax``: counts times ``ck`` into one accumulator
  stream, emit ``min_p(m1[p] * tile_k + p) >> 8``;
- ``csrc/clamp16_top2.cu`` (#5, call ``:314``) — ``v5_clamp16``: top-2
  over int16 keys ``min(count, W) * nt_pow2 + tile`` in two streams,
  updated in 16x2 lanes;
- ``csrc/group_top2.cu`` (#6, call ``:419``) — ``v6_group{P}``: exact
  top-2, a register ladder over P K tiles before one update of two int32
  streams;
- ``csrc/clamp8_top2.cu`` (#7, call ``:515``) — ``v3_clamp8`` and
  ``v3w_clamp8``: top-2 over int8 clamped counts plus a uint8 first-tile id.

All five count by ``wgmma`` on the engine of ``csrc/mma_count.cuh``,
through the lab's walk ``csrc/lab_mma.cuh``.

Every variant reads the lab's table: the class-major 0/1 mismatch table
padded with **all-ones** columns to ``k_padded = n_k_tiles * tile_k``
(``kernel_lab.py:62-71``), as int8 (a column's 4L entries, zero-padded to
``KP = 32 * ceil(4L / 32)``) tiled by :func:`pack_lab_table_i8` in the
order ``wgmma`` reads it; the plain versions read it back through
:func:`lab_table_columns`.  :data:`TABLE_FORMAT` names each kernel's
format (:func:`pack_compat_bits` packs the same table into bits, the
tests' oracle of its entries).  A pad column counts L mismatches
and takes part in every result, as in the JAX lab (kernels #1 and #2 mask
such columns; these do not).

The plain versions (``*_reference``) are written as the Pallas bodies
compute, tile by tile: counts by a float32 one-hot matmul per K tile (exact:
0/1 products, sums <= L), then the body's own integer arithmetic in the
body's own types, emit included.  A wrapper runs its plain version for a
CPU tensor and launches its kernel for a CUDA tensor (or raises); the choice
is made by the input's device, never by catching an error.  ``launches``
and ``plain_calls`` count each.

Outputs: the probes (``lab_probe``, ``mma_probe``) give ``[B]`` int32; the
exact kernels give ``(best, idx, next)`` ``[B]`` int32 like the port's other
matchers (:func:`fqtk_tpu_torch.lab.kernel_lab.make_lab_variant` puts them
in the JAX lab's order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple, Union

import torch

from ._build import load_kernel
from .hopper_matcher import _PLAIN_CHUNK_ELEMS, _check_obs, _onehot_f32
from .matcher import MAX_COUNT, Top2

#: the bound probes of kernel #4, in the order of ``csrc/lab_probe.cu``'s
#: ``Mode`` enum
PROBES = ("v1_m1only", "v2_matmul", "v2b_store", "p_i8min", "p_i8minmax")
CLAMP16 = ("v5_clamp16",)
CLAMP8 = ("v3_clamp8", "v3w_clamp8")
MMA = ("v4_int4",)
GROUP_PREFIX = "v6_group"

#: group sizes ``group_top2.cu`` is instantiated for
GROUP_SIZES = (2, 4, 8)

#: ``tile_k`` must be a multiple of this: the smallest ``wgmma`` width of
#: the tensor-core lab kernels (:func:`lab_width`)
SLICE = 32

#: the form of the lab's table each kernel and its plain version read:
#: ``"tiled"`` (:func:`pack_lab_table_i8`, the order ``wgmma`` reads it)
TABLE_FORMAT = {
    "mma_probe": "tiled", "lab_probe": "tiled", "clamp16_top2": "tiled",
    "group_top2": "tiled", "clamp8_top2": "tiled",
}

#: bytes of a design's streams that pass through shared memory per (row,
#: column) pair and K tile, reads and writes, at the TPU body's widths
#: (``v6_group{P}``: two int32 streams once per P K tiles)
STREAM_BYTES = {
    "v4_int4": 0, "v1_m1only": 8, "v2_matmul": 0, "v2b_store": 4, "p_i8min": 2,
    "p_i8minmax": 4, "v3_clamp8": 6, "v3w_clamp8": 6, "v5_clamp16": 8,
    "v6_group2": 8, "v6_group4": 4, "v6_group8": 2,
}

#: the widest ``wgmma`` each tensor-core lab kernel is built for
#: (``kMaxWidth`` of its design): ``group_top2`` holds its register ladder
#: across K tiles, at 64 columns in 16x2 lanes, at 32 where it needs int32
#: (:func:`group_lanes16`)
MAX_WIDTH = {
    "mma_probe": 128, "lab_probe": 128, "clamp16_top2": 128, "group_top2": 64,
    "clamp8_top2": 128,
}

#: the variants of the kernels that read the tiled table
TILED_VARIANTS = tuple(STREAM_BYTES)

#: the emit's sentinel for the masked first key (``jnp.int32(2**30)``)
KEY_MASKED = 1 << 30

#: largest barcode length of the lab kernels: four bit words per column
MAX_LAB_LENGTH = 32

_INT32_LIMIT = 1 << 31


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


def lab_width(tile_k: int, cap: int = 128) -> int:
    """Column positions per CTA of a tensor-core lab kernel at ``tile_k``:
    the widest ``wgmma`` (128, 64 or 32 columns) that divides it, at most
    ``cap``, the design's widest (``lab_width``, ``csrc/lab_mma.cuh``)."""
    return min(cap, 128 if tile_k % 128 == 0 else 64 if tile_k % 64 == 0 else 32)


def group_lanes16(length: int, nt_pow2: int) -> bool:
    """Whether ``group_top2`` keeps its register ladder in 16x2 lanes:
    every key ``count * nt_pow2 + kb`` (count <= L) is below 2^15."""
    return length * nt_pow2 + nt_pow2 - 1 < 1 << 15


def pack_lab_table_i8(compat: torch.Tensor) -> torch.Tensor:
    """``[4L, k_padded]`` 0/1 int8 (class-major rows ``c*L + l``; ``k_padded``
    a multiple of 8) -> the tensor-core lab kernels' table, int8
    ``[k_padded/8, KP/16, 8, 16]``, contiguous.

    It is the ``[k_padded, KP]`` table (column k's ``4L`` entries in a row,
    zero-padded to :func:`mma_depth`) in groups of 8 columns, each ``KP/16``
    core matrices of 8 columns x 16 depth bytes: entry ``j`` of column ``k``
    is ``table[k // 8, j // 16, k % 8, j % 16]``.  Any run of N consecutive
    columns (N a multiple of 8) is then one contiguous block in the order
    ``wgmma`` reads a K-major B tile without swizzle, so a kernel step is one
    bulk copy whatever the slice width (plain torch ops on ``compat``'s
    device, once per variant)."""
    wl, k_padded = compat.shape
    if k_padded % 8:
        raise ValueError(f"k_padded={k_padded} is not a multiple of 8")
    kp = mma_depth(wl // 4)
    flat = torch.zeros((k_padded, kp), dtype=torch.int8, device=compat.device)
    flat[:, :wl] = compat.T
    return flat.view(k_padded // 8, 8, kp // 16, 16).permute(0, 2, 1, 3).contiguous()


def lab_table_columns(table: torch.Tensor, k0: int, k1: int, wl: int) -> torch.Tensor:
    """``[wl, k1 - k0]`` float32 0/1: columns ``k0 .. k1 - 1`` of the
    class-major mismatch table that ``table`` (:func:`pack_lab_table_i8`)
    holds."""
    g0, g1 = k0 // 8, -(-k1 // 8)
    flat = table[g0:g1].permute(0, 2, 1, 3).reshape((g1 - g0) * 8, -1)
    return flat[k0 - g0 * 8:k1 - g0 * 8, :wl].T.to(torch.float32)


@dataclass(frozen=True)
class LabParams:
    """One lab variant at one (K, L, tile_k), with the constants its body
    derives (``kernel_lab.py:162-168``, ``:258-260``, ``:352-356``,
    ``:446-451``)."""

    name: str
    #: the ``csrc/<kernel>.cu`` that runs it
    kernel: str
    length: int
    tile_k: int
    n_k_tiles: int
    #: probe mode (index into :data:`PROBES`) or group size P
    mode: int = 0
    #: the probes' count scale ``2^max(1, bitlen(n_k_tiles - 1))``
    ck: int = 0
    #: tile-id field of the exact keys, ``2^max(1, bitlen(n_k_tiles - 1))``
    nt_pow2: int = 0
    #: count clamp of ``v5`` / ``v3``, ``max_mm + max(delta, 1) + 1``
    w_clamp: int = 0

    @property
    def k_padded(self) -> int:
        return self.n_k_tiles * self.tile_k

    @property
    def width(self) -> int:
        """Column positions per CTA of the tensor-core kernel that runs
        this variant (:func:`lab_width` at its design's :data:`MAX_WIDTH`)."""
        cap = MAX_WIDTH[self.kernel]
        if self.kernel == "group_top2" and not group_lanes16(self.length, self.nt_pow2):
            cap = 32  # the int32 ladder
        return lab_width(self.tile_k, cap)

    @property
    def scalars(self) -> Tuple[int, ...]:
        """The kernel's own arguments after ``n_k_tiles``: ``(mode, ck,
        sink_flag)`` for ``lab_probe`` and ``(sink_flag,)`` for
        ``mma_probe`` (``sink_flag`` 0: the counts' liveness fold is never
        stored), ``(P, nt_pow2)`` for ``group_top2``, ``(W, nt_pow2)`` for
        the clamped kernels."""
        if self.kernel == "lab_probe":
            return (self.mode, self.ck, 0)
        if self.kernel == "mma_probe":
            return (0,)
        if self.kernel == "group_top2":
            return (self.mode, self.nt_pow2)
        return (self.w_clamp, self.nt_pow2)


def _check_int32(what: str, largest: int) -> None:
    if largest >= _INT32_LIMIT:
        raise ValueError(
            f"{what} reaches {largest}, outside int32: pick a smaller tile_k"
        )


def lab_params(
    name: str, k: int, length: int, tile_k: int, max_mm: int = 1, delta: int = 2
) -> LabParams:
    """:class:`LabParams` of variant ``name``.  Raises ``ValueError`` where
    ``make_variant`` asserts (v3 above 255 K tiles, the v5 int16 key bound,
    v6 with P < 2 or ``n_k_tiles % P``) and where a key or emit value would
    leave int32 or the probes' int8 one-hot scale."""
    if k < 1 or not 1 <= length <= MAX_COUNT:
        raise ValueError(f"need K >= 1 and 1 <= L <= {MAX_COUNT}, got K={k} L={length}")
    if tile_k < SLICE or tile_k % SLICE:
        raise ValueError(
            f"tile_k must be a positive multiple of {SLICE} (the Hopper "
            f"kernels' column slice), got {tile_k}"
        )
    n_k_tiles = -(-k // tile_k)
    pow2 = 1 << max(1, (n_k_tiles - 1).bit_length())
    w_clamp = max_mm + max(delta, 1) + 1
    base = dict(name=name, length=length, tile_k=tile_k, n_k_tiles=n_k_tiles)
    if name in PROBES:
        ck_s1 = 1 << ((pow2.bit_length() - 1 + 1) // 2)
        if ck_s1 > 127 or pow2 // ck_s1 > 127:
            raise ValueError(
                f"ck = {pow2} ({n_k_tiles} K tiles): its factors must fit the "
                "int8 one-hot and table"
            )
        _check_int32("the probe emit key", (MAX_COUNT + 1) * pow2 * tile_k + tile_k - 1)
        return LabParams(kernel="lab_probe", mode=PROBES.index(name), ck=pow2, **base)
    if name in CLAMP16:
        kinit = w_clamp * pow2 + pow2 - 1
        if kinit >= 1 << 15:
            raise ValueError(f"int16 keys: W * nt_pow2 + nt_pow2 - 1 = {kinit} >= 2^15")
        _check_int32("the emit key", kinit * tile_k + tile_k - 1)
        return LabParams(kernel="clamp16_top2", nt_pow2=pow2, w_clamp=w_clamp, **base)
    if name.startswith(GROUP_PREFIX):
        tail = name[len(GROUP_PREFIX):] or "4"
        if not tail.isdigit():
            raise ValueError(f"unknown lab variant {name!r}")
        group = int(tail)
        if group < 2:
            raise ValueError("v6_group needs P >= 2 (the ladder folds two keys)")
        if n_k_tiles % group:
            raise ValueError(f"v6_group{group}: {n_k_tiles} K tiles is not a multiple of P")
        _check_int32("the emit key", (length * pow2 + pow2 - 1) * tile_k + tile_k - 1)
        return LabParams(kernel="group_top2", mode=group, nt_pow2=pow2, **base)
    if name in MMA:
        return LabParams(kernel="mma_probe", **base)
    if name in CLAMP8:
        if n_k_tiles > 255:
            raise ValueError(f"uint8 tile ids: {n_k_tiles} K tiles > 255")
        if w_clamp > 127:
            raise ValueError(f"int8 accumulators: W = {w_clamp} > 127")
        _check_int32("the emit key", ((w_clamp * pow2 + pow2 - 1) * tile_k) + tile_k - 1)
        return LabParams(kernel="clamp8_top2", nt_pow2=pow2, w_clamp=w_clamp, **base)
    raise ValueError(f"unknown lab variant {name!r}")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _tile_counts(onehot: torch.Tensor, bits: torch.Tensor, p: LabParams, kb: int) -> torch.Tensor:
    """``[rows, tile_k]`` int32 mismatch counts of K tile ``kb`` (pad
    columns count L), from the tiled table."""
    tk = p.tile_k
    cols = lab_table_columns(bits, kb * tk, (kb + 1) * tk, 4 * p.length)
    return torch.matmul(onehot, cols).to(torch.int32)


def _by_rows(body: Callable, obs: torch.Tensor, bits: torch.Tensor, p: LabParams):
    """``body(onehot_rows, bits, p)`` over row chunks that keep one
    ``[rows, tile_k]`` block under the plain versions' element budget;
    results concatenated.  ``bits`` is the table ``p.kernel`` reads."""
    columns = bits.shape[0] * 8  # a group of 8 columns per row of the tiled table
    if columns != p.k_padded:
        raise ValueError(f"the table has {columns} columns, the lab table {p.k_padded}")
    onehot = _onehot_f32(obs, p.length)
    step = max(1, _PLAIN_CHUNK_ELEMS // p.tile_k)
    parts = [body(onehot[r0:r0 + step], bits, p) for r0 in range(0, max(1, obs.shape[0]), step)]
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(f) for f in zip(*parts))


def _colid(p: LabParams, dev: torch.device) -> torch.Tensor:
    return torch.arange(p.tile_k, dtype=torch.int32, device=dev)


def _emit_top2(ext1: torch.Tensor, m2c: torch.Tensor, p: LabParams) -> Top2:
    """The exact variants' emit (``kernel_lab.py:290-302``, ``:397-407``,
    ``:488-503``): ``ext1 = key * tile_k + column`` is unique per row."""
    tk, nt = p.tile_k, p.nt_pow2
    g1 = ext1.min(dim=1).values
    masked = torch.where(ext1 == g1[:, None], KEY_MASKED, ext1)
    other = masked.min(dim=1).values // (nt * tk)
    nxt = torch.minimum(other, m2c)
    best = g1 // (nt * tk)
    idx = ((g1 // tk) & (nt - 1)) * tk + (g1 & (tk - 1))
    return best, idx, nxt


def _mma_rows(onehot, table, p: LabParams) -> torch.Tensor:
    acc = torch.zeros(onehot.shape[0], dtype=torch.int32, device=onehot.device)
    for kb in range(p.n_k_tiles):
        acc = _tile_counts(onehot, table, p, kb)[:, 0]
    return acc.contiguous()


def mma_probe_reference(obs_bit2: torch.Tensor, table: torch.Tensor, p: LabParams) -> torch.Tensor:
    """Plain version of ``mma_probe`` (``v4_int4``, the body at
    ``kernel_lab.py:114-132``) on the tiled int8 table
    (:func:`pack_lab_table_i8`): ``[B]`` int32, column 0 of the last K
    tile's counts."""
    return _by_rows(_mma_rows, obs_bit2, table, p)


def _probe_rows(onehot, bits, p: LabParams) -> torch.Tensor:
    mode, ck = PROBES[p.mode], p.ck
    rows, dev = onehot.shape[0], onehot.device
    if mode.startswith("p_i8"):
        m1 = torch.full((rows, p.tile_k), 127, dtype=torch.int8, device=dev)
    else:
        m1 = torch.full((rows, p.tile_k), (MAX_COUNT + 1) * ck, dtype=torch.int32, device=dev)
    for kb in range(p.n_k_tiles):
        counts_ck = _tile_counts(onehot, bits, p, kb) * ck
        if mode == "v1_m1only":
            m1 = torch.minimum(m1, counts_ck + kb)
        elif mode == "v2b_store":
            m1 = counts_ck  # a full store: no read-merge
        elif mode == "p_i8min":
            # the clamp comes before the int8 cast (counts * ck may pass 127)
            m1 = torch.minimum(m1, torch.clamp(counts_ck, max=96).to(torch.int8))
        elif mode == "p_i8minmax":
            c8 = torch.clamp(counts_ck, max=96).to(torch.int8)
            prev = m1
            m1 = torch.minimum(prev, c8)
            m1 = torch.minimum(m1, torch.maximum(prev, c8))
        else:  # v2_matmul: column 0 copied, no merge
            m1[:, 0] = counts_ck[:, 0]
    ext1 = m1.to(torch.int32) * p.tile_k + _colid(p, dev)
    return ext1.min(dim=1).values >> 8


def lab_probe_reference(obs_bit2: torch.Tensor, table: torch.Tensor, p: LabParams) -> torch.Tensor:
    """Plain version of ``lab_probe`` (the body at ``kernel_lab.py:172-214``)
    on the tiled int8 table (:func:`pack_lab_table_i8`): ``[B]`` int32,
    column 0 of the probe's emit."""
    return _by_rows(_probe_rows, obs_bit2, table, p)


def _clamp16_rows(onehot, bits, p: LabParams) -> Top2:
    rows, dev = onehot.shape[0], onehot.device
    nt, w = p.nt_pow2, p.w_clamp
    m1 = torch.full((rows, p.tile_k), w * nt + nt - 1, dtype=torch.int16, device=dev)
    m2 = m1.clone()
    for kb in range(p.n_k_tiles):
        counts = _tile_counts(onehot, bits, p, kb)
        key16 = (torch.clamp(counts, max=w) * nt + kb).to(torch.int16)
        prev1 = m1
        m1 = torch.minimum(prev1, key16)
        m2 = torch.minimum(m2, torch.maximum(prev1, key16))
    ext1 = m1.to(torch.int32) * p.tile_k + _colid(p, dev)
    return _emit_top2(ext1, m2.to(torch.int32).min(dim=1).values // nt, p)


def clamp16_top2_reference(obs_bit2: torch.Tensor, bits: torch.Tensor, p: LabParams) -> Top2:
    """Plain version of ``clamp16_top2`` (``v5_clamp16``,
    ``kernel_lab.py:263-307``): ``(best, idx, next)`` with counts clamped
    at W."""
    return _by_rows(_clamp16_rows, obs_bit2, bits, p)


def _group_rows(onehot, bits, p: LabParams) -> Top2:
    rows, dev = onehot.shape[0], onehot.device
    nt, group = p.nt_pow2, p.mode
    m1 = torch.full((rows, p.tile_k), KEY_MASKED, dtype=torch.int32, device=dev)
    m2 = m1.clone()
    for jb in range(p.n_k_tiles // group):

        def key_of(q):
            kb = jb * group + q
            return _tile_counts(onehot, bits, p, kb) * nt + kb

        lo1, lo2 = key_of(0), key_of(1)
        lo1, lo2 = torch.minimum(lo1, lo2), torch.maximum(lo1, lo2)
        for q in range(2, group):
            key = key_of(q)
            t = torch.maximum(lo1, key)
            lo1 = torch.minimum(lo1, key)
            lo2 = torch.minimum(lo2, t)
        prev1 = m1
        m1 = torch.minimum(prev1, lo1)
        m2 = torch.minimum(m2, torch.minimum(torch.maximum(prev1, lo1), lo2))
    ext1 = m1 * p.tile_k + _colid(p, dev)
    return _emit_top2(ext1, m2.min(dim=1).values // nt, p)


def group_top2_reference(obs_bit2: torch.Tensor, bits: torch.Tensor, p: LabParams) -> Top2:
    """Plain version of ``group_top2`` (``v6_group{P}``,
    ``kernel_lab.py:360-412``): exact ``(best, idx, next)`` over all
    ``k_padded`` columns."""
    return _by_rows(_group_rows, obs_bit2, bits, p)


def _clamp8_rows(onehot, bits, p: LabParams) -> Top2:
    rows, dev = onehot.shape[0], onehot.device
    nt, w = p.nt_pow2, p.w_clamp
    m1 = torch.full((rows, p.tile_k), w, dtype=torch.int8, device=dev)
    m2 = m1.clone()
    t1 = torch.zeros((rows, p.tile_k), dtype=torch.uint8, device=dev)
    for kb in range(p.n_k_tiles):
        c8 = torch.clamp(_tile_counts(onehot, bits, p, kb), max=w).to(torch.int8)
        prev1 = m1
        better = c8 < prev1
        m1 = torch.where(better, c8, prev1)
        t1 = torch.where(better, torch.tensor(kb, dtype=torch.uint8, device=dev), t1)
        m2 = torch.minimum(m2, torch.maximum(prev1, c8))
    ext1 = (m1.to(torch.int32) * nt + t1.to(torch.int32)) * p.tile_k + _colid(p, dev)
    return _emit_top2(ext1, m2.to(torch.int32).min(dim=1).values, p)


def clamp8_top2_reference(obs_bit2: torch.Tensor, table: torch.Tensor, p: LabParams) -> Top2:
    """Plain version of ``clamp8_top2`` (``v3_clamp8`` / ``v3w_clamp8``,
    ``kernel_lab.py:453-508``) on the tiled int8 table
    (:func:`pack_lab_table_i8`): ``(best, idx, next)`` with counts clamped
    at W."""
    return _by_rows(_clamp8_rows, obs_bit2, table, p)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


class LabKernel:
    """Wrapper of one ``csrc/<name>.cu`` lab kernel.

    ``table_format`` (:data:`TABLE_FORMAT` of ``name``) is the form of the
    lab's table the kernel and its plain version read.  A call checks the table whatever the device, then runs the plain version
    for a CPU tensor and launches the kernel for a CUDA tensor.

    ``launches`` counts kernel launches (one per pass-1 + pass-2 pair) and
    ``plain_calls`` runs of the plain version; each is incremented only
    where that work is issued."""

    def __init__(self, name: str, reference: Callable, exact: bool) -> None:
        self.name = name
        self.reference = reference
        self.exact = exact
        self.table_format = TABLE_FORMAT[name]
        self.launches = 0
        self.plain_calls = 0

    def table_spec(self, p: LabParams) -> Tuple[torch.dtype, Tuple[int, ...]]:
        """``(dtype, shape)`` of the table this kernel reads for ``p``."""
        kp = mma_depth(p.length)
        return torch.int8, (p.k_padded // 8, kp // 16, 8, 16)

    def check_table(self, table: torch.Tensor, obs: torch.Tensor, p: LabParams) -> None:
        """``ValueError`` unless ``table`` is this kernel's table for ``p``:
        dtype, shape, contiguity, 16-byte alignment and ``obs``'s device."""
        dtype, shape = self.table_spec(p)
        if table.dtype != dtype or tuple(table.shape) != shape:
            raise ValueError(
                f"{self.name} reads the {self.table_format} table, {dtype} "
                f"{list(shape)}; got {table.dtype} {list(table.shape)}"
            )
        if table.device != obs.device:
            raise ValueError(f"table on {table.device}, obs on {obs.device}")
        if not table.is_contiguous() or table.data_ptr() % 16:
            raise ValueError("table must be contiguous and 16-byte aligned")

    def n_slices(self, p: LabParams) -> int:
        """Column slices of a K tile, one CTA column each: the partials a
        row writes."""
        return p.tile_k // p.width

    def __call__(
        self, obs_bit2: torch.Tensor, table: torch.Tensor, p: LabParams
    ) -> Union[torch.Tensor, Top2]:
        if p.kernel != self.name:
            raise ValueError(f"{p.name} runs on {p.kernel}, not {self.name}")
        self.check_table(table, obs_bit2, p)
        if obs_bit2.device.type == "cpu":
            self.plain_calls += 1
            return self.reference(obs_bit2, table, p)
        if obs_bit2.device.type != "cuda":
            raise ValueError(f"unsupported device {obs_bit2.device}")
        return self._launch(obs_bit2, table, p)

    def _result(self, out: torch.Tensor):
        return (out[0], out[1], out[2]) if self.exact else out[0]

    def _launch(self, obs, table, p: LabParams):
        b, width = _check_obs(obs, p.length)
        if p.length > MAX_LAB_LENGTH:
            raise ValueError(f"the lab kernels take L <= {MAX_LAB_LENGTH}, got {p.length}")
        if p.kernel == "group_top2" and p.mode not in GROUP_SIZES:
            raise ValueError(f"group_top2 is built for P in {GROUP_SIZES}, got {p.mode}")
        fields = 3 if self.exact else 1
        out = torch.empty((fields, b), dtype=torch.int32, device=obs.device)
        if b == 0:
            return self._result(out)
        n_slices = self.n_slices(p)
        # mma_probe keeps no per-slice state: it writes its output itself
        scratch = () if n_slices == 0 else (
            torch.empty((fields, n_slices, b), dtype=torch.int32, device=obs.device),)
        launch = load_kernel(self.name)
        with torch.cuda.device(obs.device):
            stream = torch.cuda.current_stream(obs.device).cuda_stream
            rc = launch(
                obs.data_ptr(), b, width, table.data_ptr(), mma_depth(p.length), p.length,
                p.tile_k, p.n_k_tiles, *p.scalars,
                *(t.data_ptr() for t in scratch),
                *(o.data_ptr() for o in out), stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"{self.name} launch failed: code {rc} ({p.name}, B={b}, "
                f"k_padded={p.k_padded}, L={p.length}, tile_k={p.tile_k})"
            )
        self.launches += 1
        return self._result(out)


class MmaProbe(LabKernel):
    """Wrapper of ``csrc/mma_probe.cu`` (``v4_int4``): one launch per
    call, no partials (slice 0's CTAs write the output)."""

    def __init__(self) -> None:
        super().__init__("mma_probe", mma_probe_reference, exact=False)

    def n_slices(self, p: LabParams) -> int:
        return 0


def mma_depth(length: int) -> int:
    """``KP``: the int8 table's depth, 4L zero-padded to a multiple of
    32 (the depth of one ``wgmma`` k-step)."""
    return 32 * -(-4 * length // 32)


def make_lab_kernels() -> Dict[str, LabKernel]:
    """One wrapper per lab kernel, keyed by its ``csrc`` stem."""
    return {
        "mma_probe": MmaProbe(),
        "lab_probe": LabKernel("lab_probe", lab_probe_reference, exact=False),
        "clamp16_top2": LabKernel("clamp16_top2", clamp16_top2_reference, exact=True),
        "group_top2": LabKernel("group_top2", group_top2_reference, exact=True),
        "clamp8_top2": LabKernel("clamp8_top2", clamp8_top2_reference, exact=True),
    }


#: the wrappers the lab's variants launch through (their counts are the
#: lab's: a run sets them to 0 and reads them after)
LAB_KERNELS: Dict[str, LabKernel] = make_lab_kernels()


def reset_counts() -> None:
    """Set the counts of :data:`LAB_KERNELS` to 0."""
    for kern in LAB_KERNELS.values():
        kern.launches = kern.plain_calls = 0


def counts() -> Dict[str, Tuple[int, int]]:
    """``{kernel: (launches, plain_calls)}`` of :data:`LAB_KERNELS`."""
    return {name: (kern.launches, kern.plain_calls) for name, kern in LAB_KERNELS.items()}
