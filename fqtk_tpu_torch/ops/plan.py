"""Static plan of the matcher kernel: tiling and top-2 scheme for ``k``
local whitelist columns, and the class-major mismatch table.

The port's own copy of ``KernelPlan``, ``plan_local_kernel`` and
``_compat_classmajor`` from ``fqtk_tpu/ops/pallas_matcher.py`` (``:65-248``,
pure NumPy; the two packages share no Python module).  The port does not
run kernels at this plan's tiles: :func:`~fqtk_tpu_torch.ops.hopper_matcher.
hopper_scheme` reads only which top-2 scheme the plan keeps (``colmerge``),
so that the Hopper kernel that runs at a whitelist size is the counterpart
of the TPU kernel body the JAX package runs there, and the kernel lab reads
``macs_per_row``.  The comments below describe the TPU kernel's matrix unit
(MXU) and vector unit (VPU), whose bounds decide the scheme.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from .matcher import MAX_COUNT

logger = logging.getLogger(__name__)


def _compat_classmajor(
    masks: np.ndarray, k_padded: int, onehot_width: int
) -> np.ndarray:
    """Mismatch-indicator table in *class-major* row layout ``c*L + l``.

    ``pltpu.repeat(masks, W, axis=1)`` tiles the whole [TB, L] block W
    times, so kernel column ``j`` corresponds to position ``l = j % L`` and
    class ``c = j // L`` — the row order here must match.  Classes are the
    16 possible 4-bit masks (nib4 input) or the 4 pure base codes mapped to
    their masks 1/2/4/8 (packed2 input).  ``masks`` is ``[K, L] uint8``
    (``ExpectedSet.masks`` or a K-shard slice of it).
    """
    k, length = masks.shape
    if onehot_width == 4:
        c = np.array([1, 2, 4, 8], dtype=np.uint8)  # masks of codes 0..3
    else:
        c = np.arange(16, dtype=np.uint8)
    # viol[c, l, k] = 1 iff mask value c has a bit outside expected (k, l)
    viol = (c[:, None, None] & ~masks.T[None, :, :]) & 0xF
    compat = (viol != 0).astype(np.int8).reshape(onehot_width * length, k)
    if k_padded != k:
        pad = np.ones((compat.shape[0], k_padded - k), dtype=np.int8)
        compat = np.concatenate([compat, pad], axis=1)
    return compat


@dataclass(frozen=True)
class KernelPlan:
    """Static decisions for one kernel instantiation over ``k`` columns."""

    k: int
    length: int
    onehot_width: int
    wl: int
    tile_b: int
    tile_k: int
    n_k_tiles: int
    k_padded: int
    colmerge: bool
    mxu_scaled: bool
    key_s1: int
    key_s2: int
    ck: int
    ck_s1: int
    ck_s2: int
    unroll: int
    n_steps: int
    int8_mxu: bool
    interpret: bool

    @property
    def compat_scale(self) -> int:
        """Factor baked into the compat table (rides the matmul)."""
        if self.mxu_scaled:
            return self.key_s2
        if self.colmerge:
            return self.ck_s2
        return 1

    @property
    def macs_per_row(self) -> int:
        return self.k_padded * self.wl


def plan_local_kernel(
    k: int,
    length: int,
    tile_b: int = 512,
    tile_k: int = 512,
    interpret: bool = False,
    packed2: bool = False,
    mxu_dtype: str = "int8",
    _fuse_key_scale: bool = True,
    _top2_colmerge: bool = True,
    _colmerge_unroll: int = 1,
) -> KernelPlan:
    """Choose tiling and reduction scheme for ``k`` local columns."""
    if mxu_dtype not in ("int8", "bf16"):
        raise ValueError(f"mxu_dtype must be int8 or bf16, got {mxu_dtype}")
    if length > 255:
        raise ValueError(
            "pallas matcher supports barcode lengths <= 255 (combined-key "
            "exactness bound); use the XLA engine for longer barcodes"
        )
    onehot_width = 4 if packed2 else 16
    wl = length * onehot_width
    tile_k = min(tile_k, max(128, 1 << (k - 1).bit_length()))
    n_k_tiles = -(-k // tile_k)
    k_padded = n_k_tiles * tile_k

    int8_mxu = mxu_dtype == "int8"

    # MXU-fused key scaling (int8 mode): the combined key needs
    # ``counts * tile_k`` — a full [TB, TK] VPU multiply per grid step.
    # Setting the one-hot's nonzero to s1 and the compat indicator to s2
    # with s1 * s2 == tile_k makes every mismatch contribute exactly
    # tile_k *inside the matmul*, so the kernel reads the pre-scaled key
    # base straight out of the MXU and only adds the column iota.  Exact:
    # max accumulator = L * tile_k <= 255 * 8128 < 2^31.  Valid whenever
    # tile_k (always a power of two here) splits into int8-range factors.
    key_s1 = 1 << ((tile_k.bit_length() - 1 + 1) // 2)
    key_s2 = tile_k // key_s1
    # Column-merge top-2: instead of two cross-lane min reductions per K
    # step, keep elementwise running (smallest, second-smallest) keys per
    # lane column across the K tiles and lane-reduce ONCE per B tile.  The
    # per-column key only needs (count, tile-id) — the column is the lane
    # position, recovered at the end — and ``count * ck`` comes pre-scaled
    # out of the matmul (one-hot cs1, compat cs2, cs1 * cs2 == ck), so a K
    # step costs ONE scalar add plus the 3-op two-smallest merge, with no
    # reductions.  The final lane-wise top-2 extends keys to
    # (count, tile, column) lexicographic order — exactly the reference's
    # first-global-index tie-break.  Exactness: the extended key's maximum
    # (MAX_COUNT+1) * ck * tile_k must stay an int32.
    ck = 1 << max(1, (n_k_tiles - 1).bit_length())  # tile-id capacity
    ck_s1 = 1 << ((ck.bit_length() - 1 + 1) // 2)
    ck_s2 = ck // ck_s1
    colmerge = (
        _top2_colmerge
        and int8_mxu
        and tile_k & (tile_k - 1) == 0
        and ck_s1 <= 127
        and ck_s2 <= 127
        and (MAX_COUNT + 2) * ck * tile_k < (1 << 31)
    )
    mxu_scaled = (
        _fuse_key_scale and int8_mxu
        and key_s1 <= 127 and key_s2 <= 127
        # key_s1 * key_s2 must equal tile_k exactly or count/column key
        # ranges overlap (only guaranteed for power-of-two tile_k)
        and key_s1 * key_s2 == tile_k
        and not colmerge
    )
    unroll_eff = _colmerge_unroll
    if colmerge and unroll_eff > 1 and n_k_tiles % unroll_eff:
        # pad the whitelist out to a whole number of unrolled steps (pad
        # tiles behave exactly like pad columns: count == L, largest ids).
        # Feasibility is rechecked BEFORE committing: the padding can
        # double ck past the int8/int32 key bounds, and in that case we
        # keep the (already feasible) unroll=1 colmerge kernel instead of
        # padding and falling into the slower per-step scheme.
        extra = unroll_eff - n_k_tiles % unroll_eff
        nkt2 = n_k_tiles + extra
        ck2 = 1 << max(1, (nkt2 - 1).bit_length())
        ck2_s1 = 1 << ((ck2.bit_length() - 1 + 1) // 2)
        ck2_s2 = ck2 // ck2_s1
        if (
            ck2_s1 <= 127 and ck2_s2 <= 127
            and (MAX_COUNT + 2) * ck2 * tile_k < (1 << 31)
        ):
            n_k_tiles = nkt2
            k_padded = n_k_tiles * tile_k
            ck, ck_s1, ck_s2 = ck2, ck2_s1, ck2_s2
        else:
            logger.info(
                "colmerge unroll %d would push the tile-id key past int8/"
                "int32 bounds at %d K tiles; keeping unroll=1",
                unroll_eff,
                nkt2,
            )
            unroll_eff = 1
    unroll = unroll_eff if colmerge else 1
    n_steps = -(-n_k_tiles // unroll)
    return KernelPlan(
        k=k,
        length=length,
        onehot_width=onehot_width,
        wl=wl,
        tile_b=tile_b,
        tile_k=tile_k,
        n_k_tiles=n_k_tiles,
        k_padded=k_padded,
        colmerge=colmerge,
        mxu_scaled=mxu_scaled,
        key_s1=key_s1,
        key_s2=key_s2,
        ck=ck,
        ck_s1=ck_s1,
        ck_s2=ck_s2,
        unroll=unroll,
        n_steps=n_steps,
        int8_mxu=int8_mxu,
        interpret=interpret,
    )

