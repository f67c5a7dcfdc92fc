"""Device-side decoding of the native engine's transfer layouts, in PyTorch.

Counterpart of :mod:`fqtk_tpu.ops.device_encoding`.  There the byte -> mask
conversion is a chain of ~20 compares because gathers were slow on the TPU;
on a GPU (and on the CPU) one index into the 256-entry
:data:`fqtk_tpu_torch.core.encoding.ENCODE_LUT` is the plain way, with the same
semantics:

- no-call bytes ``N``/``n``/``.`` -> 15
- otherwise uppercase, then IUPAC mask (0 for non-IUPAC bytes)

The torch functions take a uint8 tensor and return int32 on the same
device; :func:`pack_bit2` is the host-side (numpy) encoder of the bit2
layout, for callers that make inputs without the native engine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encoding import ENCODE_LUT, NOCALL_LUT


def _lut(table: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(table.astype(np.int32), device=device)


def byte_to_mask(obs_bytes: torch.Tensor) -> torch.Tensor:
    """uint8 byte tensor -> int32 4-bit mask tensor (same shape)."""
    return _lut(ENCODE_LUT, obs_bytes.device)[obs_bytes.long()]


def byte_is_nocall(obs_bytes: torch.Tensor) -> torch.Tensor:
    """uint8 byte tensor -> int32 0/1 no-call indicator (N, n, '.')."""
    return _lut(NOCALL_LUT, obs_bytes.device)[obs_bytes.long()]


def unpack_nib4(obs_in: torch.Tensor, length: int) -> torch.Tensor:
    """Unpack ``[B, ceil(L/2)]`` 4-bit-mask bytes (low nibble = even
    position) to ``[B, L]`` int32 masks."""
    b = obs_in.shape[0]
    x = obs_in.to(torch.int32)
    return torch.stack([x & 0xF, x >> 4], dim=-1).reshape(b, -1)[:, :length]


def pack_nib4(masks: torch.Tensor) -> torch.Tensor:
    """Pack ``[B, L]`` 4-bit masks (any integer type) into ``[B, ceil(L/2)]``
    uint8, low nibble = even position: the layout :func:`unpack_nib4` reads
    and the Hopper kernels take for 16-class input.  The pad nibble of an
    odd L is 0."""
    b, length = masks.shape
    padded = torch.zeros((b, length + length % 2), dtype=torch.uint8, device=masks.device)
    padded[:, :length] = masks.to(torch.uint8)
    return (padded[:, 0::2] | (padded[:, 1::2] << 4)).contiguous()


def unpack_bit2(obs_in: torch.Tensor, length: int) -> torch.Tensor:
    """Unpack ``[B, ceil(L/4)]`` 2-bit-code bytes (lowest bit pair = first
    position) to ``[B, L]`` int32 codes in 0..3.  Same bit order as
    :func:`fqtk_tpu.ops.device_encoding.unpack_bit2`, the native engine's
    packer and the prologue of ``csrc/colmerge_top2.cu``."""
    b = obs_in.shape[0]
    x = obs_in.to(torch.int32)
    parts = [(x >> (2 * i)) & 3 for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(b, -1)[:, :length]


def pack_bit2(obs_bytes: np.ndarray) -> np.ndarray:
    """Pack ``[B, L]`` pure-ACGT bytes (upper case) into ``[B, ceil(L/4)]``
    uint8 2-bit codes (A, C, G, T = 0..3; lowest bit pair = first position),
    the layout :func:`unpack_bit2` reads.  Raises on any other byte."""
    obs = np.asarray(obs_bytes, dtype=np.uint8)
    code = np.full(256, 4, dtype=np.uint8)
    code[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = code[obs]
    if (codes == 4).any():
        raise ValueError("pack_bit2 takes only the bytes A, C, G, T")
    b, length = obs.shape
    padded = np.zeros((b, -(-length // 4) * 4), dtype=np.uint8)
    padded[:, :length] = codes
    return (
        padded[:, 0::4] | (padded[:, 1::4] << 2) | (padded[:, 2::4] << 4)
        | (padded[:, 3::4] << 6)
    ).astype(np.uint8)
