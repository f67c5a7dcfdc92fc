"""IUPAC one-hot (4-bit mask) encoding of DNA bases.

The port's own copy of ``fqtk_tpu/core/encoding.py`` (host code, no device library):
the two packages share no Python module.

Counterpart of the reference's bit-packed encoding
(``src/lib/mod.rs:7-92`` and ``src/lib/bitenc.rs``): instead of
packing 4-bit codes into ``u32`` blocks for scalar popcount loops, we keep one
``uint8`` mask per base laid out in flat arrays, because the
mismatch-count reduction is a batched product over a one-hot expansion (see
``fqtk_tpu_torch.ops.hopper_matcher``).

Mask semantics (same as the reference): bit0=A, bit1=C, bit2=G, bit3=T.  An
expected-barcode base "allows" the set of concrete bases in its mask; an
observed base mismatches iff its mask contains any bit not allowed by the
expected mask (``obs & ~exp != 0`` — asymmetric IUPAC containment, reference
``bitenc.rs:432-459``).
"""

from __future__ import annotations

import numpy as np

DNA_BASES = b"ACGTN"
IUPAC_BASES = b"ACGTMRWSYKVHDBN"

BASE_A = 1
BASE_C = 2
BASE_G = 4
BASE_T = 8
BASE_N = 15

_NOCALL_BYTES = (ord("N"), ord("n"), ord("."))


def _build_masks(iupac: bool) -> np.ndarray:
    masks = np.zeros(256, dtype=np.uint8)
    a, c, g, t = BASE_A, BASE_C, BASE_G, BASE_T
    table = {"A": a, "C": c, "G": g, "T": t, "U": t, "N": a | c | g | t}
    if iupac:
        table.update(
            {
                "M": a | c,
                "R": a | g,
                "W": a | t,
                "S": c | g,
                "Y": c | t,
                "K": g | t,
                "V": a | c | g,
                "H": a | c | t,
                "D": a | g | t,
                "B": c | g | t,
            }
        )
    for ch, mask in table.items():
        masks[ord(ch)] = mask
    return masks


#: Masks for plain DNA bases only (reference ``mod.rs:15-25``).
DNA_MASKS: np.ndarray = _build_masks(iupac=False)
#: Masks for the full IUPAC alphabet (reference ``mod.rs:26-46``).
IUPAC_MASKS: np.ndarray = _build_masks(iupac=True)


def _build_encode_lut() -> np.ndarray:
    """LUT reproducing the reference's ``encode`` (``mod.rs:49-61``):

    - no-call bytes (``N``/``n``/``.``) -> 15
    - otherwise: uppercase, then IUPAC mask (0 for any non-IUPAC byte)
    """
    lut = np.zeros(256, dtype=np.uint8)
    for b in range(256):
        if b in _NOCALL_BYTES:
            lut[b] = BASE_N
        else:
            upper = b - 32 if ord("a") <= b <= ord("z") else b
            lut[b] = IUPAC_MASKS[upper]
    return lut


#: byte -> 4-bit mask lookup used for both host and device encoding.
ENCODE_LUT: np.ndarray = _build_encode_lut()

#: byte -> 1 if the byte is a no-call (``N``/``n``/``.``), else 0.
NOCALL_LUT: np.ndarray = np.zeros(256, dtype=np.uint8)
for _b in _NOCALL_BYTES:
    NOCALL_LUT[_b] = 1

_DECODE_LUT = np.full(16, 0, dtype=np.uint8)
for _base in IUPAC_BASES:
    _DECODE_LUT[IUPAC_MASKS[_base]] = _base


def byte_is_nocall(byte: int) -> bool:
    """True for 'N', 'n' and '.' (reference ``mod.rs:85-87``)."""
    return byte in _NOCALL_BYTES


def is_valid_iupac(byte: int) -> bool:
    """True for uppercase IUPAC codes, 'U', and no-calls (``mod.rs:90-92``)."""
    return IUPAC_MASKS[byte] != 0 or byte_is_nocall(byte)


def encode(bases: bytes | np.ndarray) -> np.ndarray:
    """Encode ASCII bases to 4-bit masks (uint8 array, one mask per base)."""
    arr = np.frombuffer(bases, dtype=np.uint8) if isinstance(bases, (bytes, bytearray)) else np.asarray(bases, dtype=np.uint8)
    return ENCODE_LUT[arr]


def decode(masks: np.ndarray) -> str:
    """Decode 4-bit masks back to an IUPAC string (``mod.rs:68-82``).

    Raises ``ValueError`` on a mask with no IUPAC letter (i.e. 0).
    """
    masks = np.asarray(masks, dtype=np.uint8)
    if masks.size and (masks == 0).any() or (masks > 15).any():
        bad = masks[(masks == 0) | (masks > 15)][0]
        raise ValueError(f"Invalid bit mask for base: {bad}")
    return _DECODE_LUT[masks].tobytes().decode("ascii")


def count_nocalls(bases: bytes | np.ndarray) -> int:
    """Number of no-call bytes in ``bases``."""
    arr = np.frombuffer(bases, dtype=np.uint8) if isinstance(bases, (bytes, bytearray)) else np.asarray(bases, dtype=np.uint8)
    return int(NOCALL_LUT[arr].sum())
