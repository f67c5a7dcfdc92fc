"""Fixed-width bit-packed sequence vector (library parity with the
reference's ``BitEnc``, ``src/lib/bitenc.rs``).

The port's own copy of ``fqtk_tpu/core/bitenc.py`` (host code, pure
Python).  The device path does not use this packing (it takes raw bytes,
bit2 codes or nib4 masks; see ``fqtk_tpu_torch.ops.matcher``), but the
packed representation is part of the reference library surface, so it is
provided for host-side users: widths up to 8 bits packed into 32-bit
blocks, plus the asymmetric-containment ``hamming`` used for IUPAC matching.

>>> enc = BitEnc(4)
>>> enc.push_values(4, 0b1111)
>>> [enc.get(i) for i in range(4)]
[15, 15, 15, 15]
"""

from __future__ import annotations

from typing import Iterator, List


class BitEnc:
    """Packed vector of fixed-width (<= 8 bit) unsigned values."""

    def __init__(self, width: int):
        if not 1 <= width <= 8:
            raise ValueError(
                f"BitEnc only supports widths of 1-8, got {width}"
            )
        self.width = width
        self._mask = (1 << width) - 1
        self._storage: List[int] = []
        self._len = 0
        # values per 32-bit block; widths that don't divide 32 waste the
        # remainder bits, same policy as the reference (bitenc.rs:69-77)
        self._per_block = 32 // width

    @classmethod
    def with_capacity(cls, width: int, n: int) -> "BitEnc":
        """Pre-size the block storage for ``n`` values (``bitenc.rs:86-95``
        reserves ``n * width / 32`` blocks).  CPython lists have no reserve,
        so the blocks are allocated zeroed up front; ``nr_blocks`` reports
        *used* blocks, so capacity stays unobservable, as in the reference."""
        enc = cls(width)
        enc._storage = [0] * (n * width // 32)
        return enc

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def nr_blocks(self) -> int:
        # used blocks, not physical capacity (with_capacity preallocates)
        return -(-self._len // self._per_block)

    def nr_symbols(self) -> int:
        return self._len

    def clear(self) -> None:
        self._storage.clear()
        self._len = 0

    def _addr(self, i: int):
        return divmod(i, self._per_block)

    def push(self, value: int) -> None:
        block, off = self._addr(self._len)
        if block >= len(self._storage):
            self._storage.append(0)
        self._storage[block] |= (value & self._mask) << (off * self.width)
        self._len += 1

    def push_values(self, n: int, value: int) -> None:
        for _ in range(n):
            self.push(value)

    def set(self, i: int, value: int) -> None:
        # negative indices would divmod into the last block's unused tail
        # bits, corrupting hamming() (the Rust reference takes usize)
        if i >= self._len or i < 0:
            raise IndexError(i)
        block, off = self._addr(i)
        shift = off * self.width
        self._storage[block] &= ~(self._mask << shift)
        self._storage[block] |= (value & self._mask) << shift

    def get(self, i: int):
        if i >= self._len or i < 0:
            return None
        block, off = self._addr(i)
        return (self._storage[block] >> (off * self.width)) & self._mask

    def __iter__(self) -> Iterator[int]:
        for i in range(self._len):
            yield self.get(i)

    def hamming(self, other: "BitEnc", max_mismatches: int) -> int:
        """Asymmetric IUPAC-containment distance (``bitenc.rs:432-459``):

        position i mismatches iff ``self[i] & ~other[i] != 0`` — i.e. the
        observed value (self) has bits the expected value (other) does not
        allow.  Early-exits returning ``max_mismatches`` once reached.
        """
        if self._len != other._len:
            raise ValueError("Both bitenc sequences must have the same length")
        if self.width != other.width:
            raise ValueError("Both bitenc sequences must have the same width")
        count = 0
        for block_index in range(self.nr_blocks()):
            block_diff = self._storage[block_index] & ~other._storage[block_index]
            if block_diff:
                shift = 0
                for _ in range(self._per_block):
                    if (block_diff >> shift) & self._mask:
                        count += 1
                    shift += self.width
                if count >= max_mismatches:
                    return max_mismatches
        return count


def encode_bitenc(bases: bytes) -> BitEnc:
    """``encode`` into a width-4 BitEnc (reference ``mod.rs:49-61``)."""
    from .encoding import encode

    enc = BitEnc(4)
    for mask in encode(bases):
        enc.push(int(mask))
    return enc
