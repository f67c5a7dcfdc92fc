"""SipHash-1-3 and Rust ``DefaultHasher`` seed derivation.

The port's own copy of ``fqtk_tpu/utils/siphash.py`` (host code, no device library):
the two packages share no Python module.

The reference derives the no-seed subsample RNG seed by hashing the CLI
struct with Rust's ``std::collections::hash_map::DefaultHasher``
(``src/bin/commands/subsample.rs:92-129``).  DefaultHasher is
``SipHasher13`` keyed with (0, 0); field values reach it through Rust's
``Hash`` trait encoding.  This module reproduces both layers:

1. :func:`siphash13` — the SipHash-1-3 core (1 compression round, 3
   finalization rounds), byte-stream semantics identical to Rust's
   ``sip.rs``.  Golden-tested against CPython's independent siphash13
   implementation (CPython >= 3.11 hashes ``bytes`` with siphash13; with
   ``PYTHONHASHSEED=0`` its key is zero — see ``tests/test_siphash.py``).
2. :class:`RustDefaultHasher` — the ``Hasher`` surface used by derived/
   manual ``Hash`` impls on 64-bit little-endian targets: integer writes are
   little-endian fixed-width, ``write_length_prefix`` is ``write_usize``.
3. :func:`hash_path` — ``std::path::Path``'s Hash impl (unix): component
   bytes written without separators, ``.`` components following a separator
   skipped, followed by ``write_usize(bytes_hashed)``.
4. :func:`subsample_effective_seed` — the exact field order of the
   reference's manual ``Hash for Subsample`` impl (``subsample.rs:92-102``):
   inputs (length-prefixed Vec of Path), output Path, ``fraction.to_bits()``,
   threads, compression_level, ``Option<u64>`` seed (discriminant as isize,
   then the value), and the bool flag.

The SipHash core is cross-validated against CPython; the Rust ``Hash``
encoding layer is implemented from the Rust std sources (no Rust toolchain
exists in this environment to emit golden vectors for the composition).
"""

from __future__ import annotations

from typing import List, Optional

_MASK = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def _sipround(v0: int, v1: int, v2: int, v3: int):
    v0 = (v0 + v1) & _MASK
    v1 = _rotl(v1, 13)
    v1 ^= v0
    v0 = _rotl(v0, 32)
    v2 = (v2 + v3) & _MASK
    v3 = _rotl(v3, 16)
    v3 ^= v2
    v0 = (v0 + v3) & _MASK
    v3 = _rotl(v3, 21)
    v3 ^= v0
    v2 = (v2 + v1) & _MASK
    v1 = _rotl(v1, 17)
    v1 ^= v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def siphash13(data: bytes, k0: int = 0, k1: int = 0) -> int:
    """SipHash-1-3 of ``data`` with key (k0, k1); returns u64."""
    v0 = 0x736F6D6570736575 ^ k0
    v1 = 0x646F72616E646F6D ^ k1
    v2 = 0x6C7967656E657261 ^ k0
    v3 = 0x7465646279746573 ^ k1
    n = len(data)
    end = n - (n % 8)
    for i in range(0, end, 8):
        m = int.from_bytes(data[i : i + 8], "little")
        v3 ^= m
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m
    b = ((n & 0xFF) << 56) | int.from_bytes(data[end:], "little")
    v3 ^= b
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 ^= b
    v2 ^= 0xFF
    for _ in range(3):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK


class RustDefaultHasher:
    """Streaming ``DefaultHasher`` (``SipHasher13::new_with_keys(0, 0)``)
    with Rust's 64-bit little-endian ``Hasher`` integer encodings."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data

    def write_u8(self, x: int) -> None:
        self._buf += bytes([x & 0xFF])

    def write_u64(self, x: int) -> None:
        self._buf += (x & _MASK).to_bytes(8, "little")

    # on 64-bit targets usize/isize are u64-wide; isize two's-complement
    write_usize = write_u64
    write_isize = write_u64

    def write_length_prefix(self, n: int) -> None:
        # default Hasher::write_length_prefix == write_usize (Rust std)
        self.write_usize(n)

    def finish(self) -> int:
        return siphash13(bytes(self._buf))


def hash_path(h: RustDefaultHasher, path: str) -> None:
    """``impl Hash for std::path::Path`` (unix: no prefix, separator ``/``).

    Writes each component's bytes (skipping separators and ``.`` components
    that follow a separator, as ``components()`` would normalize away), then
    ``write_usize`` of the total bytes written.  Mirrors Rust std
    ``library/std/src/path.rs``.
    """
    b = path.encode("utf-8", "surrogateescape")
    component_start = 0
    bytes_hashed = 0
    i = 0
    n = len(b)
    while i < n:
        if b[i : i + 1] == b"/":
            if i > component_start:
                chunk = b[component_start:i]
                h.write(chunk)
                bytes_hashed += len(chunk)
            component_start = i + 1
            tail = b[component_start:]
            # skip a lone "." component after the separator
            if tail == b"." or tail[:2] == b"./":
                component_start += 1
        i += 1
    if component_start < n:
        chunk = b[component_start:]
        h.write(chunk)
        bytes_hashed += len(chunk)
    h.write_usize(bytes_hashed)


def _f64_to_bits(x: float) -> int:
    import struct

    return struct.unpack("<Q", struct.pack("<d", x))[0]


def subsample_effective_seed(
    inputs: List[str],
    output: str,
    fraction: float,
    threads: int,
    compression_level: int,
    seed: Optional[int],
    disable_read_name_checking: bool,
) -> int:
    """``Subsample::effective_seed`` for the no-seed case: DefaultHasher over
    the struct fields in declaration-independent manual-impl order
    (``subsample.rs:92-102``), then ``finish()``."""
    h = RustDefaultHasher()
    # Vec<PathBuf>: write_length_prefix(len) then each element
    h.write_length_prefix(len(inputs))
    for p in inputs:
        hash_path(h, p)
    hash_path(h, output)
    h.write_u64(_f64_to_bits(fraction))  # fraction.to_bits()
    h.write_usize(threads)
    h.write_usize(compression_level)
    # Option<u64>: derived Hash = discriminant (isize) then payload
    if seed is None:
        h.write_isize(0)
    else:
        h.write_isize(1)
        h.write_u64(seed)
    h.write_u8(1 if disable_read_name_checking else 0)
    return h.finish()
