"""FASTQ parsing and BGZF-compressed writing (pure-Python fallback path).

The port's own copy of ``fqtk_tpu/io/fastq.py`` (host code, no device library):
the two packages share no Python module.

Host-side equivalents of the reference's external crates:

- ``seq_io`` FASTQ reader (used at ``src/bin/commands/demux.rs:16``)
- ``pooled-writer`` + ``bgzf`` BGZF-compressed output
  (``demux.rs:755-798``) — outputs are ``.fq.gz`` in BGZF framing, so files
  are both gzip-compatible and blocked for later random access.
- ``fgoxide::Io`` transparent gzip input (``demux.rs:844-849``).

This module is the always-available Python implementation; the C++ engine in
``native/`` (loaded via :mod:`fqtk_tpu_torch.io.native`) replaces it on the hot
path and must match its bytes exactly at the decompressed level.
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib
from pathlib import Path
from typing import BinaryIO, Iterator, NamedTuple, Optional

BUFFER_SIZE = 1024 * 1024  # reference uses 1 MiB buffers (demux.rs:38)

# htslib-compatible BGZF constants
_BGZF_BLOCK_INPUT = 0xFF00  # max uncompressed payload per block
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class FastqRecord(NamedTuple):
    head: bytes  # header line without the leading '@' or newline
    seq: bytes
    qual: bytes


class FastqParseError(ValueError):
    pass


def chomp_line(line: bytes) -> bytes:
    """Strip one trailing newline and at most ONE carriage return before it.

    This is the single source of truth for the CR-tolerance rule shared by
    every Python reader and the native scanner (``native/fqtk_io.cpp``,
    ``consume one optional CR before the newline``): a line body ending in
    literal ``\\r`` bytes is preserved — ``rstrip`` would eat them all.
    """
    if line.endswith(b"\n"):
        line = line[:-1]
    if line.endswith(b"\r"):
        line = line[:-1]
    return line


def open_reader(path: str | Path) -> BinaryIO:
    """Open a possibly-gzipped file for buffered binary reading.

    Sniffs the gzip magic with ``peek`` (no consuming, no seeking), so
    non-seekable inputs — pipes, process substitution — stream correctly,
    as the reference's buffered reader does.
    """
    path = Path(path)
    buf = io.BufferedReader(open(path, "rb"), BUFFER_SIZE)
    if buf.peek(2)[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=buf), BUFFER_SIZE)  # type: ignore[arg-type]
    return buf


class FastqReader:
    """Strict 4-line FASTQ record reader over a binary stream."""

    def __init__(self, stream: BinaryIO, name: str = "<stream>"):
        self._stream = stream
        self._name = name
        self._line_no = 0

    def __iter__(self) -> Iterator[FastqRecord]:
        return self

    def _readline(self) -> bytes:
        line = self._stream.readline()
        if line:
            self._line_no += 1
        return line

    # CR-tolerance rule shared with the native scanner; see chomp_line.
    _chomp = staticmethod(chomp_line)

    def __next__(self) -> FastqRecord:
        head = self._readline()
        if not head:
            raise StopIteration
        if head[:1] != b"@":
            raise FastqParseError(
                f"{self._name}:{self._line_no}: FASTQ record header must start with '@', "
                f"got {head[:20]!r}"
            )
        seq = self._readline()
        plus = self._readline()
        qual = self._readline()
        if not qual:
            raise FastqParseError(
                f"{self._name}:{self._line_no}: truncated FASTQ record {head!r}"
            )
        if plus[:1] != b"+":
            raise FastqParseError(
                f"{self._name}:{self._line_no}: FASTQ separator line must start with '+'"
            )
        seq = self._chomp(seq)
        qual = self._chomp(qual)
        if len(seq) != len(qual):
            raise FastqParseError(
                f"{self._name}:{self._line_no}: sequence and quality lengths differ "
                f"({len(seq)} vs {len(qual)})"
            )
        return FastqRecord(self._chomp(head)[1:], seq, qual)

    def close(self) -> None:
        self._stream.close()


def read_fastq(path: str | Path) -> list[FastqRecord]:
    """Read all records of a (possibly gzipped) FASTQ file."""
    reader = FastqReader(open_reader(path), str(path))
    try:
        return list(reader)
    finally:
        reader.close()


class BgzfWriter:
    """BGZF block-compressed writer (gzip members with the BC extra field).

    Produces byte streams readable by any gzip reader and terminated with the
    standard 28-byte BGZF EOF marker, like the reference's ``bgzf`` crate.
    """

    def __init__(self, path: str | Path, compression_level: int = 5):
        self._fh: Optional[BinaryIO] = open(path, "wb")
        self._level = compression_level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _BGZF_BLOCK_INPUT:
            self._emit_block(bytes(self._buf[:_BGZF_BLOCK_INPUT]))
            del self._buf[:_BGZF_BLOCK_INPUT]

    def _emit_block(self, payload: bytes) -> None:
        assert self._fh is not None
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        body = comp.compress(payload) + comp.flush()
        bsize = len(body) + 25  # header(12) + extra(6) + crc(4) + isize(4) - 1
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
            0,  # mtime
            0, 0xFF,  # XFL, OS=unknown
            6,  # XLEN
            0x42, 0x43, 2,  # 'B', 'C', SLEN
            bsize,
        )
        trailer = struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)
        self._fh.write(header + body + trailer)

    def flush_block(self) -> None:
        if self._buf:
            self._emit_block(bytes(self._buf))
            self._buf.clear()

    def close(self) -> None:
        if self._fh is None:
            return
        self.flush_block()
        self._fh.write(_BGZF_EOF)
        self._fh.close()
        self._fh = None

    def __enter__(self) -> "BgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
