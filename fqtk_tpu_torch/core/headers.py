"""FASTQ header rewriting for demultiplexed output records.

The port's own copy of ``fqtk_tpu/core/headers.py`` (host code, no device library):
the two packages share no Python module.

Behavioral equivalent of the reference's ``ReadSet::write_header_internal``
(``src/bin/commands/demux.rs:171-267``):

- header = ``name[ comment]``; name has at most 8 colon-separated parts.
- UMI segments (if any) are joined with ``+`` and appended to the name: after
  a ``+`` if the name already has 8 parts (existing UMI), else after a ``:``.
- The comment is rewritten to 4 colon-separated parts
  ``<read_num>:<is filtered>:<control number>:<index>``; a missing comment
  becomes ``{read_num}:N:0:``; Illumina's trailing ``0`` index placeholder
  (any single trailing digit) is dropped; sample-barcode segments are joined
  with ``+`` and appended to the index field (after ``+`` if an index value
  is already present).

This module is the executable spec; the C++ fast path in ``native/`` must
produce byte-identical output (tested in ``tests/test_headers.py`` and the
native-vs-python fuzz in ``tests/test_fuzz_differential.py``).
"""

from __future__ import annotations

from typing import Sequence


class HeaderError(ValueError):
    pass


def rewrite_header(
    header: bytes,
    read_num: int,
    sample_barcode_seqs: Sequence[bytes],
    molecular_seqs: Sequence[bytes],
) -> bytes:
    """Return the full rewritten header line, including the leading ``@``."""
    space = header.find(b" ")
    if space >= 0:
        name, comment = header[:space], header[space + 1 :]
        has_comment = True
    else:
        name, comment = header, b""
        has_comment = False

    out = bytearray(b"@")

    # Name part: append UMIs if any molecular segments are present.
    if molecular_seqs:
        sep_count = name.count(b":")
        if sep_count > 7:
            raise HeaderError(
                "Can't handle read name with more than 8 segments: "
                + header.decode("utf-8", "replace")
            )
        out += name
        out += b"+" if sep_count == 7 else b":"
        out += b"+".join(molecular_seqs)
    else:
        out += name

    out += b" "

    # Comment part.
    if not has_comment:
        # Assume passing-filter, non-control read; barcode appended below.
        out += b"%d:N:0:" % read_num
    else:
        sep_count = comment.count(b":")
        if sep_count < 3:
            if not comment:
                # A header ending in a space has an empty comment; the
                # reference fail-fasts here (`chars.last().unwrap()` panics
                # on None, demux.rs:231).  Matched, with a clearer message.
                raise HeaderError(
                    "Header comment is empty: "
                    + header.decode("utf-8", "replace")
                )
            out += comment
            if comment[-1:] != b":":
                out += b":"
        else:
            if sep_count != 3:
                raise HeaderError(
                    "Comment in did not have 4 segments: "
                    + header.decode("utf-8", "replace")
                )
            first_colon = comment.index(b":")
            # Illumina can place a "0" placeholder in the index position of
            # unmatched FASTQs; drop a single trailing digit.
            if comment[-1:].isdigit():
                remainder = comment[first_colon + 1 : -1]
            else:
                remainder = comment[first_colon + 1 :]
            if not remainder:
                # Unreachable for a 4-part comment (the first colon cannot
                # be the last character when three colons follow it), but
                # the reference's `remainder.last().unwrap()` (demux.rs:251)
                # would panic here — matched defensively.
                raise HeaderError(
                    "Header comment index section is empty: "
                    + header.decode("utf-8", "replace")
                )
            out += b"%d:" % read_num
            out += remainder
            if remainder[-1:] != b":":
                out += b"+"

    out += b"+".join(sample_barcode_seqs)
    return bytes(out)
