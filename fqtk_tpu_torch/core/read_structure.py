"""Read-structure parsing and segment extraction.

The port's own copy of ``fqtk_tpu/core/read_structure.py`` (host code, no device library):
the two packages share no Python module.

Host-side equivalent of the external ``read-structure`` crate used by the
reference (``src/bin/commands/demux.rs:13-15``; grammar
documented at ``README.md`` and fgbio's Read Structures wiki).

A read structure is a sequence of ``<number><operator>`` pairs, e.g.
``8B92T``.  Five operators are recognized:

- ``T`` template bases
- ``B`` sample barcode bases
- ``M`` molecular barcode (UMI) bases
- ``C`` cellular barcode bases
- ``S`` bases to skip

The final pair may use ``+`` instead of a number, meaning "all remaining
bases" (variable length); only the last segment may be variable.

Segment offsets are static, so for the device pipeline they compile to fixed
slice plans over batched byte arrays (no per-read control flow on device).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple


class ReadStructureError(ValueError):
    pass


class SegmentType(enum.Enum):
    Template = "T"
    SampleBarcode = "B"
    MolecularBarcode = "M"
    CellularBarcode = "C"
    Skip = "S"

    @classmethod
    def from_char(cls, ch: str) -> "SegmentType":
        try:
            return cls(ch.upper())
        except ValueError:
            raise ReadStructureError(
                f"Invalid segment type: {ch}. Must be one of T, B, M, C, S."
            ) from None

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


#: Output-file type code per segment type (reference ``demux.rs:674-680``):
#: template->R, sample barcode->I, molecular barcode->U, cellular barcode->C.
FILE_TYPE_CODE = {
    SegmentType.Template: "R",
    SegmentType.SampleBarcode: "I",
    SegmentType.MolecularBarcode: "U",
    SegmentType.CellularBarcode: "C",
    SegmentType.Skip: "S",
}


@dataclass(frozen=True)
class ReadSegment:
    """One segment of a read structure with a fixed on-read offset."""

    offset: int
    length: Optional[int]  # None means variable length ("+")
    kind: SegmentType

    @property
    def is_variable(self) -> bool:
        return self.length is None

    def min_length(self) -> int:
        """Minimum bases this segment needs (variable segments need >=1,
        reference ``demux.rs:298``)."""
        return 1 if self.length is None else self.length

    def extract_bases_and_quals(
        self, bases: bytes, quals: bytes
    ) -> Tuple[bytes, bytes]:
        """Slice this segment's bases/quals out of a full read.

        Raises ``ReadStructureError`` if the read is too short, mirroring the
        errors the reference surfaces through
        ``read_segment.extract_bases_and_quals`` (``demux.rs:316-330``).
        """
        end = len(bases) if self.length is None else self.offset + self.length
        if end > len(bases) or self.offset >= end:
            raise ReadStructureError(
                f"Read ends before the end of the segment: {self}"
            )
        if end > len(quals):
            raise ReadStructureError(
                f"Quals end before the end of the segment: {self}"
            )
        return bases[self.offset : end], quals[self.offset : end]

    def __str__(self) -> str:
        num = "+" if self.length is None else str(self.length)
        return f"{num}{self.kind.value}"


class ReadStructure:
    """Parsed read structure; iterable over :class:`ReadSegment`."""

    def __init__(self, segments: Tuple[ReadSegment, ...], raw: str):
        self.segments = segments
        self._raw = raw

    @classmethod
    def from_str(cls, text: str) -> "ReadStructure":
        s = text.strip().upper()
        if not s:
            raise ReadStructureError(f"Read structure cannot be empty: {text}")
        segments = []
        offset = 0
        i = 0
        while i < len(s):
            if s[i] == "+":
                length = None
                i += 1
            else:
                j = i
                while j < len(s) and s[j].isdigit():
                    j += 1
                if j == i:
                    raise ReadStructureError(
                        f"Read structure missing length before operator: {text}"
                    )
                length = int(s[i:j])
                if length == 0:
                    raise ReadStructureError(
                        f"Read structure segment length cannot be zero: {text}"
                    )
                i = j
            if i >= len(s):
                raise ReadStructureError(
                    f"Read structure ended with no operator: {text}"
                )
            kind = SegmentType.from_char(s[i])
            i += 1
            segments.append(ReadSegment(offset=offset, length=length, kind=kind))
            if length is None and i < len(s):
                raise ReadStructureError(
                    f"Variable-length ('+') segment must be the last segment: {text}"
                )
            offset += length if length is not None else 0
        return cls(tuple(segments), s)

    def __iter__(self) -> Iterator[ReadSegment]:
        return iter(self.segments)

    def __len__(self) -> int:
        return len(self.segments)

    def number_of_segments(self) -> int:
        return len(self.segments)

    def segments_by_type(self, kind: SegmentType) -> Tuple[ReadSegment, ...]:
        return tuple(s for s in self.segments if s.kind == kind)

    def min_length(self) -> int:
        """Minimum read length required (reference ``demux.rs:298``)."""
        return sum(s.min_length() for s in self.segments)

    @property
    def has_variable(self) -> bool:
        return any(s.is_variable for s in self.segments)

    def __str__(self) -> str:
        return "".join(str(s) for s in self.segments)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ReadStructure({self})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ReadStructure) and self.segments == other.segments

    def __hash__(self) -> int:
        return hash(self.segments)
