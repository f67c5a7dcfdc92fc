"""Sample metadata model and TSV loading.

The port's own copy of ``fqtk_tpu/core/samples.py`` (host code, no device library):
the two packages share no Python module.

Equivalent of the reference's ``Sample``/``SampleGroup``
(``src/lib/samples.rs:17-147``), including its validation
messages, which are part of the operator-facing contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Sequence

from .encoding import is_valid_iupac

_HEADER_FIELDS = ("sample_id", "barcode")
_FILE_DELIMITER = "\t"


class SampleError(ValueError):
    """Raised on malformed sample metadata (reference panics/errors)."""


@dataclass
class Sample:
    sample_id: str
    barcode: str
    ordinal: int = 0

    @classmethod
    def new(cls, ordinal: int, name: str, barcode: str) -> "Sample":
        """Validating constructor (reference ``samples.rs:49-57``)."""
        if not name:
            raise SampleError("Sample name cannot be empty")
        if not barcode:
            raise SampleError("Sample barcode cannot be empty")
        if not all(is_valid_iupac(b) for b in barcode.encode("ascii", "replace")):
            raise SampleError(
                "All sample barcode bases must be one of A, C, G, T, U, R, Y, S, W, K, M, D, V, H, B, N"
            )
        return cls(sample_id=name, barcode=barcode, ordinal=ordinal)

    @staticmethod
    def deserialize_header_line() -> str:
        return _FILE_DELIMITER.join(_HEADER_FIELDS)

    def __str__(self) -> str:
        return (
            f"Sample({self.ordinal:04d}) - {{ name: {self.sample_id}\tbarcode: {self.barcode} }}"
        )


@dataclass
class SampleGroup:
    samples: List[Sample] = field(default_factory=list)

    @classmethod
    def from_samples(cls, samples: Sequence[Sample]) -> "SampleGroup":
        """Validate and re-ordinal a list of samples (``samples.rs:101-133``)."""
        if not samples:
            raise SampleError("Must provide one or more sample")
        ids = [s.sample_id for s in samples]
        if len(set(ids)) != len(ids):
            raise SampleError("Each sample name must be unique, duplicate identified")
        barcodes = [s.barcode for s in samples]
        if len(set(barcodes)) != len(barcodes):
            raise SampleError("Each sample barcode must be unique, duplicate identified")
        first_len = len(samples[0].barcode)
        if not all(len(b) == first_len for b in barcodes):
            raise SampleError("All barcodes must have the same length")
        return cls(
            samples=[
                Sample.new(ordinal, s.sample_id, s.barcode)
                for ordinal, s in enumerate(samples)
            ]
        )


    def __str__(self) -> str:
        lines = ["SampleGroup {"]
        for s in self.samples:
            lines.append(f"    {s}")
        lines.append("}")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_file(cls, path: str | Path) -> "SampleGroup":
        """Load from a headered TSV with ``sample_id`` and ``barcode`` columns.

        Mirrors fgoxide ``DelimFile`` semantics used by the reference
        (``samples.rs:144-147``): the header line must match the expected
        fields exactly; empty lines are skipped.
        """
        path = Path(path)
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        if not lines or (len(lines) == 1 and not lines[0].strip()):
            raise SampleError("Must provide one or more sample")
        # fgoxide loads via csv+serde, which maps columns BY HEADER NAME:
        # extra or reordered columns are accepted; a missing required column
        # errors (samples.rs:144-147)
        header_fields = lines[0].split(_FILE_DELIMITER)
        try:
            col_idx = {f: header_fields.index(f) for f in _HEADER_FIELDS}
        except ValueError:
            missing = [f for f in _HEADER_FIELDS if f not in header_fields]
            raise SampleError(
                f"Missing required column(s) {missing} in delimited file header: "
                f"{lines[0]!r}"
            ) from None
        samples: List[Sample] = []
        for line in lines[1:]:
            if not line.strip():
                continue
            fields = line.split(_FILE_DELIMITER)
            # the csv crate is strict about record length vs the header
            if len(fields) != len(header_fields):
                raise SampleError(
                    f"Record with {len(fields)} fields does not match header with "
                    f"{len(header_fields)} fields: {line!r}"
                )
            samples.append(
                Sample(
                    sample_id=fields[col_idx["sample_id"]],
                    barcode=fields[col_idx["barcode"]],
                )
            )
        return cls.from_samples(samples)
