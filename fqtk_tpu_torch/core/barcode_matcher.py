"""Single-read barcode matcher (library parity with the reference's
``BarcodeMatcher``, ``src/lib/barcode_matching.rs``).

The port's own copy of ``fqtk_tpu/core/barcode_matcher.py``, over this
package's NumPy spec (:func:`fqtk_tpu_torch.ops.matcher.mismatch_counts_np`)
and encoding tables.  The demux pipeline uses the batched matchers, which
subsume the reference's memo cache via batching.  This class provides the
same single-read host API as the reference library — including the optional
result cache — for users who consumed ``fqtk_lib`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.matcher import ExpectedSet, mismatch_counts_np
from .encoding import count_nocalls
from .samples import Sample


@dataclass(frozen=True)
class BarcodeMatch:
    """Best / second-best match info (``barcode_matching.rs:16-25``)."""

    best_match: int
    best_mismatches: int
    next_best_mismatches: int


class BarcodeMatcher:
    def __init__(
        self,
        samples: Sequence[Sample],
        max_mismatches: int,
        min_mismatch_delta: int,
        use_cache: bool = True,
    ):
        if not samples:
            raise ValueError("Must provide at least one sample")
        if any(not s.barcode for s in samples):
            raise ValueError("Sample barcode cannot be empty string")
        self.samples: List[Sample] = [
            Sample(s.sample_id, s.barcode.upper(), s.ordinal) for s in samples
        ]
        self.expected = ExpectedSet.from_barcodes([s.barcode for s in self.samples])
        self.max_mismatches = max_mismatches
        self.min_mismatch_delta = min_mismatch_delta
        self.use_cache = use_cache
        self._cache: Dict[bytes, BarcodeMatch] = {}

    @property
    def expected_barcode_length(self) -> int:
        return self.expected.length

    def count_mismatches(self, observed: bytes, expected: bytes) -> int:
        """Mismatches between two equal-length barcodes (asymmetric IUPAC)."""
        if len(observed) != len(expected):
            from .encoding import decode, encode

            raise ValueError(
                f"Read barcode ({decode(encode(observed))}) length "
                f"({len(observed)}) differs from expected barcode "
                f"({expected.decode()}) length ({len(expected)})"
            )
        es = ExpectedSet.from_barcodes([expected.decode()])
        obs = np.frombuffer(observed, dtype=np.uint8)[None, :]
        return int(mismatch_counts_np(obs, es)[0, 0])

    def _assign_internal(self, read_bases: bytes) -> Optional[BarcodeMatch]:
        if len(read_bases) != self.expected.length:
            from .encoding import decode, encode

            s0 = self.samples[0]
            raise ValueError(
                f"Read barcode ({decode(encode(read_bases))}) length "
                f"({len(read_bases)}) differs from expected barcode "
                f"({s0.barcode}) length ({self.expected.length}) for sample "
                f"{s0.sample_id}"
            )
        obs = np.frombuffer(read_bases, dtype=np.uint8)[None, :]
        counts = mismatch_counts_np(obs, self.expected)[0]
        best_idx = int(counts.argmin())
        best = int(counts[best_idx])
        if self.expected.count > 1:
            rest = np.delete(counts, best_idx)
            next_best = int(min(rest.min(), 255))
        else:
            next_best = 255
        if best > self.max_mismatches or (next_best - best) < self.min_mismatch_delta:
            return None
        return BarcodeMatch(best_idx, best, next_best)

    def assign(self, read_bases: bytes) -> Optional[BarcodeMatch]:
        """Reference semantics (``barcode_matching.rs:165-186``): length gate,
        no-call prefilter, then (cached) best/second-best with gates."""
        if len(read_bases) < self.expected_barcode_length:
            return None
        num_no_calls = count_nocalls(read_bases)
        if num_no_calls > self.max_mismatches + self.expected.max_ns_in_barcodes:
            return None
        if self.use_cache:
            hit = self._cache.get(read_bases)
            if hit is not None:
                return hit
            result = self._assign_internal(read_bases)
            if result is not None:  # only successful matches are cached
                self._cache[bytes(read_bases)] = result
            return result
        return self._assign_internal(read_bases)
