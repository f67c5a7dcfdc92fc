"""The randomized demux scenarios of the differential campaign
(:mod:`fqtk_tpu_torch.scripts.deep_campaign`): the port's own copy of
``tests/test_fuzz_differential.py``'s ``_random_scenario`` (``:17-101``) and
the constants it draws from, and of ``scripts/deep_campaign.py``'s ``_pack``.

The same ``random.Random`` state writes the same files, structures and
metadata, byte for byte, and leaves the generator in the same state, as the
original (``tests/test_torch_deep_campaign.py`` holds it so).  ``info``, when
given, receives the scenario's classes; it draws nothing."""

from __future__ import annotations

import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..core.encoding import ENCODE_LUT

BASES = "ACGT"
IUPAC = "ACGTMRWSYKVHDBN"


def _random_scenario(
    rng: random.Random, tmp_path: Path, scenario_id: int, info: Optional[dict] = None
) -> Tuple[List[Path], List[str], Path]:
    """``(inputs, structures, metadata path)`` of one scenario, written under
    ``tmp_path``: 1, 2 or 4 inputs, random segment structures, 2-24 unique
    same-length barcodes (IUPAC in about 30% of scenarios), 30-120 reads of
    near-misses, random and too-short sequences with wildcard bytes, and in
    about 25% of scenarios duplicate-heavy ("clustered") reads.  ``info``
    gets ``iupac`` and ``clustered``."""
    n_inputs = rng.choice([1, 2, 4])
    n_samples = rng.choice([2, 7, 24])
    n_reads = rng.randint(30, 120)

    # structures: each input gets barcode and/or template segments
    structures = []
    bc_total = 0
    for i in range(n_inputs):
        segs = []
        r = rng.random()
        if r < 0.6 or n_inputs == 1:
            blen = rng.randint(4, 10)
            segs.append(f"{blen}B")
            bc_total += blen
        if rng.random() < 0.4:
            segs.append(f"{rng.randint(2, 6)}M")
        if rng.random() < 0.3:
            segs.append(f"{rng.randint(1, 5)}S")
        if rng.random() < 0.5 and rng.random() < 0.5:
            segs.append(f"{rng.randint(3, 8)}C")
        segs.append("+T" if rng.random() < 0.5 else f"{rng.randint(5, 30)}T")
        structures.append("".join(segs))
    if bc_total == 0:
        structures[0] = "6B" + structures[0]
        bc_total = 6

    # unique same-length barcodes, occasionally IUPAC
    iupac = rng.random() < 0.3
    alphabet = IUPAC if iupac else BASES + "N"
    barcodes = set()
    while len(barcodes) < n_samples:
        barcodes.add("".join(rng.choice(alphabet) for _ in range(bc_total)))
    barcodes = sorted(barcodes)
    meta = tmp_path / f"meta{scenario_id}.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"s{i}\t{b}\n" for i, b in enumerate(barcodes))
    )

    # reads: mostly near-misses of real barcodes + random + some too-short
    def min_len(structure):
        total, num = 0, ""
        for ch in structure:
            if ch.isdigit():
                num += ch
            elif ch == "+":
                num = "1"
            else:
                total += int(num)
                num = ""
        return total

    inputs = []
    # 'X' and '-' encode to IUPAC mask 0: wildcards that never mismatch any
    # expected base (a zero observed nibble)
    read_alpha = BASES + "N" + "acgtn" + "RY" + "X-"
    # duplicate-heavy reads drawn from a small pool: the single-cell shape
    # that engages the window dedup (runtime/demux.py _wrap_window_dedup)
    clustered = rng.random() < 0.25
    for i in range(n_inputs):
        ml = min_len(structures[i])
        pool = [
            "".join(rng.choice(read_alpha) for _ in range(ml + rng.randint(0, 8)))
            for _ in range(rng.randint(2, max(3, n_reads // 8)))
        ]
        lines = []
        for r in range(n_reads):
            if rng.random() < 0.05:
                seq = "".join(rng.choice(BASES) for _ in range(max(0, ml - 1)))
            elif clustered and rng.random() < 0.9:
                seq = rng.choice(pool)
            else:
                seq = "".join(
                    rng.choice(read_alpha) for _ in range(ml + rng.randint(0, 8))
                )
            comment = rng.choice(["", " 1:N:0:0", " 1:Y:0:AACC", " x:y"])
            lines.append(f"@r_{r}{comment}\n{seq}\n+\n{'I' * len(seq)}\n")
        p = tmp_path / f"in{scenario_id}_{i}.fq"
        p.write_text("".join(lines))
        inputs.append(p)

    if info is not None:
        info.update(iupac=iupac, clustered=clustered)
    return inputs, structures, meta


def _pack(obs: np.ndarray) -> np.ndarray:
    """``[B, L]`` bytes -> ``[B, ceil(L/2)]`` nib4 (two 4-bit IUPAC masks a
    byte, the even position in the low nibble; an odd L's pad nibble 0),
    the host matchers' input."""
    masks = ENCODE_LUT[obs].astype(np.uint8)
    n, length = masks.shape
    if length % 2:
        masks = np.concatenate([masks, np.zeros((n, 1), np.uint8)], axis=1)
    return (masks[:, 0::2] | (masks[:, 1::2] << 4)).astype(np.uint8)
