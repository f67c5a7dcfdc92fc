"""Times ``colmerge_top2`` and ``tile_top2`` at the main paths' shapes.

    python -m fqtk_tpu_torch.lab.time_top2 [TAG]

For each kernel, shape (K, L, B) and input form (4 classes: bit2 rows; 16:
nib4 rows of the same reads, against a 16-class table): a seeded whitelist
of K random barcodes, B reads (drawn from the list, 30% with one random
base, a fifth fully random), the median CUDA-event time of a launch, the
time per launch of a back-to-back loop (host enqueue included) and a
checksum of the three outputs.  The last line is one JSON object ``{TAG:
{...}}``.

To compare two commits on one card, run this file in turns against each
checkout inside one job (two jobs may land on two cards): the file uses only
names both trees have, so ``PYTHONPATH=<other checkout> python
fqtk_tpu_torch/lab/time_top2.py parent`` times the other tree's kernels
with this tree's inputs; equal checksums show equal results.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from fqtk_tpu_torch.core.encoding import ENCODE_LUT
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2, pack_nib4
from fqtk_tpu_torch.ops.matcher import ExpectedSet

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

#: (kernel, K, L, B, classes): on bit2 rows the single-cell window's dedup
#: bucket and the kernel-phase batch at the 6,794,880-barcode list, the
#: 737,280-barcode list, the combinatorial-indexing and 96-sample shapes of
#: the demux path, and 64- and 100-bp barcodes (the sliced depth walk at KP
#: 256 and 512); on nib4 rows (the 16-class input, the sliced walk at every
#: L > 8) the combinatorial-indexing and single-cell shapes, and 24-bp
#: barcodes (KP 384: an odd slice count)
SHAPES = [
    ("tile_top2", 6_794_880, 16, 32_768, 4),
    ("tile_top2", 6_794_880, 16, 16_384, 4),
    ("tile_top2", 737_280, 16, 16_384, 4),
    ("colmerge_top2", 737_280, 16, 16_384, 4),
    ("colmerge_top2", 8_192, 16, 131_072, 4),
    ("colmerge_top2", 96, 17, 8_192, 4),
    ("colmerge_top2", 8_192, 64, 131_072, 4),
    ("colmerge_top2", 8_192, 100, 131_072, 4),
    ("colmerge_top2", 8_192, 16, 131_072, 16),
    ("colmerge_top2", 8_192, 24, 131_072, 16),
    ("tile_top2", 6_794_880, 16, 16_384, 16),
]


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``reps`` calls of ``fn`` after one warm
    call (host launch path included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def queued_ms(fn, n: int) -> float:
    """Device time per call of ``n`` calls queued behind a busy device (the
    host's launch path off the clock)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def case(k: int, length: int, b: int, classes: int = 4):
    """``(es, obs, rows)``: the whitelist, the reads as ACGT bytes ``[B,
    L]`` and as the kernel's rows (bit2 at 4 classes, nib4 at 16)."""
    rng = np.random.default_rng(k + length)
    codes = rng.integers(0, 4, size=(k, length), dtype=np.uint8)
    es = ExpectedSet(masks=np.left_shift(1, codes).astype(np.uint8),
                     max_ns_in_barcodes=0, length=length, count=k)
    obs = codes[rng.integers(0, k, size=b)].copy()
    mut = rng.random(b) < 0.3
    pos = rng.integers(0, length, size=b)
    obs[mut, pos[mut]] = rng.integers(0, 4, size=int(mut.sum()))
    rnd = rng.random(b) < 0.2
    obs[rnd] = rng.integers(0, 4, size=(int(rnd.sum()), length))
    obs = ACGT[obs]
    if classes == 4:
        return es, obs, torch.from_numpy(pack_bit2(obs))
    return es, obs, pack_nib4(torch.from_numpy(ENCODE_LUT[obs]))


def label(name: str, k: int, length: int, b: int, classes: int) -> str:
    return f"{name} K={k} L={length} B={b}" + ("" if classes == 4 else f" classes={classes}")


def main(argv=None) -> int:
    tag = (argv or sys.argv[1:] or ["run"])[0]
    if not torch.cuda.is_available():
        raise SystemExit("time_top2: needs an NVIDIA GPU")
    out = {}
    for name, k, length, b, classes in SHAPES:
        kern = hm.ColmergeTop2() if name == "colmerge_top2" else hm.TileTop2()
        es, _, rows = case(k, length, b, classes)
        rows = rows.cuda()
        state = hm.hopper_state_from_numpy(es, "cuda", name, classes=classes)
        del es

        def call():
            return kern(rows, state.table, k, length, classes)

        ms = median_ms(call, 5 if k > 100_000 else 30)
        n = 3 if k > 100_000 else 200
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3 / n
        q_ms = queued_ms(call, n)
        checksum = [int(x.to(torch.int64).sum()) for x in call()]
        where = label(name, k, length, b, classes)
        out[where] = dict(ms=ms, loop_ms=loop_ms, queued_ms=q_ms, checksum=checksum)
        print(f"{tag} {where}: {ms:.4f} ms median, {loop_ms:.4f} ms per launch in a "
              f"loop, {q_ms:.4f} ms per launch behind a full queue, checksum {checksum}",
              flush=True)
        del state, rows
        torch.cuda.empty_cache()
    print(json.dumps({tag: out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
