"""Times ``colmerge_top2`` and ``tile_top2`` at the main paths' shapes.

    python -m fqtk_tpu_torch.lab.time_top2 [TAG]

For each kernel and shape (K, L, B): a seeded whitelist of K random
barcodes, B reads (drawn from the list, 30% with one random base, a fifth
fully random), the median CUDA-event time of a launch, the time per launch
of a back-to-back loop (host enqueue included) and a checksum of the three
outputs.  The last line is one JSON object ``{TAG: {...}}``.

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

from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import ExpectedSet

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

#: (K, L, B): the single-cell window's dedup bucket and the kernel-phase
#: batch at the 6,794,880-barcode list; the 737,280-barcode list; the
#: combinatorial-indexing and 96-sample shapes of the demux path
SHAPES = {
    "tile_top2": [(6_794_880, 16, 32_768), (6_794_880, 16, 16_384), (737_280, 16, 16_384)],
    "colmerge_top2": [(737_280, 16, 16_384), (8_192, 16, 131_072), (96, 17, 8_192)],
}


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


def case(k: int, length: int, b: int):
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
    return es, torch.from_numpy(pack_bit2(ACGT[obs]))


def main(argv=None) -> int:
    tag = (argv or sys.argv[1:] or ["run"])[0]
    if not torch.cuda.is_available():
        raise SystemExit("time_top2: needs an NVIDIA GPU")
    out = {}
    for name, shapes in SHAPES.items():
        kern = hm.ColmergeTop2() if name == "colmerge_top2" else hm.TileTop2()
        for k, length, b in shapes:
            es, packed = case(k, length, b)
            packed = packed.cuda()
            state = hm.hopper_state_from_numpy(es, "cuda", name)
            del es

            def call():
                return kern(packed, state.table, k, length)

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
            out[f"{name} K={k} L={length} B={b}"] = dict(
                ms=ms, loop_ms=loop_ms, queued_ms=q_ms, checksum=checksum)
            print(f"{tag} {name} K={k} L={length} B={b}: {ms:.4f} ms median, "
                  f"{loop_ms:.4f} ms per launch in a loop, {q_ms:.4f} ms per launch "
                  f"behind a full queue, checksum {checksum}", flush=True)
            del state, packed
            torch.cuda.empty_cache()
    print(json.dumps({tag: out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
