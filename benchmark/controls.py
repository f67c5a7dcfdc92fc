"""The control of ``correct``: the plain reference put in the program's
place with one guarantee broken (each driver's ``control``: rivals looked
for only within ``max_mismatches``, which breaks ``min_mismatch_delta``),
run through the rest of a cell's run and its comparison::

    python3 -m benchmark.controls --workload <cell> --seconds <s> --seed <n> [<n> ...]

Each seed prints one JSON line with the numbers compared and ``correct``,
which has to come out false.  The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    run._prepare_env(run.common.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("[bench] the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seed:
        result = run.run_cell(args.workload, seed, args.seconds, False, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": result["correct"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
