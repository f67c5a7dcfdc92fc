"""Times the kernel lab's variants at one batch size.

    python -m fqtk_tpu_torch.lab.time_lab [TAG [name:tile_b:tile_k ...]]

For each spec (default: the lab's ``DEFAULT_SPECS``) at the lab's size
(``FQTK_LAB_K`` barcodes of ``FQTK_LAB_L`` bases; 737,280 of 16): the
variant built by ``make_lab_variant``, the median CUDA-event time of a call
on B = 16,384 of the spot check's reads (what one dedup bucket of a
single-cell window pays) and a checksum of its outputs.  The last line is
one JSON object ``{TAG: {...}}``.

To compare two commits on one card, run this file in turns against each
checkout inside one job (two jobs may land on two cards): it reaches the
kernels through ``make_lab_variant`` only, a name both trees have, so
``PYTHONPATH=<other checkout> python fqtk_tpu_torch/lab/time_lab.py parent``
times the other tree's kernels on this tree's inputs; equal checksums show
equal results.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from fqtk_tpu_torch.lab import kernel_lab as lab
from fqtk_tpu_torch.lab.time_top2 import median_ms

#: rows per timed call
BATCH = 16_384


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    tag = args[0] if args else "run"
    specs = args[1:] or list(lab.DEFAULT_SPECS)
    if not torch.cuda.is_available():
        raise SystemExit("time_lab: needs an NVIDIA GPU")
    k = int(os.environ.get("FQTK_LAB_K", "737280"))
    length = int(os.environ.get("FQTK_LAB_L", "16"))
    codes, masks = lab.lab_inputs(k, length)
    obs = torch.from_numpy(lab.pack_bit2(lab.spot_rows(codes, BATCH))).cuda()
    out = {}
    for spec in specs:
        name, tb, tk, label = lab.parse_spec(spec)
        go, table, _ = lab.make_lab_variant(name, masks, length, tile_b=tb, tile_k=tk,
                                            device="cuda")
        ms = median_ms(lambda: go(obs, table), 5)
        checksum = [int(x.to(torch.int64).sum()) for x in go(obs, table)]
        out[label] = dict(ms=ms, checksum=checksum)
        print(f"{tag} {label} K={k} L={length} B={BATCH}: {ms:.4f} ms median of 5, "
              f"checksum {checksum}", flush=True)
        del go, table
        torch.cuda.empty_cache()
    print(json.dumps({tag: out, "card": lab.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
