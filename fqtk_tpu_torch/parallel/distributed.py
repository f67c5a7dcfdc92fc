"""Multi-process demultiplexing: data-parallel input shards + merged metrics.

Counterpart of :mod:`fqtk_tpu.parallel.distributed`, on
``torch.distributed``:

- Each process runs the full native demux pipeline over its own shard of
  the input (one lane's FASTQs per process, say), its matcher on
  ``cfg.device``.
- Per-sample template counts are associative integer sums, so the global
  ``DemuxMetric`` values are the sum of the per-process counts: one
  ``all_gather`` of int64 vectors and an exact sum
  (:func:`merge_host_counts`), written once by process 0 as
  ``demux-metrics.txt``.
- Per-sample FASTQ outputs are written per process under ``shard-{pid}/``;
  the global view is their in-order concatenation
  (:func:`fqtk_tpu_torch.parallel.merge.concat_shards`, ``demux
  --merge-output`` or ``concat-shards``), equal to a single-process run over
  the concatenated input.

Entry points: :func:`init_distributed`, :func:`run_demux_multihost`,
:func:`merge_host_counts` (the identity for one process, so the same code
path runs everywhere), :func:`process_index` / :func:`process_count`.
"""

from __future__ import annotations

import datetime
import logging
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("fqtk")

#: how long a rendezvous or a collective may wait for the other processes
TIMEOUT = datetime.timedelta(seconds=60)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (a no-op if this process already has).

    ``init_process_group`` with the ``gloo`` backend, at
    ``tcp://{coordinator_address}`` (``host:port`` of process 0), and the
    given world size and rank.  What is not given comes from the
    environment, as ``torch.distributed``'s ``env://`` reads it
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    gloo, not NCCL: the one collective is :func:`merge_host_counts`, a host
    int64 vector of K + 1 counts per process.  NCCL would add a copy to the
    card and back around a few hundred bytes, and it needs one GPU per
    process, where several processes may share one card (each process's
    matcher runs on ``cfg.device`` either way)."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend="gloo", init_method=init, world_size=world, rank=rank, timeout=TIMEOUT
    )


def process_index() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def merge_host_counts(local_counts: np.ndarray) -> np.ndarray:
    """Sum per-sample template counts across all processes: each process's
    int64 vector once (``dist.all_gather`` of CPU tensors), then an exact
    integer sum over the ``[n_process, K+1]`` result, so merged metrics equal
    a single-process run's."""
    local = np.ascontiguousarray(np.asarray(local_counts, dtype=np.int64))
    n = process_count()
    if n == 1:
        return local
    mine = torch.from_numpy(local.copy())
    gathered = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(gathered, mine)
    return torch.stack(gathered).sum(dim=0).numpy()


def run_demux_multihost(
    cfg,
    input_shards: Optional[Sequence[List]] = None,
    merge_output: bool = False,
):
    """Run demux across processes: this process handles shard
    :func:`process_index`.

    ``input_shards``: optional per-process input lists (each entry is the
    ``inputs`` list for one process; all share the read structures).  When
    omitted, every process must already have its own ``cfg.inputs``.

    Outputs land in ``{cfg.output}/shard-{pid}/``; the merged
    ``demux-metrics.txt`` (global counts over all processes) is written at
    ``{cfg.output}/demux-metrics.txt`` by process 0.  With
    ``merge_output=True`` process 0 additionally concatenates the shard
    FASTQs into single per-sample files (:func:`fqtk_tpu_torch.parallel.
    merge.concat_shards`): safe because the count collective below completes
    only after every process's local pipeline has finished and closed its
    writers, so it doubles as the end-of-write barrier.  This requires a
    filesystem shared by the processes."""
    import dataclasses
    import threading

    from ..core.samples import SampleGroup
    from ..runtime.demux import compute_metrics, run_demux, write_metrics

    pid = process_index()
    nproc = process_count()
    if input_shards is not None:
        if len(input_shards) != nproc:
            raise ValueError(
                f"{len(input_shards)} input shards for {nproc} processes"
            )
        inputs = list(input_shards[pid])
    else:
        inputs = list(cfg.inputs)

    shard_out = Path(cfg.output) / f"shard-{pid}"
    local_cfg = dataclasses.replace(cfg, inputs=inputs, output=shard_out)

    # Warm the collective CONCURRENTLY with the streaming pipeline, so that
    # its first-use cost does not land at the end of the run.  Every process
    # issues the warm-up gather first and the real merge after the join, so
    # the collective ordering stays consistent.
    k_probe = len(SampleGroup.from_file(cfg.sample_metadata).samples)
    warm_exc = []

    def _warm():
        try:
            merge_host_counts(np.zeros(k_probe + 1, dtype=np.int64))
        except Exception as e:  # surfaced at join
            warm_exc.append(e)

    warm_thread = threading.Thread(target=_warm, daemon=True)
    warm_thread.start()

    result = run_demux(local_cfg)
    warm_thread.join()
    if warm_exc:
        raise warm_exc[0]

    sample_group = SampleGroup.from_file(cfg.sample_metadata)
    k = len(sample_group.samples)
    local_counts = np.zeros(k + 1, dtype=np.int64)
    for i, row in enumerate(result.metrics):
        local_counts[i] = row["templates"]

    global_counts = merge_host_counts(local_counts)
    metrics = compute_metrics(sample_group, global_counts, cfg.unmatched_prefix)
    if pid == 0:
        Path(cfg.output).mkdir(parents=True, exist_ok=True)
        write_metrics(Path(cfg.output) / "demux-metrics.txt", metrics)
        logger.info(
            "Merged metrics over %d process(es): %d templates",
            nproc,
            int(global_counts.sum()),
        )
        if merge_output:
            from .merge import concat_shards

            concat_shards(Path(cfg.output), expected_shards=nproc)
    return metrics
