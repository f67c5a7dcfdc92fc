"""The port's multi-process demux (``fqtk_tpu_torch.parallel.distributed``)
in one process, where the collective is the identity.  Mirrors
``tests/test_distributed.py``'s four tests; the shard run is held byte for
byte to the JAX package's ``run_demux_multihost``.  The real two-process
runs over gloo are ``test_torch_multiprocess.py``."""

import gzip

import numpy as np
import pytest
import torch.distributed as dist

jax = pytest.importorskip("jax")

from fqtk_tpu.parallel import distributed as jax_distributed
from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch.parallel import distributed
from fqtk_tpu_torch.parallel.distributed import merge_host_counts, run_demux_multihost
from fqtk_tpu_torch.runtime.demux import DemuxConfig, run_demux

from .test_torch_multiprocess import store_port
from .util import fastq_file, metadata_file


def test_merge_host_counts_single_process_identity():
    c = np.array([3, 1, 4, 1, 5], dtype=np.int64)
    got = merge_host_counts(c)
    np.testing.assert_array_equal(got, c)
    assert got.dtype == np.int64
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_multihost_shard_run_and_metrics(tmp_path, engine):
    barcodes = ["AAAA", "CCCC"]
    sample_metadata = metadata_file(tmp_path, barcodes)
    lane0 = fastq_file(
        tmp_path, "lane0", "l0", ["AAAA" + "G" * 10] * 3 + ["CCCC" + "G" * 10]
    )
    kw = dict(inputs=[lane0], read_structures=["4B+T"], sample_metadata=sample_metadata,
              engine=engine)
    out = tmp_path / "out"
    metrics = run_demux_multihost(DemuxConfig(output=out, device="cpu", matcher="device", **kw))
    direct = run_demux(DemuxConfig(output=tmp_path / "direct", device="cpu", **kw))
    assert [m["templates"] for m in metrics] == [m["templates"] for m in direct.metrics]
    assert (out / "shard-0" / "Sample0000.R1.fq.gz").exists()
    assert (out / "demux-metrics.txt").read_text() == (
        tmp_path / "direct" / "demux-metrics.txt"
    ).read_text()
    # the JAX package's single-process shard run writes the same bytes
    jout = tmp_path / "jax"
    jax_distributed.run_demux_multihost(jax_demux.DemuxConfig(output=jout, **kw))
    names = sorted(p.name for p in (out / "shard-0").glob("*.fq.gz"))
    assert names == sorted(p.name for p in (jout / "shard-0").glob("*.fq.gz"))
    for name in names:
        assert gzip.decompress((out / "shard-0" / name).read_bytes()) == gzip.decompress(
            (jout / "shard-0" / name).read_bytes())
    assert (out / "demux-metrics.txt").read_bytes() == (jout / "demux-metrics.txt").read_bytes()


def test_multihost_counts_sum_exactly():
    host_counts = [
        np.array([10, 0, 5], dtype=np.int64),
        np.array([2, 7, 1], dtype=np.int64),
        np.array([0, 0, 9], dtype=np.int64),
    ]
    total = sum(host_counts)
    acc = np.zeros(3, dtype=np.int64)
    for c in host_counts:
        acc += merge_host_counts(c)  # identity in single-process
    np.testing.assert_array_equal(acc, total)
    big = np.array([1 << 40, 3], dtype=np.int64)  # no int32 detour
    np.testing.assert_array_equal(merge_host_counts(big), big)


def test_init_distributed_double_init_is_noop(monkeypatch):
    """Already in a process group: nothing is called again.  Not yet: the
    group is joined with gloo at ``tcp://`` with a finite timeout, and any
    error of the rendezvous propagates."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    distributed.init_distributed("127.0.0.1:1", num_processes=1, process_id=0)
    assert calls == []

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    distributed.init_distributed("127.0.0.1:1", num_processes=2, process_id=1)
    (kw,) = calls
    assert kw["backend"] == "gloo" and kw["init_method"] == "tcp://127.0.0.1:1"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert 0 < kw["timeout"].total_seconds() <= 60

    def boom(**kw):
        raise RuntimeError("something else entirely")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="something else"):
        distributed.init_distributed("127.0.0.1:1", num_processes=1, process_id=0)


def test_init_distributed_reads_the_environment(monkeypatch):
    """World size and rank left out come from ``WORLD_SIZE`` / ``RANK``, the
    address from ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``)."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    distributed.init_distributed()
    assert (calls[0]["init_method"], calls[0]["world_size"], calls[0]["rank"]) == (
        "env://", 4, 3)


def test_one_process_group_of_one():
    """A real gloo group of one process on this host: the rank and size it
    reports, a second ``init_distributed`` that does nothing, and the
    collective itself (its store on a port below the ephemeral range, as
    the two-process tests' stores)."""
    port = store_port()
    distributed.init_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        distributed.init_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0)
        assert (distributed.process_index(), distributed.process_count()) == (0, 1)
        c = np.array([7, 1 << 40], dtype=np.int64)
        np.testing.assert_array_equal(merge_host_counts(c), c)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
