"""The port's device mesh through the product driver: ``run_demux`` with the
native engine and ``devices=8`` over eight CPU "devices"
(``parallel.mesh.local_devices`` patched to ``[cpu] * 8``, the counterpart
of conftest's 8 fake JAX devices).  Mirrors ``tests/test_mesh_e2e.py``:
the batch mesh, the whitelist mesh (``PALLAS_K_THRESHOLD`` patched as there)
and the indivisible-batch fallback.  Every decompressed output and
``demux-metrics.txt`` must equal the port's single-device run and the JAX
package's ``run_demux`` with its own mesh on the same inputs, byte for
byte."""

import gzip
import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fqtk_tpu.io import native as native_io
from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch.ops.matcher import ExpectedSet
from fqtk_tpu_torch.parallel import mesh
from fqtk_tpu_torch.runtime import demux as torch_demux

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def eight_cpu_devices(monkeypatch):
    if not native_io.available():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(mesh, "local_devices", lambda device="cuda": list(CPU8))
    torch_demux._ASSIGN_FN_CACHE.clear()
    yield
    torch_demux._ASSIGN_FN_CACHE.clear()


def _write_inputs(tmp_path, n_reads=203, k=24, bc_len=9, seed=5):
    """``tests/test_mesh_e2e.py``'s inputs: a quarter of the reads one base
    off, one in eleven with an N."""
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    barcodes, seen = [], set()
    while len(barcodes) < k:
        b = "".join(rng.choice(list(bases), size=bc_len))
        if b not in seen:
            seen.add(b)
            barcodes.append(b)
    meta = tmp_path / "metadata.tsv"
    meta.write_text("sample_id\tbarcode\n"
                    + "".join(f"Sample{i:04d}\t{b}\n" for i, b in enumerate(barcodes)))
    i1, r1 = tmp_path / "i1.fq.gz", tmp_path / "r1.fq.gz"
    with gzip.open(i1, "wb") as f1, gzip.open(r1, "wb") as f2:
        for i in range(n_reads):
            bc = list(barcodes[int(rng.integers(0, k))])
            if rng.integers(0, 4) == 0:
                bc[int(rng.integers(0, bc_len))] = bases[int(rng.integers(0, 4))]
            if rng.integers(0, 11) == 0:
                bc[int(rng.integers(0, bc_len))] = "N"
            bc = "".join(bc)
            head = f"@inst:1:AB:2:3:{i}:9 1:N:0:0".encode()
            f1.write(head + b"\n" + bc.encode() + b"\n+\n" + b"I" * bc_len + b"\n")
            tmpl = "".join(rng.choice(list(bases), size=40))
            f2.write(head + b"\n" + tmpl.encode() + b"\n+\n" + b"I" * 40 + b"\n")
    return [i1, r1], meta


def _kw(inputs, meta, out, devices, batch_size=16, **extra):
    return dict(inputs=inputs, read_structures=["9B", "+T"], sample_metadata=meta,
                output=out, max_mismatches=1, min_mismatch_delta=2, threads=5,
                batch_size=batch_size, engine="native", devices=devices, **extra)


def _port(tmp_path, inputs, meta, name, devices, **extra):
    out = tmp_path / name
    res = torch_demux.run_demux(torch_demux.DemuxConfig(
        **_kw(inputs, meta, out, devices, device="cpu", **extra)))
    return out, res


def _jax(tmp_path, inputs, meta, name, devices, **extra):
    out = tmp_path / name
    res = jax_demux.run_demux(jax_demux.DemuxConfig(**_kw(inputs, meta, out, devices, **extra)))
    return out, res


def _outputs(out):
    blob = {p.name: gzip.decompress(p.read_bytes()) for p in sorted(out.glob("*.fq.gz"))}
    blob["demux-metrics.txt"] = (out / "demux-metrics.txt").read_bytes()
    return blob


def test_batch_sharded_mesh_matches_single_device(tmp_path, caplog):
    assert len(mesh.local_devices("cpu")) == 8
    inputs, meta = _write_inputs(tmp_path)
    out1, res1 = _port(tmp_path, inputs, meta, "single", 1, matcher="device")
    with caplog.at_level(logging.INFO, logger="fqtk"):
        out8, res8 = _port(tmp_path, inputs, meta, "mesh", 8)
    assert "device mesh: 8-way batch parallelism over 8 local devices" in caplog.text
    jout, jres = _jax(tmp_path, inputs, meta, "jax_mesh", 8)
    assert res1.total_templates == res8.total_templates == jres.total_templates == 203
    assert _outputs(out8) == _outputs(out1) == _outputs(jout)
    # 13 windows of 16 rows, each over 8 batch parts: 8 plain calls a window
    assert res8.matcher["scheme"] == "colmerge_top2"
    assert res8.matcher["plain_calls"] == res8.matcher["colmerge_top2_plain_calls"] == 8 * 13
    assert res8.matcher["launches"] == 0


def test_whitelist_sharded_mesh_matches_single_device(tmp_path, monkeypatch, caplog):
    """The big-K policy forced at a tiny K (and the device side asked for,
    past the pigeonhole host matcher), so the 1 x 8 whitelist mesh and its
    cross-shard fold run through the product driver."""
    monkeypatch.setattr(torch_demux, "PALLAS_K_THRESHOLD", 8)
    monkeypatch.setattr(jax_demux, "PALLAS_K_THRESHOLD", 8)
    inputs, meta = _write_inputs(tmp_path, seed=11)
    with caplog.at_level(logging.INFO, logger="fqtk"):
        out8, res8 = _port(tmp_path, inputs, meta, "ksharded", 8, matcher="device")
    assert "device mesh: 8-way whitelist parallelism" in caplog.text
    jout, jres = _jax(tmp_path, inputs, meta, "jax_ksharded", 8, matcher="device")
    monkeypatch.setattr(torch_demux, "PALLAS_K_THRESHOLD", 1 << 30)
    out1, res1 = _port(tmp_path, inputs, meta, "single", 1, matcher="device")
    assert res1.total_templates == res8.total_templates == jres.total_templates == 203
    assert _outputs(out8) == _outputs(out1) == _outputs(jout)
    assert res8.matcher["plain_calls"] == 8 * 13  # 8 shards of 3 columns a window


def test_indivisible_batch_falls_back_to_single_device(tmp_path, caplog):
    inputs, meta = _write_inputs(tmp_path, n_reads=50, seed=7)
    with caplog.at_level(logging.INFO, logger="fqtk"):
        out, res = _port(tmp_path, inputs, meta, "odd", 8, batch_size=7, matcher="device")
    assert "batch size 7 not divisible by 8 devices; using a single device" in caplog.text
    assert "device mesh" not in caplog.text
    assert res.total_templates == 50
    jout, _ = _jax(tmp_path, inputs, meta, "jax_odd", 8, batch_size=7)
    assert _outputs(out) == _outputs(jout)
    assert res.matcher["plain_calls"] == 8  # one call a window of 7


@pytest.mark.parametrize("devices,ways", [(None, 8), (16, 8), (4, 4)])
def test_devices_unset_takes_every_local_device(tmp_path, caplog, devices, ways):
    """``--devices`` unset means every local device, as in the JAX package;
    more than there are is clamped."""
    inputs, meta = _write_inputs(tmp_path, n_reads=64, seed=3)
    with caplog.at_level(logging.INFO, logger="fqtk"):
        out, _ = _port(tmp_path, inputs, meta, "out", devices, matcher="device")
    assert f"device mesh: {ways}-way batch parallelism over 8 local devices" in caplog.text
    jout, _ = _jax(tmp_path, inputs, meta, "jax", 1)
    assert _outputs(out) == _outputs(jout)


def test_cache_key_separates_device_lists(monkeypatch):
    """Two runs under different device lists never share a matcher; the same
    list reuses it."""
    barcodes = ["ACGTACGTA", "CCGGTTAAC", "GATTACAGA"]
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = torch_demux.DemuxConfig(inputs=[], read_structures=[], sample_metadata="m",
                                  output="o", matcher="device", device="cpu", batch_size=16)
    first = torch_demux._make_device_assign_fn(cfg, es, barcodes)
    assert first[0].device_matcher.mesh.shape == {"batch": 8, "whitelist": 1}
    assert torch_demux._make_device_assign_fn(cfg, es, barcodes) is first
    monkeypatch.setattr(mesh, "local_devices", lambda device="cuda": list(CPU8[:4]))
    second = torch_demux._make_device_assign_fn(cfg, es, barcodes)
    assert second is not first
    assert second[0].device_matcher.mesh.shape == {"batch": 4, "whitelist": 1}
    monkeypatch.setattr(mesh, "local_devices", lambda device="cuda": [torch.device("cpu")])
    third = torch_demux._make_device_assign_fn(cfg, es, barcodes)
    assert third[0].device_matcher.scheme == "colmerge_top2"
    assert not hasattr(third[0].device_matcher, "mesh")  # the single-device matcher
    assert len(torch_demux._ASSIGN_FN_CACHE) == 3
