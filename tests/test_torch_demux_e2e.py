"""The port's device-placed demux against the JAX package, byte for byte.

``fqtk_tpu_torch.runtime.demux.run_demux(device="cpu", matcher="device")``
(the kernel's plain PyTorch version behind the native engine) must write
exactly the decompressed FASTQs and ``demux-metrics.txt`` of
``fqtk_tpu``'s native engine with its device matcher (``devices=1``: the
XLA bit2 scan on the CPU backend) and of its NumPy engine — with several
windows, reads carrying ``N`` (host-resolved exceptional rows), the window
dedup on and off and the one-call-in-flight overlap on and off."""

import gzip
import logging

import numpy as np
import pytest

from fqtk_tpu.io import native as native_io
from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch.runtime import demux as torch_demux

N_READS = 20_000
BATCH = 8192  # >= 4096 rows and >= 2x duplication: the window dedup engages
STRUCTURES = ["8B", "20T", "9B"]


def _write_inputs(tmp, barcodes, seed=11):
    rng = np.random.default_rng(seed)
    meta = tmp / "metadata.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i:03d}\t{b}\n" for i, b in enumerate(barcodes))
    )
    choices = rng.integers(0, len(barcodes), size=N_READS)
    mism = rng.integers(0, 10, size=N_READS) == 0
    with_n = rng.integers(0, 50, size=N_READS) == 0
    pos = rng.integers(0, 17, size=N_READS)
    tmpl = rng.choice(list("ACGT"), size=(64, 20))
    files = {n: [] for n in ("i1", "r1", "i2")}
    for i in range(N_READS):
        bc = bytearray(barcodes[choices[i]].encode())
        if mism[i]:
            bc[pos[i]] = ord("T") if bc[pos[i]] != ord("T") else ord("G")
        if with_n[i]:
            bc[(pos[i] + 3) % 17] = ord("N")
        head = f"@inst:1:AB:1:2:{i}:3 1:N:0:0"
        t = "".join(tmpl[i % 64])
        for name, seq in (("i1", bc[:8].decode()), ("r1", t), ("i2", bc[8:].decode())):
            files[name].append(f"{head}\n{seq}\n+\n{'I' * len(seq)}\n")
    paths = []
    for name in ("i1", "r1", "i2"):
        p = tmp / f"{name}.fq.gz"
        with gzip.open(p, "wt", compresslevel=1) as fh:
            fh.write("".join(files[name]))
        paths.append(p)
    return paths, meta


def _outputs(out):
    blob = {p.name: gzip.open(p).read() for p in sorted(out.glob("*.fq.gz"))}
    blob["demux-metrics.txt"] = (out / "demux-metrics.txt").read_bytes()
    return blob


def _kw(paths, meta, out, **extra):
    return dict(
        inputs=paths,
        read_structures=STRUCTURES,
        sample_metadata=meta,
        output=out,
        threads=5,
        batch_size=BATCH,
        **extra,
    )


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    if not native_io.available():
        pytest.skip("native library unavailable")
    tmp = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(3)
    barcodes = sorted({"".join(rng.choice(list("ACGT"), size=17)) for _ in range(24)})
    paths, meta = _write_inputs(tmp, barcodes)
    jax_demux.run_demux(
        jax_demux.DemuxConfig(
            **_kw(paths, meta, tmp / "jax_device", engine="native",
                  matcher="device", devices=1)
        )
    )
    jax_demux.run_demux(
        jax_demux.DemuxConfig(**_kw(paths, meta, tmp / "numpy", engine="numpy"))
    )
    return tmp, paths, meta


@pytest.mark.parametrize("dedup", ["1", "0"])
@pytest.mark.parametrize("overlap", ["1", "0"])
def test_port_byte_identical_to_jax(dataset, monkeypatch, caplog, dedup, overlap):
    tmp, paths, meta = dataset
    monkeypatch.setenv("FQTK_DEVICE_DEDUP", dedup)
    monkeypatch.setenv("FQTK_DEVICE_OVERLAP", overlap)
    out = tmp / f"port_{dedup}{overlap}"
    with caplog.at_level(logging.INFO, logger="fqtk"):
        res = torch_demux.run_demux(
            torch_demux.DemuxConfig(
                **_kw(paths, meta, out, matcher="device", device="cpu")
            )
        )
    got = _outputs(out)
    assert got == _outputs(tmp / "jax_device")
    assert got == _outputs(tmp / "numpy")
    assert res.total_templates == N_READS
    assert res.matcher["plain_calls"] >= 3  # one per window at least
    assert res.matcher["launches"] == 0  # no card here
    engaged = "device window dedup engaged" in caplog.text
    assert engaged == (dedup == "1")
    assert sum(len(v) for k, v in got.items() if k.startswith("unmatched"))


def test_port_host_matcher_has_no_device_counts(dataset):
    tmp, paths, meta = dataset
    out = tmp / "port_host"
    res = torch_demux.run_demux(
        torch_demux.DemuxConfig(**_kw(paths, meta, out, matcher="host", device="cpu"))
    )
    assert res.matcher == {}
    assert _outputs(out) == _outputs(tmp / "numpy")


@pytest.mark.parametrize("fused", ["1", "0"])
def test_port_host_matcher_fused_and_serial(dataset, monkeypatch, fused):
    """``--matcher host`` with the engine's fused assign thread
    (``FQTK_FUSED_ASSIGN=1``) and with the Python loop's serial arm (``0``): the
    same bytes as the NumPy engine either way."""
    tmp, paths, meta = dataset
    monkeypatch.setenv("FQTK_FUSED_ASSIGN", fused)
    out = tmp / f"port_host_fused{fused}"
    res = torch_demux.run_demux(
        torch_demux.DemuxConfig(**_kw(paths, meta, out, matcher="host", device="cpu"))
    )
    assert _outputs(out) == _outputs(tmp / "numpy")
    assert res.total_templates == N_READS and res.matcher == {}
    # only the serial arm assigns and submits from the Python thread
    assert ("assign" in res.timings) == ("submit" in res.timings) == (fused == "0")


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(devices=2, matcher="device"), "multi-GPU"),
        (dict(engine="bogus"), "engine must be one of"),
        (dict(device="tpu"), "cuda or cpu"),
    ],
)
def test_unported_configs_raise(dataset, kw, match):
    tmp, paths, meta = dataset
    cfg = torch_demux.DemuxConfig(**_kw(paths, meta, tmp / "bad", **{"device": "cpu", **kw}))
    with pytest.raises((RuntimeError, ValueError), match=match):
        torch_demux.run_demux(cfg)


def test_cuda_without_card_raises(dataset, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmp, paths, meta = dataset
    cfg = torch_demux.DemuxConfig(**_kw(paths, meta, tmp / "nocard", matcher="device"))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        torch_demux.run_demux(cfg)
