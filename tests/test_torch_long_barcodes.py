"""Barcodes longer than 255 bp in the port: ``fqtk_tpu_torch.ops.matcher.
make_assign_fn`` (the chunked scan for bit2 input) against the JAX package's
``make_assign_fn(packed2=True)`` and the NumPy spec, and a demux with a
256-bp sample barcode through the port against the JAX package's device
path and its NumPy engine.

Every comparison is exact (tolerance 0): the outputs are integers, and the
port's float32 products of 0/1 entries are exact (sums <= L < 2^24).  The
port runs on the CPU here, as the JAX package does."""

import gzip

import numpy as np
import pytest
import torch

from fqtk_tpu.io import native as native_io
from fqtk_tpu.ops.matcher import ExpectedSet as JaxExpectedSet
from fqtk_tpu.ops.matcher import make_assign_fn as jax_make_assign_fn
from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import ExpectedSet, assign_batch_np, make_assign_fn
from fqtk_tpu_torch.runtime import demux as torch_demux

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def whitelist(k, length, seed):
    """``k`` seeded ACGT barcodes of ``length`` bases, one of them with an
    ``N`` (it matches every base) when ``k > 2``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(k, length))
    rows = [bytes(ACGT[c]).decode() for c in codes]
    if k > 2:
        rows[2] = rows[2][:5] + "N" + rows[2][6:]
    return rows


def reads(barcodes, b, seed):
    """``[b, L]`` ACGT bytes: a third copies of barcodes, a third one or two
    bases away, the rest random; row 0 differs from barcode 0 at every
    position (its count saturates at 255 for L >= 255)."""
    rng = np.random.default_rng(seed)
    k, length = len(barcodes), len(barcodes[0])
    wl = np.frombuffer("".join(barcodes).replace("N", "A").encode(), np.uint8).reshape(k, length)
    obs = ACGT[rng.integers(0, 4, size=(b, length))]
    for i in range(b):
        if i % 3 == 0:
            obs[i] = wl[rng.integers(0, k)]
        elif i % 3 == 1:
            obs[i] = wl[rng.integers(0, k)]
            for p in rng.choice(length, size=1 + i % 2, replace=False):
                obs[i, p] = ACGT[(np.searchsorted(ACGT, obs[i, p]) + 1) % 4]
    obs[0] = ACGT[(np.searchsorted(ACGT, wl[0]) + 2) % 4]
    return obs


def spec(obs, es, mm, delta):
    idx, best, nxt = assign_batch_np(obs, es, mm, delta)
    return np.where(idx < 0, es.count, idx), best, nxt


@pytest.mark.parametrize("mm,delta", [(1, 2), (0, 0)])
@pytest.mark.parametrize("k", [1, 43, 16_385])
@pytest.mark.parametrize("length", [7, 16, 256, 300])
def test_scan_matches_jax_and_spec(length, k, mm, delta):
    barcodes = whitelist(k, length, seed=k + length)
    obs = reads(barcodes, 12 if k > 1000 else 24, seed=length)
    packed = pack_bit2(obs)
    es = ExpectedSet.from_barcodes(barcodes)
    fn = make_assign_fn(es, mm, delta, packed2=True, compact_output=True, device="cpu")
    got = [x.numpy() for x in fn(packed)]
    jax_fn = jax_make_assign_fn(
        JaxExpectedSet.from_barcodes(barcodes), mm, delta, packed2=True, compact_output=True
    )
    want = [np.asarray(x) for x in jax_fn(packed)]
    assert got[0].dtype == want[0].dtype == (np.uint8 if k < 255 else np.int32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, spec(obs, es, mm, delta)):
        np.testing.assert_array_equal(g.astype(np.int64), w)
    assert fn.scheme == "xla_scan" and fn.calls == 1
    assert fn.chunks.shape == (-(-k // 16_384), 4 * length, min(k, 16_384))
    if k == 1:  # next = 255 for a single sample, from the init and the mask
        assert (got[2] == 255).all()
    if length >= 255 and k == 1:  # row 0 mismatches everywhere: 255, unmatched
        assert (got[0][0], got[1][0]) == (k, 255)


@pytest.mark.parametrize("k_chunk", [1, 10, 43])
def test_scan_chunks_match_jax(k_chunk):
    """Ragged and one-column chunks, each column of a later chunk tying an
    earlier one: the first column wins, as in the JAX scan."""
    barcodes = whitelist(43, 300, seed=5)
    barcodes[30] = barcodes[4]
    barcodes[41] = barcodes[4]
    obs = reads(barcodes, 24, seed=9)
    obs[1] = np.frombuffer(barcodes[4].encode(), np.uint8)
    packed = pack_bit2(obs)
    es = ExpectedSet.from_barcodes(barcodes)
    fn = make_assign_fn(es, 2, 0, k_chunk=k_chunk, packed2=True, device="cpu")
    got = [x.numpy() for x in fn(torch.from_numpy(packed))]
    want = jax_make_assign_fn(JaxExpectedSet.from_barcodes(barcodes), 2, 0,
                              k_chunk=k_chunk, packed2=True)(packed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].dtype == np.int32 and (got[0][1], got[1][1], got[2][1]) == (4, 0, 0)


def test_scan_refusals(monkeypatch):
    es = ExpectedSet.from_barcodes(whitelist(5, 300, seed=1))
    fn = make_assign_fn(es, 1, 2, packed2=True, device="cpu")
    with pytest.raises(ValueError, match="bit2 rows"):
        fn(np.zeros((4, 74), dtype=np.uint8))
    # the Hopper matcher keeps its own bound
    with pytest.raises(ValueError, match="255"):
        hm.make_hopper_assign_fn(es, 1, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_assign_fn(es, 1, 2, packed2=True, device="cuda")


# --------------------------------------------------------------------------
# a demux with a 256-bp sample barcode
# --------------------------------------------------------------------------

N_READS = 3000
BATCH = 1024
BC_LEN = 256


def _outputs(out):
    blob = {p.name: gzip.open(p).read() for p in sorted(out.glob("*.fq.gz"))}
    blob["demux-metrics.txt"] = (out / "demux-metrics.txt").read_bytes()
    return blob


@pytest.fixture(scope="module")
def long_dataset(tmp_path_factory):
    if not native_io.available():
        pytest.skip("native library unavailable")
    tmp = tmp_path_factory.mktemp("long_barcodes")
    barcodes = whitelist(6, BC_LEN, seed=256)
    (tmp / "metadata.tsv").write_text(
        "sample_id\tbarcode\n" + "".join(f"S{i}\t{b}\n" for i, b in enumerate(barcodes)))
    rng = np.random.default_rng(17)
    obs = reads(barcodes, N_READS, seed=18)
    with_n = rng.integers(0, 40, size=N_READS) == 0  # host-resolved rows
    obs[with_n, rng.integers(0, BC_LEN, size=N_READS)[with_n]] = ord("N")
    tmpl = ACGT[rng.integers(0, 4, size=(N_READS, 20))]
    with gzip.open(tmp / "r1.fq.gz", "wb", compresslevel=1) as fh:
        for i in range(N_READS):
            seq = obs[i].tobytes() + tmpl[i].tobytes()
            fh.write(b"@r%d 1:N:0:0\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    kw = dict(inputs=[tmp / "r1.fq.gz"], read_structures=[f"{BC_LEN}B20T"],
              sample_metadata=tmp / "metadata.tsv", threads=5, batch_size=BATCH)
    jax_demux.run_demux(jax_demux.DemuxConfig(
        output=tmp / "jax_device", engine="native", matcher="device", devices=1, **kw))
    jax_demux.run_demux(jax_demux.DemuxConfig(output=tmp / "numpy", engine="numpy", **kw))
    return tmp, kw


def test_long_barcode_demux_byte_identical(long_dataset, caplog):
    tmp, kw = long_dataset
    with caplog.at_level("INFO", logger="fqtk"):
        res = torch_demux.run_demux(torch_demux.DemuxConfig(
            output=tmp / "port", matcher="device", device="cpu", **kw))
    got = _outputs(tmp / "port")
    assert got == _outputs(tmp / "jax_device")
    assert got == _outputs(tmp / "numpy")
    assert res.total_templates == N_READS
    assert res.matcher["scheme"] == "xla_scan"
    assert res.matcher["calls"] >= N_READS // BATCH and res.matcher["launches"] == 0
    assert "device matcher: xla_scan" in caplog.text
    templates = [int(line.split("\t")[2]) for line in got["demux-metrics.txt"].decode().splitlines()[1:]]
    assert min(templates[:-1]) > 0 and templates[-1] > 0  # every sample and unmatched


def test_long_barcode_demux_cuda_without_card_raises(long_dataset, monkeypatch):
    tmp, kw = long_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_demux.run_demux(torch_demux.DemuxConfig(
            output=tmp / "nocard", matcher="device", **kw))
