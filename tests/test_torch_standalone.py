"""The port stands on its own: ``fqtk_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``fqtk_tpu``, and every piece
of host code the port copied from that package still equals its original.

(a) an AST scan of the sources (no import of jax, of the JAX package or of
the repository's tests), (b) a subprocess that imports every module
of the port, runs a small demux on the CPU and the subsample command and
then looks at ``sys.modules``, (c) each copy against its original on seeded
inputs, exactly (integers, bytes and text: tolerance 0)."""

import argparse
import ast
import gzip
import pkgutil
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

import fqtk_tpu
import fqtk_tpu.cli as jax_cli
import fqtk_tpu.core.barcode_matcher as jax_bm
import fqtk_tpu.core.bitenc as jax_bitenc
import fqtk_tpu.core.encoding as jax_encoding
import fqtk_tpu.core.headers as jax_headers
import fqtk_tpu.core.read_structure as jax_rs
import fqtk_tpu.core.samples as jax_samples
import fqtk_tpu.io.native as jax_native
import fqtk_tpu.ops.matcher as jax_matcher
import fqtk_tpu.ops.pallas_matcher as jax_pallas
import fqtk_tpu.parallel.merge as jax_merge
import fqtk_tpu.runtime.demux as jax_demux
import fqtk_tpu.runtime.subsample as jax_subsample
import fqtk_tpu.utils.chacha as jax_chacha
import fqtk_tpu.utils.floatfmt as jax_floatfmt
import fqtk_tpu.utils.profiling as jax_profiling
import fqtk_tpu.utils.siphash as jax_siphash
import fqtk_tpu_torch
import fqtk_tpu_torch.cli as port_cli
import fqtk_tpu_torch.core.barcode_matcher as port_bm
import fqtk_tpu_torch.core.bitenc as port_bitenc
import fqtk_tpu_torch.core.encoding as port_encoding
import fqtk_tpu_torch.core.headers as port_headers
import fqtk_tpu_torch.core.read_structure as port_rs
import fqtk_tpu_torch.core.samples as port_samples
import fqtk_tpu_torch.io.native as port_native
import fqtk_tpu_torch.ops.matcher as port_matcher
import fqtk_tpu_torch.ops.plan as port_plan
import fqtk_tpu_torch.parallel.merge as port_merge
import fqtk_tpu_torch.runtime.demux as port_demux
import fqtk_tpu_torch.runtime.subsample as port_subsample
import fqtk_tpu_torch.utils.chacha as port_chacha
import fqtk_tpu_torch.utils.floatfmt as port_floatfmt
import fqtk_tpu_torch.utils.profiling as port_profiling
import fqtk_tpu_torch.utils.siphash as port_siphash

from .util import fastq_file, metadata_file

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "fqtk_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


# --------------------------------------------------------------------------
# (a) no import of jax or of the JAX package, at any depth of any source
# --------------------------------------------------------------------------


def _imports(path):
    """Every module named by an ``import`` in ``path``: top level or nested
    in a function, absolute only (a relative import stays in the port)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "fqtk_tpu"), (path.name, mod)
        # nor the repository's tests (e.g. the scenario generator of
        # tests/test_fuzz_differential.py: the port keeps its own copy)
        assert top not in ("tests", "conftest") and not top.startswith("test_"), (path.name, mod)
    # nor by name through importlib / __import__
    text = path.read_text()
    for needle in ('import_module("fqtk_tpu.', "import_module('fqtk_tpu.",
                   '__import__("fqtk_tpu"', '__import__("jax"', 'import_module("jax'):
        assert needle not in text, (path.name, needle)


def test_scan_covers_the_package():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for must in ("fqtk_tpu_torch/cli.py", "fqtk_tpu_torch/io/native.py",
                 "fqtk_tpu_torch/ops/plan.py", "fqtk_tpu_torch/runtime/subsample.py",
                 "fqtk_tpu_torch/parallel/merge.py", "fqtk_tpu_torch/parallel/mesh.py",
                 "fqtk_tpu_torch/parallel/distributed.py", "fqtk_tpu_torch/lab/kernel_lab.py",
                 "fqtk_tpu_torch/core/bitenc.py", "fqtk_tpu_torch/core/barcode_matcher.py",
                 "fqtk_tpu_torch/graft_entry.py", "fqtk_tpu_torch/bench.py",
                 "fqtk_tpu_torch/scripts/deep_campaign.py",
                 "fqtk_tpu_torch/scripts/fuzz_scenarios.py", "chip_smoke.py"):
        assert must in names


# --------------------------------------------------------------------------
# (b) a process that runs the port loads nothing of the JAX package
# --------------------------------------------------------------------------

_RUN_PORT = r"""
import gzip, importlib, pkgutil, sys
from pathlib import Path
import fqtk_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fqtk_tpu_torch.__path__, "fqtk_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
tmp = Path(sys.argv[1])
barcodes = ["AAAAC", "CCCCA", "GGTTA"]
(tmp / "meta.tsv").write_text("sample_id\tbarcode\n" + "".join(f"S{i}\t{b}\n" for i, b in enumerate(barcodes)))
reads = ["AAAAC" + "G" * 10, "CCCCA" + "T" * 10, "GGTTC" + "A" * 10, "NCCCA" + "C" * 10] * 8
(tmp / "in.fastq").write_text("".join(f"@r_{i}\n{s}\n+\n{';' * len(s)}\n" for i, s in enumerate(reads)))
from fqtk_tpu_torch.runtime.demux import DemuxConfig, run_demux
res = run_demux(DemuxConfig(inputs=[tmp / "in.fastq"], read_structures=["5B+T"],
                            sample_metadata=tmp / "meta.tsv", output=tmp / "out",
                            threads=5, batch_size=8, matcher="device", device="cpu"))
assert res.total_templates == len(reads), res.total_templates
assert res.matcher["plain_calls"] > 0 and res.matcher["launches"] == 0, res.matcher
assert [m["templates"] for m in res.metrics] == [8, 16, 8, 0], res.metrics
for engine in ("pallas", "jax", "numpy"):
    py = run_demux(DemuxConfig(inputs=[tmp / "in.fastq"], read_structures=["5B+T"],
                               sample_metadata=tmp / "meta.tsv", output=tmp / engine,
                               batch_size=8, engine=engine, device="cpu"))
    assert [m["templates"] for m in py.metrics] == [8, 16, 8, 0], (engine, py.metrics)
    assert (tmp / engine / "S1.R1.fq.gz").read_bytes()
import fqtk_tpu_torch as top
assert top.BarcodeMatcher([top.Sample("s", "ACGT", 0)], 1, 2).assign(b"ACGT").best_match == 0
from fqtk_tpu_torch.cli import main
assert main(["subsample", "-i", str(tmp / "in.fastq"), "-o", str(tmp / "sub"), "-f", "0.5", "--seed", "3"]) == 0
n = gzip.open(tmp / "sub.R1.fq.gz").read().count(b"@r_")
assert 0 < n < len(reads), n
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "fqtk_tpu"))
assert not bad, bad
print("standalone ok", len(names), n)
"""


def test_running_the_port_loads_nothing_of_the_jax_package(tmp_path):
    if not port_native.available():
        pytest.skip("native library unavailable")
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_PORT, str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("standalone ok")


def test_every_module_of_the_port_is_importable_here():
    names = [m.name for m in pkgutil.walk_packages(fqtk_tpu_torch.__path__, "fqtk_tpu_torch.")]
    assert {"fqtk_tpu_torch.core.encoding", "fqtk_tpu_torch.io.fastq",
            "fqtk_tpu_torch.ops.plan", "fqtk_tpu_torch.utils.siphash",
            "fqtk_tpu_torch.lab.time_top2"} <= set(names)


# --------------------------------------------------------------------------
# (c) each copy against its original
# --------------------------------------------------------------------------


def _random_barcodes(rng, k, length, iupac=True):
    alphabet = np.frombuffer(b"ACGTNRYKMSWacgtn", dtype=np.uint8) if iupac else ACGT
    return [bytes(r).decode() for r in alphabet[rng.integers(0, len(alphabet), size=(k, length))]]


def _nocall_barcodes(rng, kind, length):
    """No-call-heavy whitelists over ACGT rows: ``every`` has ``N``, ``n``
    and ``.`` at every position, ``all_n`` one all-``N`` row in the middle,
    ``most_last`` rows with 0..L no-calls, the most of them in the last."""
    n_rows = {"every": 3 * length, "all_n": 8, "most_last": length + 1}[kind]
    rows = ACGT[rng.integers(0, 4, size=(n_rows, length))]
    if kind == "every":
        for i, c in enumerate(b"Nn."):
            rows[i * length + np.arange(length), np.arange(length)] = c
    elif kind == "all_n":
        rows[n_rows // 2] = ord("N")
    else:
        for i in range(n_rows):
            rows[i, rng.permutation(length)[:i]] = b"Nn."[i % 3]
    return [bytes(r).decode() for r in rows]


SPEC_CASES = [pytest.param(k, n, None, id=f"{k}-{n}")
              for k, n in [(1, 1), (3, 8), (96, 17), (300, 33)]] + [
    pytest.param(0, n, kind, id=f"{kind}-{n}")
    for kind in ("every", "all_n", "most_last") for n in (1, 16, 300)]


@pytest.mark.parametrize("k,length,nocalls", SPEC_CASES)
def test_expected_set_and_numpy_spec(k, length, nocalls):
    rng = np.random.default_rng(k * 1000 + length)
    if nocalls is None:
        barcodes = _random_barcodes(rng, k, length)
    else:
        barcodes = _nocall_barcodes(rng, nocalls, length)
        k = len(barcodes)
    ours = port_matcher.ExpectedSet.from_barcodes(barcodes)
    theirs = jax_matcher.ExpectedSet.from_barcodes(barcodes)
    assert (ours.count, ours.length, ours.max_ns_in_barcodes) == (
        theirs.count, theirs.length, theirs.max_ns_in_barcodes)
    assert type(ours.max_ns_in_barcodes) is int
    if nocalls is not None:
        assert ours.max_ns_in_barcodes == (1 if nocalls == "every" else length)
    np.testing.assert_array_equal(ours.masks, theirs.masks)
    np.testing.assert_array_equal(ours.compat, theirs.compat)
    obs = np.frombuffer(b"ACGTN.acgtnRY", dtype=np.uint8)[rng.integers(0, 13, size=(200, length))]
    obs[::3] = np.frombuffer("".join(barcodes).upper().encode(), np.uint8).reshape(k, length)[
        rng.integers(0, k, size=len(obs[::3]))]
    np.testing.assert_array_equal(
        port_matcher.mismatch_counts_np(obs, ours), jax_matcher.mismatch_counts_np(obs, theirs))
    for mm, delta in [(1, 2), (0, 0), (3, 1)]:
        for got, want in zip(port_matcher.assign_batch_np(obs, ours, mm, delta),
                             jax_matcher.assign_batch_np(obs, theirs, mm, delta)):
            np.testing.assert_array_equal(got, want)
        masks = port_encoding.ENCODE_LUT[obs]
        for got, want in zip(port_matcher.assign_batch_np_masks(masks, ours, mm, delta),
                             jax_matcher.assign_batch_np_masks(masks, theirs, mm, delta)):
            np.testing.assert_array_equal(got, want)
    assert (port_matcher.MAX_COUNT, port_matcher.UNMATCHED) == (
        jax_matcher.MAX_COUNT, jax_matcher.UNMATCHED)
    for call in (port_matcher.ExpectedSet.from_barcodes, jax_matcher.ExpectedSet.from_barcodes):
        with pytest.raises(ValueError, match="same length"):
            call(["ACG", "AC"])


@pytest.mark.parametrize("barcodes,raises", [
    ([], ValueError), (["ACG", ""], ValueError), (["ACG", "AC"], ValueError),
    (["ACé"], UnicodeEncodeError), (["ACß", "ACGT"], None),
], ids=["none", "empty", "lengths", "non_ascii", "upper_grows"])
def test_expected_set_errors(barcodes, raises):
    """Both sides raise the same exception and message, or both accept
    (``"ACß".upper()`` is ``"ACSS"``) and agree."""
    outcomes = []
    for cls in (port_matcher.ExpectedSet, jax_matcher.ExpectedSet):
        try:
            outcomes.append(cls.from_barcodes(barcodes))
        except Exception as e:
            outcomes.append((type(e), str(e)))
    ours, theirs = outcomes
    if raises is not None:
        assert theirs[0] is raises and ours == theirs
    else:
        assert (ours.count, ours.length, ours.max_ns_in_barcodes) == (
            theirs.count, theirs.length, theirs.max_ns_in_barcodes)
        np.testing.assert_array_equal(ours.masks, theirs.masks)


PLAN_KS = [1, 96, 8_192, 737_280, 4_194_304, 4_194_305, 6_794_880, 100_000_000]


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("tile", [(512, 2048), (256, 128), (512, 4096), (512, 512)])
@pytest.mark.parametrize("length", [8, 16, 17, 255])
@pytest.mark.parametrize("k", PLAN_KS)
def test_plan_local_kernel(k, length, tile, dtype):
    tile_b, tile_k = tile
    for packed2 in (True, False):
        for extra in ({}, {"_top2_colmerge": False}, {"_fuse_key_scale": False},
                      {"_colmerge_unroll": 4}):
            kw = dict(tile_b=tile_b, tile_k=tile_k, packed2=packed2, mxu_dtype=dtype, **extra)
            assert asdict(port_plan.plan_local_kernel(k, length, **kw)) == asdict(
                jax_pallas.plan_local_kernel(k, length, **kw))
    ours = port_plan.plan_local_kernel(k, length, tile_b=tile_b, tile_k=tile_k, packed2=True)
    theirs = jax_pallas.plan_local_kernel(k, length, tile_b=tile_b, tile_k=tile_k, packed2=True)
    assert (ours.compat_scale, ours.macs_per_row) == (theirs.compat_scale, theirs.macs_per_row)


def test_plan_local_kernel_refusals():
    for call in (port_plan.plan_local_kernel, jax_pallas.plan_local_kernel):
        with pytest.raises(ValueError, match="mxu_dtype"):
            call(10, 8, mxu_dtype="fp8")
        with pytest.raises(ValueError, match="255"):
            call(10, 256)


@pytest.mark.parametrize("width", [4, 16])
@pytest.mark.parametrize("k,length,k_padded", [(1, 1, 1), (43, 13, 128), (300, 16, 384), (5, 255, 8)])
def test_compat_classmajor(k, length, k_padded, width):
    rng = np.random.default_rng(k + length)
    masks = rng.integers(0, 16, size=(k, length)).astype(np.uint8)
    got = port_plan._compat_classmajor(masks, k_padded, width)
    want = jax_pallas._compat_classmajor(masks, k_padded, width)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


RS_GOOD = ["8B92T", "+T", "10M+T", "5S5B5M5C+T", "8B", "151T", "1B1B1T", "3M2S+B"]
RS_BAD = ["", "8", "B", "0T", "8X", "+T8B", "8B++T", "-3T", "8B 92T", "++"]


@pytest.mark.parametrize("text", RS_GOOD + RS_BAD)
def test_read_structure(text):
    try:
        want = jax_rs.ReadStructure.from_str(text)
    except jax_rs.ReadStructureError as e:
        with pytest.raises(port_rs.ReadStructureError) as got:
            port_rs.ReadStructure.from_str(text)
        assert str(got.value) == str(e)
        return
    got = port_rs.ReadStructure.from_str(text)
    assert str(got) == str(want) and len(got) == len(want)
    assert got.min_length() == want.min_length() and got.has_variable == want.has_variable
    assert got.number_of_segments() == want.number_of_segments()
    for a, b in zip(got, want):
        assert (a.offset, a.length, a.kind.value) == (b.offset, b.length, b.kind.value)
    bases, quals = b"ACGTACGTACGTACGTACGT" * 10, b"IIIIFFFF##" * 20
    for a, b in zip(got, want):
        assert a.extract_bases_and_quals(bases, quals) == b.extract_bases_and_quals(bases, quals)
    for kind in "TBMCS":
        ours = got.segments_by_type(port_rs.SegmentType.from_char(kind))
        theirs = want.segments_by_type(jax_rs.SegmentType.from_char(kind))
        assert [str(s) for s in ours] == [str(s) for s in theirs]
    assert {t.value: c for t, c in port_rs.FILE_TYPE_CODE.items()} == {
        t.value: c for t, c in jax_rs.FILE_TYPE_CODE.items()}


SAMPLE_FILES = {
    "good": "sample_id\tbarcode\nS1\tACGT\nS2\tGGTT\n",
    "extra_columns": "barcode\tsample_id\tnote\nACGT\tS1\tx\nGGNN\tS2\ty\n",
    "duplicate_id": "sample_id\tbarcode\nS1\tACGT\nS1\tGGTT\n",
    "duplicate_barcode": "sample_id\tbarcode\nS1\tACGT\nS2\tACGT\n",
    "bad_base": "sample_id\tbarcode\nS1\tACXT\n",
    "empty": "sample_id\tbarcode\n",
    "no_header": "S1\tACGT\n",
    "ragged": "sample_id\tbarcode\nS1\tACGT\nS2\tGG\n",
    "missing": None,
}


@pytest.mark.parametrize("name", sorted(SAMPLE_FILES))
def test_sample_group(tmp_path, name):
    path = tmp_path / f"{name}.tsv"
    if SAMPLE_FILES[name] is not None:
        path.write_text(SAMPLE_FILES[name])
    try:
        want = jax_samples.SampleGroup.from_file(path)
    except Exception as e:  # the original's error, whatever its type
        with pytest.raises(Exception) as got:
            port_samples.SampleGroup.from_file(path)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return
    got = port_samples.SampleGroup.from_file(path)
    assert str(got) == str(want)
    assert [(s.sample_id, s.barcode, s.ordinal) for s in got.samples] == [
        (s.sample_id, s.barcode, s.ordinal) for s in want.samples]


@pytest.mark.parametrize("seed", range(4))
def test_format_f64(seed):
    rng = np.random.default_rng(seed)
    values = [0.0, 1.0, 0.1, 1 / 3, 2 / 3, 1e-7, 1e21, 1e16, 123456789.125, 5e-324,
              float("inf"), float("nan"), -0.0, -1.5]
    values += list(rng.random(200)) + list(rng.random(50) * 10.0 ** rng.integers(-12, 12, 50))
    values += [a / b for a, b in zip(rng.integers(0, 1000, 100), rng.integers(1, 1000, 100))]
    for v in values:
        assert port_floatfmt.format_f64(float(v)) == jax_floatfmt.format_f64(float(v)), v


@pytest.mark.parametrize("seed", [0, 1, 42, 2**63 + 5, 2**64 - 1])
def test_chacha_stream(seed):
    np.testing.assert_array_equal(port_chacha.seed_from_u64(seed), jax_chacha.seed_from_u64(seed))
    ours, theirs = port_chacha.ChaCha8Rng(seed), jax_chacha.ChaCha8Rng(seed)
    for n in (1, 7, 64, 1000):
        np.testing.assert_array_equal(ours.next_u64_batch(n), theirs.next_u64_batch(n))
        np.testing.assert_array_equal(ours.random_f64_batch(n), theirs.random_f64_batch(n))
        assert ours.next_u64() == theirs.next_u64()
        assert ours.random_f64() == theirs.random_f64()


@pytest.mark.parametrize("seed", range(5))
def test_siphash(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 8, 9, 63, 200):
        data = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
        k0, k1 = (int(x) for x in rng.integers(0, 2**63, size=2))
        assert port_siphash.siphash13(data, k0, k1) == jax_siphash.siphash13(data, k0, k1)
        assert port_siphash.siphash13(data) == jax_siphash.siphash13(data)
    ours, theirs = port_siphash.RustDefaultHasher(), jax_siphash.RustDefaultHasher()
    for h in (ours, theirs):
        h.write(b"abc")
        h.write_u8(7)
        h.write_u64(2**40 + seed)
        h.write_length_prefix(3)
    port_siphash.hash_path(ours, f"/data/run{seed}/./r1.fq.gz")
    jax_siphash.hash_path(theirs, f"/data/run{seed}/./r1.fq.gz")
    assert ours.finish() == theirs.finish()
    cfg = dict(inputs=[tmp for tmp in (f"a{seed}.fq", "b.fq.gz")], output="out/pre",
               fraction=0.1 * (seed + 1), threads=8, compression_level=5,
               disable_read_name_checking=bool(seed % 2))
    ours_cfg = port_subsample.SubsampleConfig(**cfg)
    theirs_cfg = jax_subsample.SubsampleConfig(**cfg)
    assert port_subsample.effective_seed(ours_cfg) == jax_subsample.effective_seed(theirs_cfg)


@pytest.mark.parametrize("case", ["typical", "all_unmatched", "one_sample", "zeros"])
def test_metrics_text(tmp_path, case):
    counts = {
        "typical": [10, 0, 7, 123456, 3],
        "all_unmatched": [0, 0, 0, 0, 99],
        "one_sample": [5, 2],
        "zeros": [0, 0, 0],
    }[case]
    n = len(counts) - 1
    meta = metadata_file(tmp_path, _random_barcodes(np.random.default_rng(n), n, 6, iupac=False))
    ours = port_demux.compute_metrics(
        port_samples.SampleGroup.from_file(meta), np.array(counts, dtype=np.int64), "unmatched")
    theirs = jax_demux.compute_metrics(
        jax_samples.SampleGroup.from_file(meta), np.array(counts, dtype=np.int64), "unmatched")
    port_demux.write_metrics(tmp_path / "ours.txt", ours)
    jax_demux.write_metrics(tmp_path / "theirs.txt", theirs)
    assert (tmp_path / "ours.txt").read_bytes() == (tmp_path / "theirs.txt").read_bytes()
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]


@pytest.mark.parametrize(
    "field", ["constants", "config", "result", "validate", "skip_reasons", "host_cap"])
def test_demux_host_side(tmp_path, monkeypatch, field):
    if field == "constants":
        for name in ("DEFAULT_BATCH_SIZE", "HOST_MATCHER_BATCH", "PALLAS_K_THRESHOLD"):
            assert getattr(port_demux, name) == getattr(jax_demux, name)
        assert [t.value for t in port_demux._TYPE_ORDER] == [t.value for t in jax_demux._TYPE_ORDER]
    elif field == "config":
        kw = dict(inputs=[Path("a")], read_structures=["+T"], sample_metadata=Path("m"),
                  output=Path("o"))
        ours, theirs = asdict(port_demux.DemuxConfig(**kw)), asdict(jax_demux.DemuxConfig(**kw))
        assert ours.pop("device") == "cuda"
        assert ours == theirs
        assert not issubclass(port_demux.DemuxConfig, jax_demux.DemuxConfig)
    elif field == "result":
        kw = dict(metrics=[], skip_counts={}, total_templates=0)
        ours, theirs = asdict(port_demux.DemuxResult(**kw)), asdict(jax_demux.DemuxResult(**kw))
        assert ours.pop("matcher") == {}
        assert ours == theirs
        assert not issubclass(port_demux.DemuxResult, jax_demux.DemuxResult)
        assert not issubclass(port_demux.DemuxError, jax_demux.DemuxError)
    elif field == "validate":
        fq = fastq_file(tmp_path, "in", "r", ["ACGT"])
        bad = dict(inputs=[fq, tmp_path / "nope.fq"], read_structures=["+T"],
                   sample_metadata=tmp_path / "m", output=tmp_path / "o",
                   output_types=["T", "X"], threads=2)
        with pytest.raises(jax_demux.DemuxError) as want:
            jax_demux.validate_and_prepare(jax_demux.DemuxConfig(**bad))
        with pytest.raises(port_demux.DemuxError) as got:
            port_demux.validate_and_prepare(port_demux.DemuxConfig(**bad))
        assert str(got.value) == str(want.value)
        good = dict(inputs=[fq], read_structures=["+T"], sample_metadata=tmp_path / "m",
                    output=tmp_path / "o2", output_types=["T", "B", "T"])
        out, types = port_demux.validate_and_prepare(port_demux.DemuxConfig(**good))
        out2, types2 = jax_demux.validate_and_prepare(jax_demux.DemuxConfig(**good))
        assert out == out2 and [t.value for t in types] == [t.value for t in types2]
    elif field == "skip_reasons":
        for reasons in ([], ["too-few-bases"], ["too few bases", "toofewbases"]):
            kw = dict(inputs=[], read_structures=[], sample_metadata=Path("m"),
                      output=Path("o"), skip_reasons=reasons)
            assert port_demux._too_few_bases_allowed(port_demux.DemuxConfig(**kw)) == (
                jax_demux._too_few_bases_allowed(jax_demux.DemuxConfig(**kw)))
        kw["skip_reasons"] = ["bogus"]
        with pytest.raises(port_demux.DemuxError, match="Invalid skip reason: bogus"):
            port_demux._too_few_bases_allowed(port_demux.DemuxConfig(**kw))
    else:
        for value in (None, "0", "4096", "junk"):
            if value is None:
                monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
            else:
                monkeypatch.setenv("FQTK_HOST_MATCHER_MAX_K", value)
            assert port_demux._host_matcher_max_k() == jax_demux._host_matcher_max_k()

        class Matcher:
            def assign(self, obs):
                return obs + 1

        for wrap in (port_demux._host_assign_wrapper, jax_demux._host_assign_wrapper):
            m = Matcher()
            fn = wrap(m)
            assert fn.native_matcher is m and fn(1) == 2


def _flags(parser):
    subs = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: {
            opt: (a.default, a.nargs, getattr(a, "choices", None), a.required,
                  getattr(a.type, "__name__", a.type), a.help, a.dest, type(a).__name__)
            for a in sub._actions
            for opt in a.option_strings
            if opt != "--version"
        }
        for name, sub in subs.choices.items()
    }, {name: sub.description for name, sub in subs.choices.items()}


@pytest.mark.parametrize("sub", ["demux", "subsample", "concat-shards"])
def test_parser_flags_defaults_and_help(sub):
    (ours, ours_desc), (theirs, theirs_desc) = (
        _flags(port_cli._build_parser()), _flags(jax_cli._build_parser()))
    assert set(ours) == set(theirs) == {"demux", "subsample", "concat-shards"}
    if sub == "demux":
        device = ours[sub].pop("--device")
        assert device[:3] == ("cuda", None, ["cuda", "cpu"])
    assert ours[sub] == theirs[sub]
    assert ours_desc[sub] == theirs_desc[sub]


@pytest.mark.parametrize("fraction,seed", [(0.3, 42), (0.9, 7), (0.0, 1)])
def test_subsample_bytes(tmp_path, fraction, seed):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(500)]
    r1 = fastq_file(tmp_path, "r1", "q", reads)
    r2 = fastq_file(tmp_path, "r2", "q", reads[::-1])
    outs = {}
    for name, mod in (("port", port_subsample), ("jax", jax_subsample)):
        for native in (True, False):
            prefix = tmp_path / f"{name}_{native}"
            res = mod.run_subsample(
                mod.SubsampleConfig(inputs=[r1, r2], output=prefix, fraction=fraction, seed=seed),
                use_native=native,
            )
            outs[name, native] = (
                gzip.open(f"{prefix}.R1.fq.gz").read(), gzip.open(f"{prefix}.R2.fq.gz").read(),
                res.records_read if hasattr(res, "records_read") else None,
            )
    assert outs["port", True][:2] == outs["jax", True][:2]
    assert outs["port", False][:2] == outs["jax", False][:2]
    assert outs["port", True][:2] == outs["port", False][:2]


def test_top_level_surface_is_the_ports_own():
    """Every name of ``fqtk_tpu.__all__`` resolves in ``fqtk_tpu_torch`` to
    the port's own module (lazily, as there), and the port's own entry
    points stay exported."""
    for name in fqtk_tpu.__all__:
        ours, theirs = getattr(fqtk_tpu_torch, name), getattr(fqtk_tpu, name)
        if name == "__version__":
            assert ours == theirs
            continue
        assert ours.__module__.startswith("fqtk_tpu_torch."), (name, ours.__module__)
        assert ours.__module__.split(".", 1)[1] == theirs.__module__.split(".", 1)[1], name
        assert ours is not theirs and name in dir(fqtk_tpu_torch)
    assert {"DemuxConfig", "run_demux", "make_hopper_assign_fn",
            "hopper_state_from_numpy"} <= set(fqtk_tpu_torch.__all__)
    with pytest.raises(AttributeError):
        fqtk_tpu_torch.no_such_name  # noqa: B018


@pytest.mark.parametrize(
    "piece", ["encoding", "headers", "merge", "stage_timers", "bitenc", "barcode_matcher"])
def test_small_copies(tmp_path, piece):
    if piece == "bitenc":
        rng = np.random.default_rng(8)
        for width in range(1, 9):
            ours, theirs = port_bitenc.BitEnc(width), jax_bitenc.BitEnc(width)
            for v in rng.integers(0, 256, size=100):
                ours.push(int(v))
                theirs.push(int(v))
            assert list(ours) == list(theirs) and ours._storage == theirs._storage
        with pytest.raises(ValueError) as got:
            port_bitenc.BitEnc(0)
        with pytest.raises(ValueError) as want:
            jax_bitenc.BitEnc(0)
        assert str(got.value) == str(want.value)
        for a, b in ((b"GATTACA", b"GANNACA"), (b"N", b"R"), (b"ACGTRYKM", b"TTTTNNNN")):
            for cap in (1, 3, 255):
                assert port_bitenc.encode_bitenc(a).hamming(port_bitenc.encode_bitenc(b), cap) == (
                    jax_bitenc.encode_bitenc(a).hamming(jax_bitenc.encode_bitenc(b), cap))
    elif piece == "barcode_matcher":
        barcodes = _random_barcodes(np.random.default_rng(4), 20, 7, iupac=False)
        ours = port_bm.BarcodeMatcher(
            [port_samples.Sample(f"s{i}", b, i) for i, b in enumerate(barcodes)], 1, 2)
        theirs = jax_bm.BarcodeMatcher(
            [jax_samples.Sample(f"s{i}", b, i) for i, b in enumerate(barcodes)], 1, 2)
        rng = np.random.default_rng(5)
        reads = [bytes(r) for r in np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (200, 7))]]
        reads += [b.encode() for b in barcodes] + [b"ACG"]
        for read in reads:
            got, want = ours.assign(read), theirs.assign(read)
            assert (None if got is None else tuple(vars(got).values())) == (
                None if want is None else tuple(vars(want).values())), read
        for m in (ours, theirs):
            with pytest.raises(ValueError, match="at least one sample"):
                type(m)([], 1, 2)
    elif piece == "encoding":
        np.testing.assert_array_equal(port_encoding.ENCODE_LUT, jax_encoding.ENCODE_LUT)
        np.testing.assert_array_equal(port_encoding.NOCALL_LUT, jax_encoding.NOCALL_LUT)
        for seq in (b"ACGTN", b"acgtn.RYKM", b"", b"NNNN"):
            np.testing.assert_array_equal(port_encoding.encode(seq), jax_encoding.encode(seq))
            assert port_encoding.count_nocalls(seq) == jax_encoding.count_nocalls(seq)
            assert port_encoding.decode(port_encoding.encode(seq)) == jax_encoding.decode(
                jax_encoding.encode(seq))
        for byte in range(256):
            assert port_encoding.is_valid_iupac(byte) == jax_encoding.is_valid_iupac(byte)
            assert port_encoding.byte_is_nocall(byte) == jax_encoding.byte_is_nocall(byte)
    elif piece == "headers":
        heads = [b"@inst:1:AB:1:2:7:3 1:N:0:0", b"@q_5", b"@a:b:c:d:e:f:g", b"@x y",
                 b"@inst:1:AB:1:2:7:3 2:Y:18:ACGT"]
        for head in heads:
            for idx in (1, 2):
                for bcs, umis in (([b"ACGT"], []), ([b"AC", b"GT"], [b"TTT"]), ([], [b"A", b"C"])):
                    try:
                        want = jax_headers.rewrite_header(head, idx, bcs, umis)
                    except jax_headers.HeaderError as e:
                        with pytest.raises(port_headers.HeaderError) as got:
                            port_headers.rewrite_header(head, idx, bcs, umis)
                        assert str(got.value) == str(e)
                    else:
                        assert port_headers.rewrite_header(head, idx, bcs, umis) == want
    elif piece == "merge":
        from fqtk_tpu_torch.io.fastq import BgzfWriter

        for root in ("ours", "theirs"):
            for pid in (0, 1):
                shard = tmp_path / root / f"shard-{pid}"
                shard.mkdir(parents=True)
                with BgzfWriter(shard / "S1.R1.fq.gz", 5) as w:
                    w.write(f"@r{pid}\nACGT\n+\nIIII\n".encode() * 50)
                (shard / "demux-metrics.txt").write_text("x\n")
        port_merge.concat_shards(tmp_path / "ours", remove_shards=True)
        jax_merge.concat_shards(tmp_path / "theirs", remove_shards=True)
        assert (tmp_path / "ours" / "S1.R1.fq.gz").read_bytes() == (
            tmp_path / "theirs" / "S1.R1.fq.gz").read_bytes()
        assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == sorted(
            p.name for p in (tmp_path / "theirs").iterdir())
    else:
        ours, theirs = port_profiling.StageTimers(), jax_profiling.StageTimers()
        for timers in (ours, theirs):
            with timers.time("assign"):
                pass
            with timers.time("assign"):
                pass
            with timers.time("submit"):
                pass
        assert dict(ours.counts) == dict(theirs.counts) == {"assign": 2, "submit": 1}
        assert set(ours.summary()) == set(theirs.summary())


#: the driver entry points' and the harness's generators: verbatim copies of
#: ``__graft_entry__.py``'s and ``bench.py``'s (root modules, imported here only)
GENERATORS = {
    "_whitelist": "graft", "_observed": "graft", "make_whitelist": "bench",
    "write_metadata": "bench", "write_inputs": "bench", "write_single_end_inputs": "bench",
}


def _root_module(name):
    sys.path.insert(0, str(ROOT))
    try:
        return __import__({"graft": "__graft_entry__", "bench": "bench"}[name])
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("fn", sorted(GENERATORS))
def test_generator_copies(tmp_path, fn):
    import inspect

    from fqtk_tpu_torch import bench as port_bench
    from fqtk_tpu_torch import graft_entry as port_graft

    where = GENERATORS[fn]
    ours = getattr(port_graft if where == "graft" else port_bench, fn)
    theirs = getattr(_root_module(where), fn)
    assert inspect.getsource(ours) == inspect.getsource(theirs)
    if fn == "_whitelist":
        for k, length in ((96, 17), (16, 17), (5, 3)):
            assert ours(k, length) == theirs(k, length)
    elif fn == "_observed":
        barcodes = port_graft._whitelist(96, 17)
        for batch in (8, 50, 8192):
            np.testing.assert_array_equal(ours(batch, 17, barcodes), theirs(batch, 17, barcodes))
    elif fn == "make_whitelist":
        assert ours(96, 17) == theirs(96, 17)
        assert ours(16, 17, seed=23) == theirs(16, 17, seed=23)
    elif fn == "write_metadata":
        barcodes = port_bench.make_whitelist(16, 17, seed=21)
        assert ours(tmp_path, barcodes, "a.tsv").read_bytes() == theirs(
            tmp_path, barcodes, "b.tsv").read_bytes()
    elif fn == "write_inputs":
        barcodes = port_bench.make_whitelist(96, 17)
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        got, _ = ours(tmp_path / "a", barcodes, n_reads=1200)
        want, _ = theirs(tmp_path / "b", barcodes, n_reads=1200)
        for n in ("i1", "r1", "r2", "i2"):
            assert gzip.decompress(got[n].read_bytes()) == gzip.decompress(want[n].read_bytes())
    else:
        barcodes = port_bench.make_whitelist(16, 17, seed=23)
        for var in (False, True):
            got, _ = ours(tmp_path, barcodes, 1500, f"a{var}", var_template=var)
            want, _ = theirs(tmp_path, barcodes, 1500, f"b{var}", var_template=var)
            assert gzip.decompress(got.read_bytes()) == gzip.decompress(want.read_bytes())


# --------------------------------------------------------------------------
# the binding's guard of newer exports
# --------------------------------------------------------------------------


class _StaleLib:
    """The loaded engine with some exports hidden: a library built before
    they were added."""

    def __init__(self, real, hidden):
        self._real, self._hidden = real, set(hidden)

    def __getattr__(self, name):
        if name in self._hidden:
            raise AttributeError(name)
        return getattr(self._real, name)


@pytest.mark.parametrize("hidden", [
    ("fqtk_subsample_stats",),
    ("fqtk_rng_new", "fqtk_rng_keep_mask", "fqtk_rng_free"),
    ("fqtk_demux_pipe_fuse_host_matcher", "fqtk_demux_pipe_fused_poll"),
])
def test_stale_library_reports_missing_optional_exports(monkeypatch, caplog, hidden):
    real = port_native.get_lib()
    if real is None:
        pytest.skip("native library unavailable")
    stale = _StaleLib(real, hidden)
    monkeypatch.setattr(port_native.ctypes, "CDLL", lambda path: stale)
    monkeypatch.setattr(port_native, "_missing_optional", [])
    with caplog.at_level("WARNING", logger="fqtk"):
        lib = port_native._load("stale.so")
    assert lib is stale  # the engine still loads: the native path stays on
    assert port_native.missing_optional() == list(hidden)
    for name in hidden:
        assert name in caplog.text  # reported by name
        with pytest.raises(port_native.NativeDemuxError, match=name):
            port_native._require(lib, name)
    assert set(hidden) <= set(port_native.OPTIONAL_EXPORTS)


def test_stale_library_without_a_required_export_is_refused(monkeypatch, caplog):
    real = port_native.get_lib()
    if real is None:
        pytest.skip("native library unavailable")
    stale = _StaleLib(real, ["fqtk_demux_pipe_acquire"])
    monkeypatch.setattr(port_native.ctypes, "CDLL", lambda path: stale)
    with caplog.at_level("ERROR", logger="fqtk"):
        assert port_native._load("stale.so") is None
    assert "fqtk_demux_pipe_acquire" in caplog.text
    # the JAX package's binding is untouched by the port's guard
    assert not hasattr(jax_native, "OPTIONAL_EXPORTS")
