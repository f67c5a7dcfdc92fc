"""The port's Python-IO engine (``run_demux`` with ``engine`` ``numpy``,
``jax`` or ``pallas`` on ``device="cpu"``) against ``fqtk_tpu``'s run of
the same engine on the CPU: the NumPy spec, the JAX XLA scan, and the Pallas
kernel in interpret mode.

Every scenario of the ``ENGINES``-parametrised cases of
``tests/test_demux_e2e.py`` (fragment reads, output types, catch-all, IUPAC
and N barcodes, in-line and dual-index paired reads, odd read structures,
multiple templates, too-short reads skipped and failing, gzip inputs,
single-cell style, an all-skip window, staggered EOF, empty inputs) plus
the validation failures, the variable-length barcode overrides and a
barcode longer than 255 bp.  Exact: decompressed outputs and
``demux-metrics.txt`` byte for byte, skip counts, template totals, and for
a failing run the error's type and text."""

import gzip
import random

import pytest

from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch.runtime import demux as port_demux

from .util import SAMPLE1_BARCODE, fastq_file, metadata, metadata_file

ENGINES = ["numpy", "jax", "pallas"]
S1 = "AAAAAAAAGATTACAGA"
FOUR = [S1, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"]


def _validate_ok(t):
    inputs = [
        fastq_file(t, "read1", "ex", ["GATTACA"]),
        fastq_file(t, "read2", "ex", ["TAGGATTA"]),
        fastq_file(t, "index1", "ex", [SAMPLE1_BARCODE[0:3]]),
        fastq_file(t, "index2", "ex", [SAMPLE1_BARCODE[3:]]),
    ]
    return inputs, ["+T", "+T", "+B", "+B"], metadata(t), {}


def _struct_count_mismatch(t):
    inputs, structures, meta, kw = _validate_ok(t)
    return inputs, structures[:3], meta, kw


def _input_missing(t):
    return ([t / "this_file_does_not_exist.fq", fastq_file(t, "read2", "ex", ["TAGGATTA"])],
            ["+T", "+T"], metadata(t), {})


def _too_few_threads(t):
    return [fastq_file(t, "read1", "ex", ["GATTACA"])], ["+T"], metadata(t), dict(threads=2)


def _no_output_types(t):
    return [fastq_file(t, "read1", "ex", ["GATTACA"])], ["+T"], metadata(t), dict(output_types=[])


def _fragment(t):
    return ([fastq_file(t, "ex", "ex", [S1 + "A" * 100])], ["17B100T"],
            metadata_file(t, FOUR), {})


def _output_types(t):
    meta = metadata_file(t, ["AAAAAAAA", "CCCCCCCC", "GGGGGGGG", "TTTTTTTT"])
    inputs = [fastq_file(t, "ex", "ex", ["ATCGATCGAT" + "AAAAAAAA" + "GATTACA" + "A" * 100])]
    return inputs, ["10M8B7C100T"], meta, dict(output_types=["T", "B", "M", "C"])


def _catchall(t):
    return ([fastq_file(t, "ex", "ex", ["NNNNNNN" + "A" * 100])], ["7B+T"],
            metadata_file(t, ["NNNNNNN"]), dict(max_mismatches=0))


def _iupac(t):
    reads = ["AAAAAAA" + "A" * 5, "CCCCCCC" + "A" * 5, "ACACACA" + "A" * 5,
             "GTGTGTG" + "C" * 5, "TGTGTGT" + "C" * 5, "CGCGCGC" + "T" * 5]
    return ([fastq_file(t, "ex", "ex", reads)], ["7B+T"],
            metadata_file(t, ["MMMMMMM", "KKKKKKK"]),
            dict(max_mismatches=0, min_mismatch_delta=0))


def _ns(t):
    reads = ["ANAAAAA" + "A" * 5, "ANCCCCC" + "C" * 5, "NNNAAAA" + "T" * 5]
    return ([fastq_file(t, "ex", "ex", reads)], ["7B+T"],
            metadata_file(t, ["NNAAAAA", "NNCCCCC"]),
            dict(max_mismatches=0, min_mismatch_delta=0))


def _paired_in_line(t):
    inputs = [fastq_file(t, "ex_R1", "ex", [S1[:8] + "A" * 100]),
              fastq_file(t, "ex_R2", "ex", [S1[8:] + "T" * 100])]
    return inputs, ["8B100T", "9B100T"], metadata_file(t, FOUR), {}


def _dual_index(t):
    inputs = [fastq_file(t, "ex_I1", "ex", [S1[:8], "CCCCCCCC", "TTTTTTTT"]),
              fastq_file(t, "ex_R1", "ex", ["A" * 100] * 3),
              fastq_file(t, "ex_R2", "ex", ["T" * 100] * 3),
              fastq_file(t, "ex_I2", "ex", [S1[8:], "GATTACAGA", "GATTACAGA"])]
    return inputs, ["8B", "100T", "100T", "9B"], metadata_file(t, FOUR), {}


def _weird(t):
    inputs = [fastq_file(t, "example_1", "ex", ["AAAACCCCGGGGTTTT"]),
              fastq_file(t, "example_2", "ex", ["A" * 104]),
              fastq_file(t, "example_3", "ex", ["T" * 100 + "GAT"]),
              fastq_file(t, "example_4", "ex", ["TACAGAAAT"])]
    return inputs, ["4B4M8S", "4B100T", "100S3B", "6B1S1M1T"], metadata_file(t, FOUR), {}


def _multiple_templates(t):
    read = S1 + "A" * 20 + "C" * 20 + "T" * 20 + "C" * 20 + "G" * 20
    return ([fastq_file(t, "ex", "ex", [read])], ["17B20T20S20T20S20T"],
            metadata_file(t, FOUR), {})


def _short_inputs(t):
    return [fastq_file(t, "read1", "ex", ["AAAAAAA", "CCCCCCC", ""]),
            fastq_file(t, "index1", "ex", [SAMPLE1_BARCODE[0:7], SAMPLE1_BARCODE,
                                           SAMPLE1_BARCODE])]


def _too_short_fails(t):
    return _short_inputs(t), ["+T", "7B"], metadata(t), dict(output_types=["T", "B"])


def _too_short_skipped(t):
    return (_short_inputs(t), ["+T", "7B"], metadata(t),
            dict(output_types=["T", "B"], skip_reasons=["too-few-bases"]))


def _gzip_inputs(t):
    raw = fastq_file(t, "ex", "ex", ["AAAA" + "G" * 10, "CCCC" + "G" * 10, "AAAT" + "G" * 10])
    gz_path = t / "ex.fastq.gz"
    with gzip.open(gz_path, "wb") as fh:
        fh.write(raw.read_bytes())
    return [gz_path], ["4B+T"], metadata_file(t, ["AAAA", "CCCC"]), {}


def _single_cell(t):
    rng = random.Random(9)
    barcodes = sorted({"".join(rng.choice("ACGT") for _ in range(10)) for _ in range(200)})
    reads = []
    for i in range(40):
        cell = "".join(rng.choice("ACGT") for _ in range(16))
        umi = "".join(rng.choice("ACGT") for _ in range(12))
        reads.append(cell + umi + barcodes[i % len(barcodes)] + "ACGT" * 10)
    return ([fastq_file(t, "sc", "sc", reads)], ["16C12M10B+T"], metadata_file(t, barcodes),
            dict(output_types=["T", "C", "M"], batch_size=16))


def _all_skip_window(t):
    reads = ["AC" if 6 <= i < 12 else "AAAA" + "G" * 6 for i in range(20)]
    return ([fastq_file(t, "in", "sk", reads)], ["4B+T"], metadata_file(t, ["AAAA"]),
            dict(skip_reasons=["too-few-bases"], batch_size=3))


def _staggered_skip(t):
    inputs = [fastq_file(t, "bc", "s", ["AAAA", "AAAA"]),
              fastq_file(t, "t", "s", ["G" * 20, "G" * 20, "G" * 10, "G" * 10])]
    return (inputs, ["4B", "20T"], metadata_file(t, ["AAAA"]),
            dict(skip_reasons=["too-few-bases"], batch_size=3))


def _staggered_error(t):
    inputs = [fastq_file(t, "bc", "s", ["AAAA"]), fastq_file(t, "t", "s", ["G" * 20, "G" * 10])]
    return inputs, ["4B", "20T"], metadata_file(t, ["AAAA"]), dict(batch_size=3)


def _out_of_sync(t):
    inputs = [fastq_file(t, "bc", "a", ["AAAA"]), fastq_file(t, "t", "b", ["G" * 20, "G" * 20])]
    return inputs, ["4B", "20T"], metadata_file(t, ["AAAA"]), dict(batch_size=3)


def _empty(t):
    empty = t / "empty.fastq"
    empty.write_text("")
    return [empty], ["4B+T"], metadata_file(t, ["AAAA"]), {}


def _pallas_case(t):
    reads = [S1 + "A" * 100, "CCCCCCCCGATTACAGA" + "G" * 100, "TTTTTTTTTTTTTTTTT" + "C" * 100]
    return ([fastq_file(t, "ex", "ex", reads)], ["17B100T"], metadata_file(t, FOUR),
            dict(batch_size=64))


def _variable_length_override(t):
    recs = ["ACGT" + "GATTACAT", "ACGT" + "NNNNNNN", "ACGT" + "GATTAC", "ACGT" + "NNNNNNNNNN"]
    return ([fastq_file(t, "vb", "ex", recs)], ["4T+B"], metadata_file(t, ["GATTACAT"]),
            dict(batch_size=4))


def _variable_length_error(t):
    recs = ["ACGT" + "GATTACAT", "ACGT" + "GATTACATT"]
    return ([fastq_file(t, "vb", "ex", recs)], ["4T+B"], metadata_file(t, ["GATTACAT"]),
            dict(batch_size=4))


def _long_barcode(t):
    rng = random.Random(3)
    barcodes = ["".join(rng.choice("ACGT") for _ in range(256)) for _ in range(3)]
    reads = [barcodes[i % 3] + "ACGT" for i in range(5)] + ["T" * 256 + "ACGT"]
    return ([fastq_file(t, "lb", "lb", reads)], ["256B+T"], metadata_file(t, barcodes),
            dict(batch_size=4))


SCENARIOS = {
    "validate_inputs_can_succeed": _validate_ok,
    "different_number_of_read_structs_fails": _struct_count_mismatch,
    "inputs_doesnt_exist_fails": _input_missing,
    "too_few_threads_fails": _too_few_threads,
    "no_output_types_fails": _no_output_types,
    "fragment_reads": _fragment,
    "output_type_reads": _output_types,
    "catchall_barcode": _catchall,
    "iupac_bases_in_barcode": _iupac,
    "ns_in_barcode": _ns,
    "paired_reads_in_line_barcodes": _paired_in_line,
    "dual_indexed_paired_end": _dual_index,
    "wierd_set_of_reads": _weird,
    "multiple_templates_in_one_read": _multiple_templates,
    "fails_if_reads_too_short": _too_short_fails,
    "skip_reads_too_short": _too_short_skipped,
    "gzip_inputs": _gzip_inputs,
    "single_cell_style": _single_cell,
    "all_skip_batch_window": _all_skip_window,
    "staggered_eof_skip": _staggered_skip,
    "staggered_eof_error": _staggered_error,
    "out_of_sync": _out_of_sync,
    "empty_inputs": _empty,
    "three_reads_batch_64": _pallas_case,
    "variable_length_override": _variable_length_override,
    "variable_length_error": _variable_length_error,
    "barcode_longer_than_255": _long_barcode,
}


def _run(mod, engine, inputs, structures, meta, out, kw, **extra):
    cfg = dict(output_types=["T"], unmatched_prefix="unmatched", max_mismatches=1,
               min_mismatch_delta=2, threads=5, compression_level=5, skip_reasons=[],
               batch_size=7, engine=engine)
    cfg.update(kw)
    try:
        res = mod.run_demux(mod.DemuxConfig(inputs=inputs, read_structures=structures,
                                            sample_metadata=meta, output=out, **cfg, **extra))
    except Exception as e:  # the reference's error, whatever its type
        return ("error", type(e).__name__, str(e)), None
    blob = {p.name: gzip.open(p).read() for p in sorted(out.glob("*.fq.gz"))}
    blob["demux-metrics.txt"] = (out / "demux-metrics.txt").read_bytes()
    # repr: NaN metrics (no templates) compare equal as text
    return ("ok", blob, res.skip_counts, res.total_templates, repr(res.metrics)), res


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_python_engine_matches_jax_package(tmp_path, name, engine):
    (tmp_path / "in").mkdir()
    inputs, structures, meta, kw = SCENARIOS[name](tmp_path / "in")
    want, _ = _run(jax_demux, engine, inputs, structures, meta, tmp_path / "jax", kw)
    got, res = _run(port_demux, engine, inputs, structures, meta, tmp_path / "port", kw,
                    device="cpu")
    assert got == want
    if got[0] == "error":
        return
    if engine == "numpy":
        assert res.matcher == {}
    elif engine == "jax":
        assert res.matcher["scheme"] == "xla_scan" and res.matcher["launches"] == 0
    else:
        assert res.matcher["scheme"] == "colmerge_top2"
        assert res.matcher["launches"] == 0  # no card here: the plain version
        assert res.matcher["colmerge_top2_plain_calls"] == res.matcher["plain_calls"]


def test_scenarios_reach_both_outcomes(tmp_path):
    """The table holds successful runs with reads routed, and failures (the
    byte comparison above is not vacuous)."""
    outcomes = {}
    for name in ("fragment_reads", "fails_if_reads_too_short", "barcode_longer_than_255"):
        t = tmp_path / name
        t.mkdir()
        inputs, structures, meta, kw = SCENARIOS[name](t)
        for engine in ("numpy", "pallas"):
            outcomes[name, engine] = _run(port_demux, engine, inputs, structures, meta,
                                          t / engine, kw, device="cpu")[0]
    ok = outcomes["fragment_reads", "pallas"]
    assert ok[0] == "ok" and ok[1]["Sample0000.R1.fq.gz"].startswith(b"@ex_0 1:N:0:" + S1.encode())
    assert outcomes["fails_if_reads_too_short", "numpy"][:2] == ("error", "DemuxError")
    assert outcomes["barcode_longer_than_255", "numpy"][0] == "ok"
    assert outcomes["barcode_longer_than_255", "pallas"][:2] == ("error", "ValueError")
    assert "pallas matcher supports barcode lengths <= 255" in outcomes[
        "barcode_longer_than_255", "pallas"][2]


def test_auto_stays_native_and_raises_without_it(tmp_path, monkeypatch):
    """``engine="auto"`` never drops to the Python-IO engine: where the
    native engine cannot be built, it raises."""
    from fqtk_tpu_torch.ops import _build

    (tmp_path / "in").mkdir()
    inputs, structures, meta, kw = _fragment(tmp_path / "in")

    def no_engine():
        raise _build.BuildError("native engine unavailable (test)")

    monkeypatch.setattr(port_demux, "ensure_native_engine", no_engine)
    ran = []
    monkeypatch.setattr(port_demux, "_run_demux_python", lambda cfg, e: ran.append(e))
    for engine in ("auto", "native"):
        got, _ = _run(port_demux, engine, inputs, structures, meta, tmp_path / "o", kw,
                      device="cpu")
        assert got == ("error", "BuildError", "native engine unavailable (test)")
    assert not ran


def test_engine_checks_the_device(tmp_path, monkeypatch):
    """``cfg.device`` is checked on every engine: ``cuda`` without a card
    raises before any output is written."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "in").mkdir()
    inputs, structures, meta, kw = _fragment(tmp_path / "in")
    for engine in ENGINES:
        got, _ = _run(port_demux, engine, inputs, structures, meta, tmp_path / engine, kw)
        assert got[:2] == ("error", "RuntimeError") and "cuda" in got[2]
        assert not (tmp_path / engine).exists()


@pytest.mark.parametrize("engine", ENGINES)
def test_assigner_returns_a_writable_copy(tmp_path, engine):
    """The Python-IO loop overwrites rows of the result (short and no-call
    barcodes): on the CPU a device matcher's ``.numpy()`` would share the
    tensor's memory, so the assigner hands back a copy of its own."""
    import numpy as np

    from fqtk_tpu_torch.ops.matcher import ExpectedSet

    es = ExpectedSet.from_barcodes(FOUR)
    cfg = port_demux.DemuxConfig(inputs=[], read_structures=[], sample_metadata=tmp_path,
                                 output=tmp_path, device="cpu")
    assign = port_demux._make_assigner(cfg, es, engine_override=engine)
    obs = np.frombuffer((S1 * 3).encode(), dtype=np.uint8).reshape(3, -1).copy()
    first = assign(obs)
    assert first.flags.writeable and first.flags.owndata
    assert first.dtype == np.int32 and first.tolist() == [0, 0, 0]
    first[:] = es.count
    assert assign(obs).tolist() == [0, 0, 0]
