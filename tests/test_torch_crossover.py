"""The port's measured matcher placement, its disk cache and the in-process
cache of built matchers (``fqtk_tpu_torch/runtime/demux.py``).

The first seven tests mirror ``tests/test_crossover.py`` against the port,
with the probe's timers, ``_probe_allowed`` and the cache path monkeypatched
as there (the real probe runs only where ``device`` is ``cuda``).  Then:
the port and ``fqtk_tpu`` choose the same side for the same faked timings;
the cache key and file are the port's own; the real timers run on the CPU;
and ``_ASSIGN_FN_CACHE`` reuses a built matcher, evicts at four entries and
reports each run's own counts.  No test writes outside ``tmp_path``."""

import gzip
import json
import math

import numpy as np
import pytest
import torch

from fqtk_tpu.ops.matcher import ExpectedSet as JaxExpectedSet
from fqtk_tpu.runtime import demux as jax_demux
from fqtk_tpu_torch.io import native as native_io
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.ops.device_encoding import pack_bit2
from fqtk_tpu_torch.ops.matcher import ExpectedSet, assign_batch_np
from fqtk_tpu_torch.parallel import mesh as mesh_mod
from fqtk_tpu_torch.runtime import demux as demux_mod
from fqtk_tpu_torch.runtime.demux import DemuxConfig, run_demux

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native library required"
)

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _barcodes(k, length, seed):
    rng = np.random.default_rng(seed)
    out = set()
    while len(out) < k:
        out.add(bytes(rng.choice(ACGT, size=length)).decode())
    return sorted(out)


def _cfg(tmp_path, barcodes, cls=DemuxConfig, **kw):
    meta = tmp_path / "meta.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i}\t{b}\n" for i, b in enumerate(barcodes))
    )
    if cls is DemuxConfig:
        kw.setdefault("device", "cpu")
    kw.setdefault("batch_size", 64)
    return cls(
        inputs=[tmp_path / "in.fastq"],
        read_structures=[f"{len(barcodes[0])}B+T"],
        sample_metadata=meta,
        output=tmp_path / "out",
        **kw,
    )


def _fastq(tmp_path, barcodes, n=40):
    src = tmp_path / "in.fastq"
    with open(src, "w") as fh:
        for i in range(n):
            fh.write(f"@q{i} 1:N:0:0\n{barcodes[i % len(barcodes)]}ACGT\n+\n"
                     f"{';' * (len(barcodes[0]) + 4)}\n")
    return src


def _outputs(out):
    blob = {p.name: gzip.open(p).read() for p in sorted(out.glob("*.fq.gz"))}
    blob["demux-metrics.txt"] = (out / "demux-metrics.txt").read_bytes()
    return blob


def _arm(monkeypatch, tmp_path, host_s, floor_s, device_s, mod=demux_mod):
    """Fake the probe's timers on ``mod`` (the port, or the JAX package for
    the parity test), with its cache file in ``tmp_path``."""
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    monkeypatch.delenv("FQTK_MEASURE_CROSSOVER", raising=False)
    if mod is demux_mod:
        monkeypatch.setattr(mod, "_CROSSOVER_CACHE_PATH", str(tmp_path / "crossover-torch.json"))
        monkeypatch.setattr(mod, "_probe_allowed", lambda device: True)
        monkeypatch.setattr(mod, "_device_floor_seconds", lambda b, w, d, reps=2: floor_s)
    else:
        monkeypatch.setattr(mod, "_CROSSOVER_CACHE_PATH", str(tmp_path / "crossover.json"))
        monkeypatch.setattr(mod, "_probe_allowed", lambda: True)
        monkeypatch.setattr(mod, "_device_floor_seconds", lambda b, w, reps=2: floor_s)
    monkeypatch.setattr(mod, "_time_host_window", lambda m, w, reps=2: host_s)
    monkeypatch.setattr(mod, "_time_device_window", lambda fn, ws: device_s)
    mod._ASSIGN_FN_CACHE.clear()


# --------------------------------------------------------------------------
# the seven cases of tests/test_crossover.py
# --------------------------------------------------------------------------


def test_fast_device_flips_auto_to_device(monkeypatch, tmp_path):
    """A device that wins the measured A/B takes the auto placement even at
    a whitelist size the static cap keeps on the host."""
    _arm(monkeypatch, tmp_path, host_s=0.050, floor_s=0.0002, device_s=0.001)
    barcodes = _barcodes(40, 10, seed=1)
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert not host_matcher, "fast device must win the measured placement"
    assert pack_mode == "bit2" and assign.device_matcher.scheme == "colmerge_top2"
    info = getattr(assign, "crossover", {})
    assert info.get("crossover_device_chosen") == 1.0
    assert info.get("crossover_device_s") == pytest.approx(0.001)


def test_relay_like_floor_keeps_host_without_device_build(monkeypatch, tmp_path):
    """A fat device floor and a quick host scan: host wins and the device
    matcher is never built."""
    _arm(monkeypatch, tmp_path, host_s=0.003, floor_s=0.025, device_s=None)
    built = []
    real_build = demux_mod._build_device_side
    monkeypatch.setattr(
        demux_mod,
        "_build_device_side",
        lambda cfg, es: built.append(1) or real_build(cfg, es),
    )
    barcodes = _barcodes(37, 9, seed=2)
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host_matcher and pack_mode == "nib4"
    assert not built, "host decision must skip the device matcher build"
    info = getattr(assign, "crossover", {})
    assert info.get("crossover_device_chosen") == 0.0
    assert info.get("crossover_host_s") == pytest.approx(0.003)

    # decision is disk-cached: a fresh call must not re-probe
    def boom(*a, **k):
        raise AssertionError("probe must not re-run on a cached decision")

    monkeypatch.setattr(demux_mod, "_time_host_window", boom)
    monkeypatch.setattr(demux_mod, "_device_floor_seconds", boom)
    demux_mod._ASSIGN_FN_CACHE.clear()
    assign2, _, host2 = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host2
    assert assign2.crossover == info


def test_decision_surfaces_in_demux_result_timings(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, host_s=0.002, floor_s=0.030, device_s=None)
    barcodes = _barcodes(20, 8, seed=3)
    _fastq(tmp_path, barcodes)
    cfg = _cfg(tmp_path, barcodes, engine="native")
    res = run_demux(cfg)
    assert res.timings.get("crossover_device_chosen") == 0.0
    assert "crossover_host_s" in res.timings
    assert res.matcher == {}  # a host matcher ran
    out = gzip.open(tmp_path / "out" / "S0.R1.fq.gz").read()
    assert out.count(b"@q") > 0


def test_env_cap_still_overrides(monkeypatch, tmp_path):
    """An explicit FQTK_HOST_MATCHER_MAX_K pins the crossover; the probe
    must not run at all."""

    def boom(*a, **k):
        raise AssertionError("probe must not run with an explicit cap")

    monkeypatch.setenv("FQTK_HOST_MATCHER_MAX_K", "100")
    monkeypatch.setattr(demux_mod, "_measured_placement", boom)
    demux_mod._ASSIGN_FN_CACHE.clear()
    barcodes = _barcodes(50, 9, seed=4)
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes, device="cuda")  # never resolved: no probe
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host_matcher  # 50 <= 100


def test_cpu_device_uses_static_cap(monkeypatch, tmp_path):
    """On ``device="cpu"`` the static 4096 cap applies and no probe artifact
    appears."""
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    monkeypatch.setattr(
        demux_mod, "_CROSSOVER_CACHE_PATH", str(tmp_path / "crossover-torch.json")
    )
    demux_mod._ASSIGN_FN_CACHE.clear()
    barcodes = _barcodes(30, 9, seed=5)
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host_matcher and pack_mode == "nib4"
    assert not hasattr(assign, "crossover")
    assert not list(tmp_path.glob("crossover*"))


def test_cache_key_distinguishes_same_shape_whitelists(monkeypatch, tmp_path):
    """Two whitelists of identical (K, L, batch, mm, delta) never share a
    cached placement decision (host timing is content-dependent)."""
    _arm(monkeypatch, tmp_path, host_s=0.003, floor_s=0.025, device_s=None)
    barcodes_a = _barcodes(24, 9, seed=10)
    barcodes_b = _barcodes(24, 9, seed=11)
    assert barcodes_a != barcodes_b
    es_a = ExpectedSet.from_barcodes(barcodes_a)
    es_b = ExpectedSet.from_barcodes(barcodes_b)
    cfg_a = _cfg(tmp_path, barcodes_a)
    key_a = demux_mod._crossover_cache_key(cfg_a, es_a)
    key_b = demux_mod._crossover_cache_key(cfg_a, es_b)
    assert key_a != key_b, "same-shape whitelists must have independent keys"
    assert key_a == demux_mod._crossover_cache_key(
        cfg_a, ExpectedSet.from_barcodes(list(barcodes_a))
    )

    # end to end: decide for whitelist A, then whitelist B must re-probe
    demux_mod._build_device_assign_fn(cfg_a, es_a, barcodes=barcodes_a)
    probes = []
    monkeypatch.setattr(
        demux_mod,
        "_time_host_window",
        lambda m, w, reps=2: probes.append(1) or 0.003,
    )
    demux_mod._ASSIGN_FN_CACHE.clear()
    demux_mod._build_device_assign_fn(cfg_a, es_b, barcodes=barcodes_b)
    assert probes, "different whitelist content must trigger a fresh probe"


def test_window_dedup_wrapper_exact_and_bucketed(monkeypatch, caplog):
    """_wrap_window_dedup: clustered windows shrink to a bucket of unique
    rows (at least 4096) and scatter back exactly after the fetch;
    low-duplication and small windows bypass; the log line comes once per
    run."""
    monkeypatch.delenv("FQTK_DEVICE_DEDUP", raising=False)
    calls = []

    def fake_call(obs):
        obs = np.asarray(obs)
        calls.append(obs.shape[0])
        # fake matcher: "assignment" = first byte of the row
        return demux_mod._Pending(torch.from_numpy(obs[:, 0].astype(np.int32)), keep=obs)

    assign = demux_mod._wrap_window_dedup(fake_call)
    rng = np.random.default_rng(0)
    uniq = rng.integers(0, 255, size=(100, 4), dtype=np.uint8)
    rows = uniq[rng.integers(0, 100, size=8192)]
    with caplog.at_level("INFO", logger="fqtk"):
        out = assign(rows).fetch()
        assign(rows).fetch()
    np.testing.assert_array_equal(out, rows[:, 0].astype(np.int32))
    assert calls == [4096, 4096], calls
    assert caplog.text.count("device window dedup engaged") == 1
    caplog.clear()
    assign.start_run()
    with caplog.at_level("INFO", logger="fqtk"):
        assign(rows).fetch()
    assert caplog.text.count("device window dedup engaged") == 1

    # low duplication: bypasses (unique > half)
    calls.clear()
    rows2 = rng.integers(0, 255, size=(4096, 8), dtype=np.uint8)
    out2 = assign(rows2).fetch()
    np.testing.assert_array_equal(out2, rows2[:, 0].astype(np.int32))
    assert calls == [4096]

    # small windows: bypass entirely
    calls.clear()
    rows3 = uniq[rng.integers(0, 100, size=512)]
    out3 = assign(rows3).fetch()
    np.testing.assert_array_equal(out3, rows3[:, 0].astype(np.int32))
    assert calls == [512]

    # env kill switch
    monkeypatch.setenv("FQTK_DEVICE_DEDUP", "0")
    plain = demux_mod._wrap_window_dedup(fake_call)
    assert plain is fake_call


def _window_of(rng, b, nu):
    """``b`` packed 4-byte rows holding exactly ``nu`` distinct rows, each
    at least once, in random order."""
    keys = rng.choice(1 << 31, size=nu, replace=False).astype(np.uint32)
    idx = np.concatenate([np.arange(nu), rng.integers(0, nu, size=b - nu)])
    return keys[rng.permutation(idx)].view(np.uint8).reshape(b, 4)


@pytest.mark.parametrize("b,nu", [
    (131_072, 100), (131_072, 4_097), (131_072, 22_913), (131_072, 32_768),
    (131_072, 65_536), (131_072, 65_537), (131_072, 100_000),
    (8_192, 4_096), (8_192, 4_097), (10_001, 5_000), (4_096, 100),
])
def test_window_dedup_bucket_rule(monkeypatch, b, nu):
    """The bucket of an engaged window is its distinct rows rounded up to
    the kernels' 128-row tile, at least 4096; the dedup engages on exactly
    the windows the power-of-two bucket engaged on (at most half the
    window distinct, the bucket below it); results scatter back exactly."""
    monkeypatch.delenv("FQTK_DEVICE_DEDUP", raising=False)
    calls = []

    def fake_call(obs):
        obs = np.asarray(obs)
        calls.append(obs.shape[0])
        # fake matcher: "assignment" = the whole packed row
        return demux_mod._Pending(torch.from_numpy(obs.view(np.int32).reshape(-1)), keep=obs)

    assign = demux_mod._wrap_window_dedup(fake_call)
    rows = _window_of(np.random.default_rng(b + nu), b, nu)
    out = assign(rows).fetch()
    np.testing.assert_array_equal(out, rows.view(np.int32).reshape(-1))
    tile = hm.ROWS_PER_CTA
    bucket = max(4096, -(-nu // tile) * tile)
    power_of_two = max(4096, 1 << (nu - 1).bit_length())
    engaged = nu <= b // 2 and bucket < b
    assert engaged == (nu <= b // 2 and power_of_two < b)
    assert (assign.dedup.engaged, assign.dedup.declined) == (int(engaged), int(not engaged))
    assert assign.dedup.distinct == nu
    assert calls == [bucket if engaged else b]
    assert bucket % tile == 0 and bucket <= power_of_two


def _distinct_rows(rng, nu, w):
    """``nu`` distinct rows of ``w`` bytes in random order; with room for
    them, the rows of all ones and all zeros come first, so the largest and
    the smallest key are in the window."""
    if 256 ** w <= 4 * nu:
        keys = rng.permutation(256 ** w)[:nu].astype("<u8")
        return keys.view(np.uint8).reshape(nu, 8)[:, :w].copy()
    cand = np.concatenate([
        np.full((1, w), 255, dtype=np.uint8), np.zeros((1, w), dtype=np.uint8),
        rng.integers(0, 256, size=(2 * nu + 64, w), dtype=np.uint8)])
    _, first = np.unique(cand, axis=0, return_index=True)
    return cand[np.sort(first)[:nu]]


#: a window's distinct rows as a share of its rows, from none alike to
#: heavy duplication; a width's own limit caps it (256 rows at 1 byte)
DUPLICATION = {"none": 1.0, "half": 0.5, "cells8k": 22_913 / 131_072, "heavy": 0.0}


@pytest.mark.parametrize("dup", list(DUPLICATION))
@pytest.mark.parametrize("b", [4_096, 8_192, 10_001, 131_072])
@pytest.mark.parametrize("w", range(1, 9))
def test_window_dedup_packed_sort(monkeypatch, w, b, dup):
    """Where a row's key and index fit one 64-bit word (``8 * w + rb <=
    64``), the packed sort gives ``np.unique``'s distinct keys, first rows
    and inverse; wider windows go through ``np.unique``.  Either way the
    wrapper sends the distinct rows as gathered from the window at
    ``np.unique``'s first rows, padded with the first, and hands out the
    wrapped matcher's result, byte for byte."""
    monkeypatch.delenv("FQTK_DEVICE_DEDUP", raising=False)
    rng = np.random.default_rng(w * 1_000_003 + b)
    nu = min(max(100, int(b * DUPLICATION[dup])), b, 256 ** w)
    distinct = _distinct_rows(rng, nu, w)
    rows = distinct[rng.permutation(np.concatenate(
        [np.arange(nu), rng.integers(0, nu, size=b - nu)]))]
    full = np.zeros((b, 8), dtype=np.uint8)
    full[:, :w] = rows
    keys = full.view("<u8").reshape(b)
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    rb = max(1, (b - 1).bit_length())
    packed = 8 * w + rb <= 64
    if packed:
        words, heads = demux_mod._sort_packed(keys, rb)
        assert np.count_nonzero(heads) == nu
        np.testing.assert_array_equal(words[heads] & np.uint64((1 << rb) - 1), first)
        got_uniq, got_inv = demux_mod._unpack_unique(words, heads, rb)
        np.testing.assert_array_equal(got_uniq, uniq)
        assert got_inv.dtype == np.intp
        np.testing.assert_array_equal(got_inv, inv.reshape(b))

    sent = []

    def fake_call(obs):
        obs = np.asarray(obs)
        sent.append(obs.copy())
        # fake matcher: "assignment" = the whole row, zero-padded to 8 bytes
        out = np.zeros((len(obs), 8), dtype=np.uint8)
        out[:, :obs.shape[1]] = obs
        return demux_mod._Pending(torch.from_numpy(out.view(np.int64).reshape(-1)), keep=obs)

    assign = demux_mod._wrap_window_dedup(fake_call)
    got = assign(rows).fetch()
    want = fake_call(rows).fetch()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    bucket = max(4096, -(-nu // hm.ROWS_PER_CTA) * hm.ROWS_PER_CTA)
    engaged = nu <= b // 2 and bucket < b
    if engaged:
        gathered = rows[first]
        gathered = np.concatenate([gathered, np.broadcast_to(gathered[:1], (bucket - nu, w))])
        assert sent[0].shape == (bucket, w) and sent[0].tobytes() == gathered.tobytes()
    else:
        assert sent[0].tobytes() == rows.tobytes()
    d = assign.dedup
    assert (d.windows, d.engaged, d.declined, d.distinct) == (1, int(engaged), int(not engaged), nu)
    assert d.sorted == int(packed)


def test_window_dedup_before_a_batch_mesh():
    """A 3 x 1 batch mesh behind the window dedup takes a bucket that is
    not a multiple of 3 (4,352 rows for 4,300 distinct) and gives the
    spec's assignments for every row of the window."""
    rng = np.random.default_rng(7)
    barcodes = _barcodes(23, 9, seed=7)
    expected = ExpectedSet.from_barcodes(barcodes)
    fn = mesh_mod.make_sharded_assign_fn(
        expected, 1, 2, mesh_mod.make_demux_mesh(3, 1, devices=[torch.device("cpu")] * 3),
        packed2=True, compact_output=True, with_counts=False, use_kernels=True)
    # the barcodes, each with one substitution, then random rows
    exact = np.frombuffer("".join(barcodes).encode(), dtype=np.uint8).reshape(-1, 9)
    near = np.repeat(exact, 9, axis=0)
    pos = np.tile(np.arange(9), len(exact))
    near[np.arange(len(near)), pos] = rng.choice(ACGT, size=len(near))
    cand = np.concatenate([exact, near, rng.choice(ACGT, size=(8000, 9)).astype(np.uint8)])
    _, first = np.unique(cand, axis=0, return_index=True)
    distinct = cand[np.sort(first)][:4300]
    assert len(distinct) == 4300
    obs = distinct[np.concatenate([np.arange(4300), rng.integers(0, 4300, size=9000 - 4300)])]
    calls = []

    def counted(rows):
        calls.append(len(rows))
        return fn(rows)

    assign = demux_mod._window_side(fn, counted)
    got = assign(pack_bit2(obs)).fetch()
    idx, _, _ = assign_batch_np(obs, expected, 1, 2)
    np.testing.assert_array_equal(got, np.where(idx < 0, len(barcodes), idx))
    assert calls == [4352] and 4352 % 3 != 0
    assert (got < len(barcodes)).sum() >= 23
    assert assign.dedup.engaged == 1


# --------------------------------------------------------------------------
# the same side as fqtk_tpu
# --------------------------------------------------------------------------

#: (host_s, floor_s, device_s): the floor above, equal to and below the
#: host; the device on both sides of the 10% hysteresis and at it
GRID = [
    (0.003, 0.025, None),
    (0.010, 0.010, 0.001),
    (0.010, 0.0099, 0.001),
    (0.010, 0.001, 0.0091),
    (0.010, 0.001, 0.0090),
    (0.010, 0.001, 0.010),
    (0.010, 0.001, 0.0200),
    (0.050, 0.0002, 0.001),
]


@pytest.mark.parametrize("host_s,floor_s,device_s", GRID)
def test_choice_parity_with_jax_package(monkeypatch, tmp_path, host_s, floor_s, device_s):
    barcodes = _barcodes(24, 9, seed=20)
    sides = {}
    for name, mod, es, cls in (
        ("port", demux_mod, ExpectedSet.from_barcodes(barcodes), DemuxConfig),
        ("jax", jax_demux, JaxExpectedSet.from_barcodes(barcodes), jax_demux.DemuxConfig),
    ):
        _arm(monkeypatch, tmp_path, host_s, floor_s, device_s, mod=mod)
        cfg = _cfg(tmp_path, barcodes, cls=cls, devices=1)
        assign, pack_mode, host_matcher = mod._build_device_assign_fn(
            cfg, es, barcodes=barcodes
        )
        sides[name] = (host_matcher, pack_mode, assign.crossover)
    assert sides["port"] == sides["jax"]
    want_device = host_s > floor_s and device_s * 1.1 < host_s
    assert sides["port"][0] == (not want_device)
    # each package wrote its own file, with the same decision
    ours = json.loads((tmp_path / "crossover-torch.json").read_text())
    theirs = json.loads((tmp_path / "crossover.json").read_text())
    assert [e["choice"] for e in ours.values()] == [e["choice"] for e in theirs.values()]


# --------------------------------------------------------------------------
# the port's own key and file
# --------------------------------------------------------------------------


def test_cache_key_ignores_jax_platforms_and_follows_the_card(monkeypatch, tmp_path):
    barcodes = _barcodes(16, 8, seed=30)
    es = ExpectedSet.from_barcodes(barcodes)
    cpu = _cfg(tmp_path, barcodes)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    key = demux_mod._crossover_cache_key(cpu, es)
    monkeypatch.setenv("JAX_PLATFORMS", "tpu")
    assert demux_mod._crossover_cache_key(cpu, es) == key
    assert "|cpu|" in key and f"|{torch.__version__}|" in key

    # a card: its name keys the decision (no CUDA call is made here)
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: next(names))
    cuda = _cfg(tmp_path, barcodes, device="cuda")
    h100 = demux_mod._crossover_cache_key(cuda, es)
    a100 = demux_mod._crossover_cache_key(cuda, es)
    assert "NVIDIA H100 80GB HBM3" in h100 and "NVIDIA A100-SXM4-80GB" in a100
    assert len({key, h100, a100}) == 3


def test_cache_file_is_the_ports_own(monkeypatch, tmp_path):
    """The file lives under FQTK_CACHE_DIR as crossover-torch.json; the JAX
    package's crossover.json beside it is neither read nor written."""
    monkeypatch.setenv("FQTK_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(demux_mod, "_CROSSOVER_CACHE_PATH", None)
    assert demux_mod._crossover_cache_path() == str(tmp_path / "cache" / "crossover-torch.json")
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    monkeypatch.setattr(demux_mod, "_probe_allowed", lambda device: True)
    monkeypatch.setattr(demux_mod, "_time_host_window", lambda m, w, reps=2: 0.003)
    monkeypatch.setattr(demux_mod, "_device_floor_seconds", lambda b, w, d, reps=2: 0.025)
    demux_mod._ASSIGN_FN_CACHE.clear()
    barcodes = _barcodes(16, 8, seed=31)
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    key = demux_mod._crossover_cache_key(cfg, es)
    # a JAX-package file that would say "device" under the port's own key
    jax_file = tmp_path / "cache" / "crossover.json"
    jax_file.parent.mkdir()
    jax_file.write_text(json.dumps({key: {"choice": "device", "host_s": 1.0}}))
    before = jax_file.read_bytes()
    _, _, host_matcher = demux_mod._build_device_assign_fn(cfg, es, barcodes=barcodes)
    assert host_matcher  # measured (host 3 ms under a 25 ms floor), not read
    assert jax_file.read_bytes() == before
    ours = json.loads((tmp_path / "cache" / "crossover-torch.json").read_text())
    assert ours[key]["choice"] == "host"

    # FQTK_MEASURE_CROSSOVER=1 forces a fresh probe over a cached decision
    probes = []
    monkeypatch.setattr(demux_mod, "_time_host_window",
                        lambda m, w, reps=2: probes.append(1) or 0.003)
    demux_mod._build_device_assign_fn(cfg, es, barcodes=barcodes)
    assert not probes
    monkeypatch.setenv("FQTK_MEASURE_CROSSOVER", "1")
    demux_mod._build_device_assign_fn(cfg, es, barcodes=barcodes)
    assert probes == [1]


def test_floor_failure_raises_instead_of_picking_host(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, host_s=0.003, floor_s=None, device_s=None)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(demux_mod, "_device_floor_seconds", broken)
    barcodes = _barcodes(16, 8, seed=32)
    es = ExpectedSet.from_barcodes(barcodes)
    with pytest.raises(demux_mod.DemuxError, match="device round-trip probe failed"):
        demux_mod._build_device_assign_fn(_cfg(tmp_path, barcodes), es, barcodes=barcodes)
    assert not (tmp_path / "crossover-torch.json").exists()


def test_device_decision_runs_the_device_matcher(monkeypatch, tmp_path):
    """A measured "device" decision drives the run through the device
    matcher (its plain version on the CPU) and surfaces in the timings."""
    _arm(monkeypatch, tmp_path, host_s=0.050, floor_s=0.0002, device_s=0.001)
    barcodes = _barcodes(20, 8, seed=33)
    _fastq(tmp_path, barcodes)
    res = run_demux(_cfg(tmp_path, barcodes, engine="native"))
    assert res.timings["crossover_device_chosen"] == 1.0
    assert res.matcher["scheme"] == "colmerge_top2"
    assert res.matcher["plain_calls"] == 1 and res.matcher["launches"] == 0
    assert res.total_templates == 40


# --------------------------------------------------------------------------
# the real timers on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("batch,width", [(1, 1), (4096, 5), (131_072, 3)])
def test_device_floor_seconds_runs_on_cpu(batch, width):
    s = demux_mod._device_floor_seconds(batch, width, "cpu")
    assert math.isfinite(s) and s > 0


def test_time_device_window_runs_on_cpu(tmp_path):
    barcodes = _barcodes(40, 10, seed=34)
    es = ExpectedSet.from_barcodes(barcodes)
    assign, pack_mode, host = demux_mod._build_device_side(_cfg(tmp_path, barcodes), es)
    assert (pack_mode, host) == ("bit2", False)
    rng = np.random.default_rng(0)
    windows = [pack_bit2(ACGT[rng.integers(0, 4, size=(512, 10))]) for _ in range(3)]
    before = assign.device_matcher.plain_calls
    s = demux_mod._time_device_window(assign, windows)
    assert math.isfinite(s) and s > 0
    assert assign.device_matcher.plain_calls - before == 3  # warm-up + two timed


# --------------------------------------------------------------------------
# _ASSIGN_FN_CACHE
# --------------------------------------------------------------------------


def test_assign_fn_cache_hits_evicts_and_keys_on_device(monkeypatch, tmp_path):
    builds = []

    def fake_build(cfg, es, barcodes):
        builds.append((cfg.device, cfg.threads))
        return (object(), "bit2", False)

    monkeypatch.setattr(demux_mod, "_build_device_assign_fn", fake_build)
    demux_mod._ASSIGN_FN_CACHE.clear()
    barcodes = _barcodes(8, 6, seed=40)
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes, matcher="device")
    first = demux_mod._make_device_assign_fn(cfg, es, barcodes)
    assert demux_mod._make_device_assign_fn(cfg, es, barcodes) is first
    assert len(builds) == 1
    # the device is part of the key
    on_card = _cfg(tmp_path, barcodes, matcher="device", device="cuda")
    assert demux_mod._make_device_assign_fn(on_card, es, barcodes) is not first
    assert builds[-1] == ("cuda", 8)
    # four entries at most, least recently used out first
    for threads in (5, 6):
        demux_mod._make_device_assign_fn(
            _cfg(tmp_path, barcodes, matcher="device", threads=threads), es, barcodes)
    assert len(demux_mod._ASSIGN_FN_CACHE) == 4
    demux_mod._make_device_assign_fn(cfg, es, barcodes)  # refresh: now the newest
    demux_mod._make_device_assign_fn(
        _cfg(tmp_path, barcodes, matcher="device", threads=9), es, barcodes)
    assert len(demux_mod._ASSIGN_FN_CACHE) == 4
    n = len(builds)
    assert demux_mod._make_device_assign_fn(cfg, es, barcodes) is first
    demux_mod._make_device_assign_fn(on_card, es, barcodes)  # evicted: built again
    assert len(builds) == n + 1
    # no whitelist identity: never cached
    demux_mod._make_device_assign_fn(cfg, es, None)
    assert len(builds) == n + 2


def test_second_run_builds_nothing_and_counts_its_own_launches(monkeypatch, tmp_path):
    demux_mod._ASSIGN_FN_CACHE.clear()
    states = []
    real_state = hm.hopper_state_from_numpy
    monkeypatch.setattr(hm, "hopper_state_from_numpy",
                        lambda *a, **k: states.append(1) or real_state(*a, **k))
    barcodes = _barcodes(20, 8, seed=41)
    _fastq(tmp_path, barcodes, n=100)
    results = []
    for run in range(2):
        cfg = _cfg(tmp_path, barcodes, matcher="device", batch_size=16)
        cfg.output = tmp_path / f"out{run}"
        results.append(run_demux(cfg))
    assert states == [1], "the second run must reuse the cached matcher"
    first, second = results
    assert first.matcher == second.matcher  # each run's own counts
    assert first.matcher["plain_calls"] == 7  # ceil(100 / 16) windows
    assert first.matcher["colmerge_top2_plain_calls"] == 7
    assert _outputs(tmp_path / "out0") == _outputs(tmp_path / "out1")


def test_cached_host_matcher_is_fused_again(monkeypatch, tmp_path):
    demux_mod._ASSIGN_FN_CACHE.clear()
    built, fused = [], []

    class CountingSmallK(native_io.NativeSmallKMatcher):
        def __init__(self, *a, **k):
            built.append(1)
            super().__init__(*a, **k)

    real_fuse = native_io.NativeDemuxEngine.pipe_fuse_host_matcher

    def fuse(engine, matcher):
        fused.append(matcher)
        return real_fuse(engine, matcher)

    monkeypatch.setattr(native_io, "NativeSmallKMatcher", CountingSmallK)
    monkeypatch.setattr(native_io.NativeDemuxEngine, "pipe_fuse_host_matcher", fuse)
    barcodes = _barcodes(20, 8, seed=42)
    _fastq(tmp_path, barcodes, n=100)
    for run in range(2):
        cfg = _cfg(tmp_path, barcodes, matcher="host", batch_size=16)
        cfg.output = tmp_path / f"out{run}"
        res = run_demux(cfg)
        assert res.total_templates == 100 and res.matcher == {}
    assert built == [1]
    assert len(fused) == 2 and fused[0] is fused[1]
    assert _outputs(tmp_path / "out0") == _outputs(tmp_path / "out1")
