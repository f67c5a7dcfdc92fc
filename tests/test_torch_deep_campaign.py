"""The port's differential campaign (``fqtk_tpu_torch/scripts/deep_campaign.py``)
on the CPU (``--device cpu``: the Hopper kernels' plain versions).

Its scenario generator writes the same files, structures and metadata, byte
for byte, as ``tests/test_fuzz_differential._random_scenario`` and leaves
the generator in the same state; each leg at a small size runs cases and
finds nothing; for four scenarios (big-K, device-placed, clustered, IUPAC)
the port's native outputs equal ``fqtk_tpu``'s native engine's, byte for
byte after decompression; a matcher made to move one row is caught, and the
command line exits 1; ``cuda`` without a card raises.  The campaign on the
card is ``test_deep_campaign_matcher_leg_on_card`` in
``test_torch_kernels_gpu.py`` and ``chip_smoke.py`` phase 12."""

import gzip
import os
import random
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import fqtk_tpu.runtime.demux as jax_demux
from fqtk_tpu.core.encoding import ENCODE_LUT as JAX_LUT
from fqtk_tpu_torch.io import native as port_native
from fqtk_tpu_torch.ops import hopper_matcher as hm
from fqtk_tpu_torch.runtime import demux as dmx
from fqtk_tpu_torch.scripts import deep_campaign as dc
from fqtk_tpu_torch.scripts import fuzz_scenarios
from tests.test_fuzz_differential import _random_scenario as jax_random_scenario

ROOT = Path(__file__).resolve().parent.parent


# --------------------------------------------------------------------------
# the generator
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sid", range(12))
@pytest.mark.parametrize("offset", [0, 700000])
def test_generator_equals_the_original(tmp_path, offset, sid):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    rng_o, rng_t = random.Random(31337 + offset + sid), random.Random(31337 + offset + sid)
    info = {}
    inputs, structures, meta = fuzz_scenarios._random_scenario(rng_o, ours, sid, info)
    j_inputs, j_structures, j_meta = jax_random_scenario(rng_t, theirs, sid)
    assert structures == j_structures
    assert [p.name for p in inputs] == [p.name for p in j_inputs]
    for a, b in zip(inputs + [meta], j_inputs + [j_meta]):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert rng_o.getstate() == rng_t.getstate()  # the legs draw on from here
    assert set(info) == {"iupac", "clustered"}


def test_pack_equals_the_originals_nib4():
    rng = np.random.default_rng(5)
    for length in (1, 4, 7, 16):
        obs = rng.choice(np.frombuffer(b"ACGTNnRYacgtX-.U", dtype=np.uint8), size=(50, length))
        masks = JAX_LUT[obs].astype(np.uint8)
        if length % 2:
            masks = np.concatenate([masks, np.zeros((50, 1), np.uint8)], axis=1)
        want = (masks[:, 0::2] | (masks[:, 1::2] << 4)).astype(np.uint8)
        assert np.array_equal(fuzz_scenarios._pack(obs), want)


# --------------------------------------------------------------------------
# the legs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("leg,n", [("demux", 8), ("matcher", 3), ("subsample", 4),
                                   ("malformed", 8), ("dedup", 8)])
def test_leg_runs_clean_on_the_cpu(leg, n, capsys):
    r = getattr(dc, f"{leg}_leg")(n, 0, "cpu")
    out = capsys.readouterr().out
    assert r["failures"] == 0, out
    assert r["cases"] == n and r["ok"] > 0
    assert f"{leg} leg: {n} " in out and "FAIL" not in out
    counts = r["counts"]
    assert all(c["launches"] == 0 for c in counts.values())  # no card here
    if leg == "demux":
        # sids 1 and 5 are placed on the device, 0, 3 and 6 are big-K
        assert r["device_placed"] == r["device_ran"] == 2 and r["bigk"] == 3
        assert 0 <= r["device_rows"] <= r["window_rows"] and r["window_rows"] > 0
        assert counts["colmerge_top2"]["plain_calls"] > 0
    elif leg == "matcher":
        assert all(c["plain_calls"] >= n for c in counts.values())  # bytes; bit2 if any
        assert r["max_abs_err"] == {k: {"bytes": 0, "bit2": 0} for k in hm.SCHEMES}
    elif leg == "dedup":
        assert r["hopper_cases"] == 2 and counts["colmerge_top2"]["plain_calls"] > 0
        assert r["max_abs_err"] == {k: 0 for k in hm.SCHEMES}
    else:
        assert all(c["plain_calls"] == 0 for c in counts.values())


def test_the_command_line_runs_clean(capsys):
    assert dc.main(["3", "1", "2", "2", "4", "11", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("deep_campaign: native library ") and "libdeflate" in lines[0]
    assert "seed offset 11" in lines[0]
    assert lines[-1] == "deep_campaign: CLEAN"


def test_forced_placement_is_restored(tmp_path):
    before = {n: getattr(dmx, n) for n in ("_probe_allowed", "_time_host_window",
                                           "_device_floor_seconds", "_time_device_window",
                                           "_CROSSOVER_CACHE_PATH", "PALLAS_K_THRESHOLD")}
    env = {k: os.environ.get(k) for k in ("FQTK_DEVICE_DEDUP", "FQTK_HOST_MATCHER_MAX_K")}
    case = dc.demux_case(13, 0, "cpu", tmp_path)
    assert case["ok"] and not case["failures"] and case["device_forced"]
    assert case["matcher"]["scheme"] == "colmerge_top2" and case["matcher"]["plain_calls"] > 0
    # the decision was written in the scenario's directory, nowhere else
    assert (tmp_path / "crossover-torch.json").exists()
    assert {n: getattr(dmx, n) for n in before} == before
    assert {k: os.environ.get(k) for k in env} == env
    assert not dmx._ASSIGN_FN_CACHE


def test_native_library_names_what_it_links():
    """The answer agrees with the dynamic linker's own listing of the
    library (``ldd``)."""
    lib = dc.native_library()
    path = Path(lib["path"])
    assert path.exists()
    assert path == Path(os.environ.get("FQTK_NATIVE_LIB") or port_native._LIB_PATH)
    linked = subprocess.run(["ldd", str(path)], capture_output=True, text=True,
                            check=True).stdout
    assert "libz.so" in linked  # always linked (-lz)
    assert lib["libdeflate"] == ("libdeflate" in linked)


# --------------------------------------------------------------------------
# the port against the JAX package
# --------------------------------------------------------------------------

#: (class, sid) at offset 0: a big-K scenario, a device-placed one with an
#: IUPAC whitelist, a clustered one and an IUPAC one (both host-placed)
SAMPLED = [("bigk", 0), ("device_forced", 13), ("clustered", 4), ("iupac", 22)]


def _decompressed(d: Path) -> dict:
    return {p.name: gzip.open(p).read() if p.suffix == ".gz" else p.read_bytes()
            for p in sorted(d.iterdir())}


@pytest.mark.parametrize("cls,sid", SAMPLED, ids=[c for c, _ in SAMPLED])
def test_native_outputs_equal_the_jax_packages(tmp_path, monkeypatch, cls, sid):
    case = dc.demux_case(sid, 0, "cpu", tmp_path)
    assert case[cls], case  # the scenario is of its class
    assert case["ok"] and not case["failures"], case
    if cls == "device_forced":
        assert case["matcher"]["plain_calls"] > 0
    # the JAX package's native engine on the same scenario, its own
    # placement on the CPU (the host matchers)
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    if case["bigk"]:
        monkeypatch.setattr(jax_demux, "PALLAS_K_THRESHOLD", 1)
    jax_demux._ASSIGN_FN_CACHE.clear()
    try:
        jax_demux.run_demux(jax_demux.DemuxConfig(output=tmp_path / "o_jax", engine="native",
                                                  **case["config"]))
    finally:
        jax_demux._ASSIGN_FN_CACHE.clear()
    ours = _decompressed(tmp_path / "o_native")
    assert len(ours) > 2
    assert ours == _decompressed(tmp_path / "o_jax")


# --------------------------------------------------------------------------
# a divergence is caught; cuda without a card raises
# --------------------------------------------------------------------------


def _moving_one_row(monkeypatch):
    """Make the Hopper matcher move row 0 to the next sample (or unmatched)."""
    call = hm.HopperAssignFn.__call__

    def moved(self, obs):
        assigned, best, nxt = call(self, obs)
        assigned = assigned.clone()
        assigned[0] = (int(assigned[0]) + 1) % (self.state.k + 1)
        return assigned, best, nxt

    monkeypatch.setattr(hm.HopperAssignFn, "__call__", moved)


def test_a_moved_row_fails_the_matcher_leg(monkeypatch, capsys):
    _moving_one_row(monkeypatch)
    r = dc.matcher_leg(2, 0, "cpu")
    assert r["failures"] >= 1
    assert "FAIL matcher 0 colmerge_top2 bytes" in capsys.readouterr().out


@pytest.mark.parametrize("which", ["best", "next"])
def test_a_wrong_best_or_next_fails_the_matcher_and_dedup_legs(which, monkeypatch, capsys):
    """A matcher whose assignments are right but whose best or next count is
    off by one in row 0 is caught by both legs that hold it to the spec."""
    call = hm.HopperAssignFn.__call__

    def skewed(self, obs):
        out = list(call(self, obs))
        pos = ("assigned", "best", "next").index(which)
        out[pos] = out[pos].clone()
        out[pos][0] += 1
        return tuple(out)

    monkeypatch.setattr(hm.HopperAssignFn, "__call__", skewed)
    r = dc.matcher_leg(1, 0, "cpu")
    out = capsys.readouterr().out
    assert r["failures"] >= 1 and "colmerge_top2 bytes" in out and f" {which} got " in out
    assert r["max_abs_err"]["colmerge_top2"]["bytes"] == 1
    r = dc.dedup_leg(4, 0, "cpu")
    assert r["failures"] == 1 and r["max_abs_err"]["colmerge_top2"] == 1
    assert "FAIL dedup 3: " in capsys.readouterr().out


def test_a_dedup_that_moves_rows_fails_the_dedup_leg(monkeypatch, capsys):
    def reversing(call):
        """A front end that sends the window reversed and never restores it."""
        return lambda obs: call(np.ascontiguousarray(obs[::-1]))

    monkeypatch.setattr(dmx, "_wrap_window_dedup", reversing)
    r = dc.dedup_leg(4, 0, "cpu")
    out = capsys.readouterr().out
    assert r["failures"] >= 4, out  # every window, and "never engaged"
    assert "FAIL dedup 3: " in out and "the dedup path never engaged" in out


def test_a_matcher_off_by_one_fails_a_demux_scenario(monkeypatch, tmp_path):
    """Most rows of the scenarios are not pure ACGT and are resolved on the
    host, so the device matcher decides few: in sid 29 (device-placed) it
    decides some, and a matcher that moves every row shows there."""
    call = hm.HopperAssignFn.__call__

    def off_by_one(self, obs):
        assigned, best, nxt = call(self, obs)
        return (assigned.to(torch.int32) + 1) % (self.state.k + 1), best, nxt

    for d in ("clean", "moved"):
        (tmp_path / d).mkdir()
    clean = dc.demux_case(29, 0, "cpu", tmp_path / "clean")
    assert clean["ok"] and not clean["failures"] and clean["device_rows"] > 0
    monkeypatch.setattr(hm.HopperAssignFn, "__call__", off_by_one)
    case = dc.demux_case(29, 0, "cpu", tmp_path / "moved")
    assert any(line.endswith(" differs") for line in case["failures"]), case["failures"]


def test_a_moved_row_exits_1(monkeypatch, capsys):
    _moving_one_row(monkeypatch)
    assert dc.main(["0", "2", "0", "0", "0", "--device", "cpu"]) == 1
    assert capsys.readouterr().out.strip().splitlines()[-1].endswith(" FAILURES")


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dc.main(["0", "0", "0", "0", "0"])
    for leg in dc.LEGS:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            getattr(dc, f"{leg}_leg")(1)
