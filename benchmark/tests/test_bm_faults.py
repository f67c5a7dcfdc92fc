"""``correct`` comes out false when the timed path is broken underneath a
run (the look for a card skipped, at a size a CPU holds), and for the
control: the reference put in the program's place with the
``min_mismatch_delta`` guarantee broken.

The faults a cell of this benchmark can have: an answer altered where it
is produced, and half of a window's rows left out.  No cell trains (no
state to leave unchanged) and none spans chips (no exchange to leave
out)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import common, run
from benchmark.tests.cells import cells, cpu_size
from fqtk_tpu_torch.runtime import demux

CELLS = cells()


@pytest.fixture(autouse=True)
def _fresh_matchers():
    demux._ASSIGN_FN_CACHE.clear()
    yield
    demux._ASSIGN_FN_CACHE.clear()


def _altered(monkeypatch, unmatched):
    fetch = demux._Pending.fetch

    def altered(self):
        out = np.array(fetch(self))
        out[0] = (out[0] + 1) % 7
        return out

    monkeypatch.setattr(demux._Pending, "fetch", altered)


def _half_left_out(monkeypatch, unmatched):
    fetch = demux._Pending.fetch

    def half(self):
        out = np.array(fetch(self))
        out[len(out) // 2:] = unmatched
        return out

    monkeypatch.setattr(demux._Pending, "fetch", half)


def _run_faults_size(cell, seed, root, control=False):
    return run.run_cell(cell, seed, 0.3, False, device="cpu", root=root, control=control,
                        overrides=cpu_size(cell, "faults", root))


def check_sound(cell, root=common.ROOT):
    assert _run_faults_size(cell, 2**32 + 9, root)["correct"] is True


def check_fault(cell, fault, monkeypatch, root=common.ROOT):
    # the unmatched index: the whitelist's size
    fault(monkeypatch, cpu_size(cell, "faults", root)["deployment"]["whitelist_size"])
    r = _run_faults_size(cell, 2**32 + 9, root)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def check_control(cell, root=common.ROOT):
    r = _run_faults_size(cell, 2**32 + 10, root, control=True)
    assert r["correct"] is False
    worst = max(c["value"] for c in r["checks"].values())
    assert worst > 10 * max(1, max(c["limit"] for c in r["checks"].values()))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    check_sound(cell)


@pytest.mark.parametrize("fault", [_altered, _half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    check_fault(cell, fault, monkeypatch)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    check_control(cell)


def test_the_fault_hook_is_on_the_timed_path(monkeypatch):
    """Every window of a run is fetched through the patched method."""
    fetch = demux._Pending.fetch
    seen = []

    def counted(self):
        seen.append(1)
        return fetch(self)

    monkeypatch.setattr(demux._Pending, "fetch", counted)
    r = run.run_cell("sc_v3.cells8k", 3, 0.3, False, device="cpu",
                      overrides=cpu_size("sc_v3.cells8k", "faults"))
    assert len(seen) >= r["attempted"] > 0
