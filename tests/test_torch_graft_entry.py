"""The port's driver entry points (``fqtk_tpu_torch/graft_entry.py``) on the
CPU against the repository's ``__graft_entry__.py`` and the JAX mesh.

``entry(device="cpu")`` gives the same rows and the same ``(assigned, best,
next)`` as the JAX ``entry()``; ``dryrun_multichip`` passes on 1, 2, 3 and 8
CPU "devices" (``[cpu] * n``, meshes 1x1, 1x2, 3x1 and 4x2), where each
kernel's plain version runs; its sharded steps give the same ``assigned``
and ``counts`` as the JAX ``make_sharded_assign_fn`` on conftest's 8 CPU
devices (the per-shard kernel step against Pallas in interpret mode), on
the originals' whitelists and reads; the pigeonhole driver restores
``PALLAS_K_THRESHOLD`` even when it raises.
Results are integers: every comparison is exact.  The same entry points on
the card are ``chip_smoke.py`` phase 10."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fqtk_tpu.ops.matcher import ExpectedSet as JaxExpectedSet
from fqtk_tpu.parallel import mesh as jax_mesh
from fqtk_tpu_torch import graft_entry as port
from fqtk_tpu_torch.parallel import mesh
from fqtk_tpu_torch.runtime import demux as port_demux

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402

CPU = torch.device("cpu")
#: n -> the (n_batch, n_whitelist) mesh dryrun_multichip lays out
MESHES = {1: (1, 1), 2: (1, 2), 3: (3, 1), 8: (4, 2)}


def jax_expected(expected):
    return JaxExpectedSet(masks=expected.masks, max_ns_in_barcodes=expected.max_ns_in_barcodes,
                          length=expected.length, count=expected.count)


def test_entry_matches_the_jax_entry():
    fn, (obs,) = port.entry(device="cpu")
    jfn, (jobs,) = graft.entry()
    np.testing.assert_array_equal(obs, jobs)
    out = fn(obs)
    assert out[0].shape == (8192,)
    assert all(o.device == CPU for o in out)
    for got, want in zip(out, jfn(jobs)):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds on it")
    with pytest.raises(RuntimeError, match="is_available"):
        port.entry()


@pytest.mark.parametrize("n", sorted(MESHES))
def test_dryrun_multichip_on_cpu_devices(n):
    counts = port.dryrun_multichip(n, devices=[CPU] * n)
    assert set(counts) == {"small_k", "driver", "bigk_sharded", "bigk_sharded_kernels",
                           "pigeonhole_driver"}
    for step in ("small_k", "bigk_sharded", "bigk_sharded_kernels"):
        c = counts[step]
        # one plain call per tile of the step's mesh (n tiles), no launch
        assert c == {"scheme": "colmerge_top2", "launches": 0, "plain_calls": n}, (step, c)
    if n > 1:  # the mesh ran the batch through the plain versions
        assert counts["driver"]["plain_calls"] > 0 and counts["driver"]["launches"] == 0
    else:  # one device: the placement keeps K 16 on the host, as the JAX dry run
        assert counts["driver"] == {}
    assert counts["pigeonhole_driver"] == {}  # the native pigeonhole host matcher


def test_dryrun_multichip_asserts_its_device_count():
    with pytest.raises(AssertionError):
        port.dryrun_multichip(3, devices=[CPU] * 2)


def _jax_mesh(n_batch, n_whitelist):
    return jax_mesh.make_demux_mesh(n_batch=n_batch, n_whitelist=n_whitelist,
                                    devices=jax.devices()[:n_batch * n_whitelist])


@pytest.mark.parametrize("n", sorted(MESHES))
def test_small_k_step_matches_the_jax_mesh(n):
    n_batch, n_whitelist = MESHES[n]
    expected, obs = port.small_k_case(n_batch)
    fn = mesh.make_sharded_assign_fn(
        expected, 1, 2, mesh=mesh.make_demux_mesh(n_batch, n_whitelist, devices=[CPU] * n),
        k_chunk=64)
    jfn = jax_mesh.make_sharded_assign_fn(jax_expected(expected), 1, 2,
                                          mesh=_jax_mesh(n_batch, n_whitelist), k_chunk=64)
    assigned, counts = fn(obs)
    jassigned, jcounts = jfn(obs)
    np.testing.assert_array_equal(assigned.numpy().astype(np.int64),
                                  np.asarray(jassigned).astype(np.int64))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts).astype(np.int64))


@pytest.mark.parametrize("n", [2, 8])
def test_bigk_step_matches_the_jax_mesh(n):
    expected, obs, packed = port.bigk_case()
    fn = port.bigk_sharded_fn(expected, mesh.make_demux_mesh(1, n, devices=[CPU] * n))
    jfn = jax_mesh.make_sharded_assign_fn(
        jax_expected(expected), 1, 2, mesh=_jax_mesh(1, n), k_chunk=8192,
        packed_masks=True, compact_output=False, with_counts=False)
    got = fn(packed).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, np.asarray(jfn(packed)).astype(np.int64))
    assert (got[:4] == expected.count).all()  # the no-call rows


def test_per_shard_kernel_step_matches_pallas_per_shard():
    n = 8
    expected, obs, packed = port.bigk_kernels_case()
    fn = mesh.make_sharded_assign_fn(
        expected, 1, 2, mesh=mesh.make_demux_mesh(1, n, devices=[CPU] * n),
        packed2=True, with_counts=False, use_kernels=True)
    jfn = jax_mesh.make_sharded_assign_fn(
        jax_expected(expected), 1, 2, mesh=_jax_mesh(1, n), packed2=True,
        with_counts=False, use_pallas=True, interpret=True, tile_b=8, tile_k=512)
    assert len(packed) == 50
    np.testing.assert_array_equal(fn(packed).numpy().astype(np.int64),
                                  np.asarray(jfn(packed)).astype(np.int64))


def test_pigeonhole_driver_restores_the_threshold(monkeypatch):
    saved = port_demux.PALLAS_K_THRESHOLD
    seen = []

    def driver(n_devices, devices=None):
        seen.append(port_demux.PALLAS_K_THRESHOLD)
        return {"n": n_devices}

    monkeypatch.setattr(port, "_dryrun_driver", driver)
    assert port._dryrun_pigeonhole_driver(2, [CPU] * 2) == {"n": 2}
    assert seen == [8] and port_demux.PALLAS_K_THRESHOLD == saved

    def failing(n_devices, devices=None):
        seen.append(port_demux.PALLAS_K_THRESHOLD)
        raise RuntimeError("driver failed")

    monkeypatch.setattr(port, "_dryrun_driver", failing)
    with pytest.raises(RuntimeError, match="driver failed"):
        port._dryrun_pigeonhole_driver(1, [CPU])
    assert seen == [8, 8] and port_demux.PALLAS_K_THRESHOLD == saved


def test_driver_restores_local_devices(monkeypatch):
    before = mesh.local_devices
    port._dryrun_driver(2, [CPU] * 2)
    assert mesh.local_devices is before

    def failing(cfg):
        assert mesh.local_devices() == [CPU] * 2  # the mesh's list inside
        raise RuntimeError("demux failed")

    monkeypatch.setattr(port_demux, "run_demux", failing)
    with pytest.raises(RuntimeError, match="demux failed"):
        port._dryrun_driver(2, [CPU] * 2)
    assert mesh.local_devices is before


def _original_case(k, length, extra_span, seed, batch):
    """The whitelist and reads as ``__graft_entry__.py:135-151`` and
    ``:194-231`` build them inline."""
    vals = (np.arange(k, dtype=np.uint64) * 2654435761) % (1 << (2 * length))
    vals = np.unique(vals)
    extra = np.setdiff1d(np.arange(k + extra_span, dtype=np.uint64), vals, assume_unique=False)
    vals = np.concatenate([vals, extra])[:k]
    codes = np.zeros((k, length), dtype=np.uint8)
    v = vals.copy()
    for j in range(length):
        codes[:, j] = v & 3
        v >>= 2
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    bc_bytes = letters[codes]
    rng = np.random.default_rng(seed)
    obs = bc_bytes[rng.integers(0, k, size=batch)].copy()
    mut = rng.integers(0, 3, size=batch) == 0
    obs[mut, rng.integers(0, length, size=batch)[mut]] = letters[
        rng.integers(0, 4, size=int(mut.sum()))
    ]
    return [bytes(r).decode() for r in bc_bytes], obs


def test_bigk_cases_are_the_originals():
    from fqtk_tpu.core.encoding import ENCODE_LUT

    barcodes, obs = _original_case(65536, 10, 4096, 4242, 64)
    obs[:4] = np.frombuffer(b"N" * 10, dtype=np.uint8)
    masks = ENCODE_LUT[obs].astype(np.uint8)
    expected, got_obs, packed = port.bigk_case()
    np.testing.assert_array_equal(expected.masks, JaxExpectedSet.from_barcodes(barcodes).masks)
    np.testing.assert_array_equal(got_obs, obs)
    np.testing.assert_array_equal(packed, masks[:, 0::2] | (masks[:, 1::2] << 4))

    barcodes, obs = _original_case(4096, 12, 1024, 717, 50)
    code_lut = np.zeros(256, dtype=np.uint8)
    for c, ch in zip((0, 1, 2, 3), b"ACGT"):
        code_lut[ch] = c
    oc = code_lut[obs]
    expected, got_obs, packed = port.bigk_kernels_case()
    np.testing.assert_array_equal(expected.masks, JaxExpectedSet.from_barcodes(barcodes).masks)
    np.testing.assert_array_equal(got_obs, obs)
    np.testing.assert_array_equal(
        packed, oc[:, 0::4] | (oc[:, 1::4] << 2) | (oc[:, 2::4] << 4) | (oc[:, 3::4] << 6))
