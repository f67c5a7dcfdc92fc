"""Driver entry points on GPUs: the single-device step and the multi-device
dry run.  Counterpart of the repository's ``__graft_entry__.py``.

``entry(device)`` returns the flagship step, the batched barcode assignment
(the compute core of ``fqtk demux``) on a 96-sample dual-index whitelist:
the plain-PyTorch scan of :func:`~fqtk_tpu_torch.ops.matcher.make_assign_fn`
on raw-byte rows, as the JAX entry returns its XLA contraction.

``dryrun_multichip(n, devices)`` builds a ``(batch, whitelist)`` mesh over
``n`` devices and runs the sharded demux step on tiny shapes, then the
product driver over the mesh, the big-K whitelist-sharded steps (the Hopper
kernels per shard) and the forced pigeonhole driver, each checked against
the NumPy spec or the NumPy engine.  ``devices`` may repeat a device: one
card runs every tile of a mesh (``[cuda:0] * n``), and the tests run it on
``[cpu] * n``, where each kernel's plain version runs.

    python -m fqtk_tpu_torch.graft_entry

runs ``entry()`` and ``dryrun_multichip`` over every local GPU.

Each dry-run step returns the kernel counts of its matcher (``launches``,
``plain_calls``, ``scheme``), which :func:`dryrun_multichip` gathers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

Devices = Optional[Sequence[Union[str, torch.device]]]


def _whitelist(k: int, length: int):
    """Deterministic unique ACGT barcodes."""
    rng = np.random.default_rng(12345)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seen = []
    got = set()
    while len(seen) < k:
        bc = bytes(rng.choice(bases, size=length))
        if bc not in got:
            got.add(bc)
            seen.append(bc.decode())
    return seen


def _observed(batch: int, length: int, barcodes):
    rng = np.random.default_rng(999)
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    obs = rng.choice(bases, size=(batch, length)).astype(np.uint8)
    for i in range(0, batch, 2):  # half the reads are exact matches
        obs[i] = np.frombuffer(barcodes[i % len(barcodes)].encode(), dtype=np.uint8)
    return obs


def entry(device: Union[str, torch.device] = "cuda"):
    """Return ``(fn, example_args)``: the single-device assignment step on
    ``device`` (K 96, L 17, B 8,192 raw-byte rows); ``fn(obs)`` returns
    ``(assigned, best, next)`` on ``device``."""
    from .ops.matcher import ExpectedSet, make_assign_fn

    length, k, batch = 17, 96, 8192
    barcodes = _whitelist(k, length)
    expected = ExpectedSet.from_barcodes(barcodes)
    assign = make_assign_fn(expected, max_mismatches=1, min_mismatch_delta=2, device=device)
    obs = _observed(batch, length, barcodes)
    return assign, (obs,)


def _device_list(n_devices: int, devices: Devices) -> List[torch.device]:
    """``devices`` (default: the first ``n_devices`` local GPUs), asserted to
    hold ``n_devices`` entries, as the JAX dry run asserts its devices."""
    from .parallel.mesh import local_devices

    if devices is None:
        devices = local_devices("cuda")[:n_devices]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_devices:  # checked under -O too
        raise AssertionError((len(devices), n_devices))
    return devices


def _counts(fn) -> Dict[str, Union[int, str]]:
    return {"scheme": fn.scheme, "launches": fn.launches, "plain_calls": fn.plain_calls}


def small_k_case(n_batch: int):
    """``(expected, obs)`` of the small-K sharded step: K 96, L 17 raw-byte
    rows, ``8 * n_batch`` of them."""
    from .ops.matcher import ExpectedSet

    length, k = 17, 96
    barcodes = _whitelist(k, length)
    return ExpectedSet.from_barcodes(barcodes), _observed(8 * n_batch, length, barcodes)


def dryrun_multichip(n_devices: int, devices: Devices = None) -> Dict[str, dict]:
    """Run the full sharded demux step on an ``n_devices`` mesh over
    ``devices`` (default: the first ``n_devices`` local GPUs), then the
    product driver and the big-K paths.  Returns each step's kernel counts
    (the drivers': ``DemuxResult.matcher``)."""
    from .ops.matcher import assign_batch_np
    from .parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    devices = _device_list(n_devices, devices)

    # 2-D mesh: K-sharding (the TP analog) whenever we have an even number
    # of devices, else pure data parallel.
    n_whitelist = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_batch = n_devices // n_whitelist
    mesh = make_demux_mesh(n_batch=n_batch, n_whitelist=n_whitelist, devices=devices)

    expected, obs = small_k_case(n_batch)
    k = expected.count
    fn = make_sharded_assign_fn(
        expected, max_mismatches=1, min_mismatch_delta=2, mesh=mesh, k_chunk=64
    )
    assigned, counts = fn(obs)
    assigned = assigned.cpu().numpy()
    counts = counts.cpu().numpy()

    # cross-check against the NumPy executable spec
    np_idx, _, _ = assign_batch_np(obs, expected, 1, 2)
    expect = np.where(np_idx < 0, k, np_idx)
    np.testing.assert_array_equal(assigned, expect)
    np.testing.assert_array_equal(counts, np.bincount(expect, minlength=k + 1))

    # ALSO drive the PRODUCT pipeline over the mesh: run_demux with
    # devices=n builds the sharded matcher internally (batch-parallel here),
    # runs the full native train of parse -> device assign -> route, and
    # must agree with the single-device numpy engine byte-for-byte.
    out = {"small_k": _counts(fn)}
    out["driver"] = _dryrun_driver(n_devices, devices)

    # And the remaining production matcher paths a multi-chip user
    # would actually hit with huge sample sets:
    out["bigk_sharded"] = _dryrun_bigk_sharded(n_devices, devices)
    out["bigk_sharded_kernels"] = _dryrun_bigk_sharded_pallas(n_devices, devices)
    out["pigeonhole_driver"] = _dryrun_pigeonhole_driver(n_devices, devices)
    return out


def _codes_whitelist(k: int, length: int) -> np.ndarray:
    """``[k, length]`` ACGT bytes of unique barcodes, generated numerically
    as the dry run's originals generate them (the kernel lab's
    ``unique_barcodes``: 2-bit codes of ``i * 2654435761`` mod ``4^length``,
    topped up with the smallest unused values; at the two steps' K and L
    no value repeats, so no top-up is needed)."""
    from .lab.kernel_lab import unique_barcodes

    return np.frombuffer(b"ACGT", dtype=np.uint8)[unique_barcodes(k, length)]


def _mutated_reads(bc_bytes: np.ndarray, seed: int, batch: int) -> np.ndarray:
    """``batch`` whitelist rows, a third of them with one random base."""
    k, length = bc_bytes.shape
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    obs = bc_bytes[rng.integers(0, k, size=batch)].copy()
    mut = rng.integers(0, 3, size=batch) == 0
    obs[mut, rng.integers(0, length, size=batch)[mut]] = letters[
        rng.integers(0, 4, size=int(mut.sum()))
    ]
    return obs


def bigk_case():
    """``(expected, obs, packed)`` of the big-K sharded step: K 65,536,
    L 10, 64 reads (the first four all ``N``: no-call rows) and their nib4
    rows."""
    from .core.encoding import ENCODE_LUT
    from .ops.matcher import ExpectedSet

    bc_bytes = _codes_whitelist(65536, 10)
    expected = ExpectedSet.from_barcodes([bytes(r).decode() for r in bc_bytes])
    obs = _mutated_reads(bc_bytes, 4242, 64)
    obs[:4] = np.frombuffer(b"N" * 10, dtype=np.uint8)  # no-call rows
    masks = ENCODE_LUT[obs].astype(np.uint8)
    packed = (masks[:, 0::2] | (masks[:, 1::2] << 4)).astype(np.uint8)
    return expected, obs, packed


def bigk_sharded_fn(expected, mesh):
    """The big-K step's matcher: nib4 rows, ``k_chunk`` 8,192, the default
    route (the Hopper kernel of each shard's scheme)."""
    from .parallel.mesh import make_sharded_assign_fn

    return make_sharded_assign_fn(
        expected,
        max_mismatches=1,
        min_mismatch_delta=2,
        mesh=mesh,
        k_chunk=8192,
        packed_masks=True,
        compact_output=False,
        with_counts=False,
    )


def _dryrun_bigk_sharded(n_devices: int, devices: Devices = None) -> dict:
    """Big-K path: a 65,536-barcode whitelist sharded over the FULL
    whitelist axis (the configuration large single-cell whitelists run),
    cross-shard top-2 merge, packed-mask input — vs the NumPy spec."""
    from .ops.matcher import assign_batch_np
    from .parallel.mesh import make_demux_mesh

    devices = _device_list(n_devices, devices)
    expected, obs, packed = bigk_case()
    k = expected.count
    mesh = make_demux_mesh(n_batch=1, n_whitelist=n_devices, devices=devices)
    fn = bigk_sharded_fn(expected, mesh)
    assigned = fn(packed).cpu().numpy()
    np_idx, _, _ = assign_batch_np(obs, expected, 1, 2)
    np.testing.assert_array_equal(assigned, np.where(np_idx < 0, k, np_idx))
    return _counts(fn)


def bigk_kernels_case():
    """``(expected, obs, packed)`` of the per-shard kernel step: K 4,096,
    L 12, 50 reads (a ragged batch) and their bit2 rows."""
    from .ops.device_encoding import pack_bit2
    from .ops.matcher import ExpectedSet

    bc_bytes = _codes_whitelist(4096, 12)
    expected = ExpectedSet.from_barcodes([bytes(r).decode() for r in bc_bytes])
    obs = _mutated_reads(bc_bytes, 717, 50)
    return expected, obs, pack_bit2(obs)


def _dryrun_bigk_sharded_pallas(n_devices: int, devices: Devices = None) -> dict:
    """The production multi-device big-K configuration — bit2 transfers
    through the per-shard Hopper kernel (``use_kernels=True``; on the card
    ``colmerge_top2`` per shard, on the CPU its plain version) — validated
    against the NumPy spec.  The batch of 50 is ragged on purpose: the
    kernels pad nothing."""
    from .ops.matcher import assign_batch_np
    from .parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    devices = _device_list(n_devices, devices)
    expected, obs, packed = bigk_kernels_case()
    k = expected.count
    mesh = make_demux_mesh(n_batch=1, n_whitelist=n_devices, devices=devices)
    fn = make_sharded_assign_fn(
        expected,
        max_mismatches=1,
        min_mismatch_delta=2,
        mesh=mesh,
        packed2=True,
        with_counts=False,
        use_kernels=True,
    )
    assigned = fn(packed).cpu().numpy()
    np_idx, _, _ = assign_batch_np(obs, expected, 1, 2)
    np.testing.assert_array_equal(assigned, np.where(np_idx < 0, k, np_idx))
    return _counts(fn)


def _dryrun_pigeonhole_driver(n_devices: int, devices: Devices = None) -> dict:
    """Pigeonhole path THROUGH THE PRODUCT DRIVER: force the big-K
    threshold down so run_demux auto-selects the native pigeonhole host
    matcher, and byte-compare its outputs against the NumPy engine."""
    from .ops._build import ensure_native_engine
    from .runtime import demux as demux_mod

    ensure_native_engine()  # raises where the engine cannot be built
    saved = demux_mod.PALLAS_K_THRESHOLD
    demux_mod.PALLAS_K_THRESHOLD = 8  # K=16 below routes big-K
    try:
        return _dryrun_driver(n_devices, devices)
    finally:
        demux_mod.PALLAS_K_THRESHOLD = saved


@contextlib.contextmanager
def _local_devices_as(devices: List[torch.device]):
    """``run_demux`` lays its mesh over ``parallel.mesh.local_devices``:
    make that list ``devices`` for the duration (a list may repeat a
    device).  The matcher cache keys hold the list, so no entry built here
    serves another list."""
    from .parallel import mesh as mesh_mod

    saved = mesh_mod.local_devices
    mesh_mod.local_devices = lambda device="cuda": list(devices)
    try:
        yield
    finally:
        mesh_mod.local_devices = saved


def _dryrun_driver(n_devices: int, devices: Devices = None) -> dict:
    """``run_demux`` with ``devices=n`` on the native engine over
    ``devices``, byte for byte against the NumPy engine on one device.
    Returns the mesh run's ``DemuxResult.matcher`` (empty when a host
    matcher ran)."""
    from .ops._build import ensure_native_engine
    from .runtime.demux import DemuxConfig, run_demux

    devices = _device_list(n_devices, devices)
    ensure_native_engine()  # the native engine or an error, never the JAX one
    length, k = 17, 16
    barcodes = _whitelist(k, length)
    n_reads = 8 * max(1, n_devices) * 3 + 5
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        meta = tmp / "metadata.tsv"
        meta.write_text(
            "sample_id\tbarcode\n"
            + "".join(f"S{i:02d}\t{b}\n" for i, b in enumerate(barcodes))
        )
        rng = np.random.default_rng(77)
        i1 = tmp / "i1.fq.gz"
        with gzip.open(i1, "wb") as fh:
            for r in range(n_reads):
                bc = barcodes[int(rng.integers(0, k))].encode()
                if rng.integers(0, 5) == 0:
                    bc = b"N" + bc[1:]
                head = b"@inst:1:AB:2:3:%d:9 1:N:0:0" % r
                fh.write(head + b"\n" + bc + b"ACGTACGT\n+\n" + b"I" * (length + 8) + b"\n")
        cfg = DemuxConfig(
            inputs=[i1],
            read_structures=[f"{length}B+T"],
            sample_metadata=meta,
            output=tmp / "out_mesh",
            batch_size=8 * max(1, n_devices),
            engine="native",
            devices=n_devices,
            device=devices[0].type,
        )
        with _local_devices_as(devices):
            res_mesh = run_demux(cfg)
        cfg_np = dataclasses.replace(
            cfg, output=tmp / "out_np", engine="numpy", devices=1
        )
        res_np = run_demux(cfg_np)
        if not res_mesh.total_templates == res_np.total_templates == n_reads:
            raise AssertionError((res_mesh.total_templates, res_np.total_templates, n_reads))
        # union of both listings: a file present on only one side is
        # itself a divergence
        names = sorted(
            {p.name for p in (tmp / "out_np").glob("*.fq.gz")}
            | {p.name for p in (tmp / "out_mesh").glob("*.fq.gz")}
        )
        if not names:
            raise AssertionError("no outputs produced")
        for name in names:
            a = gzip.decompress((tmp / "out_np" / name).read_bytes())
            b = gzip.decompress((tmp / "out_mesh" / name).read_bytes())
            if a != b:
                raise AssertionError(f"driver mesh output differs: {name}")
    return dict(res_mesh.matcher)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    from .parallel.mesh import local_devices

    dryrun_multichip(len(local_devices("cuda")))
    print("dryrun_multichip ok")
