"""Multi-device demux: data-parallel reads x K-sharded whitelists, on GPUs.

Counterpart of :mod:`fqtk_tpu.parallel.mesh`.  A 2-D grid of devices:

- ``batch`` axis: each window's rows are cut into contiguous parts, one per
  grid row; each part is matched on its own devices.  No collective is
  needed for the assignment itself.
- ``whitelist`` axis: the whitelist is cut into contiguous shards of
  ``ceil(K / n)`` columns, one per grid column, each shard's table built on
  its own device one shard at a time (the whole table never exists).  Each
  tile computes its part's raw ``(best, idx, next)`` against its shard; the
  triples move to the grid row's first device and fold there with
  :func:`~fqtk_tpu_torch.ops.matcher.merge_top2` in ascending shard order,
  which keeps the reference's first-index tie-break across shards.  The
  gates run after the fold, on the whole whitelist's no-call budget.

Per tile the matcher is the one the single-device path runs: the Hopper
kernel that :func:`~fqtk_tpu_torch.ops.hopper_matcher.hopper_scheme` names
for ``k_per_shard`` (``colmerge_top2`` up to 4,194,304 columns a shard,
``tile_top2`` above), launched through the shard's
:meth:`HopperAssignFn.top2` (on a CPU tensor its plain PyTorch version, as
the JAX package runs Pallas in interpret mode there); or, off the kernels
(``use_kernels=False``, barcodes longer than 255 bp), the chunked scan of
:meth:`ScanAssignFn.top2`.

The parts' results are gathered in order on the grid's first device (the
JAX ``all_gather``), and the per-sample counts are summed over the parts
(the ``psum``).  A device may appear more than once in a grid: several
shards then share one card (or, in the tests, the CPU).

:func:`local_devices` is the one place the port counts devices, the
counterpart of ``jax.devices()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.hopper_matcher import (
    ColmergeTop2,
    HopperAssignFn,
    TileTop2,
    hopper_scheme,
    hopper_state_from_numpy,
)
from ..ops.matcher import (
    MAX_COUNT,
    ExpectedSet,
    ScanAssignFn,
    check_rows,
    input_form,
    make_assign_fn,
    merge_top2,
    resolve_device,
)
from ..utils.profiling import TRACER

__all__ = [
    "DemuxMesh", "ShardedAssignFn", "local_devices", "make_demux_mesh",
    "make_sharded_assign_fn",
]


def local_devices(device: Union[str, torch.device] = "cuda") -> List[torch.device]:
    """The devices of this process for ``device``'s type: every visible GPU
    (``cuda:0 .. cuda:n-1``, from ``torch.cuda.device_count()``: none
    without a card, where the matchers' own device check raises) for
    ``cuda``, and ``[cpu]`` for ``cpu``."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


@dataclass(frozen=True)
class DemuxMesh:
    """A ``[n_batch][n_whitelist]`` grid of devices; ``shape`` names its
    axes as the JAX mesh does."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"batch": len(self.devices), "whitelist": len(self.devices[0])}


def make_demux_mesh(
    n_batch: Optional[int] = None,
    n_whitelist: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> DemuxMesh:
    """Create a ``(batch, whitelist)`` mesh over ``devices`` (default:
    :func:`local_devices` of ``cuda``), row by row.  A list may repeat a
    device."""
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = local_devices("cuda")
    devices = list(devices)
    n = len(devices)
    if n_batch is None:
        assert n % n_whitelist == 0, (n, n_whitelist)
        n_batch = n // n_whitelist
    assert n_batch * n_whitelist <= n
    return DemuxMesh(tuple(
        tuple(torch.device(devices[i * n_whitelist + j]) for j in range(n_whitelist))
        for i in range(n_batch)
    ))


Matcher = Union[HopperAssignFn, ScanAssignFn]


class ShardedAssignFn:
    """``obs (numpy or torch) -> (assigned, counts)`` over a
    :class:`DemuxMesh` (``assigned`` alone without ``with_counts``), both on
    the mesh's first device: :func:`make_sharded_assign_fn`'s matcher.

    ``tiles[i][j]`` is the matcher of whitelist shard ``j`` on
    ``mesh.devices[i][j]`` (``None`` for an empty trailing shard).
    ``launches`` / ``plain_calls`` / ``kernels`` add up every shard's Hopper
    kernels, ``calls`` every shard's scan calls, so the demux reads this
    matcher's counts as a single one's."""

    def __init__(self, mesh: DemuxMesh, tiles: List[List[Optional[Matcher]]],
                 expected: ExpectedSet, k_per_shard: int, max_mismatches: int,
                 min_mismatch_delta: int, form: str, scheme: str, use_kernels: bool,
                 kernels: Dict[str, object], compact_output: bool,
                 with_counts: bool) -> None:
        self.mesh = mesh
        self.tiles = tiles
        self.k = expected.count
        self.length = expected.length
        self.k_per_shard = k_per_shard
        self.n_k_shards = mesh.shape["whitelist"]
        self.n_batch = mesh.shape["batch"]
        # the kernels take any B: no pad rows, the parts are tensor_split's
        self.batch_multiple = self.n_batch
        self.max_mismatches = max_mismatches
        self.min_mismatch_delta = min_mismatch_delta
        # the whole whitelist's budget: a shard's own max_ns would be wrong
        self.nocall_budget = max_mismatches + expected.max_ns_in_barcodes
        self.form = form
        self.scheme = scheme
        self.use_kernels = use_kernels
        self.kernels = kernels
        self.with_counts = with_counts
        self.out_dtype = torch.uint8 if compact_output and self.k < 255 else torch.int32
        classes = 4 if form == "bit2" else 16
        # MACs of the dense one-hot contraction over the shards' columns
        self.macs_per_row = classes * self.length * self.n_k_shards * k_per_shard

    def _distinct(self) -> List[Matcher]:
        seen: Dict[int, Matcher] = {}
        for row in self.tiles:
            for fn in row:
                if fn is not None:
                    seen.setdefault(id(fn), fn)
        return list(seen.values())

    @property
    def launches(self) -> int:
        return sum(kern.launches for kern in self.kernels.values())

    @property
    def plain_calls(self) -> int:
        return sum(kern.plain_calls for kern in self.kernels.values())

    @property
    def calls(self) -> int:
        return sum(getattr(fn, "calls", 0) for fn in self._distinct())

    def _row(self, i: int, rows: torch.Tensor) -> torch.Tensor:
        """``assigned`` of batch part ``i`` on ``mesh.devices[i][0]``: every
        shard's raw top-2, folded in ascending shard order, then gated."""
        devs = self.mesh.devices[i]
        on: Dict[torch.device, torch.Tensor] = {}
        acc = nocalls = None
        for j, fn in enumerate(self.tiles[i]):
            if fn is None:
                continue
            if devs[j] not in on:
                on[devs[j]] = rows.to(devs[j], non_blocking=True)
            best, idx, nxt, nc = fn.top2(on[devs[j]])
            triple = tuple(t.to(devs[0], non_blocking=True)
                           for t in (best, idx + j * self.k_per_shard, nxt))
            if acc is None:  # shard 0: never empty, on devs[0]
                acc, nocalls = triple, nc
            else:
                acc = merge_top2(acc, triple)
        best, idx, nxt = acc
        if self.k == 1:
            # no real runner-up: the spec's 255, whatever a shard reports
            nxt = torch.full_like(nxt, MAX_COUNT)
        ok = (best <= self.max_mismatches) & (nxt - best >= self.min_mismatch_delta)
        if nocalls is not None:  # nib4 and raw bytes; bit2 rows are pure ACGT
            ok = ok & (nocalls <= self.nocall_budget)
        return torch.where(ok, idx, self.k).to(self.out_dtype)

    def __call__(self, obs: Union[np.ndarray, torch.Tensor]):
        if isinstance(obs, np.ndarray):
            obs = torch.from_numpy(np.ascontiguousarray(obs))
        check_rows(obs, self.form, self.length)
        out = self.mesh.devices[0][0]
        # every tile is enqueued before anything is fetched; H2D copies are
        # asynchronous, so the caller keeps ``obs`` alive until it fetches
        parts = [self._row(i, rows)
                 for i, rows in enumerate(torch.tensor_split(obs, self.n_batch))
                 if len(rows)]
        assigned = (torch.cat([a.to(out, non_blocking=True) for a in parts]) if parts
                    else torch.empty(0, dtype=self.out_dtype, device=out))
        if not self.with_counts:
            return assigned
        counts = torch.zeros(self.k + 1, dtype=torch.int64, device=out)
        for a in parts:
            counts += torch.bincount(a.long(), minlength=self.k + 1).to(out, non_blocking=True)
        return assigned, counts


def make_sharded_assign_fn(
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    mesh: DemuxMesh,
    k_chunk: int = 16384,
    packed_masks: bool = False,
    packed2: bool = False,
    compact_output: bool = False,
    with_counts: bool = True,
    use_kernels: Optional[bool] = None,
) -> ShardedAssignFn:
    """Build the sharded demux step: ``obs[B, W] -> (assigned[B],
    counts[K+1])`` (``assigned`` alone when ``with_counts`` is false), the
    counterpart of ``fqtk_tpu.parallel.mesh.make_sharded_assign_fn``.

    Input forms as there: ``packed2`` bit2 ``[B, ceil(L/4)]`` (pure ACGT:
    no no-call gate), ``packed_masks`` nib4 ``[B, ceil(L/2)]``, neither raw
    bytes ``[B, L]``.  ``compact_output``: uint8 ``assigned`` when K < 255.
    ``counts`` holds the per-sample template totals in int64, unmatched in
    slot K.

    ``use_kernels`` (default: L <= 255, on ``cuda`` and ``cpu`` alike) runs
    each shard through the Hopper kernel of ``hopper_scheme(k_per_shard,
    L)`` (4 classes for bit2, 16 for nib4 and raw bytes), the counterpart of
    ``use_pallas``; otherwise each shard is the chunked scan of
    :func:`~fqtk_tpu_torch.ops.matcher.make_assign_fn` over ``k_chunk``
    columns.  The JAX function's tiling arguments have no counterpart: the
    kernels keep their own (``plan_chunks``).

    A trailing shard is empty when K is tiny (K = 3 over 8 shards) and is
    skipped: the JAX package's all-ones pad columns there never win against
    a real column.  Any B works; no rows are padded."""
    form = input_form(packed_masks, packed2)
    k, length = expected.count, expected.length
    n_k_shards = mesh.shape["whitelist"]
    n_batch = mesh.shape["batch"]
    k_per_shard = -(-k // n_k_shards)
    if use_kernels is None:
        use_kernels = length <= 255
    kernels: Dict[str, object] = {}
    if use_kernels:
        if length > 255:
            raise ValueError(
                "the Hopper matcher supports barcode lengths <= 255 (8-bit "
                f"count in the top-2 key), got {length}"
            )
        scheme = hopper_scheme(k_per_shard, length)
        kernels = {"colmerge_top2": ColmergeTop2(), "tile_top2": TileTop2()}
    else:
        scheme = ScanAssignFn.scheme

    tiles: List[List[Optional[Matcher]]] = [[None] * n_k_shards for _ in range(n_batch)]
    # one set-up span over the shards' tables (host time: the shards'
    # device work is queued on their own devices)
    with TRACER.setup_span("fqtk.setup.table"):
        for s in range(n_k_shards):
            masks = expected.masks[s * k_per_shard:(s + 1) * k_per_shard]
            if not len(masks):
                continue
            shard = ExpectedSet(masks=masks, max_ns_in_barcodes=expected.max_ns_in_barcodes,
                                length=length, count=len(masks))
            # one matcher per device the shard lands on: grid rows on one
            # device share it
            built: Dict[torch.device, Matcher] = {}
            for i in range(n_batch):
                dev = mesh.devices[i][s]
                if dev in built:
                    pass
                elif use_kernels:
                    state = hopper_state_from_numpy(shard, dev, scheme,
                                                    classes=4 if form == "bit2" else 16)
                    built[dev] = HopperAssignFn(state, max_mismatches, min_mismatch_delta,
                                                False, form, kernels=kernels)
                else:
                    built[dev] = make_assign_fn(shard, max_mismatches, min_mismatch_delta,
                                                k_chunk, packed_masks, packed2, device=dev)
                tiles[i][s] = built[dev]
    return ShardedAssignFn(mesh, tiles, expected, k_per_shard, max_mismatches,
                           min_mismatch_delta, form, scheme, use_kernels, kernels,
                           compact_output, with_counts)
