"""The demux pipeline with device-placed assignment in PyTorch.

Counterpart of the device side of :mod:`fqtk_tpu.runtime.demux` on its
native engine:

1. the C++ engine (``native/fqtk_io.cpp`` through
   :mod:`fqtk_tpu_torch.io.native`) parses the FASTQs and packs each read's
   sample barcode as 2-bit codes (``[B, ceil(L/4)]`` uint8, "bit2"),
2. each window goes to the Hopper matcher
   (:func:`fqtk_tpu_torch.ops.hopper_matcher.make_hopper_assign_fn`), or for
   barcodes longer than 255 bp to the chunked scan of
   :func:`fqtk_tpu_torch.ops.matcher.make_assign_fn`, one call kept in
   flight while the previous window is fetched and routed;
   rows that are not pure ACGT are resolved on the host with the NumPy spec,
3. the engine routes records to per-sample BGZF writers.

The host side (validation, the host-matcher wrapper, metrics) is the port's
own copy of ``fqtk_tpu/runtime/demux.py``'s (``:51-265``, ``:412``,
``:1453-1511``), under the same names; nothing is imported from that
package.  The native engine is required: where it is unavailable this raises
instead of running the Python-IO engine.
"""

from __future__ import annotations

import logging
import os
import stat
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.read_structure import (
    FILE_TYPE_CODE,
    ReadStructure,
    ReadStructureError,
    SegmentType,
)
from ..core.samples import SampleGroup
from ..io import native as native_io
from ..ops._build import ensure_native_engine
from ..ops.hopper_matcher import make_hopper_assign_fn, resolve_device
from ..ops.matcher import ExpectedSet, ScanAssignFn, assign_batch_np, make_assign_fn
from ..utils.floatfmt import format_f64
from ..utils.profiling import StageTimers, maybe_device_trace

__all__ = ["DemuxConfig", "DemuxError", "DemuxResult", "run_demux"]

logger = logging.getLogger("fqtk")

_ROADMAP = "not ported yet (ROADMAP.md, 'Modules still to port')"


#: fixed iteration order of segment-type writers (reference ``demux.rs:397-402``)
_TYPE_ORDER = (
    SegmentType.Template,
    SegmentType.SampleBarcode,
    SegmentType.MolecularBarcode,
    SegmentType.CellularBarcode,
)


class DemuxError(RuntimeError):
    pass


#: default pipeline window: sized to amortize the device path's fixed
#: per-dispatch cost (transfer + launch) over many reads
DEFAULT_BATCH_SIZE = 1 << 17

#: window used when a HOST matcher is auto-selected and the user left
#: ``batch_size`` at the default: host assignment has no per-dispatch cost
#: to amortize, and small windows overlap parse/assign/route/compress far
#: better (measured +70% on the single-end configs at 16K vs 128K)
HOST_MATCHER_BATCH = 1 << 14



@dataclass
class DemuxConfig:
    inputs: List[Path]
    read_structures: List[str]
    sample_metadata: Path
    output: Path
    output_types: List[str] = field(default_factory=lambda: ["T"])
    unmatched_prefix: str = "unmatched"
    max_mismatches: int = 1
    min_mismatch_delta: int = 2
    threads: int = 8
    compression_level: int = 5
    skip_reasons: List[str] = field(default_factory=list)
    # engine extensions (not in the reference CLI)
    batch_size: int = DEFAULT_BATCH_SIZE
    engine: str = "auto"  # auto | native (the Python-IO engines are not ported)
    #: device count for the batch/whitelist mesh: None = all local devices
    #: (single-device path when only one is visible), 1 = force single
    devices: Optional[int] = None
    #: assignment placement: "auto" picks host matchers when the per-batch
    #: device round-trip would dominate (tiny K, single device) and the
    #: device paths otherwise; "host"/"device" force one side
    matcher: str = "auto"
    #: where device-placed assignment runs: "cuda" (raises without a card)
    #: or "cpu" (the kernel's plain PyTorch version)
    device: str = "cuda"


@dataclass
class DemuxResult:
    metrics: List[dict]
    skip_counts: Dict[str, int]
    total_templates: int
    timings: Dict[str, float] = field(default_factory=dict)
    #: the device matcher's route (``scheme``: ``colmerge_top2``,
    #: ``tile_top2`` or ``xla_scan``) and counters: ``launches`` and
    #: ``plain_calls`` over both Hopper kernels and ``<kernel>_launches`` /
    #: ``<kernel>_plain_calls`` for each; the ``xla_scan`` route runs no
    #: kernel (``launches`` and ``plain_calls`` 0) and counts its ``calls``;
    #: empty when a host matcher ran
    matcher: Dict[str, Union[int, str]] = field(default_factory=dict)


def _parse_output_types(chars: Sequence[str]) -> List[SegmentType]:
    types: List[SegmentType] = []
    for c in chars:
        types.append(SegmentType.from_char(c))
    # de-dup, stable order
    seen = set()
    out = []
    for t in types:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def validate_and_prepare(cfg: DemuxConfig):
    """Input validation, mirroring ``demux.rs:806-875`` (messages included)."""
    errors: List[str] = []

    if len(cfg.inputs) != len(cfg.read_structures):
        errors.append(
            "The same number of read structures should be given as FASTQs "
            f"{len(cfg.read_structures)} read-structures provided for "
            f"{len(cfg.inputs)} FASTQs"
        )

    output = Path(cfg.output)
    if not output.exists():
        logger.info('Output directory "%s" didn\'t exist, creating it.', output)
        output.mkdir(parents=True, exist_ok=True)

    # the reference checks the permission BITS (fs::Permissions::readonly,
    # demux.rs:824-827), not effective access — matters for root, where
    # os.access() would say a chmod-555 directory is writable
    if output.stat().st_mode & 0o222 == 0:
        # NB: "Ouput" typo is the reference's operator-facing text (demux.rs:826)
        errors.append(f'Ouput directory "{output}" cannot be read-only')

    output_types: Optional[List[SegmentType]] = None
    try:
        output_types = _parse_output_types(cfg.output_types)
    except ReadStructureError as e:
        errors.append(f"Error parsing segment types to report: {e}")

    for inp in cfg.inputs:
        if not Path(inp).exists():
            errors.append(f'Provided input file "{inp}" doesn\'t exist')

    # attempt to open the files for reading (collected, first failure only —
    # the reference's Result collect short-circuits; demux.rs:843-851).
    # Stream inputs (pipes / process substitution / sockets) are exempt:
    # an open-close probe would block without a writer, or kill the writer
    # with SIGPIPE before the engine's single real open.
    for inp in cfg.inputs:
        try:
            mode = os.stat(inp).st_mode
            if stat.S_ISFIFO(mode) or stat.S_ISSOCK(mode) or stat.S_ISCHR(mode):
                continue
            with open(inp, "rb"):
                pass
        except OSError as e:
            errors.append(f"Error opening input files for reading: {e}")
            break

    if cfg.threads < 5:
        errors.append(
            f"Threads provided {cfg.threads} was too low! Must be 5 or more."
        )

    if not errors and output_types is not None and not output_types:
        errors.append(
            "No output types requested, must request at least one output segment type."
        )

    if errors:
        details = "Inputs failed validation!\n"
        for e in errors:
            details += f"    - {e}\n"
        raise DemuxError(
            f"The following errors with the input(s) were detected:\n{details}"
        )
    assert output_types is not None
    return output, output_types


def _too_few_bases_allowed(cfg: DemuxConfig) -> bool:
    allowed = set()
    for s in cfg.skip_reasons:
        if s in ("too few bases", "too-few-bases", "toofewbases"):
            allowed.add("TooFewBases")
        else:
            raise DemuxError(f"Invalid skip reason: {s}")
    return "TooFewBases" in allowed



#: whitelist size from which the JAX package prefers its fused kernel to
#: the XLA scan; here it only gates the big-K pigeonhole host matcher, as
#: there
PALLAS_K_THRESHOLD = 65536


def _host_matcher_max_k():
    """Optional explicit whitelist-size cap (``FQTK_HOST_MATCHER_MAX_K``) at
    or below which the auto policy keeps assignment on the host (brute-force
    ``SmallKMatcher``).  ``None`` when unset: the JAX package then measures
    the placement; the port takes the device path (measured placement is
    not ported yet, ROADMAP.md).  ``=0`` routes every whitelist to the
    device; an unparsable value reads as 4096, as in the JAX package."""
    v = os.environ.get("FQTK_HOST_MATCHER_MAX_K")
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        return 4096


def _host_assign_wrapper(matcher):
    """Closure over the host matcher (keeps it alive, attribute-friendly).

    ``assign.native_matcher`` exposes the underlying native matcher so the
    native engine can FUSE it (engine-side assign thread, no per-window
    Python round trips; see ``NativeDemuxEngine.pipe_fuse_host_matcher``)."""

    def assign(obs_packed):
        return matcher.assign(obs_packed)

    assign.native_matcher = matcher
    return assign



class _Pending:
    """A dispatched device call.  ``fetch()`` waits for the device, copies
    the result to the host and applies ``finish`` (the dedup scatter).
    ``keep`` holds the host source of an asynchronous H2D copy until then."""

    __slots__ = ("dev", "finish", "keep")

    def __init__(self, dev: torch.Tensor, finish=None, keep=None) -> None:
        self.dev = dev
        self.finish = finish
        self.keep = keep

    def fetch(self) -> np.ndarray:
        host = self.dev.cpu().numpy()
        return host if self.finish is None else self.finish(host)


def _build_device_assign_fn(cfg: DemuxConfig, expected: ExpectedSet, barcodes):
    """Matcher for the native engine: ``(assign, pack_mode, host_matcher)``.

    The host branches are those of
    ``fqtk_tpu.runtime.demux._build_device_assign_fn``: the big-K pigeonhole
    matcher, the ``FQTK_HOST_MATCHER_MAX_K`` cap and ``--matcher host``.
    Where the JAX package would measure the placement, this takes the
    device path.  :func:`run_demux` has loaded the native library, so unlike
    the JAX package's copy this never checks for it."""
    big_k = expected.count >= PALLAS_K_THRESHOLD and expected.length <= 255
    policy = cfg.matcher or "auto"
    host_threads = max(2, min(cfg.threads - 1, os.cpu_count() or 4))

    if policy != "device" and big_k and barcodes is not None:
        try:
            matcher = native_io.NativeBigKMatcher(
                barcodes,
                cfg.max_mismatches,
                cfg.min_mismatch_delta,
                threads=host_threads,
            )
            logger.info(
                "big-K pigeonhole host matcher selected (K=%d, %d parts, "
                "%d threads)",
                expected.count,
                cfg.max_mismatches + max(cfg.min_mismatch_delta, 1),
                host_threads,
            )
            return _host_assign_wrapper(matcher), "nib4", True
        except native_io.NativeDemuxError:
            pass  # ineligible whitelist: fall through

    def _host_small_k():
        """Build the host SmallKMatcher; None if the whitelist is ineligible."""
        try:
            return native_io.NativeSmallKMatcher(
                barcodes,
                cfg.max_mismatches,
                cfg.min_mismatch_delta,
                threads=host_threads,
            )
        except native_io.NativeDemuxError:
            return None  # ineligible whitelist: fall through to device paths

    cap = _host_matcher_max_k()
    if barcodes is not None and (
        policy == "host"
        or (
            policy == "auto"
            and cfg.devices in (None, 1)
            and cap is not None
            and expected.count <= cap
        )
    ):
        matcher = _host_small_k()
        if matcher is not None:
            logger.info(
                "small-K brute-force host matcher selected (K=%d, "
                "%d threads; device round-trip would dominate)",
                expected.count,
                host_threads,
            )
            return _host_assign_wrapper(matcher), "nib4", True
    elif (
        barcodes is not None
        and policy == "auto"
        and cfg.devices in (None, 1)
        and cap is None
    ):
        logger.info(
            "measured matcher placement is %s; taking the device path "
            "(set FQTK_HOST_MATCHER_MAX_K or --matcher host for the host "
            "matcher)",
            _ROADMAP,
        )

    return _build_device_side(cfg, expected)


def _build_device_side(cfg: DemuxConfig, expected: ExpectedSet):
    """The device matcher on one device, bit2 input, behind the window
    dedup: the Hopper matcher for barcodes of at most 255 bp, the chunked
    scan of :func:`~fqtk_tpu_torch.ops.matcher.make_assign_fn` above (where
    the JAX package's device path leaves its Pallas kernel for
    ``make_assign_fn(packed2=True)``).  Returns ``(assign, "bit2",
    False)``; ``assign(obs)`` returns a :class:`_Pending`."""
    if cfg.devices is not None and cfg.devices > 1:
        raise DemuxError(f"--devices {cfg.devices}: multi-GPU mesh {_ROADMAP}")
    if expected.length <= 255:
        # colmerge_top2 up to K = 4,194,304, tile_top2 above (hopper_scheme)
        fn = make_hopper_assign_fn(
            expected,
            cfg.max_mismatches,
            cfg.min_mismatch_delta,
            device=cfg.device,
            packed2=True,
            compact_output=True,
        )
        route = f"Hopper {fn.scheme} on {fn.state.device}"
    else:
        # the 8-bit count key of the Hopper kernels does not hold L > 255
        fn = make_assign_fn(
            expected,
            cfg.max_mismatches,
            cfg.min_mismatch_delta,
            packed2=True,
            compact_output=True,
            device=cfg.device,
        )
        route = f"{fn.scheme} (float32 torch.matmul per K chunk) on {fn.device}"
    logger.info(
        "device matcher: %s (K=%d, L=%d)", route, expected.count, expected.length
    )

    def assign(obs_packed):
        return _Pending(fn(obs_packed)[0], keep=obs_packed)

    wrapped = _wrap_window_dedup(assign)
    wrapped.device_matcher = fn
    return wrapped, "bit2", False


def _wrap_window_dedup(call: Callable[[np.ndarray], _Pending]):
    """Per-window dedup in front of the device matcher (counterpart of
    ``fqtk_tpu.runtime.demux._wrap_window_dedup``, same policy): unique
    packed rows go to the device once, padded to a power-of-two bucket with
    copies of the first unique row, and results scatter back through the
    inverse map after the fetch — bit-exact, since identical packed rows
    score identically.  Engages for windows >= 4096 rows, packed width <= 8
    bytes and >= 2x duplication.  ``FQTK_DEVICE_DEDUP=0`` disables."""
    if os.environ.get("FQTK_DEVICE_DEDUP", "1") == "0":
        return call

    logged = False

    def assign(obs_packed):
        nonlocal logged
        obs = np.asarray(obs_packed)
        b, w = obs.shape
        if b >= 4096 and w <= 8:
            obs = np.ascontiguousarray(obs)
            if w in (1, 2, 4, 8):
                keys = obs.view(f"u{w}").reshape(b)
            else:
                full = np.zeros((b, 8), dtype=np.uint8)
                full[:, :w] = obs
                keys = full.view(np.uint64).reshape(b)
            uniq, first_idx, inv = np.unique(
                keys, return_index=True, return_inverse=True
            )
            nu = len(uniq)
            bucket = max(4096, 1 << max(0, (nu - 1).bit_length()))
            if nu <= b // 2 and bucket < b:
                rows = obs[first_idx]
                if bucket > nu:
                    rows = np.concatenate(
                        [rows, np.broadcast_to(rows[:1], (bucket - nu, w))]
                    )
                if not logged:
                    logged = True
                    logger.info(
                        "device window dedup engaged: %d unique of %d rows "
                        "(bucket %d)",
                        nu,
                        b,
                        bucket,
                    )
                inner = call(np.ascontiguousarray(rows))
                # results of the bucket's pad rows are dropped ([:nu])
                return _Pending(
                    inner.dev, finish=lambda h: h[:nu][inv], keep=inner.keep
                )
        return call(obs_packed)

    return assign


def run_demux(cfg: DemuxConfig) -> DemuxResult:
    """Demultiplex on the native engine with device-placed assignment on
    ``cfg.device``.  Raises for an engine other than auto/native, for
    ``device="cuda"`` without a card, and when the native engine cannot be
    loaded or built."""
    if cfg.engine not in ("auto", "native"):
        raise DemuxError(
            f"engine {cfg.engine!r}: the Python-IO engine and its JAX/NumPy "
            f"matchers are {_ROADMAP}; use engine 'native' (or 'auto')"
        )
    resolve_device(cfg.device)
    ensure_native_engine()
    return _run_demux_native(cfg)


def _run_demux_native(cfg: DemuxConfig) -> DemuxResult:
    """Driver loop of ``fqtk_tpu.runtime.demux._run_demux_native``, with the
    device results fetched through :meth:`_Pending.fetch`."""
    output, output_types = validate_and_prepare(cfg)
    skip_too_few = _too_few_bases_allowed(cfg)

    sample_group = SampleGroup.from_file(cfg.sample_metadata)
    logger.info(
        "%d samples loaded from file %s", len(sample_group.samples), cfg.sample_metadata
    )

    structures = [ReadStructure.from_str(s) for s in cfg.read_structures]
    expected = ExpectedSet.from_barcodes([s.barcode for s in sample_group.samples])
    bc_len = expected.length
    k = expected.count
    assign, pack_mode, host_matcher = _build_device_assign_fn(
        cfg, expected, barcodes=[s.barcode for s in sample_group.samples]
    )
    device_matcher = getattr(assign, "device_matcher", None)

    packed_len = (bc_len + 3) // 4 if pack_mode == "bit2" else (bc_len + 1) // 2

    engine = native_io.NativeDemuxEngine(
        threads=max(1, cfg.threads - 2), compression_level=cfg.compression_level
    )
    try:
        for path, rs in zip(cfg.inputs, structures):
            engine.add_input(
                str(path),
                str(rs),
                [(s.offset, s.length, s.kind.value) for s in rs],
            )

        requested = [t for t in _TYPE_ORDER if t in output_types]
        names = [s.sample_id for s in sample_group.samples] + [cfg.unmatched_prefix]
        files_per_sample = sum(
            sum(len(rs.segments_by_type(t)) for rs in structures) for t in requested
        )
        try:
            import resource

            fd_limit = resource.getrlimit(resource.RLIMIT_NOFILE)[1]
            resource.setrlimit(resource.RLIMIT_NOFILE, (fd_limit, fd_limit))
            if fd_limit == resource.RLIM_INFINITY:  # -1: unlimited, not tiny
                fd_limit = 1 << 30
        except (ImportError, OSError, ValueError):  # pragma: no cover
            fd_limit = 1 << 20
        if len(names) * files_per_sample + 64 > fd_limit:
            raise DemuxError(
                f"{len(names)} samples x {files_per_sample} output files exceeds "
                f"this system's open-file limit ({fd_limit}); reduce samples or "
                f"output types, or raise the limit"
            )
        for name in names:
            paths = []
            for seg_type in requested:
                count = sum(
                    len(rs.segments_by_type(seg_type)) for rs in structures
                )
                code = FILE_TYPE_CODE[seg_type]
                paths += [
                    str(output / f"{name}.{code}{idx}.fq.gz")
                    for idx in range(1, count + 1)
                ]
            engine.add_sample(paths)
        logger.info("Created sample and %s writers.", cfg.unmatched_prefix)

        engine.configure(
            bc_len=bc_len,
            nocall_budget=cfg.max_mismatches + expected.max_ns_in_barcodes,
            skip_too_few=skip_too_few,
            first_sample_id=sample_group.samples[0].sample_id,
            first_barcode=sample_group.samples[0].barcode.upper(),
            out_types="".join(t.value for t in requested),
            pack_mode=2 if pack_mode == "bit2" else 1,
        )

        skip_counts: Dict[str, int] = {}
        total = 0
        skipped_total = 0
        next_log = 1_000_000
        batch = cfg.batch_size
        if host_matcher and batch == DEFAULT_BATCH_SIZE:
            batch = HOST_MATCHER_BATCH

        timers = StageTimers()

        # The batch loop lives in C++ (parse threads, window ring, route
        # thread, BGZF pool); this thread only services matcher calls
        # between acquire and submit.  FQTK_PIPE_RAMP / FQTK_FUSED_ASSIGN as
        # in fqtk_tpu.runtime.demux.
        ramp = os.environ.get("FQTK_PIPE_RAMP") == "1" and host_matcher
        fused = (
            host_matcher
            and os.environ.get("FQTK_FUSED_ASSIGN", "1") != "0"
            and getattr(assign, "native_matcher", None) is not None
            and engine.pipe_fuse_host_matcher(assign.native_matcher)
        )
        first = True
        with maybe_device_trace():
            # started inside the trace: the pipeline timing and the engine's
            # threads do not wait on the profiler's start-up
            t_pipe = time.perf_counter()
            engine.pipe_start(batch, packed_len, ramp=ramp)
            while fused:
                state, total, skipped_total = engine.pipe_fused_poll(50)
                while total >= next_log:
                    logger.info(
                        "fqtk: %s records demultiplexed", f"{next_log:,}"
                    )
                    next_log += 1_000_000
                if state != 0:
                    break
            # Device-placement runs keep ONE window's device call in flight:
            # window N+1 is dispatched before window N's result is fetched.
            # Safe because a slot's bc buffer stays valid until ITS
            # pipe_submit, and the pending window is always fetched before
            # being submitted.
            overlap = not host_matcher and os.environ.get(
                "FQTK_DEVICE_OVERLAP", "1"
            ) != "0"
            pending = None  # (slot, n, in-flight _Pending)

            def resolve_and_submit(p_slot, p_n, assigned):
                # shared tail of the overlap and serial arms
                nonlocal total, next_log
                if pack_mode == "bit2":
                    # rows with ambiguous/no-call bytes could not be 2-bit
                    # encoded: resolve them with the NumPy spec (the no-call
                    # gate already ran in C++)
                    exc_idx, exc_raw = engine.pipe_exceptional(p_slot)
                    if exc_idx is not None:
                        with timers.time("exceptional"):
                            eidx, _, _ = assign_batch_np(
                                exc_raw,
                                expected,
                                cfg.max_mismatches,
                                cfg.min_mismatch_delta,
                            )
                            assigned[exc_idx] = np.where(
                                eidx < 0, k, eidx
                            ).astype(np.int32)
                with timers.time("submit"):
                    engine.pipe_submit(p_slot, assigned)
                total += p_n
                while total >= next_log:
                    logger.info(
                        "fqtk: %s records demultiplexed", f"{next_log:,}"
                    )
                    next_log += 1_000_000

            def finish_pending():
                nonlocal pending, first
                p_slot, p_n, fut = pending
                pending = None
                with timers.time("assign"):
                    assigned = fut.fetch()[:p_n].astype(np.int32)
                if first:
                    first = False
                    logger.info("device matcher ready.")
                resolve_and_submit(p_slot, p_n, assigned)

            while not fused:
                with timers.time("acquire_wait"):
                    n, slot, bc_view, sk = engine.pipe_acquire()
                skipped_total += sk
                if n == 0:
                    if pending is not None:
                        finish_pending()
                    break
                if host_matcher:
                    with timers.time("assign"):
                        # only the n valid rows (a leading-axis slice of the
                        # C-order view is still contiguous)
                        assigned = np.asarray(assign(bc_view[:n])).astype(
                            np.int32
                        )
                    resolve_and_submit(slot, n, assigned)
                    continue
                if overlap:
                    with timers.time("dispatch"):
                        fut = assign(bc_view[:n])
                    if pending is not None:
                        finish_pending()
                    pending = (slot, n, fut)
                    continue
                with timers.time("assign"):
                    assigned = assign(bc_view[:n]).fetch().astype(np.int32)
                if first:
                    first = False
                    logger.info("device matcher ready.")
                resolve_and_submit(slot, n, assigned)

            logger.info("Finished reading input FASTQs.")
            with timers.time("finish"):
                engine.pipe_finish()
            pipeline_s = time.perf_counter() - t_pipe
        logger.info("Output FASTQ writing complete.")
        logger.info(
            "demux pipeline: %d records in %.3f s (%.0f reads/s)",
            total,
            pipeline_s,
            total / pipeline_s if pipeline_s > 0 else 0.0,
        )
        counts = engine.counts(k + 1)
        if skipped_total:
            skip_counts["TooFewBases"] = skipped_total
        timers.log(total)
        native_stats = engine.stats()
        logger.info(
            "native stage times (thread-summed): %s",
            {k_: round(v, 3) for k_, v in native_stats.items()},
        )
    except native_io.NativeDemuxError as e:
        raise DemuxError(str(e)) from None
    finally:
        engine.close()

    if not skip_counts:
        logger.info("No records were skipped.")
    else:
        for reason, count in sorted(skip_counts.items(), key=lambda kv: kv[1]):
            logger.info("%d records were skipped due to Too few bases", count)

    matcher_stats: Dict[str, Union[int, str]] = {}
    if isinstance(device_matcher, ScanAssignFn):
        # the route of barcodes longer than 255 bp runs no kernel
        matcher_stats = {
            "scheme": device_matcher.scheme,
            "launches": 0,
            "plain_calls": 0,
            "calls": device_matcher.calls,
        }
        logger.info(
            "device matcher %s: %d calls, no kernel",
            device_matcher.scheme,
            device_matcher.calls,
        )
    elif device_matcher is not None:
        matcher_stats = {
            "scheme": device_matcher.scheme,
            "launches": device_matcher.launches,
            "plain_calls": device_matcher.plain_calls,
        }
        for name, kern in device_matcher.kernels.items():
            matcher_stats[f"{name}_launches"] = kern.launches
            matcher_stats[f"{name}_plain_calls"] = kern.plain_calls
        ran = device_matcher.kernels[device_matcher.scheme]
        logger.info(
            "device matcher %s: %d kernel launches, %d plain-version calls",
            device_matcher.scheme,
            ran.launches,
            ran.plain_calls,
        )

    metrics = compute_metrics(sample_group, counts, cfg.unmatched_prefix)
    write_metrics(output / "demux-metrics.txt", metrics)
    return DemuxResult(
        metrics=metrics,
        skip_counts=skip_counts,
        total_templates=int(counts.sum()),
        timings={**timers.summary(), **native_stats, "pipeline": pipeline_s},
        matcher=matcher_stats,
    )


def compute_metrics(
    sample_group: SampleGroup, counts: np.ndarray, unmatched_prefix: str
) -> List[dict]:
    """Derived metrics per sample (reference ``demux.rs:481-496``)."""
    n = len(sample_group.samples)
    templates = counts[:n].astype(np.float64)
    unmatched = np.float64(counts[n])
    with np.errstate(divide="ignore", invalid="ignore"):
        sample_total = templates.sum()
        total = sample_total + unmatched
        mean = sample_total / np.float64(n)
        best = np.float64(templates.max() if n else 0.0)
        rows = []
        for i, s in enumerate(sample_group.samples):
            t = templates[i]
            rows.append(
                dict(
                    sample_id=s.sample_id,
                    barcode=s.barcode,
                    templates=int(t),
                    frac_templates=float(t / total),
                    ratio_to_mean=float(t / mean),
                    ratio_to_best=float(t / best),
                )
            )
        rows.append(
            dict(
                sample_id=unmatched_prefix,
                barcode=".",
                templates=int(unmatched),
                frac_templates=float(unmatched / total),
                ratio_to_mean=float(unmatched / mean),
                ratio_to_best=float(unmatched / best),
            )
        )
    return rows


def write_metrics(path: Path, metrics: List[dict]) -> None:
    cols = [
        "sample_id",
        "barcode",
        "templates",
        "frac_templates",
        "ratio_to_mean",
        "ratio_to_best",
    ]
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\t".join(cols) + "\n")
        for row in metrics:
            fields = [
                str(row["sample_id"]),
                str(row["barcode"]),
                str(row["templates"]),
                format_f64(row["frac_templates"]),
                format_f64(row["ratio_to_mean"]),
                format_f64(row["ratio_to_best"]),
            ]
            fh.write("\t".join(fields) + "\n")
