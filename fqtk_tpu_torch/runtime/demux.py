"""The demux pipeline with device-placed assignment in PyTorch.

Counterpart of :mod:`fqtk_tpu.runtime.demux`.  Its native engine:

1. the C++ engine (``native/fqtk_io.cpp`` through
   :mod:`fqtk_tpu_torch.io.native`) parses the FASTQs and packs each read's
   sample barcode as 2-bit codes (``[B, ceil(L/4)]`` uint8, "bit2") or, for
   a host matcher, as 4-bit masks ("nib4"),
2. each window goes to the matcher that the placement chose: a host matcher
   (``--matcher host``, the big-K pigeonhole matcher, the
   ``FQTK_HOST_MATCHER_MAX_K`` cap, or a measured placement,
   :func:`_measured_placement`), or the Hopper matcher
   (:func:`fqtk_tpu_torch.ops.hopper_matcher.make_hopper_assign_fn`), or
   for barcodes longer than 255 bp the chunked scan of
   :func:`fqtk_tpu_torch.ops.matcher.make_assign_fn`, one device call kept
   in flight while the previous window is fetched and routed; rows that
   are not pure ACGT are resolved on the host with the NumPy spec,
3. the engine routes records to per-sample BGZF writers.

The built matcher is kept per process (:data:`_ASSIGN_FN_CACHE`), the
placement decision per card on disk (:func:`_crossover_cache_path`).

Its Python-IO engine (``engine`` ``numpy``, ``jax`` or ``pallas``,
:func:`_run_demux_python`) reads and writes in Python and assigns each
batch of raw barcode bytes with the NumPy spec, the chunked scan or the
Hopper kernels' 16-class input (:func:`_make_assigner`).

The host side (validation, the host-matcher wrapper, the Python-IO loop,
metrics) is the port's own copy of ``fqtk_tpu/runtime/demux.py``'s
(``:51-265``, ``:412``, ``:1281-1511``), under the same names; nothing is
imported from that package.  ``engine="auto"`` needs the native engine and
raises where it cannot be loaded or built: unlike the JAX package, the port
never drops to the Python-IO engine on its own.
"""

from __future__ import annotations

import logging
import os
import stat
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.encoding import ENCODE_LUT, count_nocalls, decode, encode
from ..core.headers import rewrite_header
from ..core.read_structure import (
    FILE_TYPE_CODE,
    ReadStructure,
    ReadStructureError,
    SegmentType,
)
from ..core.samples import SampleGroup
from ..io import native as native_io
from ..io.fastq import BgzfWriter, FastqReader, open_reader
from ..ops import hopper_matcher as hm
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
    engine: str = "auto"  # auto | native | jax | pallas | numpy
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
    #: ``tile_top2`` or ``xla_scan``) and this run's counts: ``launches``
    #: and ``plain_calls`` over both Hopper kernels and
    #: ``<kernel>_launches`` / ``<kernel>_plain_calls`` for each; the
    #: ``xla_scan`` route runs no kernel (``launches`` and ``plain_calls``
    #: 0) and counts its ``calls``; empty when a host matcher or the NumPy
    #: spec ran
    matcher: Dict[str, Union[int, str]] = field(default_factory=dict)


class SampleWriters:
    """Per-sample writers, one per (requested output type, segment index)."""

    def __init__(
        self,
        name: str,
        output_dir: Path,
        read_structures: Sequence[ReadStructure],
        output_types: Sequence[SegmentType],
        compression_level: int,
    ):
        self.name = name
        self.writers: Dict[SegmentType, List[BgzfWriter]] = {}
        for seg_type in output_types:
            count = sum(len(rs.segments_by_type(seg_type)) for rs in read_structures)
            code = FILE_TYPE_CODE[seg_type]
            ws = [
                BgzfWriter(
                    output_dir / f"{name}.{code}{idx}.fq.gz", compression_level
                )
                for idx in range(1, count + 1)
            ]
            self.writers[seg_type] = ws

    def write(
        self,
        header: bytes,
        segs_by_type: Dict[SegmentType, List[Tuple[bytes, bytes]]],
        barcode_seqs: List[bytes],
        umi_seqs: List[bytes],
    ) -> None:
        for seg_type in _TYPE_ORDER:
            writers = self.writers.get(seg_type)
            if writers is None:
                continue
            segs = segs_by_type.get(seg_type, ())
            for read_idx, (writer, (seq, qual)) in enumerate(zip(writers, segs)):
                head = rewrite_header(header, read_idx + 1, barcode_seqs, umi_seqs)
                writer.write(head + b"\n" + seq + b"\n+\n" + qual + b"\n")

    def close(self) -> None:
        for ws in self.writers.values():
            for w in ws:
                w.close()


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
    ``SmallKMatcher``).  ``None`` when unset: the auto policy then measures
    the placement on the card (:func:`_measured_placement`; on the CPU the
    static cap of 4096 applies).  ``=0`` routes every whitelist to the
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


# --------------------------------------------------------------------------
# measured placement (``fqtk_tpu/runtime/demux.py:275-593``)
# --------------------------------------------------------------------------

#: path of the disk cache of measured placement decisions; ``None`` (the
#: default) is :func:`_crossover_cache_path`'s file under
#: ``$FQTK_CACHE_DIR``, a string overrides it
_CROSSOVER_CACHE_PATH: Optional[str] = None


def _crossover_cache_path() -> str:
    """The port's own decision file, ``crossover-torch.json`` under
    ``$FQTK_CACHE_DIR`` (default ``~/.cache/fqtk``), read when used.  The
    JAX package's ``crossover.json`` beside it is keyed by ``JAX_PLATFORMS``
    and is never read or written here.  Delete the file to re-measure, or
    set ``FQTK_MEASURE_CROSSOVER=1`` to force a fresh probe."""
    if _CROSSOVER_CACHE_PATH is not None:
        return _CROSSOVER_CACHE_PATH
    return os.path.join(
        os.path.expanduser(os.environ.get("FQTK_CACHE_DIR", "~/.cache/fqtk")),
        "crossover-torch.json",
    )


def _time_host_window(matcher, win_nib4, reps=2) -> float:
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        matcher.assign(win_nib4)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _device_floor_seconds(batch: int, width: int, device, reps=2) -> float:
    """Lower bound for ANY per-window device call at this batch on
    ``device``: copy a ``[batch, width]`` uint8 array from pageable host
    memory with ``non_blocking=True`` (the route of the matchers' own H2D
    copy, ``HopperAssignFn.__call__``), reduce it on the device and fetch
    the scalar with ``.item()``, which waits for the device."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0xF100)
    # distinct inputs per rep, as the JAX package's probe
    ins = [
        torch.from_numpy(rng.integers(0, 255, size=(batch, width), dtype=np.uint8))
        for _ in range(reps + 1)
    ]

    def call(x: torch.Tensor) -> int:
        return int(x.to(dev, non_blocking=True).sum(dtype=torch.int32).item())

    call(ins[-1])  # warm: the context, the allocator, the reduction
    best = None
    for i in range(reps):
        t0 = time.perf_counter()
        call(ins[i])
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _time_device_window(assign, windows) -> float:
    """Time the real device matcher on pre-packed windows: the last warms it
    (and builds its kernel at first use), each other call is timed to the
    end of its :meth:`_Pending.fetch`."""
    assign(windows[-1]).fetch()
    best = None
    for w in windows[:-1]:
        t0 = time.perf_counter()
        assign(w).fetch()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


#: bump when the placement-relevant selection logic changes, so stale
#: cached decisions are not reused (the port's own, independent of the JAX
#: package's ``_CROSSOVER_KEY_VERSION``)
_CROSSOVER_KEY_VERSION = 1


def _device_name(device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA ``device``, ``"cpu"`` for
    the CPU."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _crossover_cache_key(cfg: DemuxConfig, expected: ExpectedSet) -> str:
    import hashlib

    # Host-matcher timing is content-dependent (IUPAC-heavy whitelists take a
    # different SIMD path; memo-cache hit rates differ), so two whitelists of
    # identical shape must never share a placement decision: key on a digest
    # of the encoded masks, not just (K, L).  The card's name and the torch
    # version stand where the JAX package keys on JAX_PLATFORMS.
    digest = hashlib.blake2b(
        np.ascontiguousarray(expected.masks).tobytes(), digest_size=16
    ).hexdigest()
    return "|".join(
        str(x)
        for x in (
            _CROSSOVER_KEY_VERSION,
            _device_name(cfg.device),
            torch.__version__,
            expected.count,
            expected.length,
            digest,
            min(cfg.batch_size, 1 << 17),
            cfg.max_mismatches,
            cfg.min_mismatch_delta,
        )
    )


def _crossover_cache_get(key: str):
    if os.environ.get("FQTK_MEASURE_CROSSOVER") == "1":
        return None
    try:
        import json

        with open(_crossover_cache_path()) as fh:
            return json.load(fh).get(key)
    except (OSError, ValueError):
        return None


def _crossover_cache_put(key: str, entry: dict) -> None:
    path = _crossover_cache_path()
    try:
        import json

        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = {}
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            pass
        data[key] = entry
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, path)
    except OSError:
        pass


def _probe_allowed(device) -> bool:
    """Measured placement runs only where the device matcher would run on a
    card (``device`` resolves to ``cuda``).  On the CPU the "device" is the
    kernels' plain PyTorch version on the cores the native host matcher
    uses, and the static cap applies, as on the JAX package's CPU backend.
    Separated for test monkeypatching."""
    return resolve_device(device).type == "cuda"


def _measured_placement(cfg, expected, barcodes, host_builder):
    """Measure host-vs-device matcher placement at the production batch.

    Returns the chosen ``(assign, pack_mode, host_matcher)`` tuple, or
    ``None`` to let the caller fall through to the device path.  The probe
    (``fqtk_tpu.runtime.demux._measured_placement``'s):

    1. time the host ``SmallKMatcher`` on a synthetic window (distinct
       random reads: the memo cache must not turn the probe into a cache
       benchmark);
    2. time the device round-trip floor (:func:`_device_floor_seconds`): if
       the host already beats a bound no device call can beat, pick host
       without building the device matcher;
    3. otherwise build the real device matcher, time it on bit2 windows of
       the same shape (:func:`_time_device_window`), and pick the device
       only if ``device_s * 1.1 < host_s`` (10% hysteresis toward the host).

    Decisions persist in the port's disk cache (:func:`_crossover_cache_path`)
    so repeat runs skip the probe.  Where the floor cannot run (a broken
    CUDA runtime) this raises: the JAX package picks host there, the port
    does not hide the device.

    Where ``cfg.device`` is the CPU the probe is skipped and the static cap
    (4096) applies, as on the JAX package's CPU backend: the plain PyTorch
    version shares the cores with the native SIMD matcher, so an A/B there
    would compare two host paths."""
    if not _probe_allowed(cfg.device):
        if expected.count <= 4096:
            matcher = host_builder()
            if matcher is not None:
                logger.info(
                    "small-K brute-force host matcher selected (K=%d; %s "
                    "device, static crossover)",
                    expected.count,
                    cfg.device,
                )
                return _host_assign_wrapper(matcher), "nib4", True
        return None
    key = _crossover_cache_key(cfg, expected)
    cached = _crossover_cache_get(key)
    if cached is not None and cached.get("choice") == "host":
        matcher = host_builder()
        if matcher is not None:
            logger.info(
                "matcher placement (cached): host (host %.3fms vs device "
                "%.3fms per %d-read window)",
                cached.get("host_s", 0) * 1e3,
                cached.get("device_s", cached.get("floor_s", 0)) * 1e3,
                cached.get("batch", 0),
            )
            fn = _host_assign_wrapper(matcher)
            _attach_crossover(fn, cached, "host")
            return fn, "nib4", True
        return None
    if cached is not None and cached.get("choice") == "device":
        out = _build_device_side(cfg, expected)
        logger.info(
            "matcher placement (cached): device (host %.3fms vs device "
            "%.3fms per %d-read window)",
            cached.get("host_s", 0) * 1e3,
            cached.get("device_s", 0) * 1e3,
            cached.get("batch", 0),
        )
        _attach_crossover(out[0], cached, "device")
        return out

    matcher = host_builder()
    if matcher is None:
        return None  # no host side to compare: the device path decides

    batch = min(cfg.batch_size, 1 << 17)
    length = expected.length
    rng = np.random.default_rng(0xF0CC)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    obs_list = [
        letters[rng.integers(0, 4, size=(batch, length))] for _ in range(3)
    ]

    def nib4(obs):
        m = ENCODE_LUT[obs]
        if length % 2:
            m = np.concatenate(
                [m, np.ones((batch, 1), dtype=np.uint8)], axis=1
            )
        return (m[:, 0::2] | (m[:, 1::2] << 4)).astype(np.uint8)

    host_s = _time_host_window(matcher, nib4(obs_list[0]))
    entry = {"host_s": host_s, "batch": batch}
    try:
        floor_s = _device_floor_seconds(batch, (length + 3) // 4, cfg.device)
    except Exception as exc:
        raise DemuxError(
            f"matcher placement: the device round-trip probe failed on "
            f"{cfg.device!r} ({exc}); pass --matcher host to keep assignment "
            "on the host"
        ) from exc
    entry["floor_s"] = floor_s
    if host_s <= floor_s:
        logger.info(
            "matcher placement measured: host %.3fms <= device floor %.3fms "
            "per %d-read window — host matcher selected (K=%d)",
            host_s * 1e3,
            floor_s * 1e3,
            batch,
            expected.count,
        )
        entry["choice"] = "host"
        _crossover_cache_put(key, entry)
        fn = _host_assign_wrapper(matcher)
        _attach_crossover(fn, entry, "host")
        return fn, "nib4", True

    # the device floor beats the host: measure the real matcher round-trip
    assign_dev, pack_mode, host_flag = _build_device_side(cfg, expected)
    code_lut = np.zeros(256, dtype=np.uint8)
    for c, ch in zip((0, 1, 2, 3), b"ACGT"):
        code_lut[ch] = c

    def bit2(obs):
        codes = code_lut[obs]
        w = -(-length // 4) * 4
        padded = np.zeros((batch, w), dtype=np.uint8)
        padded[:, :length] = codes
        return (
            padded[:, 0::4]
            | (padded[:, 1::4] << 2)
            | (padded[:, 2::4] << 4)
            | (padded[:, 3::4] << 6)
        ).astype(np.uint8)

    pack = bit2 if pack_mode == "bit2" else nib4
    device_s = _time_device_window(assign_dev, [pack(o) for o in obs_list])
    entry["device_s"] = device_s
    choice = "device" if device_s * 1.1 < host_s else "host"
    logger.info(
        "matcher placement measured: host %.3fms vs device %.3fms (floor "
        "%.3fms) per %d-read window — %s matcher selected (K=%d)",
        host_s * 1e3,
        device_s * 1e3,
        floor_s * 1e3,
        batch,
        choice,
        expected.count,
    )
    entry["choice"] = choice
    _crossover_cache_put(key, entry)
    if choice == "host":
        fn = _host_assign_wrapper(matcher)
        _attach_crossover(fn, entry, "host")
        return fn, "nib4", True
    _attach_crossover(assign_dev, entry, "device")
    return assign_dev, pack_mode, host_flag


def _attach_crossover(fn, entry: dict, choice: str) -> None:
    """Expose the placement decision for DemuxResult.timings (floats only)."""
    info = {"crossover_device_chosen": 1.0 if choice == "device" else 0.0}
    for k in ("host_s", "floor_s", "device_s"):
        if k in entry and np.isfinite(entry[k]):
            info[f"crossover_{k}"] = float(entry[k])
    try:
        fn.crossover = info
    except AttributeError:
        pass


#: process-level memo of built matchers: repeated runs over the same
#: whitelist and parameters reuse the device table (and the host matchers'
#: tables) instead of building them again
_ASSIGN_FN_CACHE: Dict[tuple, tuple] = {}


def _make_device_assign_fn(
    cfg: DemuxConfig, expected: ExpectedSet, barcodes=None
):
    """:func:`_build_device_assign_fn` behind :data:`_ASSIGN_FN_CACHE`, an
    LRU of four entries keyed as the JAX package's, plus ``cfg.device``,
    the Hopper kernel that :func:`~fqtk_tpu_torch.ops.hopper_matcher.hopper_scheme`
    names and ``FQTK_DEVICE_DEDUP`` (policy inputs of the port's build)."""
    if barcodes is None:
        # without the whitelist identity there is no safe cache key
        return _build_device_assign_fn(cfg, expected, barcodes)
    key = (
        tuple(barcodes),
        cfg.max_mismatches,
        cfg.min_mismatch_delta,
        cfg.devices,
        cfg.engine,
        cfg.matcher,
        cfg.threads,
        cfg.batch_size,
        PALLAS_K_THRESHOLD,  # policy inputs: keep tests/monkeypatching sound
        _host_matcher_max_k(),
        cfg.device,
        hm.hopper_scheme(expected.count, expected.length)
        if expected.length <= 255
        else ScanAssignFn.scheme,
        os.environ.get("FQTK_DEVICE_DEDUP", "1") != "0",
    )
    cached = _ASSIGN_FN_CACHE.pop(key, None)
    if cached is not None:
        _ASSIGN_FN_CACHE[key] = cached  # LRU: refresh on hit
        logger.info(
            "matcher reused from this process's cache (K=%d, %s)",
            expected.count,
            "host" if cached[2] else "device",
        )
        return cached
    result = _build_device_assign_fn(cfg, expected, barcodes)
    if len(_ASSIGN_FN_CACHE) >= 4:  # bound device/table memory
        _ASSIGN_FN_CACHE.pop(next(iter(_ASSIGN_FN_CACHE)))
    _ASSIGN_FN_CACHE[key] = result
    return result


def _build_device_assign_fn(cfg: DemuxConfig, expected: ExpectedSet, barcodes):
    """Matcher for the native engine: ``(assign, pack_mode, host_matcher)``.

    The branches are those of
    ``fqtk_tpu.runtime.demux._build_device_assign_fn``: the big-K pigeonhole
    matcher, ``--matcher host``, the ``FQTK_HOST_MATCHER_MAX_K`` cap, and
    with none of them :func:`_measured_placement`; else the device path.
    :func:`run_demux` has loaded the native library, so unlike the JAX
    package's copy this never checks for it."""
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
        # No explicit cap: MEASURE the placement instead of guessing (on
        # the card; the static cap on the CPU).  The decision is
        # disk-cached per card and shape, so repeat runs skip the probe.
        out = _measured_placement(cfg, expected, barcodes, _host_small_k)
        if out is not None:
            return out

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
    bytes and >= 2x duplication.  ``FQTK_DEVICE_DEDUP=0`` disables.

    It logs the first window it shrinks in each run: ``assign.start_run()``
    re-arms the line, since a cached matcher serves many runs."""
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

    def start_run() -> None:
        nonlocal logged
        logged = False

    assign.start_run = start_run
    return assign


def _matcher_counts(fn) -> Dict[str, int]:
    """The cumulative counters of a device matcher (``HopperAssignFn`` or
    ``ScanAssignFn``); empty for none."""
    if fn is None:
        return {}
    if isinstance(fn, ScanAssignFn):
        # the route of barcodes longer than 255 bp runs no kernel
        return {"launches": 0, "plain_calls": 0, "calls": fn.calls}
    counts = {"launches": fn.launches, "plain_calls": fn.plain_calls}
    for name, kern in fn.kernels.items():
        counts[f"{name}_launches"] = kern.launches
        counts[f"{name}_plain_calls"] = kern.plain_calls
    return counts


def _run_counts(fn, before: Dict[str, int]) -> Dict[str, Union[int, str]]:
    """``DemuxResult.matcher`` of one run: ``fn``'s route and its counters
    less ``before``, their values when the run started (a cached matcher
    carries the counts of earlier runs); empty for no device matcher."""
    if fn is None:
        return {}
    stats: Dict[str, Union[int, str]] = {"scheme": fn.scheme}
    for name, value in _matcher_counts(fn).items():
        stats[name] = value - before.get(name, 0)
    return stats


#: ``DemuxConfig.engine`` values: ``auto`` / ``native`` run the native
#: engine, the others the Python-IO engine with their matcher
ENGINES = ("auto", "native", "jax", "pallas", "numpy")


def _make_assigner(cfg: DemuxConfig, expected: ExpectedSet, engine_override=None):
    """Return the Python-IO engine's ``obs[B, L] uint8 -> assigned[B]``
    callable (``assigned == K`` denotes unmatched), on ``cfg.device``:

    - ``jax`` (and ``auto`` / ``native``, as in the JAX package): the
      chunked scan :func:`~fqtk_tpu_torch.ops.matcher.make_assign_fn` on raw
      bytes, the counterpart of the JAX package's XLA scan (float32
      ``torch.matmul`` per K chunk; no Pallas kernel runs there);
    - ``pallas``: the Hopper kernels' 16-class input,
      ``make_hopper_assign_fn(packed2=False)`` (``colmerge_top2``, or
      ``tile_top2`` above 4,194,304 barcodes; on ``device="cpu"`` their
      plain version, where the JAX package runs Pallas in interpret mode);
      barcodes longer than 255 bp are refused as ``make_pallas_assign_fn``
      refuses them;
    - ``numpy``: the NumPy spec ``assign_batch_np``.

    A device matcher's result is fetched with ``.cpu()`` and copied by
    ``np.array`` into memory of its own: callers overwrite rows, and on the
    CPU ``.numpy()`` alone would share the tensor's.  ``assign.device_matcher``
    is the device matcher (none for the spec)."""
    engine = engine_override or cfg.engine
    if engine in ("auto", "native"):
        engine = "jax"
    if engine in ("jax", "pallas"):
        if engine == "pallas":
            # the plan's refusal of L > 255 (pallas_matcher.py:144), in its words
            hm.hopper_scheme(expected.count, expected.length)
            fn = make_hopper_assign_fn(
                expected,
                cfg.max_mismatches,
                cfg.min_mismatch_delta,
                device=cfg.device,
                packed2=False,
                compact_output=False,
            )
        else:
            fn = make_assign_fn(
                expected, cfg.max_mismatches, cfg.min_mismatch_delta, device=cfg.device
            )

        def assign(obs: np.ndarray) -> np.ndarray:
            idx, _, _ = fn(obs)
            return np.array(idx.cpu().numpy())

        assign.device_matcher = fn
        return assign

    def assign_np(obs: np.ndarray) -> np.ndarray:
        idx, _, _ = assign_batch_np(
            obs, expected, cfg.max_mismatches, cfg.min_mismatch_delta
        )
        return np.where(idx < 0, expected.count, idx).astype(np.int32)

    return assign_np


def _resolve_engine(engine: str) -> str:
    """``auto`` -> ``native`` (C++ I/O + the placed matcher).  The JAX
    package's ``auto`` drops to its Python-IO engine where the native
    library is unavailable; the port's does not (:func:`run_demux`)."""
    if engine not in ENGINES:
        raise DemuxError(f"engine must be one of {', '.join(ENGINES)}, got {engine!r}")
    return "native" if engine == "auto" else engine


def run_demux(cfg: DemuxConfig) -> DemuxResult:
    """Demultiplex with assignment on ``cfg.device`` (checked by
    ``resolve_device`` for every engine: ``cuda`` without a card raises).

    ``auto`` and ``native`` run the native engine: ``ensure_native_engine``
    loads or builds it and raises where it cannot, so ``auto`` never drops
    to the Python-IO engine quietly, as the JAX package's does.
    ``numpy``, ``jax`` and ``pallas`` run the Python-IO engine
    (:func:`_run_demux_python`) with :func:`_make_assigner`'s matcher."""
    engine = _resolve_engine(cfg.engine)
    resolve_device(cfg.device)
    if engine == "native":
        ensure_native_engine()
        return _run_demux_native(cfg)
    return _run_demux_python(cfg, engine)


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
    assign, pack_mode, host_matcher = _make_device_assign_fn(
        cfg, expected, barcodes=[s.barcode for s in sample_group.samples]
    )
    device_matcher = getattr(assign, "device_matcher", None)
    counts_before = _matcher_counts(device_matcher)
    getattr(assign, "start_run", lambda: None)()

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

    matcher_stats = _run_counts(device_matcher, counts_before)
    _log_counts(matcher_stats)

    metrics = compute_metrics(sample_group, counts, cfg.unmatched_prefix)
    write_metrics(output / "demux-metrics.txt", metrics)
    return DemuxResult(
        metrics=metrics,
        skip_counts=skip_counts,
        total_templates=int(counts.sum()),
        timings={
            **timers.summary(),
            **native_stats,
            "pipeline": pipeline_s,
            # the measured placement decision, when the auto policy probed
            # one (see _measured_placement)
            **getattr(assign, "crossover", {}),
        },
        matcher=matcher_stats,
    )


def _log_counts(stats: Dict[str, Union[int, str]]) -> None:
    """Log one run's device-matcher counts (:func:`_run_counts`)."""
    if not stats:
        return
    scheme = stats["scheme"]
    if "calls" in stats:
        logger.info("device matcher %s: %d calls, no kernel", scheme, stats["calls"])
    else:
        logger.info(
            "device matcher %s: %d kernel launches, %d plain-version calls",
            scheme,
            stats[f"{scheme}_launches"],
            stats[f"{scheme}_plain_calls"],
        )


def _run_demux_python(cfg: DemuxConfig, engine: str) -> DemuxResult:
    """The Python-IO engine: ``fqtk_tpu.runtime.demux._run_demux_python``
    line for line (the same gates in the same order, the same error texts),
    with :func:`_make_assigner`'s matcher.  ``DemuxResult.matcher`` holds
    the device matcher's counts of this run (empty for ``numpy``)."""
    output, output_types = validate_and_prepare(cfg)
    skip_too_few = _too_few_bases_allowed(cfg)

    sample_group = SampleGroup.from_file(cfg.sample_metadata)
    logger.info(
        "%d samples loaded from file %s", len(sample_group.samples), cfg.sample_metadata
    )

    structures = [ReadStructure.from_str(s) for s in cfg.read_structures]
    min_lens = [rs.min_length() for rs in structures]

    expected = ExpectedSet.from_barcodes([s.barcode for s in sample_group.samples])
    bc_len = expected.length
    k = expected.count
    nocall_budget = cfg.max_mismatches + expected.max_ns_in_barcodes
    assign = _make_assigner(cfg, expected, engine_override=engine)
    device_matcher = getattr(assign, "device_matcher", None)

    readers = [
        FastqReader(open_reader(p), str(p)) for p in cfg.inputs
    ]

    writer_sets = [
        SampleWriters(s.sample_id, output, structures, output_types, cfg.compression_level)
        for s in sample_group.samples
    ]
    writer_sets.append(
        SampleWriters(
            cfg.unmatched_prefix, output, structures, output_types, cfg.compression_level
        )
    )
    logger.info("Created sample and %s writers.", cfg.unmatched_prefix)

    counts = np.zeros(k + 1, dtype=np.int64)
    skip_counts: Dict[str, int] = {}
    total = 0
    batch_size = cfg.batch_size

    # batch buffers
    headers: List[bytes] = []
    seg_lists: List[list] = []  # per template: [(kind, seq, qual), ...]
    barcodes: List[bytes] = []

    def flush_batch() -> None:
        nonlocal total
        b = len(headers)
        if b == 0:
            return
        obs = np.full((batch_size, bc_len), ord("A"), dtype=np.uint8)
        override = {}  # row -> forced index (K = unmatched)
        for row, bc in enumerate(barcodes):
            if len(bc) == bc_len:
                obs[row] = np.frombuffer(bc, dtype=np.uint8)
            elif len(bc) < bc_len:
                override[row] = k  # reference: assign() -> None (demux len gate)
            else:
                # reference order: no-call gate fires before the length panic
                # (barcode_matching.rs:165-186)
                if count_nocalls(bc) > nocall_budget:
                    override[row] = k
                else:
                    s0 = sample_group.samples[0]
                    obs_str = decode(encode(bc))
                    raise DemuxError(
                        f"Read barcode ({obs_str}) length ({len(bc)}) differs from "
                        f"expected barcode ({s0.barcode.upper()}) length ({bc_len}) "
                        f"for sample {s0.sample_id}"
                    )
        assigned = assign(obs)[:b]
        for row, forced in override.items():
            if row < b:
                assigned[row] = forced
        counts[: k + 1] += np.bincount(assigned, minlength=k + 1)

        for row in range(b):
            idx = int(assigned[row])
            segs = seg_lists[row]
            segs_by_type: Dict[SegmentType, List[Tuple[bytes, bytes]]] = {}
            bc_seqs: List[bytes] = []
            umi_seqs: List[bytes] = []
            for kind, seq, qual in segs:
                segs_by_type.setdefault(kind, []).append((seq, qual))
                if kind == SegmentType.SampleBarcode:
                    bc_seqs.append(seq)
                elif kind == SegmentType.MolecularBarcode:
                    umi_seqs.append(seq)
            writer_sets[idx].write(headers[row], segs_by_type, bc_seqs, umi_seqs)
            total += 1
            if total % 1_000_000 == 0:
                logger.info("fqtk: %s records demultiplexed", f"{total:,}")
        headers.clear()
        seg_lists.clear()
        barcodes.clear()

    while True:
        # positional read: EOF'd inputs keep a None placeholder so each record
        # pairs with its OWN read structure (the reference's gate runs inside
        # each per-file ReadSetIterator, demux.rs:298-314)
        all_recs = [next(r, None) for r in readers]
        recs = [rec for rec in all_recs if rec is not None]

        # per-input min-length gate against that input's structure
        skip_template = False
        for rec, rs, min_len in zip(all_recs, structures, min_lens):
            if rec is None:
                continue
            if len(rec.seq) < min_len:
                if skip_too_few:
                    skip_template = True
                else:
                    raise DemuxError(
                        f"Read {rec.head.decode('utf-8', 'replace')} had too few bases "
                        f"to demux {len(rec.seq)} vs. {min_len} needed in read "
                        f"structure {rs}."
                    )
        # reference order: skip-reason check precedes both the EOF break and
        # the sync assert (demux.rs:954-966)
        if skip_template:
            skip_counts["TooFewBases"] = skip_counts.get("TooFewBases", 0) + 1
            continue
        if not recs:
            break
        if len(recs) != len(readers):
            raise DemuxError(
                f"FASTQ sources out of sync at records: {[r.head for r in recs]}"
            )

        segs: list = []
        bc_parts: List[bytes] = []
        for rec, rs in zip(recs, structures):
            for seg_index, seg in enumerate(rs):
                try:
                    seq, qual = seg.extract_bases_and_quals(rec.seq, rec.qual)
                except ReadStructureError as e:
                    raise DemuxError(
                        f"Error extracting bases (len: {len(rec.seq)}) or quals "
                        f"(len: {len(rec.qual)}) for the {seg_index}th read segment "
                        f"({seg}) in read structure ({rs}) from FASTQ record with "
                        f"name {rec.head.decode('utf-8', 'replace')}; {e}"
                    ) from None
                segs.append((seg.kind, seq, qual))
                if seg.kind == SegmentType.SampleBarcode:
                    bc_parts.append(seq)

        headers.append(recs[0].head)
        seg_lists.append(segs)
        barcodes.append(b"".join(bc_parts))
        if len(headers) >= batch_size:
            flush_batch()

    flush_batch()

    logger.info("Finished reading input FASTQs.")
    for ws in writer_sets:
        ws.close()
    for r in readers:
        r.close()
    logger.info("Output FASTQ writing complete.")

    if not skip_counts:
        logger.info("No records were skipped.")
    else:
        for reason, count in sorted(skip_counts.items(), key=lambda kv: kv[1]):
            logger.info("%d records were skipped due to Too few bases", count)

    metrics = compute_metrics(sample_group, counts, cfg.unmatched_prefix)
    write_metrics(output / "demux-metrics.txt", metrics)
    matcher_stats = _run_counts(device_matcher, {})
    _log_counts(matcher_stats)
    return DemuxResult(
        metrics=metrics,
        skip_counts=skip_counts,
        total_templates=int(counts.sum()),
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
