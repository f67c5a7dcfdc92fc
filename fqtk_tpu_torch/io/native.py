"""ctypes bindings for the native host-I/O engine (``native/fqtk_io.cpp``).

The port's own copy of ``fqtk_tpu/io/native.py`` (host code, no device library):
the two packages share no Python module.

The native engine owns the demux host pipeline: FASTQ parsing (gzip-aware,
zero-copy into batch arenas), segment extraction, header rewriting, and
routed BGZF output with a compressor thread pool — run as a persistent
in-engine pipeline (``pipe_start``/``pipe_acquire``/``pipe_submit``/
``pipe_finish``).  Python's only per-window work is the matcher call
between acquire and submit.

Falls back gracefully (``available() -> False``) when the shared library is
missing; the pure-Python path in :mod:`fqtk_tpu_torch.io.fastq` is the behavioral
reference and the two must produce identical decompressed bytes.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / "libfqtk_io.so"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

#: exports added after the first engine builds, with what is lost when a
#: stale ``.so`` lacks them.  Binding skips a missing one and the loader
#: names it in a warning; the caller that needs it raises
#: :class:`NativeDemuxError` with the symbol's name (:func:`_require`).
#: Every other export is required: a library without one does not load.
OPTIONAL_EXPORTS = {
    "fqtk_demux_pipe_fuse_host_matcher": "fused host-matcher pipeline",
    "fqtk_demux_pipe_fused_poll": "fused host-matcher pipeline",
    "fqtk_demux_refproxy_run": "reference-architecture baseline proxy",
    "fqtk_smallk_new": "small-K host matcher",
    "fqtk_smallk_assign": "small-K host matcher",
    "fqtk_smallk_free": "small-K host matcher",
    "fqtk_simd_level": "SIMD dispatch level query",
    "fqtk_inflate_bench": "inflate calibration",
    "fqtk_subsample_stats": "subsample stage times",
    "fqtk_rng_new": "native ChaCha8 keep mask",
    "fqtk_rng_keep_mask": "native ChaCha8 keep mask",
    "fqtk_rng_free": "native ChaCha8 keep mask",
}
_missing_optional: List[str] = []


class _Unbound:
    """Stands in for a missing optional export while ``_bind`` declares its
    types (attribute writes go nowhere)."""


class _Binder:
    """View of a freshly loaded library for :func:`_bind`: an export that
    is missing and optional is recorded in ``missing`` and skipped; a
    missing required one raises ``AttributeError`` naming it."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        self.missing: List[str] = []

    def __getattr__(self, name: str):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            if name not in OPTIONAL_EXPORTS:
                raise AttributeError(
                    f"native library lacks the required export {name}"
                ) from None
            if name not in self.missing:
                self.missing.append(name)
            return _Unbound()


def missing_optional() -> List[str]:
    """Optional exports the loaded library lacks (empty before a load)."""
    return list(_missing_optional)


def _require(lib: ctypes.CDLL, name: str):
    """Export ``name`` of the loaded library, or :class:`NativeDemuxError`
    naming it (a stale ``.so``: rebuild with ``make -C native``)."""
    if name in _missing_optional or not hasattr(lib, name):
        raise NativeDemuxError(
            f"the loaded native library lacks the export {name} "
            f"({OPTIONAL_EXPORTS.get(name, 'required')}); it predates "
            "native/fqtk_io.cpp: rebuild it with `make -C native`"
        )
    return getattr(lib, name)


def _load(path: str) -> Optional[ctypes.CDLL]:
    """dlopen ``path`` and bind it; ``None`` (with the reason logged) when it
    does not load or lacks a required export."""
    import logging

    log = logging.getLogger("fqtk")
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    binder = _Binder(lib)
    try:
        _bind(binder)
    except AttributeError as e:
        log.error("%s: %s; the native engine is disabled", path, e)
        return None
    _missing_optional[:] = binder.missing
    if binder.missing:
        log.warning(
            "%s is stale: missing optional export(s) %s (%s); the paths that "
            "need them raise (stage times are left out), everything else runs (rebuild with `make -C "
            "native`)",
            path,
            ", ".join(binder.missing),
            ", ".join(sorted({OPTIONAL_EXPORTS[n] for n in binder.missing})),
        )
    return lib


def _try_build() -> None:
    makefile = _LIB_PATH.parent / "Makefile"
    if makefile.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_LIB_PATH.parent)],
                capture_output=True,
                timeout=120,
                check=False,
            )
        except Exception:
            pass


def _is_stale() -> bool:
    """True when a source edit postdates the committed .so (would otherwise
    silently load a build diverging from ``native/fqtk_io.cpp``)."""
    src = _LIB_PATH.parent / "fqtk_io.cpp"
    try:
        return src.stat().st_mtime > _LIB_PATH.stat().st_mtime
    except OSError:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    import os

    override = os.environ.get("FQTK_NATIVE_LIB")
    if override:
        # Sanitizer harness hook (scripts/sanitize.sh): load an instrumented
        # build instead of the production .so; same C API.
        _lib = _load(override)
        _load_failed = _lib is None
        return _lib
    if not _LIB_PATH.exists() or _is_stale():
        _try_build()
        if _LIB_PATH.exists() and _is_stale():
            import logging

            logging.getLogger("fqtk").warning(
                "native/fqtk_io.cpp is newer than libfqtk_io.so and the "
                "rebuild failed; loading the STALE binary (run `make -C "
                "native` to see the build error)"
            )
    if not _LIB_PATH.exists():
        _load_failed = True
        return None
    _lib = _load(str(_LIB_PATH))
    _load_failed = _lib is None
    return _lib


def _bind(lib) -> None:
    """Declare the C API's restype/argtypes on a freshly-loaded handle (a
    :class:`_Binder` view: missing optional exports are skipped)."""
    lib.fqtk_demux_new.restype = ctypes.c_void_p
    lib.fqtk_demux_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fqtk_demux_add_input.restype = ctypes.c_int
    lib.fqtk_demux_add_input.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fqtk_demux_add_sample_writer.restype = ctypes.c_int
    lib.fqtk_demux_add_sample_writer.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fqtk_demux_end_sample.argtypes = [ctypes.c_void_p]
    lib.fqtk_demux_configure.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.fqtk_demux_pipe_start.restype = ctypes.c_int
    lib.fqtk_demux_pipe_start.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.fqtk_demux_pipe_acquire.restype = ctypes.c_int64
    lib.fqtk_demux_pipe_acquire.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fqtk_demux_pipe_submit.restype = ctypes.c_int
    lib.fqtk_demux_pipe_submit.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.fqtk_demux_pipe_finish.restype = ctypes.c_int
    lib.fqtk_demux_pipe_finish.argtypes = [ctypes.c_void_p]
    lib.fqtk_demux_pipe_fuse_host_matcher.restype = ctypes.c_int
    lib.fqtk_demux_pipe_fuse_host_matcher.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.fqtk_demux_pipe_fused_poll.restype = ctypes.c_int
    lib.fqtk_demux_pipe_fused_poll.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fqtk_demux_pipe_exceptional.restype = ctypes.c_int64
    lib.fqtk_demux_pipe_exceptional.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.fqtk_demux_counts.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.fqtk_demux_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    lib.fqtk_demux_refproxy_run.restype = ctypes.c_int64
    lib.fqtk_demux_refproxy_run.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.fqtk_bigk_new.restype = ctypes.c_void_p
    lib.fqtk_bigk_new.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.fqtk_bigk_assign.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.fqtk_bigk_free.argtypes = [ctypes.c_void_p]
    lib.fqtk_smallk_new.restype = ctypes.c_void_p
    lib.fqtk_smallk_new.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.fqtk_smallk_assign.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.fqtk_smallk_free.argtypes = [ctypes.c_void_p]
    lib.fqtk_simd_level.restype = ctypes.c_int
    lib.fqtk_simd_level.argtypes = []
    lib.fqtk_inflate_bench.restype = ctypes.c_int64
    lib.fqtk_inflate_bench.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fqtk_demux_error.restype = ctypes.c_char_p
    lib.fqtk_demux_error.argtypes = [ctypes.c_void_p]
    lib.fqtk_demux_free.argtypes = [ctypes.c_void_p]

    lib.fqtk_subsample_new.restype = ctypes.c_void_p
    lib.fqtk_subsample_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fqtk_subsample_add_input.restype = ctypes.c_int
    lib.fqtk_subsample_add_input.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.fqtk_subsample_configure.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.fqtk_subsample_chunk.restype = ctypes.c_int64
    lib.fqtk_subsample_chunk.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fqtk_subsample_finish.restype = ctypes.c_int
    lib.fqtk_subsample_finish.argtypes = [ctypes.c_void_p]
    lib.fqtk_subsample_error.restype = ctypes.c_char_p
    lib.fqtk_subsample_error.argtypes = [ctypes.c_void_p]
    lib.fqtk_subsample_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    # stateful ChaCha8 keep-mask generator (subsample mask producer)
    lib.fqtk_rng_new.restype = ctypes.c_void_p
    lib.fqtk_rng_new.argtypes = [ctypes.c_uint64]
    lib.fqtk_rng_keep_mask.argtypes = [
        ctypes.c_void_p,
        ctypes.c_double,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fqtk_rng_free.argtypes = [ctypes.c_void_p]
    lib.fqtk_subsample_free.argtypes = [ctypes.c_void_p]

    lib.fqtk_bgzf_open.restype = ctypes.c_void_p
    lib.fqtk_bgzf_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.fqtk_bgzf_write.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.fqtk_bgzf_close.restype = ctypes.c_int
    lib.fqtk_bgzf_close.argtypes = [ctypes.c_void_p]


def available() -> bool:
    return get_lib() is not None


def inflate_bench(path) -> tuple:
    """Stream `path` to EOF on this thread through the engine's production
    decompressor, discarding output.  Returns ``(decompressed_bytes,
    thread_cpu_seconds, kind)`` with kind in {"plain", "gzip",
    "gzip-multimember", "bgzf"}.  bench.py's calibration for the
    serial-inflate bound: a SINGLE-member gzip stream cannot be inflated
    in parallel by ANY implementation (each deflate block's dictionary is
    the previous output), so the slowest such input's inflate CPU caps e2e
    throughput.  Multi-member/BGZF inputs are block-parallel decodable in
    principle, so no serial bound is claimed for them."""
    lib = get_lib()
    if lib is None:
        raise NativeDemuxError("native library unavailable")
    cpu = ctypes.c_double(0.0)
    kind = ctypes.c_int(0)
    n = _require(lib, "fqtk_inflate_bench")(
        str(path).encode(), ctypes.byref(cpu), ctypes.byref(kind)
    )
    if n < 0:
        raise NativeDemuxError(f"inflate_bench failed for {path}")
    kinds = {0: "plain", 1: "gzip", 2: "gzip-multimember", 3: "bgzf"}
    return int(n), float(cpu.value), kinds.get(kind.value, "unknown")


def simd_level() -> int:
    """Resolved candidate-scan dispatch level (0=scalar, 1=avx2, 2=avx512):
    min(FQTK_SIMD cap, CPU capability), read fresh from the environment."""
    lib = get_lib()
    if lib is None:
        raise NativeDemuxError("native library unavailable")
    return int(_require(lib, "fqtk_simd_level")())


class NativeDemuxError(RuntimeError):
    pass


class NativeDemuxEngine:
    """Thin wrapper over the C engine; one instance per demux run."""

    def __init__(self, threads: int, compression_level: int):
        lib = get_lib()
        if lib is None:
            raise NativeDemuxError("native library unavailable")
        self._lib = lib
        self._h = lib.fqtk_demux_new(threads, compression_level)
        self._finished = False

    def _check(self, rc) -> None:
        if rc < 0:
            msg = self._lib.fqtk_demux_error(self._h).decode("utf-8", "replace")
            raise NativeDemuxError(msg or "native demux error")

    def add_input(
        self,
        path: str,
        structure_str: str,
        segments: Sequence[Tuple[int, Optional[int], str]],
    ) -> None:
        n = len(segments)
        offs = (ctypes.c_int32 * n)(*[s[0] for s in segments])
        lens = (ctypes.c_int32 * n)(
            *[-1 if s[1] is None else s[1] for s in segments]
        )
        kinds = "".join(s[2] for s in segments).encode()
        self._check(
            self._lib.fqtk_demux_add_input(
                self._h, str(path).encode(), structure_str.encode(), offs, lens, kinds, n
            )
        )

    def add_sample(self, writer_paths: List[str]) -> None:
        for p in writer_paths:
            self._check(
                self._lib.fqtk_demux_add_sample_writer(self._h, str(p).encode())
            )
        self._lib.fqtk_demux_end_sample(self._h)

    def configure(
        self,
        bc_len: int,
        nocall_budget: int,
        skip_too_few: bool,
        first_sample_id: str,
        first_barcode: str,
        out_types: str,
        pack_masks: bool = False,
        pack_mode: Optional[int] = None,
    ) -> None:
        """``pack_mode``: 0 raw bytes, 1 4-bit IUPAC nibbles, 2 2-bit ACGT
        codes (ambiguous rows flagged exceptional); ``pack_masks=True`` is
        shorthand for mode 1."""
        if pack_mode is None:
            pack_mode = 1 if pack_masks else 0
        self._bc_len = bc_len
        self._lib.fqtk_demux_configure(
            self._h,
            bc_len,
            nocall_budget,
            1 if skip_too_few else 0,
            first_sample_id.encode(),
            first_barcode.encode(),
            out_types.encode(),
            len(out_types),
            pack_mode,
        )

    def pipe_start(
        self, batch: int, row_stride: int, ramp: bool = False
    ) -> None:
        """Start the fully-native pipeline: persistent parse threads + route
        thread inside the engine.  ``row_stride`` is the packed barcode row
        width so acquire() can shape its zero-copy view.  ``ramp`` makes the
        first three windows fractional (1/8, 1/4, 1/2) so the route and
        compressor stages start within milliseconds — use for host-matcher
        runs only (device matchers compile per window shape)."""
        self._pipe_batch = batch
        self._row_stride = row_stride
        self._check(
            self._lib.fqtk_demux_pipe_start(self._h, batch, 1 if ramp else 0)
        )

    def pipe_fuse_host_matcher(self, matcher) -> bool:
        """Fuse a host matcher (NativeSmallKMatcher / NativeBigKMatcher)
        into the engine: a dedicated engine thread assigns each gated
        window between gate_pack and route, and the Python loop only
        polls progress (``pipe_fused_poll``) — no per-window acquire/
        submit round trips.  Must be called before ``pipe_start``; the
        caller must keep ``matcher`` alive until the engine is closed."""
        kind = 1 if isinstance(matcher, NativeBigKMatcher) else 0
        _require(self._lib, "fqtk_demux_pipe_fused_poll")
        return bool(
            _require(self._lib, "fqtk_demux_pipe_fuse_host_matcher")(
                self._h, matcher._h, kind, matcher._threads
            )
        )

    def pipe_fused_poll(self, timeout_ms: int = 50) -> Tuple[int, int, int]:
        """Wait up to ``timeout_ms`` for fused-pipeline progress.  Returns
        ``(state, total_templates, total_skipped)`` with state 1 = drained,
        0 = still running, -1 = error (raise via pipe_finish)."""
        total = ctypes.c_int64(0)
        skipped = ctypes.c_int64(0)
        state = self._lib.fqtk_demux_pipe_fused_poll(
            self._h, timeout_ms, ctypes.byref(total), ctypes.byref(skipped)
        )
        return int(state), int(total.value), int(skipped.value)

    def pipe_acquire(self) -> Tuple[int, int, Optional[np.ndarray], int]:
        """Block (GIL released) until a parsed window is ready.

        Returns ``(n, slot, bc_view, skipped)``; ``n == 0`` means EOF.
        ``bc_view`` is a zero-copy [batch, row_stride] uint8 view of engine
        memory, valid until ``pipe_submit(slot, ...)``."""
        slot = ctypes.c_int32(-1)
        bc = ctypes.POINTER(ctypes.c_uint8)()
        skipped = ctypes.c_int64(0)
        n = self._lib.fqtk_demux_pipe_acquire(
            self._h, ctypes.byref(slot), ctypes.byref(bc), ctypes.byref(skipped)
        )
        self._check(n)
        if n == 0:
            return 0, -1, None, int(skipped.value)
        view = np.ctypeslib.as_array(bc, shape=(self._pipe_batch, self._row_stride))
        return int(n), int(slot.value), view, int(skipped.value)

    def pipe_exceptional(self, slot: int):
        """Rows of an acquired 2-bit-mode window that need host-side
        resolution: returns (row_indices[int32], raw_bytes[n, bc_len]) or
        (None, None) when the window had none."""
        rows = ctypes.POINTER(ctypes.c_int32)()
        raw = ctypes.POINTER(ctypes.c_uint8)()
        n = int(
            self._lib.fqtk_demux_pipe_exceptional(
                self._h, slot, ctypes.byref(rows), ctypes.byref(raw)
            )
        )
        if n == 0:
            return None, None
        idx = np.ctypeslib.as_array(rows, shape=(n,))
        raw_arr = np.ctypeslib.as_array(raw, shape=(n, self._bc_len))
        return idx, raw_arr

    def pipe_submit(self, slot: int, assigned: np.ndarray) -> None:
        """Hand device assignments for an acquired window to the native
        route thread (non-blocking)."""
        assigned = np.ascontiguousarray(assigned, dtype=np.int32)
        self._check(
            self._lib.fqtk_demux_pipe_submit(
                self._h,
                slot,
                assigned.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                assigned.shape[0],
            )
        )

    def pipe_finish(self) -> None:
        """Drain routing, close writers and the compressor pool."""
        if not self._finished:
            self._finished = True
            self._check(self._lib.fqtk_demux_pipe_finish(self._h))

    def refproxy_run(self, barcodes, max_mismatches: int, min_delta: int) -> int:
        """Run the reference-architecture baseline proxy (host-only scalar
        matcher, single main thread) to completion.  Measurement mode only —
        see scripts/measure_baseline.py."""
        self._finished = True  # refproxy closes writers itself
        k = len(barcodes)
        concat = "".join(b.upper() for b in barcodes).encode()
        buf = (ctypes.c_uint8 * len(concat)).from_buffer_copy(concat)
        n = _require(self._lib, "fqtk_demux_refproxy_run")(
            self._h, buf, k, max_mismatches, min_delta
        )
        self._check(n)
        return int(n)

    def counts(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.int64)
        self._lib.fqtk_demux_counts(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n
        )
        return out

    def stats(self) -> dict:
        out = (ctypes.c_double * 10)()
        self._lib.fqtk_demux_stats(self._h, out, 10)
        return {
            "native_parse": out[0],
            "native_gate_pack": out[1],
            "native_route": out[2],
            "native_compress": out[3],
            "native_compress_in_bytes": out[4],
            "native_compress_out_bytes": out[5],
            # wall-clock stalls (not CPU): parse threads waiting for a free
            # window slot (downstream backpressure) / route thread waiting
            # for an assigned window (upstream starvation).  With
            # stall-assist (default on) stalled threads run compress jobs,
            # so stall wall-time overlaps donated compression.
            "native_parse_stall": out[6],
            "native_route_stall": out[7],
            # subset of native_compress CPU donated by stalled/stolen
            # pipeline threads (stall-assist + queue-full steals)
            "native_donated_compress": out[8],
            # fused host-matcher CPU on the engine assign thread (real
            # matcher work — deliberately NOT part of the assign-free IO
            # ceiling keys)
            "native_host_assign": out[9],
        }

    def close(self) -> None:
        if self._h:
            self._lib.fqtk_demux_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeSubsampleEngine:
    """Lockstep subsample: Python supplies the ChaCha8 keep mask in chunks,
    C++ reads record sets and writes kept records verbatim."""

    def __init__(self, threads: int, compression_level: int):
        lib = get_lib()
        if lib is None:
            raise NativeDemuxError("native library unavailable")
        self._lib = lib
        self._h = lib.fqtk_subsample_new(threads, compression_level)

    def _check(self, rc) -> None:
        if rc < 0:
            msg = self._lib.fqtk_subsample_error(self._h).decode("utf-8", "replace")
            raise NativeDemuxError(msg or "native subsample error")

    def add_input(self, in_path, out_path) -> None:
        self._check(
            self._lib.fqtk_subsample_add_input(
                self._h, str(in_path).encode(), str(out_path).encode()
            )
        )

    def configure(self, check_names: bool, parallel: bool = True) -> None:
        """``parallel``: one reader thread per input in ``process_chunk``
        (multi-input runs); ``False`` forces the reference-architecture
        serial lockstep loop (bench.py's measured proxy)."""
        self._lib.fqtk_subsample_configure(
            self._h, 1 if check_names else 0, 1 if parallel else 0
        )

    def process_chunk(self, keep_mask: np.ndarray) -> Tuple[int, int]:
        """Returns (consumed, kept); consumed < len(mask) means EOF."""
        keep_mask = np.ascontiguousarray(keep_mask, dtype=np.uint8)
        kept = ctypes.c_int64(0)
        n = self._lib.fqtk_subsample_chunk(
            self._h,
            keep_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            keep_mask.shape[0],
            ctypes.byref(kept),
        )
        self._check(n)
        return int(n), int(kept.value)

    def finish(self) -> None:
        self._check(self._lib.fqtk_subsample_finish(self._h))

    def stats(self) -> dict:
        """Per-stage thread-CPU accounting for host-ceiling math (the
        subsample analog of the demux engine's stage stats)."""
        if "fqtk_subsample_stats" in _missing_optional:
            return {}  # a stale library: the loader's warning named it
        buf = (ctypes.c_double * 5)()
        self._lib.fqtk_subsample_stats(self._h, buf, 5)
        return {
            "native_work": buf[0],  # inflate+scan+name-check+record-copy CPU
            "native_compress": buf[1],  # BGZF pool busy thread-CPU
            "native_compress_in_bytes": buf[2],
            "native_compress_out_bytes": buf[3],
            # core-s finished readers waited at the per-chunk barrier for
            # the slowest input (lockstep skew; see DESIGN.md r5 subsample)
            "native_lockstep_skew": buf[4],
        }

    def close(self) -> None:
        if self._h:
            self._lib.fqtk_subsample_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeChaChaMask:
    """Stateful ChaCha8 keep-mask stream, bit-identical to
    ``fqtk_tpu_torch.utils.chacha.ChaCha8Rng`` driven as
    ``(rng.random_f64_batch(n) < fraction)`` (see ``fqtk_rng_keep_mask``
    in ``native/fqtk_io.cpp``).  Used by the subsample mask producer so
    drawing the mask costs ~13ns/record instead of ~50 and stops competing
    with the compressor pool for cores.  Raises ``NativeDemuxError`` when
    the loaded .so predates the export (callers fall back to the NumPy
    rng)."""

    def __init__(self, seed: int):
        lib = get_lib()
        if lib is None:
            raise NativeDemuxError("native rng unavailable")
        for name in ("fqtk_rng_keep_mask", "fqtk_rng_free"):
            _require(lib, name)
        self._lib = lib
        self._h = _require(lib, "fqtk_rng_new")(ctypes.c_uint64(seed & (2**64 - 1)))

    def keep_mask(self, n: int, fraction: float) -> np.ndarray:
        """Next ``n`` keep decisions (uint8 0/1), advancing the stream."""
        out = np.empty(n, dtype=np.uint8)
        self._lib.fqtk_rng_keep_mask(
            self._h,
            ctypes.c_double(fraction),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out

    def close(self) -> None:
        if self._h:
            self._lib.fqtk_rng_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeBigKMatcher:
    """Pigeonhole exact-candidate matcher for huge whitelists (see
    ``BigKMatcher`` in ``native/fqtk_io.cpp``).  Pure-ACGT whitelists take
    fused SIMD bucket scans; whitelists with degenerate IUPAC codes build
    expanded tables (every accepted part key) and score with 4-bit-mask
    containment.  Input is the packed 4-bit-mask layout the demux pipeline
    already produces."""

    def __init__(self, barcodes, max_mismatches: int, min_delta: int,
                 threads: int = 4):
        lib = get_lib()
        if lib is None:
            raise NativeDemuxError("native library unavailable")
        self._lib = lib
        self._threads = threads
        if not barcodes:
            raise NativeDemuxError("Must provide at least one sample")
        self.length = len(barcodes[0])
        if any(len(b) != self.length for b in barcodes):
            # len(barcodes[0]) frames every row of the concatenated buffer;
            # unequal lengths would silently mis-frame the whole whitelist
            raise NativeDemuxError("All barcodes must have the same length")
        concat = "".join(b.upper() for b in barcodes).encode()
        buf = (ctypes.c_uint8 * len(concat)).from_buffer_copy(concat)
        self._h = lib.fqtk_bigk_new(
            buf, len(barcodes), self.length, max_mismatches, min_delta
        )
        if not self._h:
            raise NativeDemuxError(
                "whitelist not eligible for the pigeonhole fast path "
                "(invalid barcode bytes, too many parts for the length, or "
                "a degenerate whitelist longer than 16bp)"
            )

    def assign(self, obs_packed: np.ndarray) -> np.ndarray:
        """obs_packed[N, ceil(L/2)] uint8 (two 4-bit masks per byte) ->
        assigned[N] int32 with K = unmatched."""
        obs_packed = np.ascontiguousarray(obs_packed, dtype=np.uint8)
        n = obs_packed.shape[0]
        out = np.empty(n, dtype=np.int32)
        self._lib.fqtk_bigk_assign(
            self._h,
            obs_packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            obs_packed.shape[1],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._threads,
        )
        return out

    def close(self) -> None:
        if self._h:
            self._lib.fqtk_bigk_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeSmallKMatcher:
    """Brute-force host matcher for small whitelists (``SmallKMatcher`` in
    ``native/fqtk_io.cpp``).  Full IUPAC containment semantics over the
    pipeline's packed 4-bit-mask layout; used by the demux auto policy when
    the per-batch device round-trip would exceed the K*L host scan cost."""

    def __init__(self, barcodes, max_mismatches: int, min_delta: int,
                 threads: int = 4):
        lib = get_lib()
        if lib is None:
            raise NativeDemuxError("native library unavailable")
        self._lib = lib
        self._threads = threads
        if not barcodes:
            raise NativeDemuxError("Must provide at least one sample")
        self.length = len(barcodes[0])
        if any(len(b) != self.length for b in barcodes):
            # len(barcodes[0]) frames every row of the concatenated buffer;
            # unequal lengths would silently mis-frame the whole whitelist
            raise NativeDemuxError("All barcodes must have the same length")
        concat = "".join(b.upper() for b in barcodes).encode()
        buf = (ctypes.c_uint8 * len(concat)).from_buffer_copy(concat)
        for name in ("fqtk_smallk_assign", "fqtk_smallk_free"):
            _require(lib, name)
        self._h = _require(lib, "fqtk_smallk_new")(
            buf, len(barcodes), self.length, max_mismatches, min_delta
        )
        if not self._h:
            raise NativeDemuxError(
                "whitelist not eligible for the small-K host matcher "
                "(invalid IUPAC bytes, or barcode length > 256)"
            )

    def assign(self, obs_packed: np.ndarray) -> np.ndarray:
        """obs_packed[N, ceil(L/2)] uint8 (two 4-bit masks per byte) ->
        assigned[N] int32 with K = unmatched."""
        obs_packed = np.ascontiguousarray(obs_packed, dtype=np.uint8)
        n = obs_packed.shape[0]
        out = np.empty(n, dtype=np.int32)
        self._lib.fqtk_smallk_assign(
            self._h,
            obs_packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            obs_packed.shape[1],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._threads,
        )
        return out

    def close(self) -> None:
        if self._h:
            self._lib.fqtk_smallk_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeBgzfWriter:
    """BGZF writer backed by the native compressor pool."""

    def __init__(self, path, compression_level: int = 5, threads: int = 4):
        lib = get_lib()
        if lib is None:
            raise NativeDemuxError("native library unavailable")
        self._lib = lib
        self._h = lib.fqtk_bgzf_open(str(path).encode(), compression_level, threads)
        if not self._h:
            raise NativeDemuxError(f"cannot open {path}")

    def write(self, data: bytes) -> None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._lib.fqtk_bgzf_write(self._h, buf, len(data))

    def close(self) -> None:
        if self._h:
            rc = self._lib.fqtk_bgzf_close(self._h)
            self._h = None
            if rc != 0:
                raise NativeDemuxError(
                    "error writing BGZF output (short write — disk full?)"
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
