"""Builds of the port's native code, loaded with ``ctypes``.

- :func:`load_kernel` compiles each ``fqtk_tpu_torch/csrc/*.cu`` with
  ``nvcc`` for ``sm_90a`` into a shared library of its own with a plain C
  interface (one nvcc per source, all started together).
- :func:`ensure_native_engine` makes sure the shared host I/O engine
  (``native/fqtk_io.cpp``, bound by :mod:`fqtk_tpu_torch.io.native`) loads, by
  building it here when the committed binary does not.

Both builds go into ``build/fqtk_tpu_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of their sources and flags, so a
source edit rebuilds and an unchanged tree reuses the last build.  Nothing
is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..utils.profiling import TRACER

_PKG_DIR = Path(__file__).resolve().parent.parent
_REPO_ROOT = _PKG_DIR.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _REPO_ROOT / "build" / "fqtk_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
]

#: ``make`` overrides for the host engine: the Makefile's flags minus
#: ``-Werror`` (a newer g++ than the one the source was checked with may
#: warn; the code built is the same)
NATIVE_CXXFLAGS = "-O3 $(ARCH) -std=c++17 -fPIC -Wall -pthread"

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

#: argument types of each kernel's entry point ``fqtk_<source stem>``; every
#: entry point returns an int status (0 on success)
ENTRY_POINTS = {
    **{
        stem: [
            _P, _I64, _I32,  # obs, b, width
            _P, _I64, _I32, _I64, _I32,  # table, k_pad, kp, k, length
            _I32,  # classes: 4 (bit2 rows) or 16 (nib4 rows)
            _I32, _I64,  # n_chunks, cols_per_cta
            _P,  # partial
            _P, _P, _P,  # best, idx, next
            _P,  # stream
        ]
        for stem in ("colmerge_top2", "tile_top2")
    },
    # the kernel lab (ops/lab_kernels.py)
    "lab_probe": [
        _P, _I64, _I32,  # obs, b, width
        _P, _I32, _I32,  # table (tiled int8), kp, length
        _I32, _I32,  # tile_k, n_k_tiles
        _I32, _I32, _I32,  # mode, ck, sink_flag
        _P, _P,  # partial, out
        _P,  # stream
    ],
    "mma_probe": [
        _P, _I64, _I32,  # obs, b, width
        _P, _I32, _I32,  # table, kp, length
        _I32, _I32,  # tile_k, n_k_tiles
        _I32,  # sink_flag
        _P,  # out
        _P,  # stream
    ],
    **{
        stem: [
            _P, _I64, _I32,  # obs, b, width
            _P, _I32, _I32,  # table (tiled int8), kp, length
            _I32, _I32,  # tile_k, n_k_tiles
            _I32, _I32,  # w_clamp (group P for group_top2), nt_pow2
            _P,  # partial
            _P, _P, _P,  # best, idx, next
            _P,  # stream
        ]
        for stem in ("clamp16_top2", "group_top2", "clamp8_top2")
    },
}

#: argument types of ``fqtk_<stem>_walk_info`` (classes, kp, out: 6 int32):
#: what the card makes of the sliced depth walk's instantiation at that depth
WALK_INFO_POINTS = {stem: [_I32, _I32, _P] for stem in ("colmerge_top2", "tile_top2")}


class BuildError(RuntimeError):
    pass


def _digest(paths: List[Path], extra: List[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for e in extra:
        h.update(e.encode())
    return h.hexdigest()[:16]


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return shutil.which("nvcc")


def build_kernels() -> Dict[str, Dict[str, object]]:
    """Compile each ``csrc/<name>.cu`` into its own shared library unless a
    build of the same source, headers and flags exists; the nvcc runs start
    together.  Returns ``{name: {"path", "seconds", "built", "log"}}``;
    ``seconds`` is 0.0 for a reused build.  Raises :class:`BuildError` with
    nvcc's output when nvcc is missing or fails."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels of fqtk_tpu_torch cannot be built"
        )
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, Dict[str, object]] = {}
    running = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC_DIR.glob("*.cu")):
        out = BUILD_DIR / f"lib{src.stem}_{_digest([src, *headers], NVCC_FLAGS)}.so"
        log = out.with_suffix(".log")
        if out.exists():
            info[src.stem] = {"path": out, "seconds": 0.0, "built": False,
                              "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(src)]
        with open(f"{tmp}.log", "w") as sink:  # a file: no pipe to fill up
            proc = subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT)
        running[src.stem] = (cmd, out, tmp, proc)
    failed = []
    for name, (cmd, out, tmp, proc) in running.items():
        proc.wait()
        text = f"$ {' '.join(cmd)}\n{Path(f'{tmp}.log').read_text()}"
        os.unlink(f"{tmp}.log")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}):\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
        info[name] = {"path": out, "seconds": time.perf_counter() - t0,
                      "built": True, "log": text}
    if failed:
        raise BuildError("\n".join(failed))
    return info


_KERNELS: Dict[str, ctypes.CDLL] = {}


def load_kernel(name: str):
    """Entry point ``fqtk_<name>`` of ``csrc/<name>.cu``'s library, with its
    ``argtypes``/``restype`` declared.  The first call of a process builds
    (or reuses) and loads every kernel library."""
    if name not in _KERNELS:
        with TRACER.setup_span("fqtk.setup.kernels") as counts:
            built = build_kernels()
            for stem, info in built.items():
                lib = ctypes.CDLL(str(info["path"]))
                fn = getattr(lib, f"fqtk_{stem}")
                fn.restype, fn.argtypes = _I32, ENTRY_POINTS[stem]
                if stem in WALK_INFO_POINTS:
                    info_fn = getattr(lib, f"fqtk_{stem}_walk_info")
                    info_fn.restype, info_fn.argtypes = _I32, WALK_INFO_POINTS[stem]
                _KERNELS[stem] = lib
            counts["built"] = sum(bool(info["built"]) for info in built.values())
            counts["reused"] = len(built) - counts["built"]
    return getattr(_KERNELS[name], f"fqtk_{name}")


def load_walk_info(name: str):
    """Entry point ``fqtk_<name>_walk_info`` of ``csrc/<name>.cu``'s library
    (:data:`WALK_INFO_POINTS`), loaded as :func:`load_kernel` loads."""
    load_kernel(name)
    return getattr(_KERNELS[name], f"fqtk_{name}_walk_info")


def _dlopen_ok(path: Path) -> bool:
    try:
        ctypes.CDLL(str(path))
    except OSError:
        return False
    return True


def ensure_native_engine() -> None:
    """Make :func:`fqtk_tpu_torch.io.native.available` true or raise.

    The committed ``native/libfqtk_io.so`` links ``libdeflate.so.0`` and was
    built ``-march=native`` on another host; where it does not load, build
    ``native/fqtk_io.cpp`` with its own Makefile into ``build/`` (it links
    libdeflate only where the header resolves) and point
    ``FQTK_NATIVE_LIB`` at the result before the first ``get_lib()``.
    Never falls back to a slower engine."""
    from ..io import native as native_io

    if not os.environ.get("FQTK_NATIVE_LIB") and not _dlopen_ok(
        native_io._LIB_PATH
    ):
        src_dir = native_io._LIB_PATH.parent
        # the Makefile's own libdeflate probe misfires under GNU make >= 4.3
        # (it passes a literal "\#include"), so probe the header here
        cxx = os.environ.get("CXX", "g++")
        probe = subprocess.run(
            [cxx, "-E", "-x", "c++", "-"], input="#include <libdeflate.h>\n",
            capture_output=True, text=True,
        )
        have_deflate = "1" if probe.returncode == 0 else ""
        tag = _digest(
            [src_dir / "fqtk_io.cpp", src_dir / "Makefile"],
            [NATIVE_CXXFLAGS, cxx, have_deflate],
        )
        out = BUILD_DIR / f"libfqtk_io_{tag}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                ["make", "-C", str(src_dir), f"OUT={tmp}",
                 f"CXXFLAGS={NATIVE_CXXFLAGS}", f"HAVE_DEFLATE={have_deflate}"],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise BuildError(
                    "native engine build failed (exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        os.environ["FQTK_NATIVE_LIB"] = str(out)
    if not native_io.available():
        raise BuildError(
            "native I/O engine unavailable (FQTK_NATIVE_LIB="
            f"{os.environ.get('FQTK_NATIVE_LIB', '')!r}, default "
            f"{native_io._LIB_PATH}); fqtk_tpu_torch requires it"
        )
