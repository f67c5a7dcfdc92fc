"""Builds of the port's native code, loaded with ``ctypes``.

- :func:`load_kernels` compiles ``fqtk_tpu_torch/csrc/*.cu`` with ``nvcc``
  for ``sm_90a`` into one shared library with a plain C interface.
- :func:`ensure_native_engine` makes sure the shared host I/O engine
  (``native/fqtk_io.cpp``, bound by :mod:`fqtk_tpu.io.native`) loads, by
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


def build_kernels() -> Dict[str, object]:
    """Compile the CUDA sources unless a build of the same sources and flags
    exists.  Returns ``{"path", "seconds", "built", "log"}``; ``seconds`` is
    0.0 when the existing build was reused.  Raises :class:`BuildError` with
    nvcc's output when nvcc is missing or fails."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels of fqtk_tpu_torch cannot be built"
        )
    srcs = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    cu = [p for p in srcs if p.suffix == ".cu"]
    tag = _digest(srcs, NVCC_FLAGS)
    out = BUILD_DIR / f"libfqtk_tpu_torch_kernels_{tag}.so"
    log = out.with_suffix(".log")
    if out.exists():
        return {"path": out, "seconds": 0.0, "built": False,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
           *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed (exit {proc.returncode}):\n{text}")
    log.write_text(text)
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "built": True, "log": text}


_KERNELS: Dict[str, ctypes.CDLL] = {}


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process,
    with every entry point's ``argtypes``/``restype`` declared."""
    lib = _KERNELS.get("lib")
    if lib is not None:
        return lib
    info = build_kernels()
    lib = ctypes.CDLL(str(info["path"]))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fqtk_colmerge_top2.restype = i32
    lib.fqtk_colmerge_top2.argtypes = [
        p, i64, i32,  # obs, b, width
        p, i64, i32, i32,  # compat, k_pad, k, length
        i32,  # ksplit
        p, p, p,  # best, idx, next
        p,  # stream
    ]
    _KERNELS["lib"] = lib
    return lib


def _dlopen_ok(path: Path) -> bool:
    try:
        ctypes.CDLL(str(path))
    except OSError:
        return False
    return True


def ensure_native_engine() -> None:
    """Make :func:`fqtk_tpu.io.native.available` true or raise.

    The committed ``native/libfqtk_io.so`` links ``libdeflate.so.0`` and was
    built ``-march=native`` on another host; where it does not load, build
    ``native/fqtk_io.cpp`` with its own Makefile into ``build/`` (it links
    libdeflate only where the header resolves) and point
    ``FQTK_NATIVE_LIB`` at the result before the first ``get_lib()``.
    Never falls back to a slower engine."""
    from fqtk_tpu.io import native as native_io

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
