"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. Nothing
is built at import: ``load`` builds on first use, and ``build_all`` starts
one ``nvcc`` per source at once (the sources are independent, so the build
takes as long as the slowest file).

Libraries are named by a hash of their source and flags, so an edited source
is rebuilt and an unchanged one is reused within a checkout. The build
directory (``kernels/_build/``) is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "nvcc_path",
           "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel name -> its CUDA source, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on the machine with the card")


def _lib_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all) in parallel.

    Returns ``{name: {"seconds": wall time of its nvcc, "log": ptxas's
    register/shared-memory report, or "cached"}}``. Raises ``RuntimeError``
    with the compiler's output when any source fails to build.
    """
    names = sorted(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "cached"}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures[name] = log
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        report[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("nvcc failed for " + ", ".join(failures) + ":\n"
                           + "\n".join(failures.values()))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
