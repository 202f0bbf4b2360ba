"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``build/kernels/`` at the repo root.
The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads from the cache. :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --split-compile=0: NVVM and ptxas optimise a source's kernels on all the
# machine's cores (the GEMM sources instantiate dozens of kernels each).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
              "-Xptxas", "-v,--split-compile=0")

_LIBS: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A kernel that cannot be built here. It declares the ``compile``
    failure class, so a guarded contraction records a failed build as the
    reference records a failed kernel compilation, by its class and not by
    its message."""

    failure_class = "compile"


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found: the CUDA kernels build only on a "
                     "machine with the CUDA toolkit")


def nvcc_command(src: Path, out: Path) -> list:
    """The ``nvcc`` command that builds ``src`` into the shared library
    ``out``, with the shared headers of ``csrc/`` on the include path."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):  # the source and any shared header
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile every named kernel (default: all) that is not built yet, one
    ``nvcc`` process per source, all started together. Returns name -> path
    of the shared library; the compiler's output is kept beside it as
    ``.log`` (``-Xptxas -v``: registers, shared memory, spills)."""
    srcs = sources()
    names = list(names) or list(srcs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        jobs[name] = (subprocess.Popen(nvcc_command(srcs[name], tmp), stdout=log,
                                       stderr=subprocess.STDOUT),
                      tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {rc}; see {out.with_suffix('.log')}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise BuildError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _LIBS[name] = lib
    return lib
