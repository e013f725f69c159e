"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C entry point and is compiled by `nvcc`
into its own shared library (`-gencode arch=compute_90a,code=sm_90a`),
then loaded with ctypes. No PyTorch headers are involved, so a build takes
seconds. Libraries go to `build/kernels/` at the repository root (listed in
.gitignore), named by a hash of their source, so an edited source is
rebuilt and an unchanged one is loaded as is. Building happens on first
use, never at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_ROOT = Path(__file__).resolve().parent
CSRC = _ROOT / "csrc"
BUILD_DIR = _ROOT.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library exists. Returns the library
    path and, while building, (process, temporary output, log file)."""
    src, lib = _paths(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = open(lib.with_suffix(".log"), "w")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=log, stderr=subprocess.STDOUT)
    return lib, (proc, tmp, log)


def _finish(name: str, lib: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp, log = pending
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (rc={rc}):\n"
            + lib.with_suffix(".log").read_text())
    os.replace(tmp, lib)


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build several kernels at once: one nvcc per source, all started
    together. Returns the library path of each."""
    started = {n: _start(n) for n in names}
    for n, (lib, pending) in started.items():
        _finish(n, lib, pending)
    return {n: lib for n, (lib, _) in started.items()}


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/spill report) of a build."""
    log = _paths(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    if name not in _loaded:
        lib = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]
