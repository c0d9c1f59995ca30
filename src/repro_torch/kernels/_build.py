"""Build the port's CUDA kernels from ``kernels/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/lib<name>.so`` at the repository root, exposing a plain
C interface that the wrappers call through ``ctypes``.  A library is built at
first use, or again when a source is newer than it; nothing is built when a
module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return lib.stat().st_mtime < newest


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named kernels that are missing or stale, all at once (one
    ``nvcc`` each, started together).  Returns the seconds each build took;
    ``-Xptxas -v`` output lands in ``build/repro_torch/lib<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale = [name for name in names if _stale(name)]
    nvcc = _nvcc() if stale else ""
    procs = {}
    for name in stale:
        tmp = _lib_path(name).with_suffix(f".so.{os.getpid()}.tmp")
        log = open(_lib_path(name).with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, log, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, log, t0) in procs.items():
        rc = proc.wait()          # every nvcc ends before anything is raised
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc == 0:
            os.replace(tmp, _lib_path(name))
        else:
            failed.append(f"nvcc failed for {name}.cu (exit {rc}):\n"
                          + _lib_path(name).with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """Load the shared library of kernel ``name``, building it if needed."""
    build([name])
    return ctypes.CDLL(str(_lib_path(name)))


H100_SMS = 132   # SMs of an H100 SXM: the planners' default card


@functools.cache
def sm_count(index: int) -> int:
    """SMs of card ``index``, by which the planners size their grids."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
