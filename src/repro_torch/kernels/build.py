"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under
``<repo>/build/repro_torch/`` at first use, and loaded with ctypes. The
library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew
and a finished build is reused. ``build_all``
starts one ``nvcc`` per source, all together. ``sm_count``, ``alignment``
and ``load_width`` are the device facts the kernels' launch plans read.

Nothing here runs at import time: the CPU tests import every module of
the port on machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

SOURCES = ("round_stats", "aircomp_sum", "gather_superpose", "ssd_chunk",
           "swa_attention")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda: the "
                       "CUDA kernels cannot be built on this machine")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # what a source includes
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns
    (process, temporary path, final path), or None if already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".tmp.so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)       # atomic: a reader never sees a partial file


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source in parallel (sources already built are
    skipped). Returns the wall seconds spent, per source."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    seconds = {}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
        seconds[name] = time.perf_counter() - t0
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once per process."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def alignment(*tensors) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    return min(min(t.data_ptr() & -t.data_ptr(), 16) for t in tensors)


def load_width(d: int, itemsize: int, align: int, g_align: int = 0) -> int:
    """Elements per load: the widest of 8, 4, 2, 1 whose bytes are at most
    16 and divide the row pitch (d elements) and the planes' pointer
    alignment ``align``; with ``g_align`` (sweep 1's f32 g, loaded at the
    same columns) the same count of f32, up to 16 bytes, must divide that
    too."""
    for vec in (8, 4, 2, 1):
        width = vec * itemsize
        if (width <= 16 and d % vec == 0 and align % width == 0
                and (not g_align or g_align % min(16, 4 * vec) == 0)):
            return vec
    raise ValueError(f"no load width for d={d}, itemsize={itemsize}, "
                     f"alignment {align}, g alignment {g_align}")
