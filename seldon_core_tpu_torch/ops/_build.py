"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` call builds it in seconds into ``build/kernels/lib<name>-<hash>.so``
at the repository root; the hash covers the source, the local headers it
includes (``#include "..."``, found in ``csrc/``) and the flags, so an
edited source or header rebuilds what includes it, and an unchanged one
loads the existing library.
Builds happen at first use, never at import. Target: ``sm_90a`` (Hopper).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr per kernel source (ptxas register / shared-memory / spill
# report), kept for the caller to print
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source at first use")


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _with_headers(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """``path``'s bytes, then those of every local header it includes,
    transitively, each once, in the order first included."""
    if path not in seen:
        text = seen[path] = path.read_bytes()
        for inc in _LOCAL_INCLUDE.findall(text.decode()):
            _with_headers(CSRC / inc, seen)
    return seen


def _library_path(name: str) -> Path:
    parts = _with_headers(CSRC / f"{name}.cu", {})
    digest = hashlib.sha256(b"".join(parts.values())
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library is already
    built. Returns (process, temporary output, final path) or None."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), \
        tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> Path:
    _, err = proc.communicate()
    build_logs[name] = err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{err}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _compile(name: str) -> Path:
    job = _start(name)
    return _library_path(name) if job is None else _finish(name, *job)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, compiling it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _libs[name] = lib
        return lib


def launch(fn, device: torch.device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream and raise if it returns a CUDA error (a refused launch never
    runs, and a later synchronise would not report it). The device context
    is switched only when ``device`` is not already current: on the serving
    path this runs hundreds of times per decode step."""
    # the raw stream and device from PyTorch's C bindings: the public
    # accessors build Python objects, a measurable host cost at this rate
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """SMs of card ``device_index``, asked once: the kernels' plans size
    their grids by it, hundreds of times per decode step."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every kernel source (one nvcc process per source, all
    started before any is awaited) and load them. Returns name -> library."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = [(n, _start(n)) for n in names]
    for n, job in jobs:
        if job is not None:
            _finish(n, *job)
    return {n: load_library(n) for n in names}


__all__ = ["BUILD_DIR", "build_all", "build_logs", "launch", "load_library", "sm_count"]
