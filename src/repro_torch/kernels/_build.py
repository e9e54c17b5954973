"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each kernel package keeps its sources under ``csrc/``. The first call that
needs a kernel compiles its source with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``src/repro_torch/_build/`` (git-ignored), under a name that carries a
hash of the source, and loads the shared library with ``ctypes``. The
libraries expose plain C functions; tensors cross as ``c_void_p`` from
``data_ptr()`` and the stream as PyTorch's current CUDA stream. Nothing
here runs at import time, so the package imports on machines without
``nvcc``.

Every wrapper counts the launches of its kernel with ``count`` (one per
launch, nowhere else), so a run can show which kernels the path went
through; ``device_us`` reads a kernel's device time from ``torch.profiler``.
``count`` adds to the process-wide ``LAUNCHES`` and to a tally of the
calling thread. A CUDA graph replays its launches without calling a
wrapper, and its capture calls the wrappers without launching anything:
the engine's graphs (``repro_torch.serving.graphs``) read their capture's
count from the capturing thread's tally (``thread_launch_counts``,
``launches_since``), so the eager launches of other threads (engines of
the frontend and the supervisor) stay out of it, take it back out of
``LAUNCHES`` (``add_launches(delta, -1)``) and add it at every replay, so
``LAUNCHES`` counts the launches executed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

#: kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"ternary_matvec": 0, "ternary_matmul": 0,
                            "ternary_matvec_experts": 0,
                            "ternary_matmul_experts": 0,
                            "chunk_attention": 0, "rms_norm": 0,
                            "add_rms_norm": 0,
                            "chunk_attention_paged": 0, "decode_attention": 0,
                            "ptqtp_search": 0, "rglru_scan": 0,
                            "rglru_scan_alone": 0, "wkv6": 0}

_LIBS: Dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()        # guards LAUNCHES: threads launch at once
_THREAD = threading.local()     # .tally: the calling thread's launches


def _tally() -> Dict[str, int]:
    tally = getattr(_THREAD, "tally", None)
    if tally is None:
        tally = _THREAD.tally = dict.fromkeys(LAUNCHES, 0)
    return tally


def count(name: str, n: int = 1) -> None:
    """Count ``n`` launches of kernel ``name`` by the calling thread: in
    ``LAUNCHES`` and in the thread's own tally."""
    with _LOCK:
        LAUNCHES[name] += n
    _tally()[name] += n


def reset_launch_counts() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    """Launches per kernel in the whole process."""
    with _LOCK:
        return dict(LAUNCHES)


def thread_launch_counts() -> Dict[str, int]:
    """Launches per kernel counted by the calling thread."""
    return dict(_tally())


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The calling thread's launches per kernel since ``before`` (its
    ``thread_launch_counts()``); other threads' launches are not in it."""
    return {k: n - before.get(k, 0) for k, n in _tally().items()}


def add_launches(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``delta`` to the process's counts (a graph's
    replays, or a negative ``times`` to take a capture's count back out)."""
    with _LOCK:
        for k, n in delta.items():
            LAUNCHES[k] += times * n


def device_us(evt) -> float:
    """Self device time (µs) of a ``torch.profiler`` ``key_averages()`` row,
    across PyTorch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set NVCC to its path)")


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def _start_build(source: Path):
    """Start nvcc for ``source`` unless its library exists; returns
    (target, process or None)."""
    target = _target(source)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    return target, proc


def _finish_build(target: Path, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {target.name}:\n{out}")
    os.replace(proc.tmp, target)  # atomic: two processes building at once both succeed


def build(sources: Iterable[Path]) -> List[Path]:
    """Compile every source with one nvcc each, all started together."""
    started = [_start_build(Path(s)) for s in sources]
    for target, proc in started:
        _finish_build(target, proc)
    return [t for t, _ in started]


def load(source: Path, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source``; declare each
    exported function's argument types (every function returns the CUDA
    error code as an int). Two wrappers may load one source with their own
    functions: each gets a handle of its own."""
    key = (str(source), tuple(signatures))
    lib = _LIBS.get(key)
    if lib is None:
        (target,) = build([source])
        lib = ctypes.CDLL(str(target))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[key] = lib
    return lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def kernel_sources() -> List[Path]:
    return sorted((_PKG / "kernels").glob("*/csrc/*.cu"))
