"""Build and bind the port's hand-written CUDA kernels.

Every kernel lives in ``src/repro_torch/csrc/<name>.cu`` behind a plain C
entry point ``<name>_launch(...)`` that launches on the stream it is given
and returns ``cudaGetLastError()``.  Each source is compiled on first use
with ``nvcc`` for ``sm_90a`` into its own shared library under the
checkout's ``build/`` directory and loaded with ``ctypes``; no PyTorch
header is included, so a build takes seconds.  All sources are compiled
together, one ``nvcc`` process each, the first time any kernel is needed.
A library's file name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc`` and no card.

Each kernel also keeps a :class:`LaunchCounter`.  Its ``launches`` count
goes up by one where the kernel is launched and nowhere else, so a run can
show which kernels its main path went through; with ``calls`` set to a
list, the launcher also appends the arguments of every launch (the chip
smoke test replays one main-path call against the plain version).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("descend_probe", "frontier_compact", "elim_combine", "range_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


class LaunchCounter:
    """Launch count of one kernel (see the module docstring)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.calls: Optional[List[tuple]] = None

    def launched(self, args: tuple) -> None:
        self.launches += 1
        if self.calls is not None:
            self.calls.append(args)


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  Returns name -> library path."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, todo[name])
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all sources first if
    any library is missing)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def on_cuda(t: torch.Tensor) -> bool:
    """Dispatch test of every ``ops`` wrapper: a CUDA tensor goes to the
    kernel (or raises), a CPU tensor to the plain version."""
    return t.is_cuda


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Validate one kernel argument before its pointer is passed on."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream


def bind(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """``lib_name``'s C entry ``fn_name`` with its argument types declared."""
    fn = _fns.get(fn_name)
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[fn_name] = fn
    return fn


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
