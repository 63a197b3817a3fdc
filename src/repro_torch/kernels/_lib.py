"""Build and bind the port's hand-written CUDA kernels.

Every kernel lives in ``src/repro_torch/csrc/<name>.cu`` behind a plain C
entry point ``<name>_launch(...)`` that launches on the stream it is given
and returns ``cudaGetLastError()``.  Each source is compiled on first use
with ``nvcc`` for ``sm_90a`` into its own shared library under the
checkout's ``build/`` directory and loaded with ``ctypes``; no PyTorch
header is included, so a build takes seconds.  All sources are compiled
together, one ``nvcc`` process each, the first time any kernel is needed.
A library's file name carries a hash of everything its build reads: its
source, every shared header ``csrc/*.cuh``, and the ``nvcc`` flags; so an
edited source or header, or a changed flag, is rebuilt and a stale library
is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc`` and no card.

Each kernel also keeps a :class:`LaunchCounter`.  Its ``launches`` count
goes up by the number of kernels a call launches, where it launches them
and nowhere else (one, but two in K4's block mode), so a run can
show which kernels its main path went through; with ``calls`` set to a
list (or a ``deque`` with a ``maxlen`` to keep only the latest), the
launcher also appends the arguments of every launch (the chip smoke test
replays one main-path call against the plain version).
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
SOURCES = (
    "descend_probe", "frontier_compact", "elim_combine", "range_scan", "decode_attention",
    "flash_attention", "leaf_probe",
)
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

    def launched(self, args: tuple, kernels: int = 1) -> None:
        self.launches += kernels
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
    """The library of source ``name``, named by a hash of its source, every
    shared header and its ``nvcc`` command line (less the paths of the
    compiler, the source and the output, which say nothing of the build)."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


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


def resolve_device(device, who: str) -> torch.device:
    """``device``, or the CUDA card when it is None: an entry point of the
    port runs on the card unless the caller asks for the CPU, and raises
    when there is no card instead of dropping to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; pass device='cpu' to run the plain "
                "versions of the kernels on the host"
            )
        device = "cuda"
    return torch.device(device)


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


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    kernels' vector and TMA loads need it; a fresh allocation always does)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream


def bind(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """``lib_name``'s C entry ``fn_name`` with its argument and result types
    declared."""
    fn = _fns.get(fn_name)
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[fn_name] = fn
    return fn


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
