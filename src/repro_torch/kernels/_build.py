"""One nvcc builder for every hand-written CUDA kernel of the port.

Each ``repro_torch/csrc/*.cu`` source is compiled on its own into a
shared library with a plain C interface (``nvcc -shared`` for
``sm_90a``), which the kernel modules load with ctypes. A library is
keyed by the hash of its source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Libraries go to
``build/repro_torch/`` beside ``src/``. Nothing is built when a module
is imported: the kernel modules call :func:`build` at first launch.

Building, loading and counting are safe across threads: the fleet
broker may launch from two flush lanes at once. Each source builds once
under its own lock (two sources still build in parallel), into a
temporary file named by process and thread, and the wrappers' launch
counters are bumped under one lock (:func:`count_launch`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple, TypeVar

import torch

PKG = Path(__file__).resolve().parents[1]            # src/repro_torch
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Shared memory one block may opt in to on sm_90 (H100/H200): 227 KB.
SMEM_LIMIT_BYTES = 232_448


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built with nvcc from repro_torch/csrc at first "
                           "use")
    return nvcc


# _LOCK guards _SOURCE_LOCKS and the launch counters; each source builds
# (and enters _BUILT) under its own lock from _SOURCE_LOCKS.
_LOCK = threading.Lock()
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}
_BUILT: Dict[str, Tuple[Path, str]] = {}

T = TypeVar("T")


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` (once per content) into a shared library
    and return its path and the compiler's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel; empty when the
    library was already built). Threads asking for one source wait for
    one build; different sources build in parallel."""
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source not in _BUILT:
            _BUILT[source] = _compile(source)
        return _BUILT[source]


def _compile(source: str) -> Tuple[Path, str]:
    src = CSRC / source
    text = src.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def load_once(factory: Callable[[], T]) -> Callable[[], T]:
    """``factory()`` called once, under a lock of its own, whichever
    threads ask first: the kernel modules' ``_lib()``."""
    made: list = []
    lock = threading.Lock()

    def get() -> T:
        if not made:
            with lock:
                if not made:
                    made.append(factory())
        return made[0]
    return get


def count_launch(fn) -> None:
    """One more launch on ``fn.launches``, under the lock: two flush
    lanes may launch the same kernel at once."""
    with _LOCK:
        fn.launches += 1


class Library:
    """A built source loaded with ctypes. Every entry point takes device
    pointers, ints and the stream (pointers and the stream as
    ``c_void_p``, so they are not cut to 32 bits), launches on that
    stream and returns ``cudaGetLastError()``; each source also exports
    ``<stem>_error_string``."""

    def __init__(self, source: str,
                 signatures: Dict[str, Sequence[type]]) -> None:
        self.source = source
        self._lib = ctypes.CDLL(str(build(source)[0]))
        for name, argtypes in signatures.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self._error = getattr(self._lib, f"{Path(source).stem}_error_string")
        self._error.argtypes = [ctypes.c_int]
        self._error.restype = ctypes.c_char_p

    def launch(self, name: str, *args, context: str = "") -> None:
        """Call one entry point; raise if CUDA refused the launch, with
        ``context`` (the sizes the caller launched at) in the message."""
        err = getattr(self._lib, name)(*args)
        if err:
            raise RuntimeError(f"{name} failed: CUDA error {err} "
                               f"({self._error(err).decode()})"
                               + (f": {context}" if context else ""))


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a 16-byte boundary, as the kernels' vector
    loads and ``cp.async`` need: ``t`` itself where it is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
