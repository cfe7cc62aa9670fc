"""The host gather of the input pipeline in C++, loaded with ctypes (the
JAX package's ``native/``).

``gather.cpp`` packs a whole batch of slice blocks in one threaded call
(``gather_blocks``); ``data/dataset.py::SliceDataset.get_batch`` takes it
when ``available()``, else its numpy branch, which gives the same batches.

Build: at first use, ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into the
package's git-ignored ``_build/`` directory, one file per source hash, then
``ctypes.CDLL`` and a check of ``rdt_native_abi_version``.  Nothing is
compiled when this module is imported.

- ``RDT_NATIVE=0`` turns the gather off (``available()`` is False);
- ``RDT_NATIVE_THREADS=N`` sizes its thread pool (default: the host's
  cores);
- without ``g++`` on the PATH ``available()`` is False and the numpy branch
  runs;
- a ``g++`` that fails to compile raises with its stderr, and a library of
  another ABI version raises: neither falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "gather.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
ABI_VERSION = 1

_lock = threading.Lock()
_state: dict = {}          # "lib": the loaded library or None, once decided


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgather_{digest[:16]}.so"


def _build(cxx: str) -> Path:
    """Compile gather.cpp once per source content; returns the library."""
    so = _target()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}) on {_SRC}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)               # concurrent builds race benignly
    return so


def _load():
    if os.environ.get("RDT_NATIVE", "1") == "0":
        return None
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    lib = ctypes.CDLL(str(_build(cxx)))
    lib.rdt_native_abi_version.restype = ctypes.c_int
    abi = lib.rdt_native_abi_version()
    if abi != ABI_VERSION:
        raise RuntimeError(f"{_target()} has ABI version {abi}; this module "
                           f"binds version {ABI_VERSION}")
    lib.rdt_gather_blocks.restype = ctypes.c_int
    lib.rdt_gather_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    return lib


def _lib():
    with _lock:
        if "lib" not in _state:
            _state["lib"] = _load()
        return _state["lib"]


def available() -> bool:
    """Whether the native gather runs here (building it on first call)."""
    return _lib() is not None


def gather_blocks(src_ptrs: np.ndarray, out: np.ndarray) -> None:
    """Fill ``out`` [n, H, W, bc] (C-contiguous float32) from ``src_ptrs``
    [n] uint64 block addresses, 0 for a zero-filled task.  Each source block
    is [bc, H, W] C-contiguous float32; the copy transposes it to
    [H, W, bc].  The caller keeps the source arrays alive for the call."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native gather is not available (RDT_NATIVE=0 "
                           "or no g++)")
    if out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous float32 array")
    n, h, w, bc = out.shape
    ptrs = np.ascontiguousarray(src_ptrs, dtype=np.uint64)
    if ptrs.shape != (n,):
        raise ValueError(f"{ptrs.shape[0]} pointers for {n} tasks")
    rc = lib.rdt_gather_blocks(
        ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        out.ctypes.data_as(ctypes.c_void_p), n, h, w, bc)
    if rc != 0:
        raise RuntimeError(f"rdt_gather_blocks failed: rc={rc}")
