"""Hand-written CUDA kernels of the port, and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  The fused SPADE
interior ``in_modulate`` (instance-norm of the z-stream, then the gamma/beta
modulation) runs as one CUDA kernel for Hopper, ``csrc/in_modulate.cu``,
which replaces the Pallas forward kernels ``_kernel`` and
``_packed_kernel``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, into the
package's ``_build/`` directory, and called through ``ctypes`` with a plain C
interface.  Nothing is compiled or loaded when this module is imported.

Dispatch: ``in_modulate`` takes the plain version for a tensor on the CPU
and the kernel for a CUDA tensor; there is no fallback from one to the
other.  The kernel has no backward yet, so ``in_modulate`` refuses a CUDA
input that requires grad.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from representation_disentanglement_torch.ops.norm import instance_norm

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_DTYPES = (torch.float32, torch.bfloat16)
_NO_BACKWARD = ("in_modulate has no backward kernel yet (ROADMAP.md, queue 2: "
                "K3 _bwd_kernel and K4 _packed_bwd_kernel); call it under "
                "torch.no_grad() or torch.inference_mode()")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ with the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/*.cu`` file built into a shared library on first use.

    ``build()`` compiles (once per source content) and returns the
    compiler's output; ``fn(name, argtypes)`` returns a bound C function.
    """

    def __init__(self, source: str):
        self.source = _CSRC / source
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _target(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}_{digest[:16]}.so"

    def build(self) -> str:
        with self._lock:
            if self._lib is not None:
                return self.build_log
            target = self._target()
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                self.build_log = res.stdout + res.stderr
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}) on "
                                       f"{self.source}:\n{self.build_log}")
                os.replace(tmp, target)
            self._lib = ctypes.CDLL(str(target))
            return self.build_log

    def fn(self, name: str, argtypes):
        self.build()
        f = getattr(self._lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        return f


class InModulateKernel:
    """ctypes binding of ``rdt_in_modulate`` with a launch counter."""

    _ARGTYPES = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

    def __init__(self):
        self.library = CudaLibrary("in_modulate.cu")
        self.launches = 0
        self._fn = None

    def __call__(self, zi, gamma, beta, eps):
        if self._fn is None:
            self._fn = self.library.fn("rdt_in_modulate", self._ARGTYPES)
        out = torch.empty_like(zi)
        n, c, h, w = zi.shape
        if out.numel() == 0:
            return out
        dev = zi.device.index
        stream = torch.cuda.current_stream(zi.device).cuda_stream
        rc = self._fn(zi.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      out.data_ptr(), n * c, h * w,
                      int(zi.dtype == torch.bfloat16),
                      int(gamma.dtype == torch.bfloat16), float(eps), dev,
                      stream)
        if rc != 0:
            raise RuntimeError(f"in_modulate kernel launch failed: CUDA error "
                               f"{rc} at shape {tuple(zi.shape)}")
        self.launches += 1
        return out


IN_MODULATE = InModulateKernel()


def launch_counts() -> dict:
    return {"in_modulate": IN_MODULATE.launches}


def reset_launch_counts() -> None:
    IN_MODULATE.launches = 0


def build_all() -> dict:
    """Build every kernel of the port; returns {name: compiler output}."""
    return {"in_modulate": IN_MODULATE.library.build()}


def in_modulate_plain(zi, gamma, beta, eps: float = 1e-5):
    """The JAX package's non-Pallas SPADE interior: ``instance_norm`` (cast
    back to zi's dtype), then ``* (1 + gamma) + beta``."""
    return instance_norm(zi, eps) * (1.0 + gamma) + beta


def in_modulate_cuda(zi, gamma, beta, eps: float = 1e-5):
    """Launch the fused kernel on [N, C, H, W] CUDA tensors of equal shape."""
    for name, t in (("zi", zi), ("gamma", gamma), ("beta", beta)):
        if not t.is_cuda:
            raise ValueError(f"in_modulate_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != zi.device:
            raise ValueError("in_modulate_cuda: inputs on different devices")
        if t.dim() != 4 or t.shape != zi.shape:
            raise ValueError(f"in_modulate_cuda: {name} has shape "
                             f"{tuple(t.shape)}; need [N, C, H, W] equal to "
                             f"zi's {tuple(zi.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"in_modulate_cuda: {name} is not contiguous")
        if t.dtype not in _DTYPES:
            raise TypeError(f"in_modulate_cuda: {name} is {t.dtype}; the "
                            "kernel takes float32 or bfloat16")
    if gamma.dtype != beta.dtype:
        raise TypeError("in_modulate_cuda: gamma and beta differ in dtype")
    return IN_MODULATE(zi, gamma, beta, eps)


class InModulate(torch.autograd.Function):
    """The kernel as an autograd node (forward only for now)."""

    @staticmethod
    def forward(ctx, zi, gamma, beta, eps):
        return in_modulate_cuda(zi, gamma, beta, eps)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_NO_BACKWARD)


def in_modulate(zi, gamma, beta, eps: float = 1e-5):
    """instance_norm(zi) * (1 + gamma) + beta: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if zi.device.type == "cpu":
        return in_modulate_plain(zi, gamma, beta, eps)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (zi, gamma, beta)):
        raise NotImplementedError(_NO_BACKWARD)
    return InModulate.apply(zi, gamma, beta, eps)
