"""Hand-written CUDA kernels of the port, and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  The fused SPADE
interior ``in_modulate`` (instance-norm of the z-stream, then the gamma/beta
modulation) runs as CUDA kernels for Hopper in ``csrc/in_modulate.cu``: the
forward replaces the Pallas kernels ``_kernel`` and ``_packed_kernel``, the
backward (``in_modulate_bwd``) replaces ``_bwd_kernel`` and
``_packed_bwd_kernel``.  This module also binds the fused BatchNorm kernels
of ``csrc/bn_train.cu`` (``bn_stats``, ``bn_norm``); their wrappers live in
``ops/fused_bn.py``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, into the
package's ``_build/`` directory, and called through ``ctypes`` with a plain C
interface.  Nothing is compiled or loaded when this module is imported.

Binding: the kernels are the torch custom ops ``rdt::in_modulate`` and
``rdt::in_modulate_bwd`` (``torch.library.custom_op``), so that a traced
graph (``torch.export``, utils/aot.py) holds the op, not a Python branch.
Each op's CUDA implementation is the ctypes launch, its CPU implementation
the plain version; a fake implementation gives shapes and dtypes to the
tracer.  ``rdt::in_modulate``'s backward (``register_autograd``) calls
``rdt::in_modulate_bwd`` on every device, and dbeta, the cotangent in
gamma's dtype, is made outside the op, since an op may not return an alias
of its input.  A CUDA tensor reaches the kernel or raises; there is no
fallback from one to the other.
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


LIBRARY = CudaLibrary("in_modulate.cu")
BN_LIBRARY = CudaLibrary("bn_train.cu")
_LIBRARIES = (LIBRARY, BN_LIBRARY)
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class CudaKernel:
    """ctypes binding of one ``extern "C"`` entry point with a launch
    counter.  ``launch(*args)`` calls it (binding on first use), raises if
    it returns a CUDA error, and only then counts the launch."""

    def __init__(self, library: CudaLibrary, symbol: str, argtypes):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def launch(self, *args, shape) -> None:
        if self._fn is None:
            self._fn = self.library.fn(self.symbol, self.argtypes)
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{rc} at shape {tuple(shape)}")
        self.launches += 1


class InModulateKernel(CudaKernel):
    """An entry point of ``in_modulate.cu``.  It takes ``n_in`` input
    tensors (zi, gamma, ...) and one output per letter of ``out_like``, all
    of zi's shape: 'z' for an output in zi's dtype, 'g' for one in
    gamma's."""

    def __init__(self, symbol: str, n_in: int, out_like):
        super().__init__(LIBRARY, symbol, [_P] * (n_in + len(out_like)) + [
            _I64, _I64, _I32, _I32, ctypes.c_float, _I32, _P])
        self.out_like = tuple(out_like)

    def __call__(self, zi, gamma, *rest, eps):
        outs = [torch.empty_like(zi, dtype=(zi if k == "z" else gamma).dtype)
                for k in self.out_like]
        n, c, h, w = zi.shape
        if zi.numel() == 0:
            return outs
        stream = torch.cuda.current_stream(zi.device).cuda_stream
        ptrs = [t.data_ptr() for t in (zi, gamma, *rest, *outs)]
        self.launch(*ptrs, n * c, h * w, int(zi.dtype == torch.bfloat16),
                    int(gamma.dtype == torch.bfloat16), float(eps),
                    zi.device.index, stream, shape=zi.shape)
        return outs


IN_MODULATE = InModulateKernel("rdt_in_modulate", 3, "z")
IN_MODULATE_BWD = InModulateKernel("rdt_in_modulate_bwd", 3, "zg")
# rdt_bn_stats(x, mean, var, G, B, C, H*W, x_bf16, vec, vt, ct, streams,
#              threads, device, stream); the plan is fused_bn.bn_plan's
BN_STATS = CudaKernel(BN_LIBRARY, "rdt_bn_stats",
                      [_P] * 3 + [_I64] * 4 + [_I32] * 7 + [_P])
# rdt_bn_norm(x, mean, var, scale, bias, y, G, B, C, H*W, x_bf16, p_bf16,
#             eps, vec, device, stream); vec is fused_bn.bn_vec's
BN_NORM = CudaKernel(BN_LIBRARY, "rdt_bn_norm",
                     [_P] * 6 + [_I64] * 4 + [_I32, _I32, ctypes.c_float]
                     + [_I32] * 2 + [_P])
# rdt_bn_empty(blocks, threads, device, stream): an empty kernel launched
# as the BatchNorm kernels are, the floor of a launch for chip_smoke.py's
# timings; not a kernel of any path, so not counted below
BN_EMPTY = CudaKernel(BN_LIBRARY, "rdt_bn_empty", [_I64, _I32, _I32, _P])
_KERNELS = {"in_modulate": IN_MODULATE, "in_modulate_bwd": IN_MODULATE_BWD,
            "bn_stats": BN_STATS, "bn_norm": BN_NORM}


def launch_counts() -> dict:
    return {name: k.launches for name, k in _KERNELS.items()}


def reset_launch_counts() -> None:
    for k in _KERNELS.values():
        k.launches = 0


def build_all() -> dict:
    """Build every kernel of the port; returns {source: compiler output}.
    The sources compile in parallel, one ``nvcc`` each."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(_LIBRARIES)) as pool:
        logs = list(pool.map(CudaLibrary.build, _LIBRARIES))
    return {lib.source.name: log for lib, log in zip(_LIBRARIES, logs)}


def in_modulate_plain(zi, gamma, beta, eps: float = 1e-5):
    """The JAX package's non-Pallas SPADE interior: ``instance_norm`` (cast
    back to zi's dtype), then ``* (1 + gamma) + beta``."""
    return instance_norm(zi, eps) * (1.0 + gamma) + beta


def in_modulate_bwd_plain(zi, gamma, g, eps: float = 1e-5):
    """The backward of ``in_modulate`` for the cotangent g, in plain
    PyTorch (the JAX package's XLA backward, pallas_kernels.py:295-308):
    f32 two-pass statistics, dzin = g (1 + gamma),
    dz = rstd (dzin - mean(dzin) - zin mean(dzin zin)), dgamma = g zin,
    dbeta = g.  Returns (dz in zi's dtype, dgamma and dbeta in gamma's)."""
    z = zi.float()
    g32 = g.float()
    mean = z.mean(dim=(-2, -1), keepdim=True)
    var = (z - mean).square().mean(dim=(-2, -1), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    zin = (z - mean) * rstd
    dzin = g32 * (1.0 + gamma.float())
    m1 = dzin.mean(dim=(-2, -1), keepdim=True)
    m2 = (dzin * zin).mean(dim=(-2, -1), keepdim=True)
    dz = rstd * (dzin - m1 - zin * m2)
    return (dz.to(zi.dtype), (g32 * zin).to(gamma.dtype),
            g32.to(gamma.dtype))


def _check_cuda(fn: str, ref, named) -> None:
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}, not a CUDA "
                             "device")
        if t.device != ref.device:
            raise ValueError(f"{fn}: inputs on different devices")
        if t.dim() != 4 or t.shape != ref.shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}; need "
                             f"[N, C, H, W] equal to zi's {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel takes "
                            "float32 or bfloat16")


def in_modulate_cuda(zi, gamma, beta, eps: float = 1e-5):
    """Launch the fused kernel on [N, C, H, W] CUDA tensors of equal shape."""
    _check_cuda("in_modulate_cuda", zi,
                (("zi", zi), ("gamma", gamma), ("beta", beta)))
    if gamma.dtype != beta.dtype:
        raise TypeError("in_modulate_cuda: gamma and beta differ in dtype")
    return IN_MODULATE(zi, gamma, beta, eps=eps)[0]


def in_modulate_bwd_cuda(zi, gamma, g, eps: float = 1e-5):
    """Launch the backward kernel on [N, C, H, W] CUDA tensors of equal
    shape; g (the cotangent of the output) has zi's dtype.  Returns
    (dz in zi's dtype, dgamma in gamma's); dbeta, g in gamma's dtype, is
    the caller's."""
    _check_cuda("in_modulate_bwd_cuda", zi,
                (("zi", zi), ("gamma", gamma), ("g", g)))
    if g.dtype != zi.dtype:
        raise TypeError("in_modulate_bwd_cuda: g and zi differ in dtype")
    dz, dgamma = IN_MODULATE_BWD(zi, gamma, g, eps=eps)
    return dz, dgamma


@torch.library.custom_op("rdt::in_modulate", mutates_args=(),
                         device_types="cuda")
def _in_modulate_op(zi: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float) -> torch.Tensor:
    return in_modulate_cuda(zi, gamma, beta, eps)


@_in_modulate_op.register_kernel("cpu")
def _(zi, gamma, beta, eps):
    return in_modulate_plain(zi, gamma, beta, eps)


@_in_modulate_op.register_fake
def _(zi, gamma, beta, eps):
    return torch.empty_like(zi)


@torch.library.custom_op("rdt::in_modulate_bwd", mutates_args=(),
                         device_types="cuda")
def _in_modulate_bwd_op(zi: torch.Tensor, gamma: torch.Tensor,
                        g: torch.Tensor, eps: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    return in_modulate_bwd_cuda(zi, gamma, g, eps)


@_in_modulate_bwd_op.register_kernel("cpu")
def _(zi, gamma, g, eps):
    dz, dgamma, _ = in_modulate_bwd_plain(zi, gamma, g, eps)
    return dz, dgamma


@_in_modulate_bwd_op.register_fake
def _(zi, gamma, g, eps):
    return torch.empty_like(zi), torch.empty_like(zi, dtype=gamma.dtype)


def _in_modulate_setup(ctx, inputs, output):
    zi, gamma, _, eps = inputs
    ctx.save_for_backward(zi, gamma)       # the JAX custom VJP's residuals
    ctx.eps = eps


def _in_modulate_backward(ctx, grad):
    zi, gamma = ctx.saved_tensors
    g = grad.to(zi.dtype).contiguous()
    dz, dgamma = torch.ops.rdt.in_modulate_bwd(zi, gamma, g, ctx.eps)
    return dz, dgamma, g.to(gamma.dtype), None


_in_modulate_op.register_autograd(_in_modulate_backward,
                                  setup_context=_in_modulate_setup)


def in_modulate(zi, gamma, beta, eps: float = 1e-5):
    """instance_norm(zi) * (1 + gamma) + beta through ``rdt::in_modulate``:
    the plain version for CPU tensors, the CUDA kernels (forward and
    backward) for CUDA tensors."""
    return torch.ops.rdt.in_modulate(zi, gamma, beta, float(eps))
