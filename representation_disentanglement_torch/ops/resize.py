"""Bilinear resize as two matrix products over the H and W axes.

The reference mixes two conventions (quirk Q7): ``align_corners=True`` in
the U-Net up blocks and ``align_corners=False`` in SPADE and the attention
gates.  The interpolation matrices are built with numpy exactly as the JAX
package builds them, and applied H pass first, then W pass, so an f32
result matches the JAX one to rounding.

bf16 keeps the JAX package's two branches: where every weight is exact in
bf16 (all the model's x2 resamples), both products run in bf16 with f32
accumulation; otherwise the weights stay f32 and only the intermediate
between the two passes is rounded to bf16.  Either way the result carries
exactly one extra bf16 rounding against the f32 interior.

The matrices live in a cache of tensors keyed by ``(in_size, out_size,
align_corners, device, dtype)``: the first call for a key copies the
matrix to its device once (the ``rdt.resize.upload`` span), and every
later call takes the cached tensor, so a warm resize neither copies from
the host nor waits for the stream.  ``matrix_cache_info()`` counts the
hits and misses.  Every caller shares an entry, and none writes to it.
Entries are plain tensors, made outside inference mode, so that a matrix
first made while serving still serves a training backward.  While ``torch.compile`` or ``torch.export`` traces, the cache
is neither read nor filled: the matrix is built in the traced program as
a constant, and no traced tensor reaches a later real call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from representation_disentanglement_torch.utils.profiling import span


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int, align_corners: bool):
    """[out_size, in_size] bilinear interpolation matrix (float32), with
    torch ``F.interpolate(mode='bilinear')`` source-index math."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for dst in range(out_size):
        if align_corners:
            src = dst * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = max((dst + 0.5) * in_size / out_size - 0.5, 0.0)
        lo = min(int(np.floor(src)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        w_hi = src - lo
        m[dst, lo] += 1.0 - w_hi
        m[dst, hi] += w_hi
    return m


@functools.lru_cache(maxsize=None)
def _weights_exact_in_bf16(in_size: int, out_size: int,
                           align_corners: bool) -> bool:
    # an f32 value is a bf16 value when its low 16 bits are zero (in
    # numpy, so that a traced forward, torch.export's, sees no tensor op)
    m = _resize_matrix_np(in_size, out_size, align_corners)
    return not (m.view(np.uint32) & 0xFFFF).any()


_MATRICES = {}
_COUNTS = {"hits": 0, "misses": 0}


def matrix_cache_info() -> dict:
    """{hits, misses, size} of the device matrix cache since the last
    ``clear_matrix_cache``."""
    return dict(_COUNTS, size=len(_MATRICES))


def clear_matrix_cache() -> None:
    _MATRICES.clear()
    _COUNTS.update(hits=0, misses=0)


def _matrix(in_size, out_size, align_corners, device, dtype):
    m = _resize_matrix_np(in_size, out_size, bool(align_corners))
    if torch.compiler.is_compiling():
        return torch.from_numpy(m).to(device=device, dtype=dtype)
    key = (in_size, out_size, bool(align_corners), device, dtype)
    t = _MATRICES.get(key)
    if t is not None:
        _COUNTS["hits"] += 1
        return t
    _COUNTS["misses"] += 1
    with span("rdt.resize.upload"), torch.inference_mode(False):
        t = _MATRICES[key] = torch.from_numpy(m).to(device=device,
                                                    dtype=dtype)
    return t


def bilinear_resize(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize the last two dims of [..., H, W]."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    with span("rdt.resize"):
        dev = x.device
        if (x.dtype == torch.bfloat16
                and _weights_exact_in_bf16(h_in, h_out, bool(align_corners))
                and _weights_exact_in_bf16(w_in, w_out, bool(align_corners))):
            rh = _matrix(h_in, h_out, align_corners, dev, torch.bfloat16)
            rw = _matrix(w_in, w_out, align_corners, dev, torch.bfloat16)
            y = torch.einsum("Hh,...hw->...Hw", rh, x)
            return torch.einsum("Ww,...hw->...hW", rw, y)
        rh = _matrix(h_in, h_out, align_corners, dev, torch.float32)
        rw = _matrix(w_in, w_out, align_corners, dev, torch.float32)
        y = torch.einsum("Hh,...hw->...Hw", rh, x.float())
        if x.dtype == torch.bfloat16:
            y = y.to(torch.bfloat16).float()
        y = torch.einsum("Ww,...hw->...hW", rw, y)
        return y.to(x.dtype)
