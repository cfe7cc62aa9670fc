"""The port's fused SPADE interior (ops/kernels.py) against the JAX Pallas
kernels.

On the CPU, ``in_modulate`` takes its plain version; the JAX side runs
``fused_instance_norm_modulate(..., interpret=True)``, i.e. the Pallas slab
kernel K1 (C a multiple of 128) or the packed-lane kernel K2 (small C) in
interpret mode, as tests/test_pallas.py does.  Tolerances: f32 atol 1e-5
(the Pallas kernels' one-pass variance against the plain two-pass one);
bf16 rtol 2e-2, atol 6e-2 (test_pallas.py: one rounding in the kernel,
several in the plain composition).

The CUDA kernel itself runs only on a card: see tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from representation_disentanglement_tpu.ops.pallas_kernels import (
    _dispatch, fused_instance_norm_modulate)
from representation_disentanglement_torch.ops import kernels

# NHWC shapes for JAX, with the Pallas layout they dispatch to
SHAPES = [((3, 8, 16, 128), "slab"), ((2, 40, 48, 128), "slab"),
          ((2, 40, 48, 64), "packed"), ((2, 16, 16, 8), "packed")]


def _inputs(shape, dtype, seed):
    rs = np.random.default_rng(seed)
    zi = (1.5 + 2.0 * rs.normal(size=shape)).astype(np.float32)
    gamma = (0.5 * rs.normal(size=shape)).astype(np.float32)
    beta = (0.5 * rs.normal(size=shape)).astype(np.float32)
    # round once through torch's bf16 so both sides see the same values
    return [torch.from_numpy(np.moveaxis(a, -1, 1).copy()).to(dtype)
            for a in (zi, gamma, beta)]


def _jax(t):
    a = np.moveaxis(t.float().numpy(), 1, -1)
    return jnp.asarray(a).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kind", SHAPES)
def test_in_modulate_matches_pallas(shape, kind, dtype):
    zi, gamma, beta = _inputs(shape, dtype, seed=sum(shape))
    jz, jg, jb = _jax(zi), _jax(gamma), _jax(beta)
    assert _dispatch(jz) == kind
    before = kernels.launch_counts()["in_modulate"]
    want = fused_instance_norm_modulate(jz, jg, jb, interpret=True)
    got = kernels.in_modulate(zi, gamma, beta)
    assert got.dtype == dtype
    assert kernels.launch_counts()["in_modulate"] == before   # plain on CPU
    want = np.moveaxis(np.asarray(want, np.float32), -1, 1)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=6e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_in_modulate_plain_is_the_jax_plain_path():
    """in_modulate_plain == JAX instance_norm(zi) * (1 + gamma) + beta,
    including the cast of the normalized zi back to bf16."""
    from representation_disentanglement_tpu.ops import instance_norm
    zi, gamma, beta = _inputs((2, 6, 10, 32), torch.bfloat16, seed=3)
    jz, jg, jb = _jax(zi), _jax(gamma), _jax(beta)
    want = np.asarray(instance_norm(jz) * (1.0 + jg) + jb, np.float32)
    got = kernels.in_modulate_plain(zi, gamma, beta).float().numpy()
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 1), rtol=2 ** -7,
                               atol=2 ** -7)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back: a CPU tensor is an error."""
    zi, gamma, beta = _inputs((1, 4, 4, 8), torch.float32, seed=1)
    before = kernels.launch_counts()["in_modulate"]
    with pytest.raises(ValueError, match="not a CUDA device"):
        kernels.in_modulate_cuda(zi, gamma, beta)
    assert kernels.launch_counts()["in_modulate"] == before
