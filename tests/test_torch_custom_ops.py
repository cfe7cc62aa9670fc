"""The port's kernels as torch custom ops (``rdt::in_modulate``,
``rdt::in_modulate_bwd``, ``rdt::bn_stats``, ``rdt::bn_norm``), on the CPU.

- ``torch.library.opcheck`` of each op (schema, fake implementation,
  autograd registration, AOT dispatch), f32 and bf16;
- each op against its plain version: the CPU implementation is the plain
  version, so they are equal;
- the gradient through ``rdt::in_modulate`` (its registered backward,
  ``rdt::in_modulate_bwd``) against autograd of the plain composition: f32
  rtol 1e-5 / atol 1e-5 (the two are the same formula in another order);
  bf16 within one bf16 ulp of the larger magnitude plus 1e-2 (autograd
  rounds each intermediate of the composition to bf16, the op once);
- the fused BatchNorm through ``rdt::bn_stats`` / ``rdt::bn_norm`` against
  autograd of ``bn_train_fused_plain``, f32 rtol 1e-5 / atol 1e-5;
- the binding has no plain path for a CUDA tensor: each op's CUDA key holds
  the ctypes launcher and no composite kernel stands behind it; the
  launchers refuse a tensor that is not on a card, and the kernel library
  raises where ``nvcc`` is missing (this machine has neither a card nor
  ``nvcc``).
"""

import numpy as np
import pytest
import torch

from representation_disentanglement_torch.ops import fused_bn, kernels

OPS = ("in_modulate", "in_modulate_bwd", "bn_stats", "bn_norm")


def _sp(shape, dtype, seed, offset=0.0):
    rs = np.random.default_rng(seed)
    return torch.from_numpy((offset + rs.normal(size=shape)).astype(
        np.float32)).to(dtype)


def _spade(dtype, seed=0, grad=False):
    shape = (3, 4, 6, 10)
    t = [_sp(shape, dtype, seed, 1.5), 0.5 * _sp(shape, dtype, seed + 1),
         0.5 * _sp(shape, dtype, seed + 2)]
    return [x.requires_grad_(grad) for x in t]


def _bn(dtype, seed=0):
    x = _sp((2, 3, 4, 5, 6), dtype, seed, 0.5)
    scale, bias = _sp((4,), torch.float32, seed + 1), _sp(
        (4,), torch.float32, seed + 2)
    return x, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck(dtype):
    zi, gamma, beta = _spade(dtype, grad=True)
    torch.library.opcheck(torch.ops.rdt.in_modulate.default,
                          (zi, gamma, beta, 1e-5))
    torch.library.opcheck(torch.ops.rdt.in_modulate_bwd.default,
                          (zi.detach(), gamma.detach(),
                           _sp(zi.shape, dtype, 9), 1e-5))
    x, scale, bias = _bn(dtype)
    torch.library.opcheck(torch.ops.rdt.bn_stats.default, (x,))
    mean, var = fused_bn.bn_stats_plain(x)
    torch.library.opcheck(torch.ops.rdt.bn_norm.default,
                          (x.requires_grad_(), mean, var,
                           scale.requires_grad_(), bias.requires_grad_(),
                           1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_are_their_plain_versions_on_the_cpu(dtype):
    zi, gamma, beta = _spade(dtype)
    g = _sp(zi.shape, dtype, 5)
    before = kernels.launch_counts()
    assert torch.equal(torch.ops.rdt.in_modulate(zi, gamma, beta, 1e-5),
                       kernels.in_modulate_plain(zi, gamma, beta))
    got = torch.ops.rdt.in_modulate_bwd(zi, gamma, g, 1e-5)
    want = kernels.in_modulate_bwd_plain(zi, gamma, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want[:2]))
    x, scale, bias = _bn(dtype)
    mean, var = torch.ops.rdt.bn_stats(x)
    assert (mean.shape, mean.dtype) == ((2, 4), torch.float32)
    want = fused_bn.bn_stats_plain(x)
    assert torch.equal(mean, want[0]) and torch.equal(var, want[1])
    assert torch.equal(torch.ops.rdt.bn_norm(x, mean, var, scale, bias,
                                             1e-5),
                       fused_bn.bn_norm_plain(x, mean, var, scale, bias))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_modulate_gradient_matches_autograd_of_plain(dtype):
    zi, gamma, beta = _spade(dtype, seed=4, grad=True)
    g = _sp(zi.shape, dtype, 8)
    got = torch.autograd.grad(kernels.in_modulate(zi, gamma, beta),
                              (zi, gamma, beta), g)
    want = torch.autograd.grad(kernels.in_modulate_plain(zi, gamma, beta),
                               (zi, gamma, beta), g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        a, b = a.float(), b.float()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            ulp = 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
            assert bool(((a - b).abs() <= ulp + 1e-2).all())


def test_fused_bn_gradient_matches_autograd_of_plain():
    x, scale, bias = _bn(torch.float32, seed=3)
    gy = _sp(x.shape, torch.float32, 11)
    params = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y, mean, var = fused_bn.bn_train_fused(
        params[0].reshape(-1, *x.shape[2:]), params[1], params[2], 1e-5,
        groups=2)
    assert not mean.requires_grad and not var.requires_grad
    got = torch.autograd.grad(y, params, gy.reshape(y.shape))
    ref = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want = torch.autograd.grad(fused_bn.bn_train_fused_plain(*ref)[0], ref,
                               gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_a_cuda_tensor_has_no_plain_path(monkeypatch):
    for name in OPS:
        op = f"rdt::{name}"
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
        for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd"):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(op,
                                                                      key)
    zi, gamma, beta = _spade(torch.float32)
    x, scale, bias = _bn(torch.float32)
    mean, var = fused_bn.bn_stats_plain(x)
    for call in (lambda: kernels.in_modulate_cuda(zi, gamma, beta),
                 lambda: kernels.in_modulate_bwd_cuda(zi, gamma, beta),
                 lambda: fused_bn.bn_stats_cuda(x),
                 lambda: fused_bn.bn_norm_cuda(x, mean, var, scale, bias)):
        with pytest.raises(ValueError, match="not a CUDA device"):
            call()
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    library = kernels.CudaLibrary("in_modulate.cu")
    monkeypatch.setattr(library, "_target",
                        lambda: kernels.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        library.build()
    assert kernels.LIBRARY._lib is None and kernels.BN_LIBRARY._lib is None
