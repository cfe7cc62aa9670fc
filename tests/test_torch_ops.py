"""The port's ops (representation_disentanglement_torch.ops) against their
JAX counterparts, on the CPU, with the same seeded numpy inputs.

JAX works on NHWC, the port on NCHW; each test moves the channel axis.
f32 tolerance: atol 1e-5 (summation order only).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from representation_disentanglement_tpu import ops as jops
from representation_disentanglement_tpu.ops import resize as jresize
from representation_disentanglement_torch import ops as tops
from representation_disentanglement_torch.ops import resize as tresize

ATOL = 1e-5


def _nchw(a):
    return np.moveaxis(np.asarray(a, np.float32), -1, -3)


def _nhwc(a):
    return np.moveaxis(np.asarray(a), -3, -1)


@pytest.fixture
def rs():
    return np.random.default_rng(20)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("hw,out_hw", [((5, 6), (10, 12)),    # x2 up
                                       ((10, 12), (5, 6)),    # x2 down
                                       ((4, 4), (7, 9)),      # non-integer
                                       ((1, 2), (5, 6)),      # in_size 1
                                       ((160, 192), (5, 6))])  # SPADE sp1
def test_bilinear_resize_matches_jax(rs, align, hw, out_hw):
    x = rs.normal(size=(2, 3, *hw)).astype(np.float32)
    want = jops.bilinear_resize(jnp.asarray(_nhwc(x)), out_hw,
                                align_corners=align)
    got = tops.bilinear_resize(torch.from_numpy(x), out_hw,
                               align_corners=align)
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=ATOL)


@pytest.mark.parametrize("align,dyadic", [(False, True), (True, False)])
def test_bilinear_resize_bf16_branches_match_jax(rs, align, dyadic):
    """x2 with align_corners=False has dyadic weights (bf16 products,
    f32 accumulation); x2 with align_corners=True does not (f32 weights,
    one bf16 rounding between the passes).  Both packages compute the same
    f32 sums and round at the same two places, so the outputs agree to one
    bf16 ulp (rtol 2**-7) where summation order tips a rounding."""
    hw, out_hw = (10, 12), (20, 24)
    assert tresize._weights_exact_in_bf16(hw[0], out_hw[0], align) == dyadic
    assert jresize._weights_exact_in_bf16(hw[0], out_hw[0], align) == dyadic
    x = rs.normal(size=(2, 3, *hw)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jops.bilinear_resize(
        jnp.asarray(_nhwc(xb.float().numpy())).astype(jnp.bfloat16), out_hw,
        align_corners=align)
    got = tops.bilinear_resize(xb, out_hw, align_corners=align)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _nchw(want),
                               rtol=2.0 ** -7, atol=1e-6)


def _fresh_matrix(key):
    """The uncached matrix of a cache key."""
    n_in, n_out, align, device, dtype = key
    return torch.from_numpy(tresize._resize_matrix_np(n_in, n_out, align)) \
        .to(device=device, dtype=dtype)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_matrix_cache_hits_bit_equal(rs, dtype, align):
    """The first resize at a shape makes its two matrices (two misses),
    the second takes them from the cache (two hits, no miss) and returns
    the same bits; each cached matrix equals the uncached one bit for bit,
    in the dtype of its branch (bf16 products only for dyadic weights)."""
    tresize.clear_matrix_cache()
    x = torch.from_numpy(rs.normal(size=(2, 3, 10, 12)).astype(
        np.float32)).to(dtype)
    first = tresize.bilinear_resize(x, (20, 24), align_corners=align)
    assert tresize.matrix_cache_info() == {"hits": 0, "misses": 2,
                                           "size": 2}
    second = tresize.bilinear_resize(x, (20, 24), align_corners=align)
    assert tresize.matrix_cache_info() == {"hits": 2, "misses": 2,
                                           "size": 2}
    assert torch.equal(first, second) and first.dtype == dtype
    branch = torch.bfloat16 if (dtype == torch.bfloat16 and not align) \
        else torch.float32
    for key, m in tresize._MATRICES.items():
        assert key[2] == align and key[4] == branch
        assert m.dtype == branch and torch.equal(m, _fresh_matrix(key))


def test_resize_matrix_made_in_inference_mode_serves_backward(rs):
    """A matrix first made under ``torch.inference_mode()`` (a serve step)
    is a plain tensor: a later train-mode resize takes it from the cache
    and its backward runs."""
    tresize.clear_matrix_cache()
    x = torch.from_numpy(rs.normal(size=(2, 3, 5, 6)).astype(np.float32))
    with torch.inference_mode():
        served = tresize.bilinear_resize(x, (10, 12), align_corners=True)
    assert all(not m.is_inference() for m in tresize._MATRICES.values())
    xg = x.clone().requires_grad_(True)
    y = tresize.bilinear_resize(xg, (10, 12), align_corners=True)
    y.square().sum().backward()
    assert tresize.matrix_cache_info()["hits"] == 2
    assert torch.equal(y.detach(), served)
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


def test_export_neither_reads_nor_fills_the_matrix_cache(rs):
    """``torch.export`` (as ``utils/aot.export_serve_step`` runs it) traces
    with fake tensors: it leaves the cache as it found it, with no hit, no
    miss and no new entry, and its program holds the matrices as
    constants.  A real resize after it returns a real tensor equal to the
    uncached product."""
    from torch._subclasses.fake_tensor import is_fake

    class Up(torch.nn.Module):
        def forward(self, x):
            return tresize.bilinear_resize(x, (10, 12), align_corners=True)

    tresize.clear_matrix_cache()
    x = torch.from_numpy(rs.normal(size=(1, 2, 5, 6)).astype(np.float32))
    tresize.bilinear_resize(x, (7, 9))              # one warm entry pair
    before = tresize.matrix_cache_info()
    with torch.no_grad():
        program = torch.export.export(Up(), (x,), strict=False)
    assert tresize.matrix_cache_info() == before
    got = Up()(x)
    assert type(got) is torch.Tensor and not is_fake(got)
    assert all(type(m) is torch.Tensor and not is_fake(m)
               for m in tresize._MATRICES.values())
    rh = _fresh_matrix((5, 10, True, x.device, torch.float32))
    rw = _fresh_matrix((6, 12, True, x.device, torch.float32))
    want = torch.einsum("Ww,...hw->...hW", rw,
                        torch.einsum("Hh,...hw->...Hw", rh, x))
    assert torch.equal(got, want)
    assert torch.equal(program.module()(x), want)


@pytest.mark.parametrize("shape", [(3, 5, 8, 9), (2, 4, 1, 2)])
def test_instance_norm_matches_jax(rs, shape):
    x = (2.0 + 3.0 * rs.normal(size=shape)).astype(np.float32)
    want = jops.instance_norm(jnp.asarray(_nhwc(x)))
    got = tops.instance_norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=ATOL)


def test_batch_norm_apply_matches_jax(rs):
    C = 6
    x = rs.normal(size=(4, C, 5, 7)).astype(np.float32)
    mean, scale, bias = (rs.normal(size=C).astype(np.float32)
                         for _ in range(3))
    var = rs.uniform(0.5, 2.0, size=C).astype(np.float32)
    want = jops.batch_norm_apply(jnp.asarray(_nhwc(x)), jnp.asarray(mean),
                                 jnp.asarray(var), jnp.asarray(scale),
                                 jnp.asarray(bias))
    t = torch.from_numpy
    got = tops.batch_norm_apply(t(x), t(mean), t(var), t(scale), t(bias))
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=ATOL)


@pytest.mark.parametrize("name", ["identity", "no", "lrelu", "relu", "elu",
                                  "sigmoid", "tanh", "softplus"])
def test_apply_act_matches_jax(rs, name):
    x = (3.0 * rs.normal(size=(4, 5))).astype(np.float32)
    want = jops.apply_act(jnp.asarray(x), name)
    got = tops.apply_act(torch.from_numpy(x), name)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("fix", [False, True])
def test_resolve_block_act_matches_jax(fix):
    for name in ("lrelu", "relu", "elu", "no", "softplus", "tanh"):
        assert tops.resolve_block_act(name, fix) == \
            jops.resolve_block_act(name, fix)
    # quirk Q1: every block activation but 'elu' is the identity
    assert tops.resolve_block_act("lrelu") == "identity"
    with pytest.raises(ValueError):
        tops.apply_act(torch.zeros(1), "swish")


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (4, 2, 1), (1, 1, 0)])
def test_cond_conv_matches_jax(rs, k, stride, pad):
    """cond_route + mix_experts + modality_conv2d with per-group types:
    G=3 groups (types 1..3), E=3 experts, one kernel mixed per group."""
    G, B, Ci, Co, E, emb = 3, 2, 5, 4, 3, 1
    x = rs.normal(size=(G, B, Ci, 12, 10)).astype(np.float32)
    experts = rs.normal(size=(E, Co, Ci, k, k)).astype(np.float32)  # torch
    fc_w = rs.normal(size=(E, emb)).astype(np.float32)              # torch
    fc_b = rs.normal(size=E).astype(np.float32)
    bias = rs.normal(size=Co).astype(np.float32)
    types = np.arange(1, G + 1, dtype=np.float32)[:, None]

    j_route = jops.cond_route(jnp.asarray(types), jnp.asarray(fc_w.T),
                              jnp.asarray(fc_b))
    j_kern = jops.mix_experts(j_route, jnp.asarray(
        np.transpose(experts, (0, 3, 4, 2, 1))))
    want = jops.modality_conv2d(jnp.asarray(_nhwc(x)), j_kern,
                                jnp.asarray(bias), stride, pad)

    t = torch.from_numpy
    route = tops.cond_route(t(types), t(fc_w), t(fc_b))
    np.testing.assert_allclose(route.numpy(), np.asarray(j_route), atol=ATOL)
    kern = tops.mix_experts(route, t(experts))
    np.testing.assert_allclose(
        kern.numpy(), np.transpose(np.asarray(j_kern), (0, 4, 3, 1, 2)),
        atol=ATOL)
    got = tops.modality_conv2d(t(x.reshape(G * B, Ci, 12, 10)), kern, t(bias),
                               stride, pad)
    np.testing.assert_allclose(got.numpy().reshape(G, B, *got.shape[1:]),
                               _nchw(want), atol=ATOL)


def test_conv2d_matches_jax(rs):
    x = rs.normal(size=(2, 3, 9, 8)).astype(np.float32)
    w = rs.normal(size=(5, 3, 3, 3)).astype(np.float32)
    b = rs.normal(size=5).astype(np.float32)
    want = jops.conv2d(jnp.asarray(_nhwc(x)),
                       jnp.asarray(np.transpose(w, (2, 3, 1, 0))),
                       jnp.asarray(b), 2, 1)
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), 2, 1)
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=ATOL)
