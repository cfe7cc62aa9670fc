"""The port's 3D stack (``ops/conv3d.py``, ``models/unet3d.py``,
``weights.from_jax_nvnet3d``) against the JAX package's, on the CPU in f32.

The JAX parameters are built from the port's torch initialization by the
inverse of ``from_jax_nvnet3d`` (``to_jax_nvnet3d`` below, written apart
from it), so no JAX initialization is compiled.  Volumes are [B, C, H, W,
D] in the port and [B, D, H, W, C] in the JAX package; every comparison
transposes the JAX side.

Model: 2 contrasts, ``init_channels`` 8.  The eval forward runs at (H, W,
D) = (32, 16, 32), where the VAE's reconstruction layer decodes a 2x1x2
grid, so that its feature permutation is not the identity; the gradients
at 16x16x16, batch 2.

Tolerances, each against the largest magnitude of the tensor compared:
ops and the loss 1e-5, the forward outputs 1e-4, each parameter's gradient
1e-4 (measured on a CPU: ops at most 7.9e-7, forward 3.9e-6, loss terms
4.0e-7, gradients 3.6e-5).  At width 8 a GroupNorm of 8 groups has one
channel per group, so it cancels the bias of the convolution before it:
the gradients of those biases (``conv1`` of each width-8 block) are zero
up to rounding (about 5e-9) and are held against the largest gradient
entry of the model instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.models import unet3d as junet
from representation_disentanglement_tpu.ops import conv3d as jconv
from representation_disentanglement_torch.models import unet3d as tunet
from representation_disentanglement_torch.ops import conv3d as tconv
from representation_disentanglement_torch.weights import from_jax_nvnet3d
from test_torch_dump import few_threads  # noqa: F401 (autouse fixture)

M, F = 2, 8
OP_TOL, FWD_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4


def to_jax(x):
    """[B, C, H, W, D] (port) <-> [B, D, H, W, C] (JAX): an involution."""
    return np.transpose(np.asarray(x), (0, 4, 2, 3, 1))


def assert_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest entry > {tol}"


def to_jax_nvnet3d(sd, input_shape_hwd):
    """The port's state_dict -> the JAX NVNet3D params tree (the layout of
    tests/test_unet3d.py's transplant, at any size)."""
    sd = {k: v.detach().numpy().copy() for k, v in sd.items()}
    conv = lambda t: {"kernel": np.transpose(sd[f"{t}.weight"],
                                             (4, 2, 3, 1, 0)),
                      "bias": sd[f"{t}.bias"]}
    gn = lambda t: {"scale": sd[f"{t}.weight"], "bias": sd[f"{t}.bias"]}
    lin = lambda t: {"kernel": sd[f"{t}.weight"].T, "bias": sd[f"{t}.bias"]}

    def block(t):
        return {"gn1": gn(f"{t}.gn1"), "conv1": conv(f"{t}.conv1"),
                "gn2": gn(f"{t}.gn2"), "conv2": conv(f"{t}.conv2")}

    unet = {n: conv(f"unet.{n}") for n in (
        "conv1a", "ds1", "ds2", "ds3", "up4conva", "up3conva", "up2conva",
        "up1conv")}
    unet.update({n: block(f"unet.{n}") for n in (
        "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a",
        "conv4b", "conv4c", "conv4d", "up4convb", "up3convb", "up2convb")})
    h, w, d = (s // 16 for s in input_shape_hwd)
    rec = lin("vae_branch.reconstraction.0")
    n = rec["bias"].shape[0]
    # the reference unflattens (C, H/16, W/16, D/16), JAX (C, D/16, H/16,
    # W/16)
    perm = np.arange(n).reshape(n // (h * w * d), h, w, d).transpose(
        0, 3, 1, 2).ravel()
    vae = {"hidden_gn": gn("vae_branch.hidden_conv.0"),
           "hidden_conv": conv("vae_branch.hidden_conv.2"),
           "mu_fc": lin("vae_branch.mu_fc"),
           "logvar_fc": lin("vae_branch.logvar_fc"),
           "reconstruction": {"kernel": rec["kernel"][:, perm],
                              "bias": rec["bias"][perm]},
           "vconv4_conv": conv("vae_branch.vconv4.0"),
           "vconv3_conv": conv("vae_branch.vconv3.0"),
           "vconv3_block": block("vae_branch.vconv3.2"),
           "vconv2_conv": conv("vae_branch.vconv2.0"),
           "vconv2_block": block("vae_branch.vconv2.2"),
           "vconv1_conv": conv("vae_branch.vconv1.0"),
           "vconv1_block": block("vae_branch.vconv1.2"),
           "vconv0": conv("vae_branch.vconv0")}
    return {"unet": unet, "vae_branch": vae}


def models(hwd, seed=0, dropout_p=0.2):
    """(port model in eval mode, JAX model, JAX params) from one torch
    initialization; GroupNorm scales and biases made nonidentity."""
    tm = tunet.build_nvnet3d(hwd, M, 3, F, dropout_p, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if ".gn" in name or "hidden_conv.0" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    jm = junet.NVNet3D(input_shape=(hwd[2], hwd[0], hwd[1]), in_channels=M,
                       out_channels=3, init_channels=F, dropout_p=dropout_p)
    return tm, jm, to_jax_nvnet3d(tm.state_dict(), hwd)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv3d_matches_jax(k, stride, pad):
    rs = np.random.default_rng(k + stride)
    x = rs.normal(size=(2, 3, 8, 6, 4)).astype(np.float32)
    w = rs.normal(size=(5, 3, k, k, k)).astype(np.float32)
    b = rs.normal(size=(5,)).astype(np.float32)
    got = tconv.conv3d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                       stride, pad)
    want = jconv.conv3d(jnp.asarray(to_jax(x)),
                        jnp.asarray(np.transpose(w, (4, 2, 3, 1, 0))),
                        jnp.asarray(b), stride, pad)
    assert_close(got.numpy(), to_jax(want), OP_TOL, "conv3d")


@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_group_norm_matches_jax(offset):
    """Welford's variance (F.group_norm) against JAX's one-pass form, also
    on an input whose mean is three times its spread."""
    rs = np.random.default_rng(1)
    x = (offset + rs.normal(size=(2, 16, 6, 5, 4))).astype(np.float32)
    scale = rs.normal(size=(16,)).astype(np.float32)
    bias = rs.normal(size=(16,)).astype(np.float32)
    got = tconv.group_norm(torch.tensor(x), torch.tensor(scale),
                           torch.tensor(bias), 8)
    want = jconv.group_norm(jnp.asarray(to_jax(x)), jnp.asarray(scale),
                            jnp.asarray(bias), 8)
    assert_close(got.numpy(), to_jax(want), OP_TOL, "group_norm")


def test_global_mean_and_upsample_match_jax():
    rs = np.random.default_rng(2)
    x = rs.normal(size=(2, 3, 4, 6, 2)).astype(np.float32)
    assert_close(tconv.global_mean3d(torch.tensor(x)).numpy(),
                 jconv.global_mean3d(jnp.asarray(to_jax(x))), OP_TOL,
                 "global_mean3d")
    up = tconv.upsample3d_nearest(torch.tensor(x)).numpy()
    assert up.shape == (2, 3, 8, 12, 4)
    np.testing.assert_array_equal(
        up, to_jax(jconv.upsample3d_nearest(jnp.asarray(to_jax(x)))))


def test_forward_eval_matches_jax():
    hwd = (32, 16, 32)
    tm, jm, params = models(hwd)
    x = np.random.default_rng(3).normal(size=(2, M) + hwd).astype(
        np.float32)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v, train=False))(
        params, jnp.asarray(to_jax(x)))
    assert got[0].shape == (2, 3) + hwd and got[1].shape == (2, M) + hwd
    for name, g, w, spatial in zip(("uout", "vout", "mu", "logvar"), got,
                                   want, (True, True, False, False)):
        w = to_jax(w) if spatial else np.asarray(w)
        assert_close(g.numpy(), w, FWD_TOL, name)


def loss_inputs(seed=4, hwd=(8, 6, 4)):
    rs = np.random.default_rng(seed)
    uout = rs.normal(size=(2, 3) + hwd).astype(np.float32)
    vout = rs.normal(size=(2, M) + hwd).astype(np.float32)
    x = rs.normal(size=(2, M) + hwd).astype(np.float32)
    seg = rs.integers(0, 4, size=(2, 1) + hwd).astype(np.float32)
    mu = rs.normal(size=(2, 16)).astype(np.float32)
    lv = 0.3 * rs.normal(size=(2, 16)).astype(np.float32)
    return uout, vout, mu, lv, seg, x


def test_nvnet_loss_matches_jax():
    uout, vout, mu, lv, seg, x = loss_inputs()
    loss, aux = tunet.nvnet_loss(*map(torch.tensor, (uout, vout, mu, lv,
                                                     seg, x)), 0.3, 0.2)
    jloss, jaux = junet.nvnet_loss(
        jnp.asarray(to_jax(uout)), jnp.asarray(to_jax(vout)),
        jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(to_jax(seg)),
        jnp.asarray(to_jax(x)), 0.3, 0.2)
    assert loss.dtype == torch.float32
    assert_close(loss.item(), float(jloss), OP_TOL, "loss")
    for k in ("dice_loss", "vae_recon", "kl"):
        assert_close(aux[k].item(), float(jaux[k]), OP_TOL, k)


def test_gradients_match_jax_in_train_mode():
    """Train mode without randomness (``generator=None`` / ``rng=None``:
    z = mu, no dropout), so both sides compute the same loss; every
    parameter's gradient within GRAD_TOL of its largest entry."""
    hwd = (16, 16, 16)
    tm, jm, params = models(hwd, seed=5)
    rs = np.random.default_rng(6)
    x = rs.normal(size=(2, M) + hwd).astype(np.float32)
    seg = rs.integers(0, 4, size=(2, 1) + hwd).astype(np.float32)
    tm.train()
    out = tm(torch.tensor(x))
    loss, _ = tunet.nvnet_loss(*out, torch.tensor(seg), torch.tensor(x))
    loss.backward()

    def jloss(p):
        o = jm.apply({"params": p}, jnp.asarray(to_jax(x)), train=True,
                     rng=None)
        return junet.nvnet_loss(*o, jnp.asarray(to_jax(seg)),
                                jnp.asarray(to_jax(x)))[0]

    want_loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    assert_close(loss.item(), float(want_loss), OP_TOL, "loss")
    want = from_jax_nvnet3d(jax.tree.map(np.asarray, grads),
                            (hwd[2], hwd[0], hwd[1]))
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, p in named.items():
        assert p.grad is not None, name
        got, w = p.grad.numpy(), want[name].numpy()
        if name.endswith("conv1.bias") and p.shape == (F,):
            # cancelled by a GroupNorm of one channel per group
            assert np.abs(got - w).max() <= GRAD_TOL * largest, name
            continue
        assert float(p.grad.abs().max()) > 0, name
        assert_close(got, w, GRAD_TOL, name)


def test_from_jax_nvnet3d_round_trips():
    """The port's weights through the test's inverse and back, at a size
    whose reconstruction grid (2x3x1 in H, W, D) permutes; and through
    tests/test_unet3d.py's own transplant of the reference state_dict
    (init 16 at its (H, W, D) = (32, 32, 16))."""
    hwd = (32, 48, 16)
    tm = tunet.build_nvnet3d(hwd, M, 3, F, device="cpu")
    back = from_jax_nvnet3d(to_jax_nvnet3d(tm.state_dict(), hwd),
                            (hwd[2], hwd[0], hwd[1]))
    sd = tm.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    tm.load_state_dict(back, strict=True)

    from test_unet3d import _params_from_torch
    ref = tunet.build_nvnet3d((32, 32, 16), 2, 3, 16, device="cpu")
    back = from_jax_nvnet3d(_params_from_torch(ref), (16, 32, 32))
    for k, v in ref.state_dict().items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="no place"):
        params = _params_from_torch(ref)
        params["unet"]["extra"] = {"kernel": np.zeros(1)}
        from_jax_nvnet3d(params, (16, 32, 32))


def test_train_mode_randomness_comes_from_the_generator():
    """Dropout (elementwise, keep 0.8) and the VAE's eps are drawn from the
    caller's generator: equal seeds give equal outputs, no generator gives
    the deterministic forward, and eval ignores the generator."""
    hwd = (16, 16, 16)
    tm = tunet.build_nvnet3d(hwd, M, 3, F, device="cpu").train()
    x = torch.randn(1, M, *hwd, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = tm(x, torch.Generator().manual_seed(1))
        b = tm(x, torch.Generator().manual_seed(1))
        c = tm(x, torch.Generator().manual_seed(2))
        det = tm(x)
        tm.eval()
        ev = tm(x, torch.Generator().manual_seed(1))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], det[0])
    for u, v in zip(det, ev):
        assert torch.equal(u, v)
    # without dropout only the VAE's sample differs: uout, mu and logvar
    # are the deterministic ones, vout is decoded from z != mu
    tm.unet.dropout_p = 0.0
    tm.train()
    with torch.no_grad():
        s = tm(x, torch.Generator().manual_seed(1))
    for i in (0, 2, 3):
        assert torch.equal(s[i], det[i])
    assert not torch.equal(s[1], det[1])
    with pytest.raises(AssertionError, match="in_channels == out"):
        tunet.BasicBlock3D(8, 16, gen=torch.Generator())
    with pytest.raises(ValueError, match="divide by 16"):
        tunet.build_nvnet3d((16, 16, 24), device="cpu")
