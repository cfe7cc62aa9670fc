"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where there is no CUDA device, since a
CUDA kernel has no CPU mode.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch; there, run it
without the repository's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import pytest
import torch

import chip_smoke
from representation_disentanglement_torch.ops import fused_bn, kernels

_STEP_BN_SHAPES = ([s for s, _, _ in chip_smoke.FLAGSHIP_BN_SHAPES]
                   + chip_smoke.D_BN_SHAPES)
_DT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchw", [(64, 128, 5, 6), (64, 64, 80, 96),
                                  (8, 32, 160, 192)])
def test_cuda_kernel_matches_plain(cuda_device, nchw, dtype):
    """On the card: kernel against the plain version computed in f32 from
    the same inputs.  bf16: 2 bf16 ulps of the output plus the f32
    tolerance (the same f32 arithmetic in another order before the one
    rounding); f32: atol 1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    mk = lambda s, o: (o + s * torch.randn(nchw, generator=g,
                                           device=cuda_device)).to(dtype)
    zi, gamma, beta = mk(2.0, 3.0), mk(0.5, 0.0), mk(0.5, 0.0)
    before = kernels.launch_counts()["in_modulate"]
    got = kernels.in_modulate(zi, gamma, beta).float()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["in_modulate"] == before + 1
    ref = kernels.in_modulate_plain(zi.float(), gamma.float(), beta.float())
    err = (got - ref).abs()
    if dtype == torch.bfloat16:
        _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -100))
        tol = 2.0 * torch.pow(2.0, (exp - 8).float()) + 1e-5
        assert bool((err <= tol).all()), float(err.max())
    else:
        assert float(err.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("nchw", [(256, 128, 5, 6), (64, 64, 80, 96),
                                  (8, 32, 160, 192), (4, 8, 7, 9)])
def test_cuda_backward_kernel_matches_plain(cuda_device, nchw, dtypes):
    """On the card, autograd through ``in_modulate`` launches the backward
    kernel once; its dz, dgamma, dbeta agree with the plain backward
    computed in f32 from the same inputs: 2 bf16 ulps of a bf16 output plus
    2^-18 of the magnitudes of its terms (chip_smoke.bwd_tolerance).  (4, 8,
    7, 9) has H*W odd: the kernel's scalar path."""
    import chip_smoke
    zd, gd = dtypes
    g = torch.Generator(device=cuda_device).manual_seed(1)
    rnd = lambda: torch.randn(nchw, generator=g, device=cuda_device)
    zi = (3.0 + 2.0 * rnd()).to(zd).requires_grad_(True)
    gamma = (0.5 * rnd()).to(gd).requires_grad_(True)
    beta = (0.5 * rnd()).to(gd).requires_grad_(True)
    cot = rnd().to(zd)
    before = kernels.launch_counts()
    out = kernels.in_modulate(zi, gamma, beta)
    dz, dgamma, dbeta = torch.autograd.grad(out, (zi, gamma, beta), cot)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["in_modulate"] == before["in_modulate"] + 1
    assert after["in_modulate_bwd"] == before["in_modulate_bwd"] + 1
    assert (dz.dtype, dgamma.dtype, dbeta.dtype) == (zd, gd, gd)
    rz, rg, rb = kernels.in_modulate_bwd_plain(
        zi.detach().float(), gamma.detach().float(), cot.float())
    tol_dz, tol_dg = chip_smoke.bwd_tolerance(torch, zi.detach(),
                                              gamma.detach(), cot)
    if zd == torch.bfloat16:
        tol_dz = tol_dz + chip_smoke.bf16_ulps(torch, rz)
    if gd == torch.bfloat16:
        tol_dg = tol_dg + chip_smoke.bf16_ulps(torch, rg)
    assert bool(((dz.float() - rz).abs() <= tol_dz).all())
    assert bool(((dgamma.float() - rg).abs() <= tol_dg).all())
    assert torch.equal(dbeta, cot.to(gd))


@pytest.mark.cuda
def test_cuda_train_step_launches_both_kernels(cuda_device):
    """One train step of a small flagship-structure model (M=2) on the card:
    3 + 3*M launches of the forward and of the backward kernel, none of the
    BatchNorm kernels (``fuse_bn`` is off), finite metrics, and the weights
    move."""
    import numpy as np
    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.training import optim, train
    cfg = config.flagship()
    cfg.contrast_list, cfg.batch_size, cfg.effective_batch = (
        ["T1", "T1c"], 2, 2)
    cfg.input_height, cfg.input_width = 64, 96
    model = build_model(cfg)
    step = train.make_train_step(model, cfg, optim.make_optimizer(
        model.parameters(), cfg))
    rs = np.random.default_rng(0)
    batch = {"inputs": rs.normal(size=(1, 2, 2, 64, 96, 7)).astype(
                 np.float32),
             "mask": np.ones((1, 2, 2), np.float32),
             "mask_img": np.zeros((1, 2, 64, 96), np.float32)}
    w0 = model.input_decoder_list[2].sp1.gamma.weight.detach().clone()
    before = kernels.launch_counts()
    metrics = train.metrics_to_dict(step(
        batch, torch.Generator(device=cuda_device).manual_seed(0),
        train.draw_pairs(rs, 2, 1), first_of_epoch=True))
    after = kernels.launch_counts()
    per_step = 3 + 3 * cfg.modality_num
    assert {k: after[k] - before[k] for k in after} == {
        "in_modulate": per_step, "in_modulate_bwd": per_step,
        "bn_stats": 0, "bn_norm": 0}
    assert all(np.isfinite(v) for v in metrics.values())
    assert not torch.equal(w0, model.input_decoder_list[2].sp1.gamma.weight)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_serve_step_goes_through_the_kernel(cuda_device):
    """A small flagship-structure model on the card: build_model picks CUDA
    by default, each serve step launches the kernel once per SPADE block
    (6), and the bf16 outputs agree with the plain interior's."""
    import numpy as np
    from representation_disentanglement_torch import config, serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    cfg = config.flagship()
    cfg.contrast_list, cfg.batch_size = ["T1", "T1c"], 2
    cfg.input_height, cfg.input_width = 64, 96
    model = build_model(cfg)
    assert model.device.type == "cuda"
    rs = np.random.default_rng(0)
    x = rs.normal(size=(2, 2, 64, 96, 7)).astype(np.float32)
    x[0] = 0.0
    mask = np.array([[0, 1], [0, 1]], np.float32)
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    step = serve.make_serve_step(model, cfg, source=1)
    before = kernels.launch_counts()["in_modulate"]
    got_x, got_y = (t.cpu().numpy() for t in step(x, mask, mask_img))
    assert kernels.launch_counts()["in_modulate"] == before + 6
    model.set_use_pallas(False)
    want_x, want_y = (t.cpu().numpy() for t in step(x, mask, mask_img))
    for got, want in ((got_x, want_x), (got_y, want_y)):
        assert np.isfinite(got).all()
        assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4, 5])
@pytest.mark.parametrize("bchw", [(16, 256, 5, 6), (16, 64, 40, 48),
                                  (16, 32, 80, 96), (3, 5, 7, 9)])
def test_cuda_bn_kernels_match_plain(cuda_device, bchw, groups, dtype):
    """On the card: K6 (``bn_stats_cuda``) and K7 (``bn_norm_cuda``, from the
    plain statistics) against their plain versions on the same inputs, with
    the tolerances of chip_smoke.py's ``bn_kernel_check``; one launch each.
    5x6 and 7x9 planes take the kernels' one-value-at-a-time path."""
    import chip_smoke
    x, scale, bias = chip_smoke.bn_case(torch, (groups,) + bchw, dtype,
                                        seed=sum(bchw) + groups)
    before = kernels.launch_counts()
    got = chip_smoke.bn_norm_from_plain_stats(fused_bn, x, scale, bias)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["bn_stats"] == before["bn_stats"] + 1
    assert after["bn_norm"] == before["bn_norm"] + 1
    res = chip_smoke.bn_errors(torch, fused_bn, x, scale, bias, got)
    assert res["ok"], res


@pytest.mark.cuda
def test_cuda_fused_bn_autograd_matches_plain(cuda_device):
    """``bn_train_fused`` on a CUDA tensor goes through the custom ops
    ``rdt::bn_stats`` and ``rdt::bn_norm`` (their CUDA implementations and
    registered backward): y, mean, var and the three gradients of the
    plain version (f32)."""
    import chip_smoke
    x, scale, bias = chip_smoke.bn_case(torch, (4, 8, 16, 20, 24),
                                        torch.float32, seed=3)
    xf = x.reshape(32, 16, 20, 24).requires_grad_(True)
    s, b = scale.requires_grad_(True), bias.requires_grad_(True)
    gy = torch.randn_like(xf)
    y, mean, var = fused_bn.bn_train_fused(xf, s, b, 1e-5, groups=4)
    assert not mean.requires_grad
    got = torch.autograd.grad(y, (xf, s, b), gy)
    ry, rm, rv = fused_bn.bn_train_fused_plain(xf.view(4, 8, 16, 20, 24), s,
                                               b, 1e-5)
    want = torch.autograd.grad(ry, (xf, s, b), gy.view_as(ry))
    for a, w in ((y, ry.reshape(y.shape)), (mean, rm), (var, rv),
                 *zip(got, want)):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_opcheck(cuda_device, dtype):
    """``torch.library.opcheck`` of the four ``rdt::`` ops on CUDA tensors:
    schema, fake implementation, autograd registration, AOT dispatch."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda_device)
    zi, gamma, beta = (mk(64, 128, 5, 6).to(dtype) for _ in range(3))
    torch.library.opcheck(torch.ops.rdt.in_modulate.default,
                          (zi.requires_grad_(), gamma.requires_grad_(),
                           beta.requires_grad_(), 1e-5))
    torch.library.opcheck(torch.ops.rdt.in_modulate_bwd.default,
                          (zi.detach(), gamma.detach(),
                           mk(64, 128, 5, 6).to(dtype), 1e-5))
    x = mk(4, 16, 64, 40, 48).to(dtype)
    torch.library.opcheck(torch.ops.rdt.bn_stats.default, (x,))
    mean, var = fused_bn.bn_stats_plain(x)
    torch.library.opcheck(torch.ops.rdt.bn_norm.default,
                          (x.requires_grad_(), mean, var,
                           mk(64).requires_grad_(), mk(64).requires_grad_(),
                           1e-5))


@pytest.mark.cuda
def test_cuda_fused_bn_train_step_launches(cuda_device):
    """A fused-BN train step of a small flagship-structure model (M=2) on
    the card: 28 launches of each BatchNorm kernel on the first step of an
    epoch (anatomy U-Net 8, its re-encode 8, the y decoder 12) and 16 on
    the next, besides 3 + 3*M of each SPADE kernel."""
    import numpy as np
    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.training import optim, train
    cfg = config.flagship()
    cfg.contrast_list, cfg.batch_size, cfg.effective_batch = (
        ["T1", "T1c"], 2, 2)
    cfg.input_height, cfg.input_width, cfg.fuse_bn = 64, 96, True
    model = build_model(cfg)
    step = train.make_train_step(model, cfg, optim.make_optimizer(
        model.parameters(), cfg))
    rs = np.random.default_rng(0)
    batch = {"inputs": rs.normal(size=(1, 2, 2, 64, 96, 7)).astype(
                 np.float32),
             "mask": np.ones((1, 2, 2), np.float32),
             "mask_img": np.zeros((1, 2, 64, 96), np.float32)}
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    spade = 3 + 3 * cfg.modality_num
    for first, bn in ((True, 28), (False, 16)):
        before = kernels.launch_counts()
        metrics = train.metrics_to_dict(step(batch, gen,
                                             train.draw_pairs(rs, 2, 1),
                                             first_of_epoch=first))
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "in_modulate": spade, "in_modulate_bwd": spade,
            "bn_stats": bn, "bn_norm": bn}
        assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", _STEP_BN_SHAPES)
def test_cuda_bn_kernels_at_every_step_shape(cuda_device, shape, dtype):
    """K6 and K7 at every BatchNorm shape of the flagship train step (the
    anatomy U-Net at G=4, the y decoder at G=5) and of the discriminator
    (G=2), against their plain versions under chip_smoke.py's BN_STATS_REL
    and BN_NORM_REL; a second K6 launch on the same x gives the same bits;
    two launches of K6 and one of K7 counted."""
    before = kernels.launch_counts()
    res = chip_smoke.bn_check(torch, fused_bn, shape, _DT[dtype],
                              seed=sum(shape))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["bn_stats"] == before["bn_stats"] + 2
    assert after["bn_norm"] == before["bn_norm"] + 1
    assert res["stats_bitwise_repeat"] and res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,pdtype,offset",
                         chip_smoke.BN_EDGE_CASES)
def test_cuda_bn_kernels_edge_cases(cuda_device, shape, dtype, pdtype,
                                    offset):
    """K6 and K7 at chip_smoke.py's BN_EDGE_CASES: H*W of 1, 30 and 7, x at
    a 2-byte offset (not 16-byte aligned), G*C = 1, B = 1, a slab of 64
    samples, f32 x with bf16 scale and bias; the tolerances and the
    bit-identical second K6 launch of the step shapes."""
    res = chip_smoke.bn_check(torch, fused_bn, shape, _DT[dtype],
                              seed=sum(shape), pdtype=_DT[pdtype],
                              offset=offset)
    torch.cuda.synchronize()
    assert res["stats_bitwise_repeat"] and res["ok"], res


@pytest.mark.cuda
def test_cuda_kernels_at_the_spadefull_grid(cuda_device):
    """K1 and K3 at the SPADEFull train grid of the flagship (all six
    blocks on N = M*M*B = 256 planes; sp6 holds 2.5e8 values, so the
    kernels' index arithmetic is held beyond 2^27), bf16, under
    chip_smoke.py's tolerances, and the backward's f32 and mixed-dtype
    cases."""
    shapes = chip_smoke.full_train_shapes(4, 16)
    assert max(n * c * h * w for _, n, c, h, w in shapes) == 256 * 32 * 160 * 192
    before = kernels.launch_counts()
    chip_smoke.check_kernels(torch, kernels, 0, shapes)
    chip_smoke.check_bwd_kernels(torch, kernels, 0, shapes)
    after = kernels.launch_counts()
    assert after["in_modulate"] == before["in_modulate"] + 6
    assert after["in_modulate_bwd"] == before["in_modulate_bwd"] + 6 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", chip_smoke.OPTIONS_G1_BN_SHAPES)
def test_cuda_bn_kernels_at_the_per_modality_shapes(cuda_device, shape,
                                                    dtype):
    """K6 and K7 at the per-modality anatomy encoders' BatchNorm shapes
    (G = 1; the channel-attention decoders' gates run at the 'U+SA'
    gates' shapes, test_cuda_bn_kernels_at_every_step_shape), against
    their plain versions; a second K6 launch gives the same bits."""
    res = chip_smoke.bn_check(torch, fused_bn, shape, _DT[dtype],
                              seed=sum(shape))
    torch.cuda.synchronize()
    assert res["stats_bitwise_repeat"] and res["ok"], res


@pytest.mark.cuda
def test_cuda_options_train_step_kernels_vs_plain(cuda_device):
    """One train step of a small model (M=2, B=2, 64x96, f32) with
    SPADEFull, per-modality encoders, mod_enc_s, 'U+SSA+CA' and fuse_bn:
    6 launches of each SPADE kernel, 36 of each BatchNorm kernel on the
    first step of an epoch (per-modality encoders 2 x 4, the shared decoder
    half 4, twice, and the decoder's 12); then the step's losses and
    gradients with the kernels against the plain versions, and fused
    against unfused BatchNorm, under chip_smoke.py's f32 tolerances."""
    import numpy as np
    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.training import optim, train
    cfg = chip_smoke.copy_cfg(
        config.flagship(), contrast_list=["T1", "T1c"], batch_size=2,
        effective_batch=2, input_height=64, input_width=96,
        compute_dtype="float32", **dict(chip_smoke.OPTION_CFGS["full"],
                                        others=dict(config.flagship().others,
                                                    mod_enc_s=True)))
    cfg.derive().validate()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    step = train.make_train_step(model, cfg, optim.make_optimizer(
        model.parameters(), cfg))
    rng = np.random.default_rng(0)
    batch = chip_smoke.train_batch(rng, cfg)
    pairs = train.draw_pairs(rng, 2, 1)
    before = kernels.launch_counts()
    metrics = train.metrics_to_dict(step(
        batch, torch.Generator(device=cuda_device).manual_seed(0), pairs,
        first_of_epoch=True))
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "in_modulate": 6, "in_modulate_bwd": 6, "bn_stats": 36,
        "bn_norm": 36}
    assert all(np.isfinite(v) for v in metrics.values())
    model.train()
    for toggle, loss_tol, grad_tol in (
            (model.set_use_pallas, chip_smoke.TRAIN_F32_LOSS_REL,
             chip_smoke.TRAIN_F32_GRAD_REL_L2),
            (model.set_fuse_bn, chip_smoke.FUSED_F32_LOSS_REL,
             chip_smoke.FUSED_F32_GRAD_REL_L2)):
        loss_rel, _, grad_rel, _, _ = chip_smoke.compare_one_step(
            torch, train, model, cfg, batch, pairs[0], 0, toggle)
        assert max(loss_rel.values()) <= loss_tol, loss_rel
        assert grad_rel <= grad_tol, grad_rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", chip_smoke.LEGACY_BN_SHAPES)
def test_cuda_bn_kernels_at_the_legacy_shapes(cuda_device, shape, dtype):
    """K6 and K7 at the grids of the modules beside MultimodalModel that
    no earlier configuration gives them: G*C = 32 and 64 over 16x160x192
    planes (fewer tiles than SMs) and planes of 1 and 4 values at C = 512,
    against their plain versions; a second K6 launch gives the same
    bits."""
    res = chip_smoke.bn_check(torch, fused_bn, list(shape), _DT[dtype],
                              seed=sum(shape))
    torch.cuda.synchronize()
    assert res["stats_bitwise_repeat"] and res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_percase_conv_matches_a_loop(cuda_device, dtype):
    """The per-sample CondConv's grouped conv (``percase_conv2d``) with its
    bias against one F.conv2d per sample with its own kernel, on the card,
    computed in f32 from the same (bf16-rounded) inputs and rounded where
    the port and JAX round (torch ops/conv.py:66-72, JAX ops/conv.py:
    101-111): in bf16 the conv is rounded to bf16, then the bf16 bias is
    added in bf16.  Within 1e-4 of the output's largest entry, and in bf16
    also 2 bf16 ulps of the conv before the bias (the conv's one rounding,
    after f32 sums in another order) and 2 of the output (the sum's)."""
    import torch.nn.functional as F
    from representation_disentanglement_torch.ops.conv import percase_conv2d
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(16, 64, 40, 48, generator=g,
                    device=cuda_device).to(dtype)
    w = 0.05 * torch.randn(16, 128, 64, 4, 4, generator=g,
                           device=cuda_device)
    b = torch.randn(128, generator=g, device=cuda_device)
    got = percase_conv2d(x, w, b, 2, 1).float()
    conv = torch.cat([F.conv2d(x[i:i + 1].float(), w[i].to(dtype).float(),
                               None, 2, 1) for i in range(16)])
    ref = (conv.to(dtype) + b.to(dtype)[:, None, None]).float()
    tol = 1e-4 * float(ref.abs().max())
    if dtype == torch.bfloat16:
        tol = (chip_smoke.bf16_tolerance(torch, conv)
               + chip_smoke.bf16_tolerance(torch, ref) + tol)
    assert bool(((got - ref).abs() <= tol).all())


def _sync_sites(fn):
    """Runs ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    returns {the innermost source line of each synchronizing call, and the
    port's innermost line that led to it where that is another: how many
    times it synchronized}."""
    import collections
    import os
    import traceback
    import warnings
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if os.path.basename(f.filename) != "warnings.py"]
        ours = [f for f in stack
                if "representation_disentanglement_torch" in f.filename]
        where = [stack[-1]] + ([ours[-1]] if ours and ours[-1] is not
                               stack[-1] else [])
        sites[" <- ".join(f"{os.path.relpath(f.filename, root)}:{f.lineno}"
                          f" {f.name}: {f.line}" for f in where)] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sites)


@pytest.mark.cuda
def test_cuda_warm_serve_step_never_synchronizes(cuda_device):
    """The flagship model (four contrasts, 160x192, bf16) at B = 2 on the
    card.  After one warm-up call, a serve step whose inputs are already on
    the card runs under ``torch.cuda.set_sync_debug_mode("error")``, where
    any call that synchronizes with the card raises, and copies no resize
    matrix: no ``rdt.resize.upload`` span and no cache miss.

    Then one warm train step of ``training.epoch.make_train_epoch`` over a
    small device volume cache runs under ``"warn"``; the synchronizing
    calls left in it are printed (``pytest -s``), and not asserted.  Last,
    the same instrument finds the synchronizing copy of a resize whose
    matrices are not cached."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from representation_disentanglement_torch import config, serve
    from representation_disentanglement_torch.data.device_store import (
        DeviceBatchLoader, DeviceVolumeCache)
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.ops import resize
    from representation_disentanglement_torch.training import epoch, optim
    cfg = config.flagship()
    cfg.batch_size = cfg.effective_batch = 2
    M, B, H, W = (cfg.modality_num, 2, cfg.input_height, cfg.input_width)
    torch.manual_seed(0)
    model = build_model(cfg, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(M, B, H, W, 7, generator=g, device=cuda_device)
    x[0] = 0.0
    mask = torch.ones(B, M, device=cuda_device)
    mask[:, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).float()
    step = serve.make_serve_step(model.eval(), cfg, source=1)
    step(x, mask, mask_img)
    torch.cuda.synchronize()
    before = resize.matrix_cache_info()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            x_hat, y = step(x, mask, mask_img)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = resize.matrix_cache_info()
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "rdt.serve.step" in names and "rdt.resize" in names
    assert "rdt.resize.upload" not in names
    assert bool(torch.isfinite(x_hat).all()) and bool(
        torch.isfinite(y).all())

    model.train()
    S, D = 2, 12
    cache = DeviceVolumeCache(
        torch.randn(S, M, D, H, W, generator=g, device=cuda_device).to(
            torch.bfloat16),
        torch.rand(S, D, H, W, generator=g, device=cuda_device),
        torch.ones(S, M, device=cuda_device), ["a", "b"], cfg.block_size, D)
    loader = DeviceBatchLoader(cache, ["a", "b"] * 4, list(range(4, 12)), B,
                               shuffle=True, drop_last=True, seed=2)
    train_epoch, _ = epoch.make_train_epoch(
        model, cfg, optim.make_optimizer(model.parameters(), cfg), cache,
        torch.Generator(device=cuda_device).manual_seed(3))
    plan = epoch.epoch_indices(loader, 1, M, np.random.default_rng(3))
    train_epoch(plan.chunk(0, 1), first_chunk=True)
    torch.cuda.synchronize()
    sites = _sync_sites(lambda: train_epoch(plan.chunk(1, 2),
                                            first_chunk=False))
    print("synchronizing calls in a warm train step:")
    for site, n in sorted(sites.items()):
        print(f"  {n:4d}  {site}")

    # the instrument sees the copy of a cold matrix, which synchronizes
    resize.clear_matrix_cache()
    cold = _sync_sites(lambda: resize.bilinear_resize(
        x[0].movedim(-1, 1), (5, 6)))
    assert any("_matrix" in site for site in cold), cold
