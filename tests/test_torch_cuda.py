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

from representation_disentanglement_torch.ops import kernels


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
def test_cuda_in_modulate_refuses_grad(cuda_device):
    zi = torch.randn(2, 4, 8, 8, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.in_modulate(zi, torch.zeros_like(zi), torch.zeros_like(zi))


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
