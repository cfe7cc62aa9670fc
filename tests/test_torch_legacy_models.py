"""The legacy models of the port (models/legacy.py) against the JAX
package's (JAX models/legacy.py) on the CPU, with the same weights carried
over by ``weights.from_jax_legacy``: ``UNet``, ``GANStandardGenerator``
(8 downs, 256x256 at first_num_ch 4, a 1x1 bottleneck),
``GANShortNoShortCutGenerator``, ``VariationNet`` (no noise: exact;
with a generator: the noise's statistics), ``GANShortGeneratorVAE``,
``LowdoseModel``, ``SymmetrySpatialAttentionLayer`` (and residual) and
``MultiAttentionLayer``, each in eval mode and in train mode with the
updated running statistics; the gradient of ``UNet`` leaf by leaf; one
model with JAX on its fused-BatchNorm path against the port's plain and
fused-plain paths.  B = 2, f32, first_num_ch 8 unless stated.
"""

import pytest
import torch

from representation_disentanglement_tpu.models import legacy as JL
from representation_disentanglement_torch.models import legacy as L
from representation_disentanglement_torch.models.layers import set_fuse_bn
import torch_legacy_common as C

few_threads = pytest.fixture(scope="module", autouse=True)(C.few_threads)

CPU = dict(device="cpu")


def _pair(jm, tm, kind, x, *extra_j, extra_t=(), seed=1):
    return C.LegacyPair(jm, tm, kind, (C.nhwc(x),) + extra_j,
                        (torch.from_numpy(x),) + tuple(extra_t), seed=seed)


def test_unet_parity_and_grads():
    x = C.seeded((2, 3, 64, 64), 0)
    p = _pair(JL.UNet(out_num_ch=1, first_num_ch=8),
              L.UNet(3, 1, 8, **CPU), "unet", x)
    p.check("UNet")
    p.check_grads("UNet", cancelled=r"\.conv\d\.bias$")
    with pytest.raises(ValueError, match="linear"):
        L.UNet(3, 1, 8, output_activation="linear", **CPU)


CASES = {
    "standard": (lambda: JL.GANStandardGenerator(out_num_ch=1,
                                                 first_num_ch=4),
                 lambda: L.GANStandardGenerator(3, 1, 4, **CPU),
                 (2, 3, 256, 256)),
    "noshortcut": (lambda: JL.GANShortNoShortCutGenerator(out_num_ch=1,
                                                          first_num_ch=8),
                   lambda: L.GANShortNoShortCutGenerator(3, 1, 8, **CPU),
                   (2, 3, 64, 96)),
    "lowdose": (lambda: JL.LowdoseModel(),
                lambda: L.LowdoseModel(3, **CPU), (2, 3, 64, 96)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_model_parity(case):
    jctor, tctor, shape = CASES[case]
    kind = "lowdose" if case == "lowdose" else "generator"
    _pair(jctor(), tctor(), kind, C.seeded(shape, 1)).check(case)


def test_variation_net_and_vae_parity():
    x = C.seeded((2, 3, 64, 96), 2)
    vn = _pair(JL.VariationNet(first_num_ch=8), L.VariationNet(3, 8, **CPU),
               "generator", x, None, extra_t=(None,))
    lat = vn.check("VariationNet").detach()
    assert lat.shape == (2, 64, 2, 3)
    latent = C.seeded(tuple(lat.shape), 3)
    _pair(JL.GANShortGeneratorVAE(out_num_ch=1, first_num_ch=8),
          L.GANShortGeneratorVAE(3, 1, 8, **CPU), "generator", x,
          C.nhwc(latent), extra_t=(torch.from_numpy(latent),)).check("VAE")


def test_variation_net_noise_statistics():
    """With a generator the latent gets standard normal noise from it:
    the difference from the noiseless latent has mean 0 and variance 1,
    and the same seed gives the same latent."""
    vn = L.VariationNet(3, 8, **CPU).eval()
    x = torch.from_numpy(C.seeded((8, 3, 64, 96), 4))
    with torch.no_grad():
        base = vn(x)
        noisy = vn(x, torch.Generator().manual_seed(5))
        again = vn(x, torch.Generator().manual_seed(5))
    d = (noisy - base).double()
    assert d.numel() == 8 * 64 * 2 * 3
    assert abs(float(d.mean())) < 0.1 and abs(float(d.var()) - 1) < 0.1
    assert torch.equal(noisy, again)


@pytest.mark.parametrize("residual", [False, True])
def test_symmetry_spatial_attention_parity(residual):
    x, g = C.seeded((2, 8, 32, 48), 6), C.seeded((2, 16, 16, 24), 7)
    gen = torch.Generator().manual_seed(0)
    tm = L.SymmetrySpatialAttentionLayer(8, 16, 8, gen=gen,
                                         residual=residual)
    _pair(JL.SymmetrySpatialAttentionLayer(8, residual=residual), tm,
          "generator", x, C.nhwc(g), extra_t=(torch.from_numpy(g),)).check(
        f"ssa residual={residual}")


def test_multi_attention_parity():
    """Integer channel division: 16 // 4 = 4 channels in W_down; the
    8x8 / 2 pooled gate needs x of at least 8x8."""
    x, g = C.seeded((2, 16, 32, 48), 8), C.seeded((2, 32, 16, 24), 9)
    gen = torch.Generator().manual_seed(0)
    tm = L.MultiAttentionLayer(16, 32, gen=gen, sample_factor_channel=4)
    assert tm.W_down.weight.shape[0] == 4
    _pair(JL.MultiAttentionLayer(sample_factor_channel=4), tm, "generator",
          x, C.nhwc(g), extra_t=(torch.from_numpy(g),)).check("multi")


def test_fused_bn_jax_fused_against_port(monkeypatch):
    """JAX on its fused path (the Pallas BatchNorm in interpret mode)
    against the port's plain BatchNorm and its fused path, which on a CPU
    tensor is the fused kernels' plain version: train-mode outputs and
    running statistics."""
    from representation_disentanglement_tpu.models import layers as jlayers
    from representation_disentanglement_tpu.ops import pallas_bn
    monkeypatch.setattr(jlayers, "_BN_FUSED_DEFAULT", True)
    monkeypatch.setattr(pallas_bn, "_FORCE_INTERPRET", True)
    x = C.seeded((2, 3, 32, 32), 10)
    for fused in (False, True):
        tm = L.GANShortNoShortCutGenerator(3, 1, 4, **CPU)
        set_fuse_bn(tm, fused)
        assert all(m.fused == fused for m in tm.modules()
                   if hasattr(m, "fused"))
        _pair(JL.GANShortNoShortCutGenerator(out_num_ch=1, first_num_ch=4),
              tm, "generator", x).check(f"fused={fused}")
