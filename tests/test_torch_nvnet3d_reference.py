"""The port's NVNet3D held against the benchmark's plain float32 reference
(``benchmark/reference/nvnet3d.py``, which imports nothing of the port) on
the CPU: seeded random weights at 32x48x32, 4 contrasts, 8 filters and a
VAE bottleneck of 32, in train mode with the generator's dropout mask
and eps.  The outputs, the loss terms, every leaf's gradient and three
Adam steps of ``make_train_step_3d`` against the reference's
``train_steps``; ``VolumeDataset3D``'s augmented crop against the
reference's ``crop``; and ``--squeeze-channels`` reaching the model
through ``main_3d``'s parser.

Both sides run the same float32 convolutions and GroupNorm on the CPU, so
the forward agrees to the last bit here; what may differ is the order of
the sums in the linear layers, the loss and the backward (measured: 0 on
the outputs and terms, 1.3e-6 of a leaf's gradient norm).
"""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import nvnet3d
from representation_disentanglement_torch import main_3d
from representation_disentanglement_torch.data import synthetic
from representation_disentanglement_torch.data.dataset import (
    VolumeStore, fold_txt_names)
from representation_disentanglement_torch.data.dataset3d import (
    VolumeDataset3D)
from representation_disentanglement_torch.data.preprocess import (
    write_fold_txts)
from representation_disentanglement_torch.models.unet3d import (
    build_nvnet3d, nvnet_loss)
from representation_disentanglement_torch.training.train3d import (
    create_state_3d, make_train_step_3d)

HWD, M, F, SQ, LR = (32, 48, 32), 4, 8, 32, 1e-4
CFG = {"init_channels": F, "squeeze_channels": SQ, "lr": LR,
       "contrast_list": ["T1", "T1c", "T2", "T2_FLAIR"],
       "image_size": list(HWD)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _model():
    return build_nvnet3d(HWD, M, 3, F, device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         squeeze_channels=SQ).train()


def _batch(g):
    return {"inputs": torch.randn(1, M, *HWD, generator=g),
            "targets": torch.randint(0, 4, (1, 1, *HWD),
                                     generator=g).float()}


def _leaves(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_parameters_are_the_reference_s():
    model = _model()
    assert [n for n, _, _ in nvnet3d.param_specs(CFG)] == \
        list(model.state_dict())
    assert all(tuple(s) == tuple(model.state_dict()[n].shape)
               for n, s, _ in nvnet3d.param_specs(CFG))
    assert model.vae_branch.mu_fc.weight.shape == (SQ // 2, SQ // 2)


def test_outputs_terms_and_gradients_match():
    """Outputs and terms within 1e-5 of the largest entry (float32, the
    same operators; measured 0); each leaf's gradient within 1e-4 of its
    norm or of the median leaf's, whichever is larger (the backward's sums
    in another order; measured 1.3e-6; the conv1 biases that a
    one-channel-per-group GroupNorm cancels hold round-off alone)."""
    model = _model()
    P = {n: v.clone().requires_grad_(True) for n, v in _leaves(model)
         .items()}
    b = _batch(torch.Generator().manual_seed(1))
    out = model(b["inputs"], torch.Generator().manual_seed(5))
    ref = nvnet3d.forward(P, CFG, b["inputs"],
                          torch.Generator().manual_seed(5))
    for name, o, r in zip(("uout", "vout", "mu", "logvar"), out, ref):
        o, r = o.detach(), r.detach()
        assert o.shape == r.shape, name
        assert float((o - r).abs().max()) <= 1e-5 * float(r.abs().max()), \
            name
    loss, aux = nvnet_loss(*out, b["targets"], b["inputs"])
    want = nvnet3d.losses(*ref, b["targets"], b["inputs"])
    for k, v in dict(aux, all=loss).items():
        np.testing.assert_allclose(float(v.detach()),
                                   float(want[k].detach()), rtol=1e-5,
                                   err_msg=k)
    loss.backward()
    grads = torch.autograd.grad(want["all"], list(P.values()))
    norms = {n: float(g.norm()) for n, g in zip(P, grads)}
    med = float(np.median(list(norms.values())))
    for (n, p), g in zip(model.named_parameters(), grads):
        gap = float((p.grad - g).norm())
        assert gap <= 1e-4 * max(norms[n], med), (n, gap, norms[n])


def test_three_adam_steps_match():
    """Three steps of ``make_train_step_3d`` and of the reference's
    ``train_steps`` on the same crops and draws: every step's loss within
    1e-5 (measured 0), and each leaf's distance from the other side's
    within 5e-3 of its change (measured 5.9e-4: Adam divides small
    gradients' round-off by their own size).  Leaves whose first gradient
    is round-off (under 1e-3 of the median leaf's; the GroupNorm-cancelled
    biases) are held to 6 lr per element: each of the three steps moves
    an element by about lr at most, on either side."""
    model = _model()
    w0 = _leaves(model)
    g = torch.Generator().manual_seed(2)
    batches = [_batch(g) for _ in range(3)]
    step = make_train_step_3d(model, create_state_3d(model, lr=LR))
    gen = torch.Generator().manual_seed(5)
    got = [float(step(b, gen)["loss"]) for b in batches]
    P = {n: v.clone().requires_grad_(True) for n, v in w0.items()}
    res = nvnet3d.train_steps(P, CFG, [[b] for b in batches],
                              torch.Generator().manual_seed(5))
    np.testing.assert_allclose(got, res["loss"], rtol=1e-5)
    med = float(np.median(list(res["grad1"].values())))
    for n, p in model.named_parameters():
        gap = float((p.detach() - P[n].detach()).norm())
        if res["grad1"][n] >= 1e-3 * med:
            assert gap <= 5e-3 * float((P[n].detach() - w0[n]).norm()), n
        else:
            assert gap <= 6 * LR * p.numel() ** 0.5, n


def test_augmented_crop_is_the_reference_s():
    """``VolumeDataset3D(aug=True)``'s crop, from a ``VolumeStore`` of
    [H, W, D] volumes, against the reference's ``crop`` from [S, M, D, H,
    W] tensors on the same draws (flip, scale, shift, read from a copy of
    the dataset's generator): labels equal, label 4 read as 3; inputs
    within 1e-6 (numpy and torch may round the affine map apart by an
    ulp), the background pinned to -10 in the same voxels."""
    g = torch.Generator().manual_seed(3)
    S, DZ, (H, W, D), start = 2, 40, (16, 24, 16), 7
    contrasts = CFG["contrast_list"]
    vols = torch.randn(S, M, DZ, H, W, generator=g)
    vols[:, :, :, :3] = -6.0                      # background rows
    tgts = torch.randint(0, 5, (S, DZ, H, W), generator=g).float()
    data = {f"s{i}/seg": tgts[i].permute(1, 2, 0).numpy() for i in range(S)}
    data.update({f"s{i}/{c}": vols[i, m].permute(1, 2, 0).numpy()
                 for i in range(S) for m, c in enumerate(contrasts)})
    flips = set()
    for seed in range(4):
        ds = VolumeDataset3D("BraTS", VolumeStore(data=data),
                             [f"s{i}" for i in range(S)], contrasts,
                             aug=True, image_size=(H, W, D),
                             slab=slice(start, start + D),
                             rng=np.random.default_rng(seed))
        draws = np.random.default_rng(seed)
        for i in range(S):
            got = ds[i]
            assert got is not None
            flip = draws.random() > 0.5
            scale = 1 + 0.2 * (draws.random() - 0.5)
            shift = 0.2 * (draws.random() - 0.5)
            flips.add(flip)
            x, t = nvnet3d.crop(vols, tgts, i, start, D, flip, scale, shift)
            np.testing.assert_array_equal(got["targets"], t.numpy())
            assert (got["targets"] == 3).any() and (got["targets"] < 4).all()
            np.testing.assert_allclose(got["inputs"], x.numpy(), rtol=0,
                                       atol=1e-6)
            assert ((got["inputs"] == -10) == (x.numpy() == -10)).all()
            assert (x == -10).sum() >= M * 3 * W * D
    assert flips == {True, False}


def test_squeeze_channels_reaches_the_model_through_main_3d(tmp_path,
                                                            monkeypatch):
    """One epoch of ``main_3d.run`` from its parser's arguments on three
    phantom subjects: the model it builds has the bottleneck that
    ``--squeeze-channels`` names, and its checkpoint holds it."""
    vols, subjects, _ = synthetic.synthetic_volumes(
        "BraTS", ("T1", "T2"), "z-score", 5, (16, 16, 32), seed=4)
    path = str(tmp_path / "data")
    os.makedirs(path)
    write_fold_txts(
        synthetic.one_fold((subjects[:3], subjects[3:4], subjects[4:])),
        path, synthetic.by_split(fold_txt_names("BraTS", 0, 2)))
    built = []

    def build(*a, **kw):
        built.append(build_nvnet3d(*a, **kw))
        return built[-1]
    monkeypatch.setattr(main_3d, "build_nvnet3d", build)
    ckpt = str(tmp_path / "ckpt3d")
    args = main_3d.build_parser().parse_args(
        ["--data-path", path, "--contrasts", "T1", "T2", "--init-channels",
         "8", "--squeeze-channels", "48", "--image-size", "16", "16", "16",
         "--slab-start", "8", "--ckpt-dir", ckpt, "--epochs", "1"])
    assert args.squeeze_channels == 48
    out = main_3d.run(args, device="cpu", store=VolumeStore(data=vols))
    assert out["epochs"][0]["steps"] == 3
    vae = built[0].vae_branch
    assert vae.sq == 48 and vae.mu_fc.weight.shape == (24, 24)
    assert vae.hidden_conv[2].weight.shape[0] == 48
    from representation_disentanglement_torch.training import checkpoint
    params = checkpoint.load_checkpoint(ckpt)["params"]
    assert tuple(params["vae_branch.logvar_fc.weight"].shape) == (24, 24)
    default = main_3d.build_parser().parse_args(["--data-path", path])
    assert default.squeeze_channels is None
