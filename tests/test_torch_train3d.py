"""The port's 3D train and eval steps (``training/train3d.py``) and 3D
dataset (``data/dataset3d.py``) against the JAX package's, on the CPU in
f32.

Steps: NVNet3D with 2 contrasts, ``init_channels`` 8, at 16x16x16, batch
1, from the port's torch initialization carried to JAX by
tests/test_torch_unet3d.py's ``to_jax_nvnet3d`` (no JAX initialization is
compiled), deterministic (``generator=None`` / ``rng=None``: z = mu, no
dropout).  The JAX side is tests/test_train3d.py's manual oracle: the loss
gradient, ``clip_global_norm`` to 1, ``adam_amsgrad_torch`` with weight
decay 1e-5 at lr 1e-3.

Tolerances, with what was measured on a CPU: each step's loss, its terms
and the gradient norm rtol 2e-3, tests/test_torch_train_step.py's
(measured at most 5.8e-4, the gradient norm of the third step; the first
step's within 3.2e-6).  Parameters after 3 steps, as the update each side
made from the common start: per tensor the L2 gap at most 0.1 of the JAX
update (measured at most 3.8e-2, on a GroupNorm bias; median 2.7e-3), all
tensors together 2e-2 (measured 7.8e-3).  Adam's update is about lr times
the sign of the gradient's running mean, so a component whose gradient is
near zero turns f32 rounding noise (the gradients agree to 3.6e-5 of each
leaf's largest entry, tests/test_torch_unet3d.py) into a gap of up to lr.
``accum=2`` against one step of the port on the mean of the two
microbatches' gradients: the loss terms rtol 1e-6, the parameters within
1e-6 (measured 5.6e-8 relative and 0).
Datasets: equal arrays, up to the layout's transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.data import dataset as jdataset
from representation_disentanglement_tpu.data import dataset3d as jdataset3d
from representation_disentanglement_tpu.models import unet3d as junet
from representation_disentanglement_tpu.training import optim as joptim
from representation_disentanglement_torch.data import synthetic
from representation_disentanglement_torch.data.dataset import VolumeStore
from representation_disentanglement_torch.data.dataset3d import (
    VolumeDataset3D, collate_volumes)
from representation_disentanglement_torch.models import unet3d as tunet
from representation_disentanglement_torch.training import train3d
from representation_disentanglement_torch.weights import from_jax_nvnet3d
from test_torch_dump import few_threads  # noqa: F401 (autouse fixture)
from test_torch_unet3d import M, F, to_jax, to_jax_nvnet3d

HWD = (16, 16, 16)
LR, STEPS = 1e-3, 3
METRIC_RTOL, UPDATE_REL, UPDATE_REL_ALL = 2e-3, 0.1, 2e-2
ACCUM_RTOL, ACCUM_ATOL = 1e-6, 1e-6


def batch(seed):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(1, M) + HWD).astype(np.float32)
    seg = rs.integers(0, 4, size=(1, 1) + HWD).astype(np.float32)
    return x, seg


def port_model(seed=0):
    return tunet.build_nvnet3d(HWD, M, 3, F, device="cpu",
                               generator=torch.Generator().manual_seed(seed))


def test_three_adam_steps_match_jax():
    tm = port_model()
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    params = to_jax_nvnet3d(start, HWD)
    opt = train3d.create_state_3d(tm, lr=LR)
    step = train3d.make_train_step_3d(tm, opt)
    jm = junet.NVNet3D(input_shape=HWD, in_channels=M, out_channels=3,
                       init_channels=F)
    tx = joptim.adam_amsgrad_torch(weight_decay=1e-5)

    @jax.jit
    def jstep(p, s, x, seg):
        def loss_fn(q):
            o = jm.apply({"params": q}, x, train=True, rng=None)
            return junet.nvnet_loss(*o, seg, x)
        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        g, gnorm = joptim.clip_global_norm(g, 1.0)
        upd, s = tx.update(g, s, p, learning_rate=LR)
        return jax.tree.map(jnp.add, p, upd), s, dict(aux, loss=loss,
                                                      grad_norm=gnorm)

    state = tx.init(params)
    for i in range(STEPS):
        x, seg = batch(10 + i)
        got = step({"inputs": torch.tensor(x), "targets": torch.tensor(seg)})
        assert set(got) == set(train3d.METRIC_KEYS)
        params, state, want = jstep(params, state, jnp.asarray(to_jax(x)),
                                    jnp.asarray(to_jax(seg)))
        for k in train3d.METRIC_KEYS:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=METRIC_RTOL, err_msg=k)
    want = from_jax_nvnet3d(jax.tree.map(np.asarray, params), HWD)
    gap2 = upd2 = 0.0
    for name, p in tm.state_dict().items():
        update = want[name] - start[name]
        gap = float((p - want[name]).norm())
        assert gap <= UPDATE_REL * float(update.norm()), name
        gap2 += gap ** 2
        upd2 += float(update.norm()) ** 2
    assert gap2 ** 0.5 <= UPDATE_REL_ALL * upd2 ** 0.5
    assert all(float(s["step"]) == STEPS for s in opt.state.values())


def test_accum2_equals_one_step_on_the_mean_gradient():
    tm, ref = port_model(1), port_model(1)
    (x1, s1), (x2, s2) = batch(20), batch(21)
    step = train3d.make_train_step_3d(tm, train3d.create_state_3d(tm,
                                                                  lr=LR),
                                      accum=2)
    got = step({"inputs": torch.tensor(np.stack([x1, x2])),
                "targets": torch.tensor(np.stack([s1, s2]))})

    # the oracle: each microbatch's gradient, their mean, clip, Adam
    opt = train3d.create_state_3d(ref, lr=LR)
    ref.train()
    grads, terms = [], []
    for x, s in ((x1, s1), (x2, s2)):
        ref.zero_grad()
        loss, aux = tunet.nvnet_loss(*ref(torch.tensor(x)), torch.tensor(s),
                                     torch.tensor(x))
        loss.backward()
        grads.append([p.grad.clone() for p in ref.parameters()])
        terms.append([loss.item()] + [aux[k].item() for k in
                                      ("dice_loss", "vae_recon", "kl")])
    for p, g1, g2 in zip(ref.parameters(), *grads):
        p.grad = (g1 + g2) / 2
    from representation_disentanglement_torch.training.optim import (
        clip_global_norm)
    gnorm = clip_global_norm([p.grad for p in ref.parameters()], 1.0)
    opt.step()
    want = dict(zip(("loss", "dice_loss", "vae_recon", "kl"),
                    np.mean(terms, 0)), grad_norm=gnorm.item())
    for k in train3d.METRIC_KEYS:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=ACCUM_RTOL,
                                   err_msg=k)
    for (name, p), q in zip(tm.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=ACCUM_ATOL, err_msg=name)


def test_eval_step_gives_probabilities():
    tm = port_model(2)
    x, _ = batch(30)
    probs, vout = train3d.make_eval_step_3d(tm)(torch.tensor(x))
    assert probs.shape == (1, 3) + HWD and vout.shape == (1, M) + HWD
    assert float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0
    assert not tm.training and not probs.requires_grad


@pytest.mark.parametrize("dataset,contrasts", [
    ("BraTS", ("T1", "T1c", "T2")), ("ZeroDose", ("T1", "T2_FLAIR"))])
def test_volume_dataset_matches_jax(dataset, contrasts):
    """From one in-memory store and seed, with augmentation and dropoff on
    and one contrast absent from one subject: every sample and collated
    batch equals JAX's up to the layout's transpose, the random draws in
    the same order.  The default slabs ([45:-46], [45:-47] of a 155- or
    156-slice volume) give 64 slices."""
    depth = 155 if dataset == "BraTS" else 156
    vols, subjects, _ = synthetic.synthetic_volumes(
        dataset, contrasts, "z-score", 6, (16, 8, depth), seed=3)
    del vols[f"{subjects[2]}/{contrasts[0]}"]
    if dataset == "BraTS":         # labels 1-4, one voxel of each
        vols[f"{subjects[0]}/seg"][0, 0, 45:49] = [1, 2, 3, 4]
    port = VolumeDataset3D(dataset, VolumeStore(data=vols), subjects,
                           contrasts, aug=True, dropoff=True,
                           image_size=(16, 8, 64))
    jax_ds = jdataset3d.VolumeDataset3D(
        dataset, jdataset.VolumeStore(data=vols), subjects, contrasts,
        aug=True, dropoff=True, image_size=(16, 8, 64))
    got, want = [], []
    for _ in range(4):                       # 24 samples' worth of draws
        for i in range(len(subjects)):
            got.append(port[i])
            want.append(jax_ds[i])
    masks = set()
    for g, w in zip(got, want):
        assert g["subj_id"] == w["subj_id"]
        np.testing.assert_array_equal(g["mask"], w["mask"])
        np.testing.assert_array_equal(g["inputs"],
                                      np.transpose(w["inputs"],
                                                   (0, 2, 3, 1)))
        np.testing.assert_array_equal(g["targets"][0],
                                      np.transpose(w["targets"][..., 0],
                                                   (1, 2, 0)))
        np.testing.assert_array_equal(g["mask_img"], w["mask_img"].T)
        assert g["inputs"].shape == (len(contrasts), 16, 8, 64)
        masks.add(tuple(g["mask"]))
    assert len(masks) > 1                    # dropoff or absence happened
    if dataset == "BraTS":
        labels = np.unique(got[0]["targets"])
        assert 4 not in labels and 3 in labels
    b = collate_volumes(got[:2])
    jb = jdataset3d.collate_volumes(want[:2])
    np.testing.assert_array_equal(b["inputs"], to_jax(jb["inputs"]))
    np.testing.assert_array_equal(b["targets"], to_jax(jb["targets"]))
    np.testing.assert_array_equal(b["mask"], jb["mask"])
    assert b["subj_id"] == jb["subj_id"]
    assert port[len(subjects) + 5] is None and jax_ds[len(subjects) + 5] \
        is None
