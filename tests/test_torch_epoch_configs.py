"""The port's device-cache epoch (``training/epoch.py::make_train_epoch``)
in the stage-2 and ZeroDose configurations against the JAX package's
``training/epoch.py::make_train_epoch`` (its ``lax.scan`` over the steps),
on the CPU, from the same weights and the same epoch plan:

- stage 2: configs/brats_seg_stage2.yaml's losses (the BraTS segmentation
  y, ``out_num_ch`` 4) with ``continue_train`` + ``fix_pretrain``, two
  microbatches per step: the stage-1 parameters bit-identical after the
  epoch on both sides;
- ZeroDose: configs/zerodose_pet.yaml's losses (the PET-like target beside
  the shipped five) with its two microbatches per step and its train-time
  dropoff.

Model as tests/test_torch_train_configs.py (M=2, 32x64, B=2, plain
convolutions, the port's initialization with nonzero biases carried to JAX
by ``transplant_multimodal``, z = the encoder mean), f32.  Data: the JAX
package's synthetic volumes (32x64x16) of the configuration's dataset,
8 train slices of one subject, so that an epoch is 2 optimizer steps of 2
microbatches; each side builds its own device cache (f32) and loader from
the same seeds, and the two plans (rows, slices, dropoff, pairs) are
equal.

Tolerances, those of tests/test_torch_main_missing.py's run, with what
was measured on a CPU (stage 2; ZeroDose):
- the per-step metrics: rtol 2e-3, atol 1e-6 (at most 8.2e-6; 3.0e-5
  relative);
- the final weights through ``weights.from_jax_params``, as the update
  each side made from the common start: per tensor the L2 gap at most
  5e-2 of JAX's update (4.1e-2; 2.3e-2, on a bias that a BatchNorm
  follows, whose gradient is rounding noise; median 9.6e-5; 1.4e-4), a
  tensor JAX did not move bit-identical, all tensors together 2e-3
  (5.1e-4; 6.1e-4); the BatchNorm running statistics per tensor within
  5e-3 of the tensor's largest value (4.6e-4; 4.8e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.data import (
    dataset as jdataset, device_store as jstore)
from representation_disentanglement_tpu.data.synthetic import (
    make_synthetic_dataset)
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_tpu.training import epoch as jepoch
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.data import dataset, device_store
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training import epoch, optim
from representation_disentanglement_torch.training.train import (
    is_stage1_param, metrics_to_dict)
from tests.test_torch_train_configs import (  # noqa: F401
    A, B, BASE, H, M, W, assert_trajectory, few_threads, port_state_dict,
    start, z_is_the_mean)
from tests.test_torch_train_configs_y import STAGE2, ZERODOSE

pytest.importorskip("h5py")

D = 16
STEPS = 2
UPDATE_REL, UPDATES_REL, BN_STAT_REL = 5e-2, 2e-3, 5e-3
# dataset, subject, configuration, dropoff, the loaders' seed (ZeroDose's
# drops two inputs of the epoch)
CASES = {
    "stage2": ("BraTS", "BraTS20_Training_000", dict(STAGE2), False, 3),
    "zerodose": ("ZeroDose", "case_000",
                 dict(ZERODOSE, effective_batch=A * B, dropoff=True), True,
                 6),
}

def _caches(tmp_path, name):
    """Both packages' train caches (f32) and loaders over the same 8
    slices of one synthetic subject."""
    ds, subj, kw, dropoff, seed = CASES[name]
    d = str(tmp_path)
    h5 = make_synthetic_dataset(d, ds, kw["contrast_list"], "z-score",
                                n_subj=1, shape=(H, W, D), seed=2)
    subjs, idxs = [subj] * (STEPS * A * B), list(range(4, 12))
    jcache = jstore.build_device_cache(
        ds, jdataset.VolumeStore(h5), subjs, kw["contrast_list"],
        block_size=3, dtype=jnp.float32)
    pcache = device_store.build_device_cache(
        ds, dataset.VolumeStore(h5), subjs, kw["contrast_list"],
        block_size=3, dtype=torch.float32, device="cpu")
    loaders = [store.DeviceBatchLoader(cache, subjs, idxs, B, shuffle=True,
                                       drop_last=True, dropoff=dropoff,
                                       seed=seed)
               for store, cache in ((jstore, jcache),
                                    (device_store, pcache))]
    return jcache, pcache, loaders

@pytest.mark.parametrize("name", list(CASES))
def test_device_epoch_matches_jax(name, tmp_path, z_is_the_mean):
    kw = CASES[name][2]
    state0, txs, sd0 = start(kw)
    jcache, pcache, (jloader, ploader) = _caches(tmp_path, name)

    jcfg = JaxConfig(**dict(BASE, remat=False, **kw)).derive().validate()
    jplan, _ = jepoch.epoch_indices(jloader, A, M, np.random.default_rng(4),
                                    jax.random.PRNGKey(0))
    pplan = epoch.epoch_indices(ploader, A, M, np.random.default_rng(4))
    assert pplan.steps == STEPS
    for j, p in zip((jplan[0], jplan[1], jplan[2], jplan[4], jplan[5]),
                    (pplan.rows, pplan.slices, pplan.drop, pplan.sim,
                     pplan.adv)):
        np.testing.assert_array_equal(np.asarray(j), np.asarray(p))
    if CASES[name][3]:
        assert float(np.asarray(jplan[2]).min()) == 0.0   # dropped inputs

    train_epoch, n_micro = jepoch.make_train_epoch(
        jax_build_model(jcfg), jcfg, txs, jcache, donate=False)
    assert n_micro == A
    state, jmetrics = train_epoch(state0, *jplan, jnp.float32(jcfg.lr),
                                  first_chunk=True)

    cfg = Config(**dict(BASE, **kw)).derive().validate()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd0, strict=True)
    opt = optim.make_optimizer(model.parameters(), cfg)
    port_epoch, _ = epoch.make_train_epoch(model, cfg, opt, pcache, None)
    pmetrics = port_epoch(pplan, True)

    got = [metrics_to_dict(r) for r in pmetrics]
    want = [metrics_to_dict(r) for r in np.asarray(jmetrics)]
    assert_trajectory(got, want)
    assert all(g["recon_y"] > 0 and g["recon_y_fused"] > 0 for g in got)

    want_sd = port_state_dict(state)
    num = den = 0.0
    for k, v in model.state_dict().items():
        w = want_sd[k]
        if "running" in k:
            err = float((v - w).abs().max())
            assert err <= BN_STAT_REL * float(w.abs().max()), k
            continue
        if "num_batches" in k:
            continue
        gap = float((v - w).norm())
        upd = float((w - sd0[k]).norm())
        if upd == 0.0:
            assert torch.equal(v, sd0[k]), k
        else:
            assert gap <= UPDATE_REL * upd, (k, gap, upd)
        num, den = num + gap ** 2, den + upd ** 2
    assert num ** 0.5 <= UPDATES_REL * den ** 0.5
    if name == "stage2":
        frozen = [k for k in sd0 if is_stage1_param(k) and "running" not in k
                  and "num_batches" not in k]
        assert frozen
        for k in frozen:
            assert torch.equal(model.state_dict()[k], sd0[k]), k
            assert torch.equal(want_sd[k], sd0[k]), k
