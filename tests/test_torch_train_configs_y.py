"""The port's train step with the y losses against the JAX package's
``make_train_step``, on the CPU from the same weights (model, data and
tolerances of tests/test_torch_train_configs.py):

- the stage-2 freeze: configs/brats_seg_stage2.yaml's losses (the BraTS
  segmentation y, recon_y 1 and recon_y_fused 2, every stage-1 loss off,
  ``out_num_ch`` 4) with ``continue_train`` + ``fix_pretrain``, 3 steps of
  two microbatches: the trajectory, the frozen parameters bit-identical,
  the output decoder moved, the frozen parameters' Adam moments (driven by
  the weight decay alone) as JAX's, rtol 1e-6 (measured 1.7e-7), and the
  BatchNorm running statistics, per tensor within 5e-3 of the tensor's
  largest value (measured 3.1e-3); the metrics measured at most 5.9e-5
  relative (the gradient norm);
- ZeroDose: configs/zerodose_pet.yaml's losses (the L1 reconstruction of
  a PET-like target, recon_y 1 and recon_y_fused 2, beside the shipped
  five; T1 and T2-FLAIR), 3 steps of one microbatch: the trajectory
  (measured at most 2.0e-4 relative, the gradient norm of the third
  step).
"""

import numpy as np
import torch

from representation_disentanglement_torch.training.train import (
    is_stage1_param)
from representation_disentanglement_torch.weights import from_jax_grads
from tests.test_torch_train_configs import (  # noqa: F401
    B, H, M, W, assert_trajectory, few_threads, make_batch, port_state_dict,
    run_both, start, z_is_the_mean)

STAGE2 = dict(contrast_list=["T1", "T1c"], lambda_recon_y=1.0,
              lambda_recon_y_fused=2.0, lambda_recon_x=0.0,
              lambda_recon_x_mix=0.0, lambda_kl=0.0, lambda_latent_z=0.0,
              lambda_sim_s=0.0, lambda_sim_z=0.0, lambda_adv_s=0.0,
              out_num_ch=4, continue_train=True, fix_pretrain=True)
ZERODOSE = dict(dataset_name="ZeroDose", contrast_list=["T1", "T2_FLAIR"],
                lambda_recon_y=1.0, lambda_recon_y_fused=2.0, p=1,
                effective_batch=B)


def test_stage2_freeze_matches_jax(z_is_the_mean):
    start_ = start(STAGE2)
    sd0 = start_[2]
    got, want, port, opt, state = run_both(STAGE2, start_,
                                           make_batch("seg"))
    assert_trajectory(got, want)
    assert all(g["recon_y"] > 0 and g["recon_y_fused"] > 0 for g in got)
    kw = dict(modality_num=M, input_size=(H, W))
    mu = from_jax_grads(state.opt_state.mu, **kw)
    nu = from_jax_grads(state.opt_state.nu, **kw)
    n_frozen = 0
    for name, p in port.named_parameters():
        if is_stage1_param(name):
            assert torch.equal(p.detach(), sd0[name]), name
            st = opt.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name],
                                       rtol=1e-6, atol=0, err_msg=name)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name],
                                       rtol=1e-6, atol=0, err_msg=name)
            n_frozen += 1
        elif name.startswith("output_decoder."):
            assert not torch.equal(p.detach(), sd0[name]), name
    assert n_frozen > 0
    want_sd = port_state_dict(state)
    for k, v in port.state_dict().items():
        if "running" in k:
            err = float((v - want_sd[k]).abs().max())
            assert err <= 5e-3 * float(want_sd[k].abs().max()), k


def test_zerodose_matches_jax(z_is_the_mean):
    got, want, *_ = run_both(ZERODOSE, start(ZERODOSE), make_batch("pet"))
    assert_trajectory(got, want)
    for k in ("recon_y", "recon_y_fused", "recon_x", "recon_x_mix"):
        assert all(g[k] > 0 for g in got), k
