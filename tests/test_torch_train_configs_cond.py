"""The gradients of one adversarial step with conditional convolutions
(``is_cond``, as the flagship) against the JAX package's
``make_train_step``, leaf by leaf, before any Adam step: the accumulated
and clipped main gradient of two microbatches, and the discriminator's
gradient ``d_grads`` (quirk Q3: over every parameter), which the step
carries into the next window (quirk Q10).

Both steps run whole, with their optimizers replaced by a capture: on the
port, each optimizer's ``step`` records ``.grad`` instead of stepping; on
the JAX side, a transformation whose update is zero and whose new state is
the gradient it was given, so the main gradient comes back as
``opt_state`` and ``d_grads`` as ``d_carry``.  The configuration is the
EVERYTHING set of tests/test_torch_train_configs.py (the BraTS
segmentation y, the KL to the learned prior, the adversarial step, the
latent and sim terms) with ``is_cond: True``; model, data and weights as
there.

Tolerance, per leaf: |port - JAX| <= 1e-3 * max|JAX leaf| + 2e-5,
tests/test_torch_train_model.py's.  Measured on a CPU: at most 1.05e-4 of
the leaf's largest entry on every leaf but those below, so those leaves
are also held to 1e-3 of their largest entry without the absolute term.

Zero up to rounding: the 31 biases that feed a normalization
(``BEFORE_NORM``: the anatomy encoder's convs before their BatchNorm, the
discriminator's convs 2, 5, 8 and 11 before theirs, the output decoder's
convs before its BatchNorms, the SPADE ``out`` convs sp1-sp5 before the
instance norm).  A constant before a normalization changes no output, so
their gradient is exactly 0 and both sides return rounding noise:
measured 1e-12 to 6e-9 in the main gradient (all 31) and 7e-9 to 1.2e-6
in ``d_grads`` (the 12 of the anatomy encoder and the discriminator), up
to 3.1 times the JAX value apart.

What Adam makes of these gradients: its first update is
-lr * g / (|g| + eps), about lr times the sign of g, so an element whose
gradient lies within rounding of zero steps by up to lr either way.  The
main Adam adds the weight decay (1e-5 * w) to g first, which decides the
sign there: measured, no element of the two sides' first main updates
differs by lr / 2.  The discriminator's Adam has no weight decay:
measured, 29 of 32.2 M elements (all in the anatomy encoder's conv
weights) take first updates that differ by more than lr / 2, and the 12
rounding biases of ``d_grads`` take steps of 0.4 to 1 lr of arbitrary
sign (those move no train-mode loss, since the normalization removes them,
only the BatchNorm running means they feed).  That is where multi-step
trajectories of port and JAX part with CondConv on: with plain SGD in place
of both Adams the same three steps agree within 2e-3
(``test_cond_adversarial_sgd_trajectory_matches_jax``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_tpu.training import train as jtrain
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training import optim, train
from representation_disentanglement_torch.weights import from_jax_grads
from tests.test_torch_train_configs import (  # noqa: F401
    A, ADV, BASE, EVERYTHING, H, M, SIM, STEPS, W, assert_trajectory,
    few_threads, make_batch, start, z_is_the_mean)

KW = dict(EVERYTHING, is_cond=True, is_distri_z=True)
BEFORE_NORM = re.compile(
    r"anatomy_encoder_(enc_list\.\d\.down_\d|dec\.up_\d)\.conv\.bias"
    r"|discrim_s\.discrim\.(2|5|8|11)\.bias"
    r"|output_decoder\.(down_\d\.conv\.0|up_\d\.up\.1|att_\d\.W_out\.0)"
    r"\.bias"
    r"|input_decoder_list\.\d\.sp[1-5]\.out\.bias")


class Capture:
    """An optax-like transformation: zero updates, the gradient as state."""

    @staticmethod
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    @staticmethod
    def update(grads, state, params=None, learning_rate=None):
        return jax.tree.map(jnp.zeros_like, grads), grads


class SGD:
    """An optax-like plain SGD: the update -learning_rate * g, no state."""

    @staticmethod
    def init(params):
        return ()

    @staticmethod
    def update(grads, state, params=None, learning_rate=None):
        return jax.tree.map(lambda g: -learning_rate * g, grads), state


def jax_grads(state, batch):
    jcfg = JaxConfig(**dict(BASE, remat=False, **KW)).derive().validate()
    jstep, _ = jtrain.make_train_step(jax_build_model(jcfg), jcfg,
                                      (Capture, Capture), donate=False)
    zeros = Capture.init(state.params)
    state = jtrain.TrainState(state.params, state.batch_stats, zeros, zeros,
                              zeros)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out, _ = jstep(state, jb, jax.random.split(jax.random.PRNGKey(0), A),
                   jnp.asarray(SIM), jnp.asarray(ADV), jnp.float32(0.0))
    grads = lambda tree: from_jax_grads(jax.tree.map(np.asarray, tree),
                                        modality_num=M, input_size=(H, W))
    return grads(out.opt_state), grads(out.d_carry)


def port_grads(sd, batch):
    cfg = Config(**dict(BASE, **KW)).derive().validate()
    port = build_model(cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    seen = {}
    opts = {"main": optim.make_optimizer(port.parameters(), cfg),
            "d": optim.make_d_optimizer(port.parameters(), cfg)}
    for name, opt in opts.items():
        def capture(*args, name=name, **kw):
            seen[name] = {n: p.grad.detach().clone()
                          for n, p in port.named_parameters()}
        opt.step = capture
    train.make_train_step(port, cfg, opts["main"], opts["d"])(
        batch, None, SIM, ADV, first_of_epoch=True)
    return seen["main"], seen["d"]


def test_cond_adversarial_gradients_match_jax_leaf_by_leaf(z_is_the_mean):
    state, _, sd = start(KW)
    batch = make_batch("seg")
    want_main, want_d = jax_grads(state, batch)
    got_main, got_d = port_grads(sd, batch)
    rounding = {}
    for which, got, want in (("main", got_main, want_main),
                             ("d", got_d, want_d)):
        assert set(got) == set(want)
        top = max(float(w.abs().max()) for w in want.values())
        for name, w in want.items():
            g, w = got[name].numpy(), w.numpy()
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            assert err <= 1e-3 * scale + 2e-5, (which, name, err, scale)
            if BEFORE_NORM.fullmatch(name):
                # zero up to rounding on both sides
                assert max(scale, float(np.abs(g).max())) <= 1e-5 * top, (
                    which, name, scale)
                rounding.setdefault(which, []).append(name)
            else:
                assert err <= 1e-3 * scale, (which, name, err, scale)
    assert len(rounding["main"]) == 31
    # the discriminator's loss reaches only the anatomy encoder and itself
    assert sum(bool(got_d[n].any()) for n in rounding["d"]) == 12

    # Adam's first update of each side, on the leaves a loss can see
    cfg = Config(**dict(BASE, **KW)).derive()
    lr, eps, wd = cfg.lr, 1e-8, cfg.weight_decay
    first = lambda g: -lr * g / (np.abs(g) + eps)
    for which, got, want, decay, most in (("main", got_main, want_main, wd, 0),
                                          ("d", got_d, want_d, 0.0, 1000)):
        apart = 0
        for name, w in want.items():
            if not BEFORE_NORM.fullmatch(name):
                p = sd[name].numpy()
                du = first(got[name].numpy() + decay * p) - first(
                    w.numpy() + decay * p)
                apart += int((np.abs(du) > lr / 2).sum())
        assert apart <= most, (which, apart)


def test_cond_adversarial_sgd_trajectory_matches_jax(z_is_the_mean):
    """The three CondConv adversarial steps whose Adam trajectories of port
    and JAX part by up to 9e-3 (sim_s, the gradient norm), with both
    optimizers of both sides replaced by plain SGD at the configuration's
    learning rate (2e-4): the metrics of every step agree within the
    trajectory tests' rtol 2e-3 (measured on a CPU: at most 7.3e-4, the
    latent-z term of about 5e-5), while the steps move the losses (sim_s
    0.172 -> 0.102, adv_s 1.417 -> 1.454).  So the 9e-3 comes from Adam,
    whose first update is about lr * sign(g) and turns rounding-level
    gradient differences into lr-sized steps (see the module docstring),
    not from a fault of the port."""
    state, _, sd = start(KW)
    batch = make_batch("seg")
    jcfg = JaxConfig(**dict(BASE, remat=False, **KW)).derive().validate()
    jstep, _ = jtrain.make_train_step(jax_build_model(jcfg), jcfg,
                                      (SGD, SGD), donate=False)
    jstate = jtrain.TrainState(state.params, state.batch_stats, (), (),
                               jax.tree.map(jnp.zeros_like, state.params))
    cfg = Config(**dict(BASE, **KW)).derive().validate()
    port = build_model(cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    step = train.make_train_step(
        port, cfg, torch.optim.SGD(port.parameters(), lr=cfg.lr),
        torch.optim.SGD(port.parameters(), lr=cfg.lr))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = jax.random.split(jax.random.PRNGKey(0), A)
    got, want = [], []
    for i in range(STEPS):
        # the y loss is on, so every step decodes y on both sides
        jstate, m = jstep(jstate, jb, rngs, jnp.asarray(SIM),
                          jnp.asarray(ADV), jnp.float32(cfg.lr))
        want.append(jtrain.metrics_to_dict(m))
        got.append(train.metrics_to_dict(step(batch, None, SIM, ADV,
                                              first_of_epoch=(i == 0))))
    assert_trajectory(got, want)
    for side in (got, want):
        assert abs(side[1]["sim_s"] - side[0]["sim_s"]) > 0.1 * side[0][
            "sim_s"]
