"""Shared set-up of the parity tests of the modules beside
``MultimodalModel`` (tests/test_torch_zcond.py, test_torch_legacy_models.py,
test_torch_legacy_generators.py, test_torch_resnet_danet.py).

``LegacyPair`` holds a JAX module with variables of the structure of its
``init`` and random values from a seed (``jax.eval_shape`` gives the
structure, so no JAX init is compiled: a jitted init of one of these
generators takes about 10 s on the CPU), and the port's module with the
same weights through ``weights.from_jax_legacy``.  The random values are
nonzero where the init puts zeros (CondConv biases, PAM/CAM ``gamma``), so
that those paths and their gradients are tested.  ``check`` runs the JAX
module in eval and train mode in one jitted call and holds the port
against it: outputs within ``REL_L2`` relative L2 and ``ATOL`` (the JAX
package's own legacy tolerance, tests/test_legacy_generators.py:23), and
the updated running statistics.  ``check_grads`` holds the gradient of a
scalar loss leaf by leaf against ``jax.grad``.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from representation_disentanglement_torch.weights import from_jax_legacy

REL_L2 = 1e-4
ATOL = 2e-4
STATS_ATOL = 1e-5
GRAD_REL = 1e-4


def few_threads():
    """Two intra-op threads: the workers of a parallel test run share the
    cores, and torch's thread pool slows many times over when they are
    oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def random_variables(shapes, seed: int):
    """Numpy leaves of the structure ``shapes``: torch-default-like
    kernels, small nonzero biases, BatchNorm scales and running variances
    in [0.5, 1.5], ``gamma`` in [0.3, 0.8]."""
    rs = np.random.default_rng(seed)

    def fill(path, a):
        name, shape = path[-1].key, a.shape
        if name == "mean":
            return rs.normal(0.0, 0.1, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("bias", "route_bias"):
            return rs.normal(0.0, 0.05, shape).astype(np.float32)
        if name == "gamma":
            return rs.uniform(0.3, 0.8, shape).astype(np.float32)
        if name == "route_kernel":
            return rs.uniform(-1.0, 1.0, shape).astype(np.float32)
        fan = int(np.prod(shape[-4:-1])) if len(shape) >= 4 else shape[-2]
        return (rs.uniform(-1.0, 1.0, shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


def nchw(a):
    """A JAX NHWC array (or grouped [G, B, H, W, C], folded group-major)
    in the port's NCHW layout; other ranks as they are."""
    a = np.asarray(a)
    if a.ndim == 5:
        a = a.reshape((-1,) + a.shape[2:])
    return np.moveaxis(a, -1, 1) if a.ndim == 4 else a


def first(out):
    return out[0] if isinstance(out, tuple) else out


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got, want, what: str, rel=REL_L2, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    diff = float(np.abs(got - want).max())
    assert err <= rel and diff <= atol, f"{what}: rel L2 {err}, max {diff}"


class LegacyPair:
    """``jm`` (flax) applied as ``jm.apply(v, *jargs, train=...)`` and
    ``tm`` (the port, on the CPU) applied as ``tm(*targs)``; ``kind`` is
    ``from_jax_legacy``'s."""

    def __init__(self, jm, tm, kind: str, jargs, targs, seed: int = 1,
                 jkw=None):
        self.jm, self.tm, self.kind = jm, tm, kind
        self.jargs, self.targs, self.jkw = jargs, targs, dict(jkw or {})
        shapes = jax.eval_shape(lambda k: jm.init(
            {"params": k}, *jargs, **self._mode(False)),
            jax.random.PRNGKey(0))
        v = random_variables(shapes, seed)
        self.params = v["params"]
        self.stats = v.get("batch_stats", {})
        tm.load_state_dict(from_jax_legacy(self.params, self.stats, kind),
                           strict=True)

    def _mode(self, train: bool):
        """The keywords of a JAX call; a module without BatchNorm or
        dropout (PAM, CAM) takes no ``train``."""
        if "train" not in inspect.signature(self.jm.__call__).parameters:
            return self.jkw
        return dict(self.jkw, train=train)

    def jax_both(self):
        """(eval output, whole, train output, train-updated batch_stats)."""
        def both(params, stats, *args):
            v = {"params": params, "batch_stats": stats}
            e = self.jm.apply(v, *args, **self._mode(False))
            if not stats:
                return e, first(self.jm.apply(v, *args,
                                              **self._mode(True))), stats
            out, new = self.jm.apply(v, *args, mutable=["batch_stats"],
                                     **self._mode(True))
            return e, first(out), new["batch_stats"]
        return jax.jit(both)(self.params, self.stats, *self.jargs)

    def check(self, what: str, train_tol=(REL_L2, ATOL)):
        """Eval and train outputs and the running statistics against JAX,
        and a dict of eval-mode maps returned beside the output (the
        attention gates' alphas); returns the port's train output.  The
        train output is held at ``train_tol`` (relative L2, max abs)."""
        je, jt, jstats = self.jax_both()
        tm = self.tm
        with torch.no_grad():
            te = tm.eval()(*self.targs)
            tt = first(tm.train()(*self.targs))
        if isinstance(te, tuple) and isinstance(te[1], dict):
            assert sorted(te[1]) == sorted(je[1])
            for k, v in te[1].items():
                assert_close(v.numpy(), nchw(je[1][k]), f"{what} {k}")
        te, je = first(te), first(je)
        assert_close(te.numpy(), nchw(je), f"{what} eval")
        assert_close(tt.numpy(), nchw(jt), f"{what} train", *train_tol)
        want = from_jax_legacy(self.params, to_np(jstats), self.kind)
        got = tm.state_dict()
        stats = [k for k in want if k.endswith(("running_mean",
                                                "running_var"))]
        assert len(stats) == sum(
            1 for k in got if k.endswith(("running_mean", "running_var")))
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=STATS_ATOL,
                                       err_msg=f"{what} {k}")
        return tt

    def check_grads(self, what: str, cancelled: str = "", seed: int = 7):
        """The gradient of sum(y * r) (r fixed random, y the train-mode
        output) on every parameter, leaf by leaf, within GRAD_REL of the
        leaf's largest JAX entry.  The parameters whose names match the
        regex ``cancelled`` (the bias of a conv that a train-mode BatchNorm
        follows, which the normalization cancels: its gradient is zero up
        to rounding) are held against the model's largest gradient entry
        instead."""
        je = jax.eval_shape(lambda: first(self.jm.apply(
            {"params": self.params, "batch_stats": self.stats}, *self.jargs,
            **self._mode(False))))
        r = np.random.default_rng(seed).standard_normal(je.shape).astype(
            np.float32)

        def loss(params, stats, *args):
            v = {"params": params, "batch_stats": stats}
            if stats:
                out, _ = self.jm.apply(v, *args, mutable=["batch_stats"],
                                       **self._mode(True))
            else:
                out = self.jm.apply(v, *args, **self._mode(True))
            return jnp.sum(first(out) * r)

        jg = jax.jit(jax.grad(loss))(self.params, self.stats, *self.jargs)
        want = from_jax_legacy(to_np(jg), None, self.kind)
        tm = self.tm.train()
        tm.zero_grad(set_to_none=True)
        y = first(tm(*self.targs))
        (y * torch.from_numpy(nchw(r).copy())).sum().backward()
        named = dict(tm.named_parameters())
        assert set(named) == set(want)
        top = max(float(v.abs().max()) for v in want.values())
        for name, p in named.items():
            w = want[name].numpy()
            g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
            scale = (top if cancelled and re.search(cancelled, name)
                     else max(float(np.abs(w).max()), 1e-12))
            assert float(np.abs(g - w).max()) <= GRAD_REL * scale, \
                f"{what} grad {name}: {np.abs(g - w).max()} of {scale}"


def seeded(shape, seed: int):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
