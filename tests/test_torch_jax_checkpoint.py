"""The port's reader of the JAX package's checkpoints
(training/flax_msgpack.py, ``checkpoint.load_checkpoint``) against flax's
``msgpack_restore``, on files written by the JAX package's
``save_checkpoint``; and a resumed Adam step: a JAX checkpoint's Adam state
mapped onto torch Adam, then one port Adam step, against JAX's
``adam_amsgrad_torch`` update on the same trees (the update jitted alone,
no model compile).

Reader: every leaf equal in value, dtype and shape (bfloat16 leaves by
their bits), the payload's scalars (0-d arrays in the file) as Python
numbers; a chunked leaf (flax's ``MAX_CHUNK_SIZE`` patched small) joined
back.  Adam: the parameters after the step rtol 1e-6 / atol 1e-8 (JAX
rounds the update before adding it, torch's ``addcdiv`` adds it unrounded:
measured at most 3.1e-9, one ulp of parameters of about 0.04), the moments
rtol 1e-6 / atol 1e-6 of the leaf's largest entry (torch mixes the first
moment as ``lerp``: measured 1.3e-10 on entries near 5e-7 of a leaf up to
3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from representation_disentanglement_tpu.training import (
    checkpoint as jckpt)
from representation_disentanglement_tpu.training.optim import (
    AdamAmsgradState, adam_amsgrad_torch)
from representation_disentanglement_torch import main_missing
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training import (
    checkpoint, flax_msgpack)
from representation_disentanglement_torch.training.optim import (
    make_optimizer)
from representation_disentanglement_torch.weights import (
    from_jax_grads, from_jax_params)
from test_torch_dump import BASE, jax_weights, port_weights

M, H, W = 2, 32, 64


def _tree_like(params, rs, scale=1.0, positive=False):
    f = (lambda a: np.abs(rs.normal(size=a.shape)).astype(np.float32)
         * scale) if positive else (
        lambda a: rs.normal(size=a.shape).astype(np.float32) * scale)
    return _map(f, params)


def _map(f, tree):
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    return f(np.asarray(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for k, wv in w.items():
        gv = g[k]
        if isinstance(wv, np.ndarray) and wv.dtype.name == "bfloat16":
            assert isinstance(gv, torch.Tensor) and gv.dtype == torch.bfloat16
            assert tuple(gv.shape) == wv.shape
            np.testing.assert_array_equal(gv.view(torch.int16).numpy(),
                                          wv.view(np.int16), err_msg=str(k))
        elif isinstance(wv, np.ndarray):
            assert isinstance(gv, np.ndarray), k
            assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
            np.testing.assert_array_equal(gv, wv, err_msg=str(k))
        else:
            assert type(gv) is type(wv) and gv == wv, k


def _payload(rs):
    """A JAX training checkpoint's payload, with what a run writes and a
    few leaves it could: a bfloat16 leaf, an int leaf, a nested stat."""
    params = {"enc": {"conv": {"kernel": rs.normal(size=(3, 3, 2, 4))
                               .astype(np.float32),
                               "bias": rs.normal(size=(4,)).astype(
                                   np.float32)}},
              "half": jnp.asarray(rs.normal(size=(5, 7)), jnp.bfloat16),
              "count": np.arange(6, dtype=np.int32).reshape(2, 3)}
    z = lambda: _map(lambda a: np.zeros_like(a), params)
    return {"epoch": 4, "monitor_metric": 0.25, "monitor_is_val_dice": 1,
            "stat": {"loss": 1.5, "per_class": {"dice_1": 0.5}},
            "params": params, "batch_stats": {"enc": {"bn": {
                "mean": np.zeros(4, np.float32),
                "var": np.ones(4, np.float32)}}},
            "opt_state": AdamAmsgradState(jnp.asarray(7, jnp.int32), z(),
                                          z(), z()),
            "opt_d_state": (),
            "scheduler": {"lr": 2e-4, "best": 0.5, "num_bad_epochs": 2}}


@pytest.mark.parametrize("chunk", [None, 64])
def test_reader_matches_flax(tmp_path, monkeypatch, chunk):
    if chunk is not None:               # every leaf over 64 bytes chunked
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    jckpt.save_checkpoint(_payload(np.random.default_rng(0)), False,
                          str(tmp_path), name="a.ckpt")
    blob = (tmp_path / "a.ckpt").read_bytes()
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in blob
    want = serialization.msgpack_restore(blob)
    _assert_trees_equal(flax_msgpack.restore(blob), want)
    assert want["opt_d_state"] == {}
    got = checkpoint.load_checkpoint(str(tmp_path), "a.ckpt")
    assert got["format"] == "jax"
    assert (got["epoch"], got["monitor_metric"],
            got["monitor_is_val_dice"]) == (4, 0.25, 1)
    assert type(got["epoch"]) is int and type(got["monitor_metric"]) is float
    assert got["stat"] == {"loss": 1.5, "per_class": {"dice_1": 0.5}}
    assert got["scheduler"] == {"lr": 2e-4, "best": 0.5,
                                "num_bad_epochs": 2}
    assert int(got["opt_state"]["count"]) == 7


def test_reader_covers_the_scalar_types():
    """Every msgpack type flax writes or reads: ints of each width, floats,
    nil, bools, str and bin, ext 2 (complex) and ext 3 (numpy scalar)."""
    import msgpack
    tree = {"ints": [0, 127, -1, -32, -33, 255, 65535, 2 ** 32, -2 ** 40,
                     2 ** 63],
            "f": [0.5, -1e300], "none": None, "b": [True, False],
            "s": "x" * 40, "bin": b"\x00\x01" * 200,
            "c": complex(1.5, -2.0), "np": np.float32(3.5),
            "big": list(range(20)), "map": {str(i): i for i in range(20)}}
    blob = serialization.msgpack_serialize(tree)
    got = flax_msgpack.restore(blob)
    want = serialization.msgpack_restore(blob)
    assert got == want
    assert isinstance(got["np"], np.float32)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(blob[:-3])
    with pytest.raises(ValueError, match="after the msgpack"):
        flax_msgpack.restore(blob + msgpack.packb(1))


def test_load_checkpoint_tells_the_formats_apart(tmp_path):
    checkpoint.save_checkpoint({"epoch": 2, "params": {"w": torch.ones(2)}},
                               False, str(tmp_path), name="t.ckpt")
    got = checkpoint.load_checkpoint(str(tmp_path), "t.ckpt")
    assert "format" not in got and got["epoch"] == 2
    (tmp_path / "x.ckpt").write_bytes(b"\x00garbage")
    with pytest.raises(ValueError, match="neither"):
        checkpoint.load_checkpoint(str(tmp_path), "x.ckpt")


def test_resumed_adam_step_matches_jax(tmp_path):
    """A JAX checkpoint (params, batch_stats, Adam state at count 3) read
    by the port's ``_restore`` and ``restore_optimizers``, then one port
    Adam step on given gradients, against JAX's update of the same trees:
    the parameters and the three moments."""
    cfg = Config(**BASE).derive().validate()
    cfg.ckpt_path = str(tmp_path)
    params, stats = (_map(np.asarray, t) for t in jax_weights(port_weights()))
    rs = np.random.default_rng(5)
    state = AdamAmsgradState(
        jnp.asarray(3, jnp.int32), _tree_like(params, rs, 1e-3),
        _tree_like(params, rs, 1e-6, positive=True),
        _tree_like(params, rs, 2e-6, positive=True))
    grads = _tree_like(params, rs, 1e-2)
    jckpt.save_checkpoint({"epoch": 3, "monitor_metric": 0.5, "stat": {},
                           "params": params, "batch_stats": stats,
                           "opt_state": state, "opt_d_state": (),
                           "scheduler": {"lr": cfg.lr, "best": 0.5,
                                         "num_bad_epochs": 0}},
                          True, str(tmp_path))
    tx = adam_amsgrad_torch(weight_decay=cfg.weight_decay)
    # jitted: op by op, the update of 202 leaves compiles each op apart
    updates, new = jax.jit(lambda g, s, p: tx.update(
        g, s, p, learning_rate=cfg.lr))(grads, state, params)
    want = from_jax_params(_map(np.asarray, {
        k: v for k, v in _map_pair(lambda p, u: np.asarray(p)
                                   + np.asarray(u), params,
                                   updates).items()}), None,
        modality_num=M, input_size=(H, W))

    model = build_model(cfg, device="cpu")
    ckpt, restored = main_missing._restore(model, cfg, "model_best.ckpt")
    assert restored[0] == restored[1]
    optimizer = make_optimizer(model.parameters(), cfg)
    assert main_missing.restore_optimizers(ckpt, optimizer)
    named = dict(model.named_parameters())
    for name, g in from_jax_grads(grads, modality_num=M,
                                  input_size=(H, W)).items():
        named[name].grad = g.clone()
    assert all(p.grad is not None for p in named.values())
    optimizer.step()
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    moments = {k: from_jax_grads(_map(np.asarray, getattr(new, j)),
                                 modality_num=M, input_size=(H, W))
               for k, j in (("exp_avg", "mu"), ("exp_avg_sq", "nu"),
                            ("max_exp_avg_sq", "nu_max"))}
    for name, p in named.items():
        st = optimizer.state[p]
        assert float(st["step"]) == 4.0
        for k, tree in moments.items():
            want_k = tree[name].numpy()
            np.testing.assert_allclose(
                st[k].numpy(), want_k, rtol=1e-6,
                atol=1e-6 * float(np.abs(want_k).max()),
                err_msg=f"{name} {k}")


def _map_pair(f, a, b):
    if isinstance(a, dict):
        return {k: _map_pair(f, a[k], b[k]) for k in a}
    return f(a, b)
