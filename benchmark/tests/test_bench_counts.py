"""The FLOP of a cell's request and step, counted on the reference, against
a count worked by hand at one small shape: every convolution and matrix
product of the model listed with its sizes, 2 FLOP per multiply-add; the
backward pass computes each product's weight gradient and, where its
input carries a gradient, its input gradient, each as many FLOP as the
forward product."""

import pytest

from benchmark import counts
from benchmark.inputs import load_config

H, W = 64, 96


def _conv(rows, ci, co, k, h, w, groups=0,
          in_grad=True):
    """One convolution (``groups``: the routing product of a CondConv
    over that many groups, 3 experts from one label), output h x w."""
    return [("conv", 2 * rows * h * w * co * ci * k * k, in_grad)] + (
        [("route", 2 * groups * 3, False)] if groups else [])


def _lin(rows, n_in, n_out, in_grad=True):
    return [("lin", 2 * rows * n_in * n_out, in_grad)]


def _anatomy(n, g, first_grad=False):
    f, out = 32, []
    chans = [7, f, 2 * f, 4 * f, 8 * f, 8 * f]
    for i in range(5):
        s = 2 ** (i + 1)
        out += _conv(n, chans[i], chans[i + 1], 4, H // s, W // s,
                     groups=g, in_grad=first_grad or i > 0)
    for ci, co, s in ((8 * f, 8 * f, 16), (16 * f, 4 * f, 8),
                      (8 * f, 2 * f, 4), (4 * f, f, 2), (2 * f, 4, 1)):
        out += _conv(n, ci, co, 3, H // s, W // s, groups=g)
    return out


def _modality(n, g, first_grad=False, log_var=True):
    """``log_var=False``: the log-variance head reaches no loss (the
    latent cycle), so it has no backward."""
    chans, out = [7, 16, 32, 64, 128, 128], []
    for i in range(5):
        s = 2 ** (i + 1)
        out += _conv(n, chans[i], chans[i + 1], 3, H // s, W // s,
                     groups=g, in_grad=first_grad or i > 0)
    flat = 128 * (H // 32) * (W // 32)
    head = _lin(n, 32, 16) if log_var else [("forward only", 2 * n * 32 * 16,
                                             False)]
    return out + _lin(n, flat, 32) + _lin(n, 32, 16) + head


def _spade(n, g, ci, co, s):
    h, w = H // s, W // s
    return (_conv(n, 4, ci, 3, h, w, groups=g)
            + _conv(n, ci, ci, 3, h, w, groups=g) * 2
            + _conv(n, ci, co, 3, h, w, groups=g))


def _shared(n, g):
    return (_lin(n, 16, (H // 32) * (W // 32) * 128)
            + _spade(n, g, 128, 128, 32) + _spade(n, g, 128, 128, 16)
            + _spade(n, g, 128, 128, 8))


def _not_shared(n, g):
    return (_spade(n, g, 128, 64, 4) + _spade(n, g, 64, 32, 2)
            + _spade(n, g, 32, 16, 1) + _conv(n, 16, 7, 1, H, W, groups=g))


def _usa(n):
    f, out = 64, []
    chans = [4, f, 2 * f, 4 * f, 8 * f, 8 * f]
    for i in range(5):
        s = 2 ** (i + 1)
        out += _conv(n, chans[i], chans[i + 1], 4, H // s, W // s)
    # level: skip channels, gate channels, skip scale, up conv in -> out
    for c, gc, s, ui, uo in ((8 * f, 8 * f, 16, 8 * f, 8 * f),
                             (4 * f, 16 * f, 8, 16 * f, 4 * f),
                             (2 * f, 8 * f, 4, 8 * f, 2 * f),
                             (f, 4 * f, 2, 4 * f, f)):
        h, w = H // s, W // s
        out += (_conv(n, c, c, 2, h // 2, w // 2)
                + _conv(n, gc, c, 1, h // 2, w // 2)
                + _conv(n, c, 1, 1, h // 2, w // 2)
                + _conv(n, c, c, 1, h, w)
                + _conv(n, ui, uo, 3, h, w))
    return out + _conv(n, 2 * f, 1, 3, H, W)


def _cfg(name):
    cfg = load_config(name)
    cfg.update(input_height=H, input_width=W)
    return cfg


def _fwd(ops):
    return sum(f for _, f, _ in ops)


def _fwd_bwd(ops):
    """Forward, the weight gradients and the input gradients asked for."""
    times = {"conv": 2, "lin": 2, "route": 2, "forward only": 1}
    return sum(f * (times[k] + bool(g)) for k, f, g in ops)


@pytest.mark.parametrize("name,M", [("brats_4mod", 4), ("zerodose_pet", 2)])
def test_request_flop_by_hand(name, M):
    B = 3
    n = M * B
    hand = (_anatomy(n, M) + _modality(n, M) + _shared(n, M)
            + _not_shared(n, M) + _usa(B))
    assert counts.request_flop(_cfg(name), B) == _fwd(hand)


@pytest.mark.parametrize("name,M,y", [("brats_4mod", 4, False),
                                      ("zerodose_pet", 2, True)])
def test_train_step_flop_by_hand(name, M, y):
    B, A = 2, 3
    n = M * B
    grad = (_anatomy(n, M) + _modality(n, M) + _shared(M * n, M * M)
            + sum((_not_shared(n, M) for _ in range(M)), [])
            + (_usa((M + 1) * B) if y else [])
            + _modality(n, M, first_grad=True, log_var=False))  # latent cycle
    no_grad = _anatomy(n, M)                  # its BatchNorm statistics
    hand = _fwd_bwd(grad) + _fwd(no_grad)
    assert counts.train_step_flop(_cfg(name), B, A) == A * hand
