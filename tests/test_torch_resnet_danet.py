"""ResNet18 and DANet of the port (models/resnet.py, models/danet.py)
against the JAX package's on the CPU, with the same weights carried over
by ``weights.from_jax_legacy``: ResNet18 in eval and train mode with the
updated running statistics and its gradient leaf by leaf; the torchvision
``state_dict`` contract of ``load_resnet18_params`` on a synthetic state
dict (the fc taken only when its rows match); PAM and CAM alone; DANet
(dilated ResNet50 backbone, dual-attention head, nonzero ``gamma``s) in
eval and train mode without dropout; and the head's Dropout2d statistics
from a ``torch.Generator``.  B = 2, f32, the fixed torchvision widths.
"""

import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.models import danet as JD
from representation_disentanglement_tpu.models import resnet as JR
from representation_disentanglement_torch.models import danet as D
from representation_disentanglement_torch.models import resnet as R
import torch_legacy_common as C

few_threads = pytest.fixture(scope="module", autouse=True)(C.few_threads)


def _resnet_pair(seed=1):
    x = C.seeded((2, 3, 64, 64), 0)
    return C.LegacyPair(JR.ResNet18(), R.ResNet18(device="cpu"), "resnet18",
                        (C.nhwc(x),), (torch.from_numpy(x),), seed=seed)


def test_resnet18_parity_and_grads():
    p = _resnet_pair()
    p.check("ResNet18")
    p.check_grads("ResNet18")


def test_load_resnet18_params_contract():
    """A torchvision-style state dict (with ``num_batches_tracked`` and a
    1000-way fc) through JAX's ``load_resnet18_params`` and the port's:
    the same network; with ``num_outputs`` 1000 both take the fc."""
    src = R.ResNet18(num_outputs=1000, gen=torch.Generator().manual_seed(3),
                     device="cpu")
    rs = np.random.default_rng(4)
    sd = {}
    for k, v in src.state_dict().items():
        a = v.numpy()
        if k.endswith("running_mean"):
            a = rs.normal(0, 0.2, a.shape).astype(np.float32)
        elif k.endswith("running_var"):
            a = rs.uniform(0.6, 1.4, a.shape).astype(np.float32)
        sd[k] = a
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = np.array(3)
    x = C.seeded((2, 3, 64, 64), 5)
    for rows in (1, 1000):
        params, stats = JR.load_resnet18_params(sd, num_outputs=rows)
        tm = R.ResNet18(num_outputs=rows, device="cpu")
        fc = tm.fc.weight.detach().clone()
        loaded = R.load_resnet18_params(tm, sd)
        assert ("fc.weight" in loaded) == (rows == 1000)
        if rows == 1:                  # the model's own fc is kept: give
            params["fc"] = {           # JAX the same one
                "kernel": fc.numpy().T, "bias": tm.fc.bias.detach().numpy()}
        want = JR.ResNet18(num_outputs=rows).apply(
            {"params": params, "batch_stats": stats}, C.nhwc(x), train=False)
        with torch.no_grad():
            got = tm.eval()(torch.from_numpy(x))
        C.assert_close(got.numpy(), np.asarray(want), f"rows={rows}")
    with pytest.raises(ValueError, match="resnet18"):
        R.load_resnet18_params(R.ResNet18(device="cpu"),
                               {"conv1.weight": sd["conv1.weight"]})


@pytest.mark.parametrize("name", ["PAM", "CAM"])
def test_pam_cam_parity(name):
    x = C.seeded((2, 16, 8, 12), 6)
    jm = JD.PAM() if name == "PAM" else JD.CAM()
    gen = torch.Generator().manual_seed(0)
    tm = D.PAM(16, gen=gen) if name == "PAM" else D.CAM()
    C.LegacyPair(jm, tm, "danet", (C.nhwc(x),), (torch.from_numpy(x),),
                 seed=7).check(name)
    assert float(tm.gamma.detach()) != 0.0


def test_danet_parity():
    """Eval mode at REL_L2 / ATOL.  Train mode normalizes each of its 60
    BatchNorms over 48 to 1536 values: JAX's own f32 output lies 1.02e-4
    relative L2 from an f64 evaluation of the same network (the port's
    4.7e-5; measured on the CPU with this seed and size), so the train
    output is held at 2e-4 (max 5e-4)."""
    x = C.seeded((2, 8, 16, 24), 8)
    p = C.LegacyPair(JD.DANet(out_num_ch=3), D.DANet(8, 3, device="cpu"),
                     "danet", (C.nhwc(x),), (torch.from_numpy(x),), seed=9)
    y = p.check("DANet", train_tol=(2e-4, 5e-4))
    assert y.shape == (2, 3, 16, 24)
    # output stride 8 of the x2-upsampled input
    with torch.no_grad():
        c4 = p.tm.backbone(torch.zeros(1, 3, 32, 48))
    assert c4.shape == (1, 2048, 4, 6)


def test_danet_head_dropout_statistics():
    """Train mode with a generator: each (sample, channel) plane of the 1x1
    heads' input is kept with probability 0.9 and scaled by 1/0.9, the
    same seed giving the same mask; eval mode and no generator: none."""
    head = D.DANetHead(64, 3, gen=torch.Generator().manual_seed(0))
    seen = []
    head.conv8[1].register_forward_pre_hook(
        lambda m, a: seen.append(a[0].detach().clone()))
    h = torch.ones(256, 16, 2, 2)
    with torch.no_grad():
        head.train()._head(h, "conv8", torch.Generator().manual_seed(1))
        head._head(h, "conv8", torch.Generator().manual_seed(1))
        head._head(h, "conv8", None)
        head.eval()._head(h, "conv8", torch.Generator().manual_seed(1))
    drop, again, plain, evald = seen
    vals = np.unique(drop.numpy())
    assert len(vals) == 2 and vals[0] == 0.0
    assert vals[1] == np.float32(1.0) / np.float32(0.9)
    assert torch.equal(drop.amax((2, 3)), drop.amin((2, 3)))
    assert abs(float((drop == 0).float().mean()) - 0.1) < 0.02
    assert torch.equal(drop, again)
    assert torch.equal(plain, h) and torch.equal(evald, h)
