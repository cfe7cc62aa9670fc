"""The port's AOT serve artifact (utils/aot.py, ``serve --export-aot`` /
``--aot``) on the CPU.

Model: tests/test_torch_dump.py's (the flagship structure at M=2, 32x64,
B=2, plain convolutions), with ``use_pallas`` on, so that the program holds
``rdt::in_modulate``, in f32 and in bf16.  The artifact's output must be
bit-equal to the live step's: both run the same ops on the same weights.
The header checks refuse what JAX's serve refuses (source / with_y, batch,
compute dtype) and a device type other than the one exported on; a JAX
package artifact (``RDTAOT1``) is refused by name.  The serve CLI with
``--export-aot`` then ``--aot`` writes the same files as the live CLI, over
tests/test_torch_test_phase.py's data and a port checkpoint of the same
weights.
"""

import json
import os

import numpy as np
import pytest
import torch

from representation_disentanglement_torch import serve
from representation_disentanglement_torch.config import Config, resolve_run
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training import checkpoint
from representation_disentanglement_torch.utils import aot
from test_torch_dump import BASE, few_threads, port_weights  # noqa: F401
from test_torch_test_phase import (
    FOLDS, H, LABEL, W, make_data, port_cfg, run_dir)

M, B = 2, 2


def _model(dtype="float32", **kw):
    cfg = Config(**dict(BASE, compute_dtype=dtype, use_pallas=True,
                        **kw)).derive().validate()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(port_weights())
    return cfg, model


def _inputs(seed=0):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(M, B, H, W, 7)).astype(np.float32)
    x[0, 1] = 0.0                             # contrast 0 missing in row 1
    mask = np.ones((B, M), np.float32)
    mask[1, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    return dict(inputs=x, mask=mask, mask_img=mask_img)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def exported(request):
    cfg, model = _model(request.param)
    sample = _inputs()
    blob = aot.export_serve_step(model, cfg, source=1, sample=sample)
    return cfg, model, blob


def test_artifact_is_bit_equal_to_the_live_step(exported):
    """Export, save, load, run: the same x_hat and y, bit for bit, on new
    inputs; the program holds the SPADE kernel's op; the weights of another
    checkpoint loaded into it move it as they move the live step."""
    cfg, model, blob = exported
    step, hdr = aot.load_serve_step(blob)
    assert hdr == {"source": 1, "with_y": True,
                   "inputs_shape": [M, B, H, W, 7],
                   "compute_dtype": cfg.compute_dtype, "device_type": "cpu",
                   "device": "cpu", "torch": torch.__version__}
    ops = [n.target for n in step.module.graph.nodes
           if "rdt" in str(n.target)]
    assert ops and all("rdt.in_modulate" in str(t) for t in ops)
    live = serve.make_serve_step(model, cfg, source=1)
    b = _inputs(seed=3)
    for got, want in zip(step(b["inputs"], b["mask"], b["mask_img"]),
                         live(b["inputs"], b["mask"], b["mask_img"])):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    sd = {k: v * 1.01 if k.endswith(".weight") else v
          for k, v in port_weights().items()}
    aot.load_weights(step, sd)
    _, other = _model(cfg.compute_dtype)
    other.load_state_dict(sd)
    live = serve.make_serve_step(other, cfg, source=1)
    moved = step(b["inputs"], b["mask"], b["mask_img"])
    assert torch.equal(moved[0], live(b["inputs"], b["mask"],
                                      b["mask_img"])[0])


def test_headers_refused_as_jax_refuses(exported, tmp_path):
    cfg, _, blob = exported
    path = str(tmp_path / "a.rdt")
    with open(path, "wb") as f:
        f.write(blob)
    ok = dict(cfg=cfg, source=1, with_y=True, batch=B, device="cpu")
    assert serve.load_checked_aot(path, **ok).header["source"] == 1
    other = Config(**dict(BASE, compute_dtype="bfloat16"
                          if cfg.compute_dtype == "float32" else "float32"))
    for kw, match in ((dict(source=0), "source=1, with_y=True"),
                      (dict(with_y=False), "with_y"),
                      (dict(batch=4), "batch 2 != serving batch 4"),
                      (dict(cfg=other), "compute_dtype"),
                      (dict(device="meta"), "device type")):
        with pytest.raises(ValueError, match=match):
            serve.load_checked_aot(path, **dict(ok, **kw))
    with pytest.raises(ValueError, match="RDTAOT1"):
        aot.read_header(b"RDTAOT1\n" + bytes(8))
    with pytest.raises(ValueError, match="bad magic"):
        aot.read_header(b"PK\x03\x04")
    n = int.from_bytes(blob[len(aot.MAGIC):len(aot.MAGIC) + 4], "big")
    hdr = json.loads(blob[len(aot.MAGIC) + 4:len(aot.MAGIC) + 4 + n])
    stale = json.dumps(dict(hdr, torch="0.0")).encode()
    with pytest.raises(ValueError, match="torch 0.0"):
        aot.load_serve_step(aot.MAGIC + len(stale).to_bytes(4, "big")
                            + stale + blob[len(aot.MAGIC) + 4 + n:])
    with pytest.raises(ValueError, match="aot-platforms"):
        serve.main(["cfg.yaml", "--missing", "T1", "--aot-platforms",
                    "tpu,cpu"], device="cpu")


def test_cli_export_then_aot_writes_the_live_files(tmp_path):
    """``--export-aot`` writes the artifact and nothing else; ``--aot``
    then writes the live CLI's files, equal."""
    data_dir = make_data(str(tmp_path / "data"))
    root = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint({"epoch": 3, "params": port_weights()}, True,
                               run_dir(root))
    cfg = resolve_run(port_cfg(data_dir, use_pallas=True),
                      root).derive().validate()
    kw = dict(fmt="npy", device="cpu")
    blob = str(tmp_path / "serve_B2.rdt")
    assert serve.serve(cfg, ["T1"], None, str(tmp_path / "none"),
                       export_aot=blob, **kw) == {}
    assert not os.path.exists(tmp_path / "none")
    assert aot.read_header(open(blob, "rb").read())["inputs_shape"] == [
        M, B, H, W, 7]
    live = serve.serve(cfg, ["T1"], None, str(tmp_path / "live"), **kw)
    got = serve.serve(cfg, ["T1"], None, str(tmp_path / "aot"), aot=blob,
                      **kw)
    assert sorted(live) == sorted(got) == sorted(s for s, _ in
                                                 FOLDS["test"])
    for subj in live:
        assert [os.path.basename(p) for p in got[subj]] == [
            os.path.basename(p) for p in live[subj]]
        for p, q in zip(got[subj], live[subj]):
            np.testing.assert_array_equal(np.load(p), np.load(q))
