"""The port stands alone: it imports neither JAX, flax, optax, the JAX package
nor its entry module ``__graft_entry__``, imports with h5py, pandas, yaml
and msgpack absent (the card's machine lacks them), compiles nothing when
imported, and never runs on the CPU unless the caller asks for it."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "representation_disentanglement_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "representation_disentanglement_tpu", "__graft_entry__")
ABSENT = ("h5py", "pandas", "yaml", "msgpack")

_PROBE = """
import importlib, pkgutil, sys
for name in {absent!r}:
    sys.modules[name] = None          # importing it raises ImportError
import representation_disentanglement_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from representation_disentanglement_torch.ops import kernels
assert kernels.IN_MODULATE.library._lib is None, "kernel loaded at import"
assert kernels.BN_LIBRARY._lib is None, "BatchNorm kernels loaded at import"
from representation_disentanglement_torch import native
assert not native._state, "the native gather was built at import"
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(len(names), bad)
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN),
                                             absent=ABSENT)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert int(count) >= 15          # every module of the port was imported
    assert bad == "[]", bad


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_port_source_names_no_jax_import(path):
    """No import of JAX or the JAX package anywhere in the source, including
    imports inside functions."""
    pattern = re.compile(r"^\s*(from|import)\s+(%s)\b" % "|".join(FORBIDDEN),
                         re.MULTILINE)
    assert not pattern.search((ROOT / path).read_text()), path


def test_build_model_without_device_refuses_the_cpu(monkeypatch):
    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.flagship()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)


def test_run_and_train_without_device_refuse_the_cpu(monkeypatch,
                                                      tmp_path):
    from representation_disentanglement_torch import config, main_missing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_missing.run(config.flagship(), str(tmp_path))
    assert not list(tmp_path.iterdir())
    cfg = config.flagship()
    model = torch.nn.Linear(2, 2)
    model.device = torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_missing.train(cfg, model, None, None, -1, None)
    with pytest.raises(ValueError, match="the model is on cpu"):
        main_missing.train(cfg, model, None, None, -1, None, device="meta")


def test_multi_card_entry_points_without_device_refuse_the_cpu(
        monkeypatch, tmp_path):
    """``mesh_shape: {data: 2}`` and ``--depth-shards 2`` asked for no
    device: no card, no processes started, nothing written."""
    from representation_disentanglement_torch import config, main_3d
    from representation_disentanglement_torch import main_missing
    from representation_disentanglement_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.flagship()
    cfg.mesh_shape = {"data": 2}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_missing.run(cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_3d.main(["--data-path", str(tmp_path), "--ckpt-dir",
                      str(tmp_path / "ck"), "--depth-shards", "2"])
    with pytest.raises(ValueError, match="needs 2 cards"):
        mesh.spawn(2, print)
    assert not list(tmp_path.iterdir())


def test_bench_without_device_exits_nonzero(monkeypatch, capsys):
    """The benchmark measures the card: without one and without
    ``--device cpu`` it prints no result and exits with status 2."""
    from representation_disentanglement_torch import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--smoke"])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_unported_configurations_raise():
    """Nothing of JAX's 2D build_model is refused any more: the 'vmap'
    halves and the channel-attention decoders build; what raises is what
    JAX refuses too, a VGG path without its npz."""
    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    cfg = config.flagship()
    cfg.input_height, cfg.input_width = 32, 64
    cfg.notshared_impl = "vmap"
    cfg.target_model_name = "U+SA+CA"
    model = build_model(cfg, device="cpu")
    assert hasattr(model.output_decoder, "att_4_c")
    cfg = config.flagship()
    cfg.s_sim_method = "perceptual"
    with pytest.raises(ValueError, match="vgg_npz"):
        cfg.validate()


def test_walk_covers_every_port_module():
    """The import probe and the source scan above reach every module of the
    port, the discriminator and the z prior (models/discriminator.py) and
    the VGG16 extractor of the similarity paths (models/vgg.py, which keeps
    its own copy of the JAX package's JAX-free npz helpers) included, and
    the host gather (``native``, its own copy of the JAX package's), the
    AOT artifact (utils/aot.py), the reader of the JAX package's
    checkpoints (training/flax_msgpack.py) and the tool modules
    (serve_latency, bench3d)."""
    import pkgutil
    import representation_disentanglement_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    files = {str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")}
    for mod in ("models.discriminator", "models.vgg", "models.attention",
                "models.generators", "models.spade", "utils.aot",
                "training.flax_msgpack", "serve_latency", "bench3d",
                "bench", "utils.profiling", "parallel.mesh", "parallel.halo",
                "parallel.tp"):
        assert f"representation_disentanglement_torch.{mod}" in names
        assert ("representation_disentanglement_torch/"
                f"{mod.replace('.', '/')}.py") in files
    assert "representation_disentanglement_torch.native" in names
    assert "representation_disentanglement_torch/native/__init__.py" in files
    assert (PORT / "native" / "gather.cpp").exists()
    assert "representation_disentanglement_tpu" not in (
        PORT / "native" / "gather.cpp").read_text()
