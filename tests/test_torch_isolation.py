"""The port stands alone: it imports neither JAX, flax, optax nor the JAX
package, compiles nothing when imported, and never runs on the CPU unless
the caller asks for it."""

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
             "representation_disentanglement_tpu")

_PROBE = """
import importlib, pkgutil, sys
import representation_disentanglement_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from representation_disentanglement_torch.ops import kernels
assert kernels.IN_MODULATE.library._lib is None, "kernel loaded at import"
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(len(names), bad)
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
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


def test_unported_configurations_raise():
    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    cfg = config.flagship()
    cfg.notshared_impl = "vmap"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
    cfg = config.flagship()
    cfg.target_model_name = "U+SA+CA"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
