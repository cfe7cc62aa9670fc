"""The port's tool modules on the CPU, at tiny sizes: ``serve_latency``
(JAX's percentile rule; the live and AOT rows), ``bench3d`` (f32 and bf16),
``utils/profiling.trace`` (writes a Chrome trace) and
``device_memory_stats`` (empty without a card); and what the JAX package's
3D step computes from bf16 volumes, which ``bench3d --dtype bfloat16``
feeds the port: the eval forward against JAX's at bf16 inputs (each conv
in bf16, each output against its largest entry: 3e-2, about four bf16
ulps of it; measured 2.3e-2 on vout, 1.1e-2 on uout), and the output dtypes of a train-mode
forward with its random draws against JAX's (``jax.eval_shape``, nothing
compiled): the VAE's f32 eps makes z and the decoder after it f32.

The times here are CPU times and say nothing of the card.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_torch import bench3d, serve_latency
from representation_disentanglement_torch.utils import profiling
from test_torch_dump import few_threads  # noqa: F401 (autouse fixture)
from test_torch_unet3d import M, models, to_jax

ROOT = Path(__file__).resolve().parent.parent


def jax_pct():
    """JAX's ``pct`` rule, taken from tools/serve_latency.py's source (it
    is a lambda inside ``profile_batch``) and bound to a list."""
    src = (ROOT / "tools" / "serve_latency.py").read_text()
    body = re.search(r"pct = (lambda p: .*?\)\)\]\))", src, re.S).group(1)
    return lambda lat, p: eval(body, {"lat": np.asarray(sorted(lat)),
                                      "int": int, "min": min,
                                      "round": round, "len": len,
                                      "float": float})(p)


def test_percentile_rule_is_jax_s():
    rule = jax_pct()
    for n in (1, 2, 7, 50, 101):
        lat = list(np.random.default_rng(n).exponential(size=n))
        for p in (0, 50, 95, 99, 100):
            assert serve_latency.pct(lat, p) == rule(lat, p), (n, p)


def test_serve_latency_rows_on_the_cpu(monkeypatch, tmp_path, capsys):
    from representation_disentanglement_torch import config as C
    monkeypatch.setattr(C, "flagship", lambda: C.Config(
        contrast_list=["T1", "T1c"], input_height=32, input_width=64,
        is_cond=False, others={"mod_enc_s": False, "ana_dec_act": "softmax",
                               "old": False, "softmax_remove_mask": True}))
    rows = serve_latency.main(["--device", "cpu", "--requests", "3",
                               "--batches", "1", "2", "--aot-batch", "2",
                               "--aot-path", str(tmp_path / "a.rdt")])
    assert [r["batch"] for r in rows] == [1, 2, 2]
    for r in rows[:2]:
        assert r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
        assert r["slices_per_s"] > 0 and r["cold_start_s"] > 0
    aot = rows[2]
    assert aot["aot_vs_live_max_abs"] == 0.0
    assert aot["aot_bytes"] == (tmp_path / "a.rdt").stat().st_size
    assert aot["aot_p50_ms"] > 0 and aot["aot_cold_start_s"] > 0
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench3d_on_the_cpu(dtype):
    res = bench3d.bench((16, 16, 16), 2, 3, 8, 1, 1, dtype, "cpu")
    assert res["device"] == "cpu" and res["peak_mem_gb"] is None
    assert res["value"] > 0 and res["infer_volumes_per_sec"] > 0
    assert res["flop_per_step"] == 3 * res["eval_flop"] > 0
    assert dtype in res["config"]


def test_forward_flop_counts_the_layers():
    """One 3x3x3 conv of 2 -> 8 channels at 16^3 is 2 * 16^3 * 8 * 54
    operations; the model's count is the sum over its layers."""
    tm, _, _ = models((16, 16, 16))
    x = torch.zeros(1, M, 16, 16, 16)
    total = bench3d.forward_flop(tm, x)
    first = 2.0 * 16 ** 3 * 8 * (M * 27)
    assert total > first
    assert bench3d.forward_flop(tm.unet.conv1a, x) == first


def test_bf16_eval_forward_matches_jax():
    tm, jm, params = models((32, 16, 32))
    rs = np.random.default_rng(3)
    x = rs.normal(size=(1, M, 32, 16, 32)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(xb)
    want = jm.apply({"params": params},
                    jnp.asarray(to_jax(xb.float().numpy()), jnp.bfloat16))
    for name, g, w in zip(("uout", "vout", "mu", "logvar"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        if g.ndim == 5:
            w = to_jax(w)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 3e-2, (name, err)


def test_bf16_train_forward_dtypes_match_jax():
    tm, jm, params = models((16, 16, 16))
    tm.train()
    xb = torch.zeros(1, M, 16, 16, 16, dtype=torch.bfloat16)
    got = tm(xb, torch.Generator().manual_seed(0))
    want = jax.eval_shape(
        lambda p, x: jm.apply({"params": p}, x, train=True,
                              rng=jax.random.PRNGKey(0)),
        params, jax.ShapeDtypeStruct((1, 16, 16, 16, M), jnp.bfloat16))
    assert [str(g.dtype).split(".")[-1] for g in got] == [
        str(w.dtype) for w in want]
    assert got[1].dtype == torch.float32           # vout: the f32 decoder


def test_trace_and_memory_stats_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
    assert profiling.device_memory_stats() == []
