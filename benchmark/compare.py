"""The numbers that decide ``correct``: the gaps between what the timed
path produced and what the plain reference works out from the same
inputs, and their limits (``limits/<workload>.json``).

Training: each loss term of the first step, the first gradient as the
optimizer got it, and the parameters' change after the checked steps,
the last two leaf by leaf: the gap between the program's norm of a leaf
and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger, taken at the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change. Imputation:
every sampled slice block's output, as the norm of its difference from
the reference's over the reference's norm.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict

import numpy as np

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
NOUGHT = 1e-3           # a leaf's gradient under this share of the median


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names):
    med = float(np.median([ref[n] for n in ref]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def _worst(gaps: Dict[str, float]):
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def training(prog: dict, ref: dict) -> dict:
    """Readings of one training run.  Compared (``limits/``):
    ``terms_step1_max``, the largest relative gap among the first step's
    loss terms; ``grad_gap_median`` and ``change_gap_median``, the median
    leaf's gap of the first gradient and of the change.  Read beside them:
    ``loss_gap`` (the checked steps' total losses), ``loss_gap_step1``,
    each first-step term, and the worst leaves (``grad_gap``,
    ``change_gap``) with their names and the worst change leaf's reference
    gradient over the median leaf's."""
    loss = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog["loss"], ref["loss"])]
    terms = {k: abs(prog["terms"][0][k] - v) / max(abs(v), 1e-30)
             for k, v in ref["terms"][0].items() if k != "all"}
    g_ref = ref["grad1"]
    med_g = float(np.median(list(g_ref.values())))
    counted = [n for n in g_ref if g_ref[n] >= NOUGHT * med_g]
    grad = _leaf_gaps(prog["grad1"], g_ref, list(g_ref))
    change = _leaf_gaps(prog["change"], ref["change"], counted)
    gw, gname = _worst(grad)
    cw, cname = _worst(change)
    return {"terms_step1_max": max(terms.values()),
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap_median": float(np.median(list(change.values()))),
            "loss_gap": max(loss), "loss_gap_step1": loss[0],
            **{f"term1_{k}": v for k, v in terms.items()},
            "grad_gap": gw, "grad_worst_leaf": gname,
            "change_gap": cw, "change_worst_leaf": cname,
            "change_worst_ref_grad_share": g_ref[cname] / med_g,
            "change_left_out": len(g_ref) - len(counted)}


def answers(prog, ref) -> np.ndarray:
    """Per slice block (dim 1 of x_hat [M, B, ...], dim 0 of y [B, ...]):
    ||prog - ref|| / ||ref||, for a pair of tensors."""
    p, r = prog.float(), ref.float()
    dims = tuple(d for d in range(p.dim()) if d != (1 if p.dim() == 5
                                                    else 0))
    num = (p - r).square().sum(dims).sqrt()
    den = r.square().sum(dims).sqrt().clamp_min(1e-30)
    return (num / den).cpu().numpy()


def imputation(x_gaps, y_gaps) -> dict:
    x, y = np.concatenate(x_gaps), np.concatenate(y_gaps)
    return {"xhat_gap": float(x.max()), "y_gap": float(y.max()),
            "xhat_gap_median": float(np.median(x)),
            "y_gap_median": float(np.median(y)), "answers": int(x.size)}


def limits(workload: str) -> Dict[str, float]:
    """{number: limit} of a workload; the numbers compared."""
    return json.loads((LIMITS_DIR / f"{workload}.json").read_text())[
        "limits"]


def judge(readings: dict, lim: Dict[str, float], failed: int):
    """(correct, checks): every compared number finite and within its
    limit, nothing failed."""
    checks = {k: {"value": readings.get(k, float("nan")), "limit": v}
              for k, v in lim.items()}
    ok = failed == 0 and bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
