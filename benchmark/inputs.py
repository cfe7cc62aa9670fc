"""Everything a run feeds both sides, made from ``--seed`` on the device:
the configuration's volume cache (phantom brains), the model weights,
and the seeds of the host-side draws.

The same seed gives the same inputs; every seed gives the same sizes.
Weights and volumes are drawn with a ``torch.Generator`` on the card in a
few large calls, in the dtype they are used in.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.model import BN, Reference

ROOT = Path(__file__).resolve().parent
CONFIG_DIR = ROOT / "configs"
TRAFFIC_DIR = ROOT / "traffic"


def load_config(name: str) -> dict:
    """A configuration file of ``configs/``: the shipped YAML's keys at
    the top level, ``data`` (the cache a deployment holds) and ``source``
    / ``assumed`` notes."""
    return json.loads((CONFIG_DIR / f"{name}.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def run_config(cfg: dict, traffic: dict) -> dict:
    """The configuration as a cell runs it: the file's keys with the
    traffic's batch (``batch_size`` per microbatch on a card times the
    cards, ``effective_batch`` per optimizer step over all cards)."""
    out = dict(cfg)
    world = traffic.get("cards", 1)
    if "batch_size" in traffic:
        out["batch_size"] = traffic["batch_size"] * world
        out["effective_batch"] = traffic["effective_batch"] * world
        out["mesh_shape"] = {"data": world}
    return out


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's seed (any whole
    number)."""
    ss = np.random.SeedSequence(int(seed) & (2 ** 128 - 1))
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in ss.spawn(n)]


# ---------------------------------------------------------------------------
# the volume cache
# ---------------------------------------------------------------------------

def fold_subjects(data: dict) -> int:
    """Training subjects of fold 0 when the cohort of ``data["cohort"]``
    is split as the preprocessing does (test 20%, validation 10% of the
    rest, the others train)."""
    n = data["cohort"]
    return n - max(int(n * 0.2), 1) - max(int(n * 0.1), 1)


def make_cache(cfg: dict, seed: int, device, chunk: int = 8):
    """Phantom volumes of the fold on the device: vols [S, M, D, H, W]
    bf16 (z-scored inside an ellipsoidal brain, exactly 0 outside), tgts
    [S, D, H, W] f32 (BraTS: tumour labels 0-3 in a lesion; otherwise a
    smooth target image inside the brain) and presence [S, M] (every
    contrast present)."""
    data = cfg["data"]
    S, M = fold_subjects(data), len(cfg["contrast_list"])
    D, H, W = data["depth"], cfg["input_height"], cfg["input_width"]
    g = torch.Generator(device=device).manual_seed(seed)
    vols = torch.empty((S, M, D, H, W), dtype=torch.bfloat16, device=device)
    tgts = torch.empty((S, D, H, W), dtype=torch.float32, device=device)
    prm = torch.rand((S, 16 + 3 * M), generator=g, device=device)
    zz = torch.linspace(-1, 1, D, device=device)[:, None, None]
    yy = torch.linspace(-1, 1, H, device=device)[None, :, None]
    xx = torch.linspace(-1, 1, W, device=device)[None, None, :]
    for lo in range(0, S, chunk):
        p = prm[lo:lo + chunk, :, None, None, None]         # [s, k, 1, 1, 1]
        c = lambda k: p[:, k]
        # brain: ellipsoid with radii 0.75-0.95 of the half-widths
        r2 = (((zz - 0.1 * (c(0) - 0.5)) / (0.75 + 0.2 * c(1))) ** 2
              + ((yy - 0.1 * (c(2) - 0.5)) / (0.75 + 0.2 * c(3))) ** 2
              + ((xx - 0.1 * (c(4) - 0.5)) / (0.75 + 0.2 * c(5))) ** 2)
        brain = r2 < 1.0
        # a lesion: a smaller ball inside
        l2 = (((zz - 0.4 * (c(6) - 0.5)) / (0.1 + 0.15 * c(7))) ** 2
              + ((yy - 0.4 * (c(8) - 0.5)) / (0.1 + 0.15 * c(7))) ** 2
              + ((xx - 0.4 * (c(9) - 0.5)) / (0.1 + 0.15 * c(7))) ** 2)
        wave = torch.sin(6.0 * zz + 6.28 * c(10)) * torch.cos(
            9.0 * yy + 6.28 * c(11)) * torch.sin(7.0 * xx + 6.28 * c(12))
        for m in range(M):
            a = p[:, 16 + 3 * m:16 + 3 * m + 3]
            tissue = (a[:, 0] - 0.5) * 2.0 + 1.5 * torch.cos(
                3.14 * r2 * (1.0 + a[:, 1])) + 0.5 * wave
            tissue = tissue + (1.0 + 2.0 * a[:, 2]) * (l2 < 1.0)
            vols[lo:lo + chunk, m] = torch.where(
                brain, tissue, torch.zeros((), device=device)).to(
                    torch.bfloat16)
        if cfg["dataset_name"] == "BraTS":
            lab = (l2 < 1.0).float() * (1.0 + (l2 < 0.6).float()
                                        + (l2 < 0.25).float())
        else:
            lab = torch.where(brain, 1.0 + 0.5 * torch.cos(3.14 * r2)
                              + 0.3 * wave + (l2 < 1.0) * c(13),
                              torch.zeros((), device=device))
        tgts[lo:lo + chunk] = lab
    presence = torch.ones((S, M), device=device)
    return vols, tgts, presence


def slice_rows(cfg: dict):
    """The fold's (subject, slice) rows: every training subject over the
    configuration's slice range."""
    S = fold_subjects(cfg["data"])
    lo, hi = cfg["data"]["slice_range"]
    subj = np.repeat(np.arange(S), hi - lo)
    sl = np.tile(np.arange(lo, hi), S)
    return subj, sl


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------

def make_weights(ref: torch.nn.Module, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the model by its state-dict name, f32
    on ``device``: convolution and linear weights (each CondConv expert
    too) He-normal, N(0, 2 / fan_in); their biases U(+-1/sqrt(fan_in)),
    a CondConv's 0; BatchNorm scale 1 and shift 0, running mean 0 and
    variance 1.  Two draws: one normal, one uniform.

    He-normal keeps the activations' scale through the layers as a
    trained model's is kept.  torch's defaults (and the CondConv banks'
    xavier-normal) shrink it by about five each layer, so the modality
    encoder, which has no normalization, turns every input into nearly
    the same z; the similarity losses then sit on differences of cosines
    near 1 and the imputed contrast hardly depends on its input, and
    rounding rules both sides' numbers."""
    nor, uni, const = [], [], []
    for mod_name, mod in ref.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            if isinstance(mod, BN):
                const.append((name, p.shape, 1.0 if pname == "weight"
                              else 0.0))
            elif pname == "weight":
                nor.append((name, p.shape, math.sqrt(2.0 / mod.fan_in)))
            elif mod.cond:
                const.append((name, p.shape, 0.0))
            else:
                uni.append((name, p.shape, 1.0 / math.sqrt(mod.fan_in)))
        for bname, b in mod.named_buffers(recurse=False):
            name = f"{mod_name}.{bname}" if mod_name else bname
            const.append((name, b.shape,
                          1.0 if bname == "running_var" else 0.0))
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for leaves, draw in ((nor, lambda n: torch.randn(n, generator=g,
                                                     device=device)),
                         (uni, lambda n: torch.rand(n, generator=g,
                                                    device=device) * 2 - 1)):
        sizes = [math.prod(s) for _, s, _ in leaves]
        scale = torch.repeat_interleave(
            torch.tensor([k for _, _, k in leaves], device=device),
            torch.tensor(sizes, device=device))
        flat = draw(sum(sizes)) * scale
        for (name, shape, _), part in zip(leaves, flat.split(sizes)):
            out[name] = part.view(shape)
    for name, shape, v in const:
        out[name] = torch.full(shape, v, device=device)
    return {k: out[k] for k in ref.state_dict()}


def meta_reference(rc: dict, **kw) -> Reference:
    """The reference's modules without storage: the names, shapes and
    fan-ins that ``make_weights`` and the FLOP counts read."""
    with torch.device("meta"):
        return Reference(rc, **kw)


def reference_on(rc: dict, weights: Dict[str, torch.Tensor], device, **kw
                 ) -> Reference:
    """The reference on ``device`` holding ``weights``, with no
    initialization of its own on the host."""
    ref = meta_reference(rc, **kw).to_empty(device=device)
    ref.load_state_dict(weights)
    return ref


def calibrated(rc: dict, weights: Dict[str, torch.Tensor], seed: int, vols,
               tgts, presence, rows: int = 16) -> Dict[str, torch.Tensor]:
    """``weights`` with every BatchNorm's running statistics set to those
    of its input on ``rows`` slice blocks of the fold drawn from the seed
    (all contrasts present), as a trained model's statistics match its
    data: the eval-mode model then passes its input's structure on rather
    than shrinking it layer by layer.  One float32 forward of the
    reference, TF32 off."""
    from benchmark.reference.train import gather, no_tf32
    ref = reference_on(rc, weights, vols.device)
    subj, sl = slice_rows(rc)
    pick = np.random.default_rng(seed).integers(0, len(subj), rows)
    b = rc["block_size"]
    batch = gather(vols, tgts, presence, subj[pick],
                   np.clip(sl[pick], b, vols.shape[2] - b - 1),
                   np.ones((rows, vols.shape[1]), np.float32), b)
    with no_tf32():
        ref.calibrate(batch["inputs"], batch["mask"], batch["mask_img"])
    return {k: v.detach() for k, v in ref.state_dict().items()}
