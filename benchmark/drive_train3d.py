"""The driver of whole-volume 3D training traffic (``"kind": "train3d"``):
NVNet3D on ``main_3d``'s own path.

Set-up draws the fold's phantom volumes on the card (``inputs.
make_cache``), moves them to the host as ``main_3d``'s ``VolumeStore`` of
float32 [H, W, D] arrays (one per subject and contrast, and the
``seg`` labels) and frees the card.  The program reads them as
``main_3d`` trains: ``VolumeDataset3D`` with augmentation over the slab
``[slab_start, slab_start + D)``, ``main_3d.volume_loader`` shuffling,
``build_nvnet3d`` holding the benchmark's weights, ``create_state_3d``'s
Adam, ``make_train_step_3d``, all driven one optimizer step at a time by
``training.train3d.train_loop_3d`` (load and copy to the card, step, one
read-back of the metrics).  Its first ``CHECKED_STEPS`` steps give what
the comparison needs, ``WARM_STEPS`` more time the pace; the window then
runs steps until ``--seconds`` have passed, the last one dropped where
the pace says it would end more than half a step late.  Steps never
compile anything: the first ones settle cuDNN's choices.

The reference runs after the window, on the same crops redrawn from the
seeds (the cache drawn again, the shuffle and the augmentation worked out
with numpy as the loader draws them, ``reference/nvnet3d.crop``) and a
generator seeded as the program's, so that it draws the same dropout
masks and eps.

The traffic file gives batch_size (crops per microbatch) and
effective_batch (crops per optimizer step).  A configuration's
``volume_dtype`` (absent: float32) casts the crops the step gets, as
``bench3d --dtype`` does: the control of the limits feeds bfloat16.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import compare, counts3d
from benchmark.inputs import fold_subjects, make_cache, seeds
from benchmark.reference import nvnet3d
from benchmark.reference.train import no_tf32

CHECKED_STEPS = 3       # steps set-up drives that the reference follows
WARM_STEPS = 2          # more steps before the window, which time its pace
TRACED_STEPS = 2        # steps a --trace 1 run profiles after the window
TERMS = ("dice_loss", "vae_recon", "kl")


def make_weights(cfg: dict, seed: int, device):
    """Every parameter by its state-dict name, float32 on ``device``, as
    ``build_nvnet3d`` initializes them (torch's defaults) but drawn from
    ``seed`` on the card in one call: convolution and linear weights and
    biases U(+-1 / sqrt(fan_in)), GroupNorm scale 1 and shift 0."""
    specs = nvnet3d.param_specs(cfg)
    drawn = [(n, s, fi) for n, s, fi in specs if fi]
    sizes = [math.prod(s) for _, s, _ in drawn]
    scale = torch.repeat_interleave(
        torch.tensor([1.0 / math.sqrt(fi) for _, _, fi in drawn],
                     device=device), torch.tensor(sizes, device=device))
    g = torch.Generator(device=device).manual_seed(seed)
    flat = (torch.rand(sum(sizes), generator=g, device=device) * 2 - 1) \
        * scale
    out = {n: part.view(s) for (n, s, _), part in zip(drawn,
                                                     flat.split(sizes))}
    for n, s, fi in specs:
        if not fi:
            out[n] = torch.full(s, 1.0 if n.endswith(".weight") else 0.0,
                                device=device)
    return {n: out[n] for n, _, _ in specs}


def host_store(vols, tgts, contrasts, names):
    """``main_3d``'s ``VolumeStore`` of the cache: ``<name>/<contrast>``
    and ``<name>/seg`` float32 [H, W, Dz] arrays on the host."""
    from representation_disentanglement_torch.data.dataset import (
        VolumeStore)
    data = {}
    for i, name in enumerate(names):
        x = vols[i].float().permute(0, 2, 3, 1).contiguous().cpu().numpy()
        for m, c in enumerate(contrasts):
            data[f"{name}/{c}"] = x[m]
        data[f"{name}/seg"] = tgts[i].permute(1, 2, 0).contiguous() \
            .cpu().numpy()
    return VolumeStore(data=data)


def plan_crops(n_subj: int, loader_seed: int, aug_seed: int, count: int):
    """The first ``count`` crops the loader yields, worked out with numpy
    as ``volume_loader`` shuffles and ``VolumeDataset3D`` augments: the
    epoch's subjects shuffled, then per subject in that order a flip draw
    (flipped above 0.5), a scale 1 + 0.2 (u - 0.5) and a shift 0.2 (u -
    0.5).  [(subject, flip, scale, shift)]."""
    if count > n_subj:
        raise ValueError(f"{count} crops reach past the first epoch")
    order = np.arange(n_subj)
    np.random.default_rng(loader_seed).shuffle(order)
    aug = np.random.default_rng(aug_seed)
    out = []
    for s in order[:count]:
        flip = aug.random() > 0.5
        scale = 1 + 0.2 * (aug.random() - 0.5)
        shift = 0.2 * (aug.random() - 0.5)
        out.append((int(s), bool(flip), scale, shift))
    return out


def run(rc: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, started: float) -> dict:
    from representation_disentanglement_torch.data.dataset3d import (
        VolumeDataset3D)
    from representation_disentanglement_torch.main_3d import volume_loader
    from representation_disentanglement_torch.models.unet3d import (
        build_nvnet3d)
    from representation_disentanglement_torch.training.train3d import (
        create_state_3d, make_train_step_3d, train_loop_3d)

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    s_data, s_w, s_loader, s_aug, s_z = seeds(seed, 5)
    B = rc["batch_size"]
    A = max(rc["effective_batch"] // B, 1)
    H, W, D = rc["image_size"]
    start = rc["slab_start"]
    contrasts = list(rc["contrast_list"])

    # ---- the data on the host, the card freed ----
    vols, tgts, _ = make_cache(rc, s_data, device)
    names = [f"s{i:04d}" for i in range(vols.shape[0])]
    store = host_store(vols, tgts, contrasts, names)
    del vols, tgts
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the program's set-up ----
    weights = make_weights(rc, s_w, device)
    w0 = {k: v.clone() for k, v in weights.items()}
    ds = VolumeDataset3D(rc["dataset_name"], store, names, contrasts,
                         aug=True, image_size=(H, W, D),
                         slab=slice(start, start + D),
                         rng=np.random.default_rng(s_aug))
    loader = volume_loader(ds, B, True, seed=s_loader)

    def batches():
        while True:
            yield from loader()

    model = build_nvnet3d((H, W, D), len(contrasts), 3, rc["init_channels"],
                          device=device,
                          squeeze_channels=rc["squeeze_channels"])
    model.load_state_dict(weights)
    del weights
    opt = create_state_3d(model, weight_decay=rc["weight_decay"],
                          lr=rc["lr"])
    step = make_train_step_3d(model, opt, clip_norm=rc["grad_clip_norm"],
                              accum=A)
    dtype = getattr(torch, rc.get("volume_dtype", "float32"))
    if dtype != torch.float32:
        inner = step
        step = lambda b, g: inner(dict(b, inputs=b["inputs"].to(dtype)), g)
    gen = torch.Generator(device=device).manual_seed(s_z)
    loop = train_loop_3d(step, batches(), A, device, gen)
    mets, failed = [], 0

    def one() -> None:
        nonlocal loop, failed
        try:
            mets.append(next(loop))
        except FloatingPointError:
            failed += 1
            loop = train_loop_3d(step, batches(), A, device, gen)

    named = dict(model.named_parameters())
    beta1 = opt.param_groups[0]["betas"][0]
    one()
    with torch.no_grad():           # the gradient as the update read it
        grad1 = {n: float((opt.state[p]["exp_avg"] / (1 - beta1)).norm())
                 if "exp_avg" in opt.state.get(p, {}) else 0.0
                 for n, p in named.items()}
    for _ in range(CHECKED_STEPS - 1):
        one()
    with torch.no_grad():
        change = {n: float((p - w0[n]).norm()) for n, p in named.items()}
    sync()
    t_warm = time.perf_counter()
    for _ in range(WARM_STEPS):
        one()
    sync()
    pace = (time.perf_counter() - t_warm) / WARM_STEPS
    setup_s = time.perf_counter() - started

    # ---- the window ----
    def steps(n_wanted: int, t0: float, deadline: float) -> int:
        """Up to ``n_wanted`` steps; stops before a step that the pace (of
        the warm-up, then of the window's steps) says would end more than
        half a step after ``deadline``."""
        done = 0
        while done < n_wanted:
            now = time.perf_counter()
            per = (now - t0) / done if done else pace
            if done and deadline - now < per / 2:
                break
            one()
            done += 1
        return done

    t0 = time.perf_counter()
    window_steps = steps(1 << 30, t0, t0 + seconds)
    sync()
    window_s = time.perf_counter() - t0
    out = {"setup_s": setup_s, "window_s": window_s,
           "window_steps": window_steps,
           "train_slices_per_s": window_steps * rc["effective_batch"] * D
           / window_s}
    if trace:
        from benchmark.trace import record
        forever = float("inf")
        out["trace"] = record(lambda: steps(TRACED_STEPS, 0.0, forever),
                              sync)
        out["trace_shapes"] = record(lambda: steps(1, 0.0, forever), sync,
                                     shapes=True)
    mem = torch.cuda.max_memory_allocated(device) if cuda else 0
    prog = {"loss": [m["loss"] for m in mets[:CHECKED_STEPS]],
            "terms": [{k: m[k] for k in TERMS} for m in mets[:CHECKED_STEPS]],
            "grad1": grad1, "change": change}
    del model, opt, step, loop, named, mets, store, ds
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference, after the window ----
    ref = reference_steps(rc, w0, s_data, s_loader, s_aug, s_z,
                          CHECKED_STEPS, device)
    readings = compare.training(prog, ref)
    readings.update(tf32_cudnn=int(torch.backends.cudnn.allow_tf32),
                    tf32_matmul=int(torch.backends.cuda.matmul.allow_tf32))
    out.update(attempted=window_steps, failed=failed, memory_peak=mem,
               readings=readings)
    if trace:
        out["flop_per_unit"] = counts3d.train_step_flop(rc, B, A)
        out["unit_s"] = window_s / window_steps
        out["card"] = torch.cuda.get_device_name(device) if cuda else "cpu"
    return out


def reference_steps(rc, w0, s_data, s_loader, s_aug, s_z, n_steps, device):
    """The reference's first ``n_steps`` optimizer steps from the initial
    weights ``w0``, in float32 with TF32 off, on the crops the loader
    yields first (the cache drawn again from ``s_data``) and the noise a
    generator seeded with ``s_z`` draws."""
    B = rc["batch_size"]
    A = max(rc["effective_batch"] // B, 1)
    D = rc["image_size"][2]
    with no_tf32():
        vols, tgts, _ = make_cache(rc, s_data, device)
        plan = plan_crops(fold_subjects(rc["data"]), s_loader, s_aug,
                          n_steps * A * B)
        crops = [nvnet3d.crop(vols, tgts, s, rc["slab_start"], D, *aug)
                 for s, *aug in plan]
        del vols, tgts
        steps = []
        for k in range(n_steps):
            micro = []
            for a in range(A):
                part = crops[(k * A + a) * B:(k * A + a + 1) * B]
                micro.append({"inputs": torch.stack([x for x, _ in part]),
                              "targets": torch.stack([t for _, t in part])})
            steps.append(micro)
        P = {n: v.clone().requires_grad_(True) for n, v in w0.items()}
        gen = torch.Generator(device=device).manual_seed(s_z)
        res = nvnet3d.train_steps(P, rc, steps, gen, rc["grad_clip_norm"],
                                  rc["weight_decay"])
        with torch.no_grad():
            res["change"] = {n: float((P[n] - w0[n]).norm()) for n in P}
        res["terms"] = [{k: t[k] for k in TERMS} for t in res["terms"]]
        return res
