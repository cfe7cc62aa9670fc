"""The general driver of training traffic (``"kind": "train"``).

Set-up builds the program's training objects once, as
``main_missing.train_device_epochs`` does over the device volume cache:
the model (weights from the seed), Adam, ``training.epoch.
make_train_epoch``'s ``train_epoch`` over the cache, and the epoch's plan
(``epoch_indices``).  It drives that same ``train_epoch`` through the
plan's first ``CHECKED_STEPS`` steps (one call for the first, the
epoch's first chunk with its y decode, one for the rest) and reads what
the comparison needs, then ``WARM_STEPS`` more.  The window then runs chunks
of ``epoch_chunk_steps`` steps of the plan, a new epoch's plan when one
runs out, without the per-epoch validation and checkpoint, until
``--seconds`` have passed, and ends with a synchronize.

The traffic file gives batch_size (per microbatch on a card) and
effective_batch (per optimizer step on a card).  How deep the check goes
and how much is warmed and traced are the harness's own, the same for
every training cell.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import compare, counts
from benchmark.inputs import (make_cache, make_weights, meta_reference,
                              reference_on, seeds, slice_rows)
from benchmark.reference import train as rtrain

CHECKED_STEPS = 3       # steps set-up drives that the reference follows
WARM_STEPS = 2          # more steps before the window, which time its pace
TRACED_STEPS = 2        # steps a --trace 1 run profiles after the window


def program_config(rc: dict):
    from representation_disentanglement_torch.config import Config
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in rc.items() if k in known}) \
        .derive().validate()


def plan_rows(rc: dict, loader_seed: int, pair_seed: int, steps: int,
              presence: np.ndarray):
    """The first ``steps`` optimizer steps of the epoch's plan, worked out
    with numpy from the seeds as the reference's loader draws them: the
    fold's rows shuffled, cut into [steps, A, B]; a dropoff draw per row
    (one random number per row with more than one contrast present, a
    contrast dropped when it exceeds 0.8); a sim pair per microbatch of
    every step.  Returns rows, slices, drop [steps, A, B(, M)], sim."""
    subj, sl = slice_rows(rc)
    B = rc["batch_size"]
    A = max(rc["effective_batch"] // B, 1)
    M = len(rc["contrast_list"])
    b = rc["block_size"]
    D = rc["data"]["depth"]
    sl = np.clip(sl, b, min(min(155, D) - b, D - b - 1))
    rng = np.random.default_rng(loader_seed)
    order = np.arange(len(subj))
    rng.shuffle(order)
    n_steps = len(order) // (A * B)
    sel = order[:n_steps * A * B].reshape(n_steps, A, B)[:steps]
    rows, slices = subj[sel], sl[sel]
    drop = np.ones(rows.shape + (M,), np.float32)
    if rc["dropoff"]:
        flat = drop.reshape(-1, M)
        for j, r in enumerate(rows.reshape(-1)):
            pres = np.where(presence[r] > 0)[0]
            if len(pres) > 1 and rng.random() > 0.8:
                flat[j, rng.choice(pres)] = 0.0
    prng = np.random.default_rng(pair_seed)
    sim = [[(0, 1) if M == 2 else tuple(prng.choice(M, 2, replace=False))
            for _ in range(A)] for _ in range(steps)]
    return rows, slices, drop, sim


def run(rc: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, started: float) -> dict:
    from representation_disentanglement_torch.data.device_store import (
        DeviceBatchLoader, DeviceVolumeCache)
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.training.epoch import (
        epoch_indices, make_train_epoch)
    from representation_disentanglement_torch.training.optim import (
        make_optimizer)
    from representation_disentanglement_torch.training.train import (
        LOSS_KEYS)

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    s_data, s_w, s_loader, s_pair, s_z = seeds(seed, 5)
    pcfg = program_config(rc)
    M = pcfg.modality_num
    vols, tgts, presence = make_cache(rc, s_data, device)
    weights = make_weights(meta_reference(rc), s_w, device)
    w0 = {k: v.clone() for k, v in weights.items()}

    # ---- the program's set-up ----
    D = vols.shape[2]
    subj, sl = slice_rows(rc)
    names = [f"s{i:04d}" for i in range(vols.shape[0])]
    cache = DeviceVolumeCache(vols, tgts, presence, names, pcfg.block_size,
                              min(155, D))
    loader = DeviceBatchLoader(cache, [names[i] for i in subj], sl,
                               pcfg.batch_size, shuffle=True,
                               drop_last=True, dropoff=pcfg.dropoff,
                               seed=s_loader)
    model = build_model(pcfg, device=device)
    model.load_state_dict(weights)
    del weights
    opt = make_optimizer(model.parameters(), pcfg)
    gen = torch.Generator(device=device).manual_seed(s_z)
    train_epoch, n_micro = make_train_epoch(model, pcfg, opt, cache, gen)
    pair_rng = np.random.default_rng(s_pair)
    plan = epoch_indices(loader, n_micro, M, pair_rng)
    K = pcfg.epoch_chunk_steps or plan.steps
    checked = CHECKED_STEPS
    named = dict(model.named_parameters())
    beta1 = opt.param_groups[0]["betas"][0]

    mets = [train_epoch(plan.chunk(0, 1), first_chunk=True)]
    with torch.no_grad():           # an optimizer that never stepped: 0
        grad1 = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).norm()
                 if "exp_avg" in opt.state.get(p, {}) else torch.zeros(())
                 for n, p in named.items()}
    mets.append(train_epoch(plan.chunk(1, checked), first_chunk=False))
    with torch.no_grad():
        change = {n: (p - w0[n]).norm() for n, p in named.items()}
    cursor = checked
    warm = WARM_STEPS
    sync()
    t_warm = time.perf_counter()
    mets.append(train_epoch(plan.chunk(cursor, cursor + warm), False))
    cursor += warm
    sync()
    pace = (time.perf_counter() - t_warm) / warm
    setup_s = time.perf_counter() - started

    # ---- the window ----
    def steps(n_wanted: int, t0: float, deadline: float) -> int:
        """Chunks of K steps of the plan; where the pace (of the warm-up
        steps, then of the window's) says a whole chunk would overrun
        ``deadline``, the last one is cut to the steps that fit (at least
        one)."""
        nonlocal plan, cursor
        done = 0
        while done < n_wanted:
            if cursor >= plan.steps:
                plan, cursor = epoch_indices(loader, n_micro, M,
                                             pair_rng), 0
            n = min(K, plan.steps - cursor, n_wanted - done)
            now = time.perf_counter()
            per = (now - t0) / done if done else pace
            if deadline - now < n * per:
                n = max(1, min(n, round((deadline - now) / per)))
            mets.append(train_epoch(plan.chunk(cursor, cursor + n),
                                    first_chunk=cursor == 0))
            cursor += n
            done += n
            if time.perf_counter() >= deadline:
                break
        return done

    t0 = time.perf_counter()
    window_steps = steps(1 << 30, t0, t0 + seconds)
    sync()
    window_s = time.perf_counter() - t0
    out = {"setup_s": setup_s, "window_s": window_s,
           "window_steps": window_steps,
           "train_slices_per_s": window_steps * rc["effective_batch"]
           / window_s}
    if trace:
        from benchmark.trace import record
        forever = float("inf")
        out["trace"] = record(lambda: steps(TRACED_STEPS, 0.0,
                                            forever), sync)
        out["trace_shapes"] = record(lambda: steps(1, 0.0, forever), sync,
                                     shapes=True)
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    all_k = LOSS_KEYS.index("all")
    metrics = torch.cat(mets).float().cpu().numpy()
    prog = {"loss": [float(v) for v in metrics[:checked, all_k]],
            "terms": [dict(zip(LOSS_KEYS, map(float, row)))
                      for row in metrics[:checked]],
            "grad1": {n: float(v) for n, v in grad1.items()},
            "change": {n: float(v) for n, v in change.items()}}
    failed = int((~np.isfinite(metrics[:, all_k])).sum())
    del model, opt, train_epoch, plan, named, grad1, change, mets, gen
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, after the window ----
    ref_out = reference_steps(rc, w0, vols, tgts, presence, s_loader,
                              s_pair, s_z, checked, device)
    out.update(attempted=window_steps, failed=failed, memory_peak=mem,
               readings=compare.training(prog, ref_out))
    if trace:
        out["flop_per_unit"] = counts.train_step_flop(
            rc, rc["batch_size"], n_micro)
        out["unit_s"] = window_s / window_steps
    return out


def reference_steps(rc, w0, vols, tgts, presence, s_loader, s_pair, s_z,
                    n_steps, device, quant=None, rows_kept=None):
    """The reference's first ``n_steps`` optimizer steps from the initial
    weights ``w0``, in float32 with TF32 off, on batches it gathers from
    the cache by its own indexing and the noise the program's generator
    drew (the same seed, in the same order).  ``quant`` is the control's
    rounding; ``rows_kept`` keeps the first rows of every microbatch
    (a fault)."""
    from benchmark.reference.model import F32
    with rtrain.no_tf32():
        ref = reference_on(rc, w0, device, quant=quant or F32,
                           checkpointed=True)
        names = [n for n, _ in ref.named_parameters()]
        params = [p for _, p in ref.named_parameters()]
        rows, slices, drop, sim = plan_rows(rc, s_loader, s_pair, n_steps,
                                            presence.cpu().numpy())
        gen = torch.Generator(device=device).manual_seed(s_z)
        M, B, z = len(rc["contrast_list"]), rows.shape[2], rc["z_size"]
        steps = []
        for k in range(n_steps):
            micro, eps = [], []
            for a in range(rows.shape[1]):
                e = torch.randn((M, B, z), generator=gen, device=device)
                keep = slice(0, rows_kept or B)
                micro.append(rtrain.gather(
                    vols, tgts, presence, rows[k, a, keep],
                    slices[k, a, keep], drop[k, a, keep], rc["block_size"]))
                eps.append(e[:, keep])
            steps.append({"micro": micro, "eps": eps, "sim": sim[k]})
        res = rtrain.train_steps(ref, rc, steps, params)
        with torch.no_grad():
            res["change"] = {n: float((p - w0[n]).norm())
                             for n, p in zip(names, params)}
        res["grad1"] = dict(zip(names, res["grad1"]))
        return res
