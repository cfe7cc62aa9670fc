"""Entry point of a training run: the reference's ``python main_missing.py``
workflow on one CUDA card (JAX ``main_missing.py``).

Run as ``python -m representation_disentanglement_torch.main_missing
[config.yaml] [--data-root DIR] [--ckpt-root DIR]``, or call
``run(cfg, ckpt_root, store=...)`` with the volumes in memory where
``h5py`` is absent.  The YAML config drives everything (the reference's
keys).  ``phase: train`` runs the epochs: each trains over the device
volume cache (``device_data_cache``, when the volumes fit
``device_cache_budget_gb``) or the host loader, then validates, steps the
plateau schedule on the monitor metric, appends to ``stat.csv`` and writes
``epochNNN.ckpt`` (``model_best.ckpt`` when the monitor improved).
``continue_train`` resumes from ``ckpt_name`` or a newer ``preempt.ckpt``;
the merge is shape-tolerant, so a stage-2 run (``config.seg_stage2``)
starts from a stage-1 run directory whose output layer had another shape,
and then loads the schedule and the epoch but not the optimizer.
SIGTERM or SIGINT (or ``guard.request()``) saves ``preempt.ckpt`` at the
next chunk of ``epoch_chunk_steps`` steps and stops.

``phase: test`` (with ``ckpt_timelabel`` naming the trained run) restores
``ckpt_name`` (no optimizer, no ``preempt.ckpt``) and evaluates the set
that ``--set`` names (``test``, ``val``, ``train`` or ``test_dropoff``),
writing ``result_<set>/results_all<info>.h5``; ``--info nearest_neighbour``
/ ``mean`` (or ``<mode>_src=<c>``) re-decodes with z retrieved from that
set's earlier dump.  ``run`` then returns the stat dict; ``writer=`` and
``bank=`` replace the HDF5 writer and bank file where ``h5py`` is absent
(training/evaluate.py).

``mesh_shape: {data: N}`` trains on N cards, one process each (rank r on
``cuda:r``, NCCL; on the CPU with ``device="cpu"``, gloo), with the JAX DP
step's global semantics (parallel/mesh.py, training/train.py): ``run``
starts the N processes itself (a free port on localhost) unless a process
group exists or ``torchrun`` describes one (RANK, WORLD_SIZE, ...), which
it then joins.  The train cache is sharded over the cards
(``shard_data_cache``; per-card bytes about 1/N, locality-aware epoch
plan), the val/test caches too (``shard_eval_cache``); else they are
replicated and each rank takes its rows of every batch.  The host loader
gathers only the rank's rows.  Validation runs on the mesh; the test
phase runs on one card.  Only rank 0 writes the run directory (config
snapshots, ``stat.csv``, checkpoints); every rank reads a checkpoint, so a
resume works under DP and a checkpoint written under DP resumes on one
card.  A preemption is agreed at every chunk or step: all ranks save the
same step.

Differences from the reference, all as in the JAX package: gradient
accumulation over A microbatches inside one optimizer step, the epoch's
leftover microbatches dropped; non-finite metrics raise
``FloatingPointError``; the input pipeline prefetches.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from representation_disentanglement_torch.config import (
    Config, load_config, resolve_run)
from representation_disentanglement_torch.data.dataset import (
    _H5_NAMES, DataAll, TestDropoffDataset, VolumeStore, fold_txt_names,
    load_idx_list)
from representation_disentanglement_torch.data.device_store import (
    DeviceBatchLoader, ShardedDeviceBatchLoader, ShardedEvalBatchLoader,
    build_device_cache, build_sharded_device_cache)
from representation_disentanglement_torch.data.loader import BatchLoader
from representation_disentanglement_torch.models.layers import (
    resolve_device)
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.parallel.mesh import (
    agree, broadcast_object, data_size, is_writer, join, launched,
    mesh_from_config, replicate_training, shard_epoch_plan, spawn)
from representation_disentanglement_torch.training.checkpoint import (
    restore_model_state, save_checkpoint)
from representation_disentanglement_torch.training.epoch import (
    epoch_indices, make_train_epoch)
from representation_disentanglement_torch.training.evaluate import (
    evaluate, make_eval_step)
from representation_disentanglement_torch.training.optim import (
    ReduceLROnPlateau, load_adam_state, make_d_optimizer, make_optimizer)
from representation_disentanglement_torch.training.stats import (
    save_result_stat)
from representation_disentanglement_torch.training.train import (
    LOSS_KEYS, METRIC_KEYS, draw_pairs, make_train_step, metrics_to_dict)
from representation_disentanglement_torch.utils.preempt import (
    PREEMPT_NAME, PreemptionGuard, clear_stale_preempt,
    drop_preempt_sidecar, latest_resume_checkpoint, tag_preempt_epoch)
from representation_disentanglement_torch.utils.profiling import StepTimer
from representation_disentanglement_torch.weights import from_jax_params


def make_loaders(cfg: Config, device, store: Optional[VolumeStore] = None,
                 mesh=None):
    """(train, val, test) loaders: over device volume caches when
    ``device_data_cache`` is on and all three fit the budget, else host
    ``BatchLoader``s that copy each batch to ``device``.  With a data
    ``mesh`` (JAX main_missing.py:84-140) the train cache is sharded over
    its ranks with ``shard_data_cache`` and the val/test caches with
    ``shard_eval_cache`` (``device_cache_budget_gb`` then bounds a card's
    shard), else replicated; the host train loader gathers the rank's
    rows."""
    data = DataAll(
        cfg.dataset_name, cfg.data_path, norm_type=cfg.norm_type,
        fold=cfg.fold, block_size=cfg.block_size,
        contrast_list=cfg.contrast_list, aug=False, dropoff=cfg.dropoff,
        skull_strip=cfg.skull_strip, image_size=cfg.input_size,
        seed=cfg.seed, store=store)
    if cfg.device_data_cache and not cfg.skull_strip:
        budget = int(cfg.device_cache_budget_gb * 2**30)
        clamp = 89 if cfg.dataset_name == "Tau" else 155
        loaders = []
        for ds, shuffle, drop_last, dropoff in (
                (data.train_dataset, cfg.shuffle, True, cfg.dropoff),
                (data.val_dataset, False, False, cfg.dropoff),
                (data.test_dataset, False, False, False)):
            is_train = ds is data.train_dataset
            if mesh is not None and (cfg.shard_data_cache if is_train
                                     else cfg.shard_eval_cache):
                cache = build_sharded_device_cache(
                    cfg.dataset_name, data.store, ds.subj_list,
                    cfg.contrast_list, mesh, cfg.block_size,
                    budget_bytes=budget, clamp_max=clamp, device=device)
                if cache is None:
                    break
                loaders.append(
                    ShardedDeviceBatchLoader(
                        cache, ds.subj_list, ds.idx_list, cfg.batch_size,
                        shuffle=shuffle, drop_last=drop_last,
                        dropoff=dropoff, seed=cfg.seed) if is_train
                    else ShardedEvalBatchLoader(
                        cache, ds.subj_list, ds.idx_list, cfg.batch_size,
                        dropoff=dropoff, seed=cfg.seed))
                continue
            cache = build_device_cache(
                cfg.dataset_name, data.store, ds.subj_list,
                cfg.contrast_list, cfg.block_size, budget_bytes=budget,
                clamp_max=clamp, device=device)
            if cache is None:
                break
            loaders.append(DeviceBatchLoader(
                cache, ds.subj_list, ds.idx_list, cfg.batch_size,
                shuffle=shuffle, drop_last=drop_last, dropoff=dropoff,
                seed=cfg.seed))
        else:
            if is_writer():
                per_card = sum(getattr(ld.cache, "nbytes_per_card",
                                       ld.cache.nbytes) for ld in loaders)
                print("[data] device-resident volume cache active: "
                      f"{per_card / 2**20:.1f} MiB per card")
            return tuple(loaders)
    train = BatchLoader(data.train_dataset, cfg.batch_size,
                        shuffle=cfg.shuffle, drop_last=True, seed=cfg.seed,
                        prefetch=cfg.prefetch_depth, device=device,
                        shard=mesh)
    val = BatchLoader(data.val_dataset, cfg.batch_size, shuffle=False,
                      prefetch=cfg.prefetch_depth, device=device)
    test = BatchLoader(data.test_dataset, cfg.batch_size, shuffle=False,
                       prefetch=cfg.prefetch_depth, device=device)
    return train, val, test


def make_dropoff_loader(cfg: Config, store: Optional[VolumeStore] = None,
                        sel_idx_list=(438, 450), device=None) -> BatchLoader:
    """The ``set: test_dropoff`` loader (reference main_missing.py:348-350;
    JAX main_missing.py:522-547): every drop of at most two contrasts over
    the selected rows of the test fold txt, or over its first two rows when
    the selection exceeds the fold.  Volumes come from ``store`` when given,
    else from the HDF5 file under ``cfg.data_path``."""
    if store is None:
        names = _H5_NAMES[cfg.dataset_name]
        h5_name = names[0] if cfg.norm_type == "mean" else names[1]
        store = VolumeStore(os.path.join(cfg.data_path, h5_name))
    fold_txt = fold_txt_names(cfg.dataset_name, cfg.fold,
                              cfg.modality_num)[2]
    subjs, idxs = load_idx_list(os.path.join(cfg.data_path, fold_txt))
    sel = [i for i in sel_idx_list if i < len(subjs)] or list(
        range(min(2, len(subjs))))
    ds = TestDropoffDataset(store, subjs, idxs, sel,
                            block_size=cfg.block_size,
                            contrast_list=cfg.contrast_list,
                            dataset_name=cfg.dataset_name,
                            image_size=cfg.input_size)
    return BatchLoader(ds, cfg.batch_size, shuffle=False,
                       prefetch=cfg.prefetch_depth, device=device)


def _checkpoint(epoch: int, monitor: float, stat: dict, model, optimizer,
                scheduler, d_optimizer=None) -> dict:
    """The checkpoint payload; ``opt_d_state`` is the discriminator's Adam
    (None without one).  The adversarial gradient carry (quirk Q10) is not
    saved, as in the JAX package (JAX train.py:142-147)."""
    return {"epoch": epoch, "monitor_metric": monitor, "stat": stat,
            "params": model.state_dict(),
            "opt_state": optimizer.state_dict(),
            "opt_d_state": None if d_optimizer is None
            else d_optimizer.state_dict(),
            "scheduler": scheduler.state_dict()}


def _save_preempt(cfg, epoch, monitor_best, model, optimizer,
                  scheduler, d_optimizer=None) -> None:
    """Mid-epoch preemption: persist the live state tagged with the last
    COMPLETED epoch, so that a resume replays this one (at-least-once;
    utils/preempt.py).  The stale sidecar goes first, so that a kill
    between the save and the tag never pairs this file with an older
    tag."""
    drop_preempt_sidecar(cfg.ckpt_path)
    save_checkpoint(_checkpoint(epoch - 1, monitor_best, {}, model,
                                optimizer, scheduler, d_optimizer),
                    False, cfg.ckpt_path, name=PREEMPT_NAME)
    tag_preempt_epoch(cfg.ckpt_path, epoch - 1)


def _end_epoch(cfg, model, optimizer, scheduler, val_loader, eval_steps,
               epoch: int, monitor_best: float, record: dict,
               d_optimizer=None, mesh=None) -> float:
    """Validation, the plateau schedule, stat.csv's val row and the
    epoch's checkpoint (reference main_missing.py:312-335).  Fills
    ``record`` and returns the new best monitor value.  Under a data
    ``mesh`` every rank validates and steps the schedule; rank 0 writes."""
    t0 = time.perf_counter()
    writer = is_writer()
    if writer:
        os.makedirs(os.path.join(cfg.ckpt_path, "result_val"),
                    exist_ok=True)
    stat = evaluate(model, cfg, val_loader, eval_steps=eval_steps,
                    mesh=mesh)
    record["val_s"] = time.perf_counter() - t0
    # monitor metric (reference main_missing.py:317-320)
    if cfg.lambda_recon_y == 0 or cfg.lambda_recon_y_fused == 0:
        monitor = stat["recon_x_mix"]
    else:
        monitor = stat["recon_y_fused"]
    scheduler.step(monitor)
    is_best = monitor <= monitor_best
    record.update(val=stat, monitor=monitor, is_best=is_best)
    if writer:
        save_result_stat(stat, cfg.ckpt_path, info="val")
        print(f"epoch {epoch} val:", stat)
        t0 = time.perf_counter()
        path = save_checkpoint(_checkpoint(epoch, monitor, stat, model,
                                           optimizer, scheduler,
                                           d_optimizer),
                               is_best, cfg.ckpt_path)
        record.update(ckpt_save_s=time.perf_counter() - t0,
                      ckpt_bytes=os.path.getsize(path))
        clear_stale_preempt(cfg.ckpt_path, epoch)
    return min(monitor, monitor_best)


def train_device_epochs(cfg: Config, model, optimizer, loaders,
                        start_epoch: int, scheduler: ReduceLROnPlateau,
                        guard: PreemptionGuard, d_optimizer=None,
                        mesh=None) -> list:
    """Epochs over the device volume cache (training/epoch.py): one plan
    upload and one metrics fetch per epoch, the steps dispatched in chunks
    of ``cfg.epoch_chunk_steps`` with a preemption poll between chunks, so
    that a preemption loses at most that many optimizer steps.  Under a
    data ``mesh`` the ranks agree on the poll."""
    train_loader, val_loader, _ = loaders
    generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
    train_epoch, n_micro = make_train_epoch(model, cfg, optimizer,
                                            train_loader.cache, generator,
                                            d_optimizer, mesh)
    opts = [o for o in (optimizer, d_optimizer) if o is not None]
    eval_steps = make_eval_step(model, cfg, mesh)
    writer = is_writer()
    pair_rng = np.random.default_rng(cfg.seed)
    monitor_best = 100.0
    history = []
    for epoch in range(start_epoch + 1, cfg.epochs):
        t0 = time.perf_counter()
        scheduler.apply(*opts)
        plan = epoch_indices(train_loader, n_micro, cfg.modality_num,
                             pair_rng)
        if plan is None:
            raise ValueError("not enough samples for one optimizer step")
        if not isinstance(train_loader, ShardedDeviceBatchLoader):
            plan = shard_epoch_plan(plan, mesh)
        total = plan.steps
        K = cfg.epoch_chunk_steps or total
        chunks = []
        done = 0
        while done < total:
            n = min(K, total - done)
            chunks.append(train_epoch(plan.chunk(done, done + n),
                                      first_chunk=(done == 0)))
            done += n
            if agree(mesh, guard.requested) and done < total:
                if writer:
                    _save_preempt(cfg, epoch, monitor_best, model,
                                  optimizer, scheduler, d_optimizer)
                print(f"[preempt] saved {PREEMPT_NAME} mid-epoch {epoch} "
                      f"after {done}/{total} on-device steps (resume "
                      "replays the epoch); exiting", flush=True)
                history.append({"epoch": epoch, "preempted_after_steps":
                                done, "steps": total})
                return history
        metrics = torch.cat(chunks).cpu().numpy()        # the epoch's fetch
        n_steps = metrics.shape[0]
        if not np.isfinite(metrics).all():
            bad = np.where(~np.isfinite(metrics))[0][:1]
            raise FloatingPointError(
                f"non-finite metrics at epoch {epoch}, step {bad}")
        sums = metrics.sum(0)
        stat_train = {k: float(v) / (n_steps * n_micro)
                      for k, v in zip(METRIC_KEYS, sums)}
        stat_train.pop("grad_norm", None)
        dt = time.perf_counter() - t0
        sps = n_steps * cfg.effective_batch / dt
        if writer:
            save_result_stat(stat_train, cfg.ckpt_path,
                             info=f"epoch[{epoch:2d}]")
            print(f"epoch {epoch} train ({dt:.1f}s, {sps:.1f} slices/s, "
                  f"{n_steps} steps on-device):", stat_train)
        record = {"epoch": epoch, "steps": n_steps, "train": stat_train,
                  "train_s": dt, "slices_per_s": sps}
        monitor_best = _end_epoch(cfg, model, optimizer, scheduler,
                                  val_loader, eval_steps, epoch,
                                  monitor_best, record, d_optimizer, mesh)
        history.append(record)
        if agree(mesh, guard.requested):
            print(f"[preempt] stopped cleanly after epoch {epoch}",
                  flush=True)
            break
    return history


def _stack_micro(micro) -> dict:
    return {k: torch.stack([torch.as_tensor(m[k]) for m in micro])
            for k in ("inputs", "targets", "mask", "mask_img")}


def train(cfg: Config, model, optimizer, loaders, start_epoch: int,
          scheduler: ReduceLROnPlateau,
          guard: Optional[PreemptionGuard] = None, *, device=None,
          d_optimizer=None, mesh=None) -> list:
    """Train epochs start_epoch+1 .. cfg.epochs-1 on ``device`` (default
    CUDA; the model must be there) under a preemption guard (entered here,
    on the calling thread, when none is given); ``d_optimizer`` is the
    discriminator's Adam, with ``lambda_adv_s > 0``.  Returns one record
    per epoch: its train and val stats, seconds, slices/s and the
    checkpoint's bytes and save seconds.  ``mesh``: the data axis, with
    ``make_loaders``'s loaders of that mesh."""
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"the model is on {model.device}; training runs "
                         f"on {device}")
    if guard is None:
        with PreemptionGuard() as g:
            return train(cfg, model, optimizer, loaders, start_epoch,
                         scheduler, guard=g, device=device,
                         d_optimizer=d_optimizer, mesh=mesh)
    if isinstance(loaders[0], (DeviceBatchLoader,
                               ShardedDeviceBatchLoader)):
        return train_device_epochs(cfg, model, optimizer, loaders,
                                   start_epoch, scheduler, guard,
                                   d_optimizer, mesh)
    train_loader, val_loader, _ = loaders
    step = make_train_step(model, cfg, optimizer, d_optimizer, mesh)
    opts = [o for o in (optimizer, d_optimizer) if o is not None]
    n_micro = max(cfg.effective_batch // cfg.batch_size, 1)
    eval_steps = make_eval_step(model, cfg, mesh)
    writer = is_writer()
    pair_rng = np.random.default_rng(cfg.seed)
    generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
    monitor_best = 100.0
    timer = StepTimer(warmup=1)
    history = []
    for epoch in range(start_epoch + 1, cfg.epochs):
        t0 = time.perf_counter()
        scheduler.apply(*opts)
        timer.reset_interval()
        metric_sum = None          # on the device; one fetch at epoch end
        n_iters = 0                # and one per log interval
        micro = []
        first = True
        for batch in train_loader:
            micro.append(batch)
            if len(micro) < n_micro:
                continue
            stacked = _stack_micro(micro)
            micro = []
            sim_pairs = draw_pairs(pair_rng, cfg.modality_num, n_micro)
            adv_pairs = draw_pairs(pair_rng, cfg.modality_num, n_micro)
            metrics = step(stacked, generator, sim_pairs, adv_pairs,
                           first_of_epoch=first)
            first = False
            n_iters += n_micro
            timer.step(cfg.effective_batch)
            metric_sum = metrics if metric_sum is None \
                else metric_sum + metrics
            if agree(mesh, guard.requested):
                if writer:
                    _save_preempt(cfg, epoch, monitor_best, model,
                                  optimizer, scheduler, d_optimizer)
                print(f"[preempt] saved {PREEMPT_NAME} mid-epoch {epoch} "
                      f"(resume replays it); exiting", flush=True)
                history.append({"epoch": epoch, "preempted_after_steps":
                                n_iters // n_micro})
                return history
            if writer and cfg.log_every \
                    and (n_iters // n_micro) % cfg.log_every == 0:
                m = metrics_to_dict(metrics)        # one transfer
                if not np.isfinite(m["all"]):
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch}: {m}")
                print(f"Epoch[{epoch:3d}], iter[{n_iters:3d}]: " +
                      ", ".join(f"{k}=[{m[k] / n_micro:.4f}]"
                                for k in ("all", "recon_x", "recon_x_mix",
                                          "sim_s", "sim_z", "latent_z")))
        sums = metrics_to_dict(metric_sum) if metric_sum is not None else {
            k: 0.0 for k in LOSS_KEYS}                 # the epoch's fetch
        if not np.isfinite(sums.get("all", 0.0)):
            raise FloatingPointError(
                f"non-finite loss during epoch {epoch}: {sums}")
        stat_train = {k: sums.get(k, 0.0) / max(n_iters, 1)
                      for k in LOSS_KEYS}
        n_steps = n_iters // n_micro
        # as in the device branch: the whole epoch up to its fetch
        dt = time.perf_counter() - t0
        sps = n_steps * cfg.effective_batch / dt
        if writer:
            save_result_stat(stat_train, cfg.ckpt_path,
                             info=f"epoch[{epoch:2d}]")
            print(f"epoch {epoch} train ({dt:.1f}s, {sps:.1f} slices/s, "
                  f"{timer.throughput:.1f} between queued steps after the "
                  "first):", stat_train)
        record = {"epoch": epoch, "steps": n_steps, "train": stat_train,
                  "train_s": dt, "slices_per_s": sps}
        monitor_best = _end_epoch(cfg, model, optimizer, scheduler,
                                  val_loader, eval_steps, epoch,
                                  monitor_best, record, d_optimizer, mesh)
        history.append(record)
        if agree(mesh, guard.requested):
            print(f"[preempt] stopped cleanly after epoch {epoch}",
                  flush=True)
            break
    return history


def restore_optimizers(ckpt: dict, optimizer, d_optimizer=None) -> bool:
    """Load ``opt_state`` (and ``opt_d_state`` into ``d_optimizer``) from a
    checkpoint of either package, tolerating a mismatch as the reference
    does (util.py:880-888).  Returns whether the main optimizer was
    loaded."""
    loaded = False
    if "opt_state" in ckpt:
        try:
            load_adam_state(optimizer, ckpt["opt_state"])
            loaded = True
        except (KeyError, ValueError):
            print("loading optimizer failed!")
    if d_optimizer is not None and ckpt.get("opt_d_state"):
        try:
            load_adam_state(d_optimizer, ckpt["opt_d_state"])
        except (KeyError, ValueError):
            print("loading the discriminator's optimizer failed!")
    return loaded


def run(cfg: Config, ckpt_root: str = "../ckpt", *, device=None,
        store: Optional[VolumeStore] = None,
        guard: Optional[PreemptionGuard] = None, eval_set: str = "test",
        eval_info: str = "", writer=None, bank=None):
    """Resolve the run directory, build the model (on ``device``, default
    CUDA) and the loaders (from ``store`` when given, else the HDF5 file
    under ``cfg.data_path``), then train or test.

    ``phase: train``: resume when ``continue_train``, train, and return a
    summary: ``ckpt_path``, ``loader`` ('device' or 'host'), ``gather``
    (the host loader's batch gather, 'native' or 'numpy'; None on the
    device cache),
    ``cache_bytes`` (the device caches), ``start_epoch``, ``restored``
    ([n_restored, n_total] or None), ``resume_name``, ``optimizer_loaded``
    (the resume loaded the optimizer: only when every tensor was
    restored), ``scheduler_at_start`` and the per-epoch records of
    ``train``.

    ``phase: test``: restore ``ckpt_name``, evaluate the ``eval_set``
    loader with the dump (``writer``) and the retrieval ``eval_info``
    (``bank``), and return the stat dict (JAX main_missing.py:550-627).

    ``mesh_shape: {data: N}`` with N > 1 trains on N processes (module
    docstring): without a process group, ``run`` starts them, each on its
    card (``device`` None or CUDA) or on the CPU (``device="cpu"``), and
    returns rank 0's summary, which also gives ``mesh`` (N) and
    ``cache_bytes_per_card``; ``guard`` is then each process's own.  In a
    process group (or under ``torchrun``) it is one rank's run; in a
    group of one rank, with N = 1, the DP path on one card.  A resume
    keeps the caller's ``mesh_shape`` (the saved one is the cards of the
    earlier run), so a run written on N cards resumes on one, and back."""
    device = resolve_device(device)
    n = data_size(cfg)
    mesh = None
    if cfg.phase == "train" and n > 1 and not launched():
        if guard is not None:
            raise ValueError("a guard cannot reach the processes that run "
                             "starts for mesh_shape data > 1")
        return spawn(n, run, cfg, ckpt_root, device=device, store=store)
    if cfg.phase == "train" and (n > 1 or torch.distributed.is_initialized()):
        device = join(device)
        mesh = mesh_from_config(cfg, device)
    if is_writer():
        live = cfg.mesh_shape
        cfg = resolve_run(cfg, ckpt_root=ckpt_root)
        cfg.mesh_shape = live        # the cards of this run, not the saved
    cfg = broadcast_object(cfg, mesh).derive().validate()
    if is_writer():
        print(cfg.model_name, "->", cfg.ckpt_path)
    model = build_model(cfg, device=device)
    loaders = make_loaders(cfg, device, store, mesh)
    if cfg.phase == "test":
        return _test(cfg, model, loaders, device, store, eval_set,
                     eval_info, writer, bank)
    # the JAX package draws one batch here to shape its initialization,
    # which advances the train loader's RNG; drawing it too keeps the two
    # packages' epoch plans equal from the same seed
    next(iter(loaders[0]))
    optimizer = make_optimizer(model.parameters(), cfg)
    d_optimizer = make_d_optimizer(model.parameters(), cfg) \
        if cfg.is_discrim_s else None
    scheduler = ReduceLROnPlateau(cfg.lr)
    start_epoch, restored, resume_name = -1, None, None
    opt_loaded = False
    if cfg.continue_train:
        # prefer a preempt.ckpt when it is the more recent epoch
        resume_name, _ = latest_resume_checkpoint(cfg.ckpt_path,
                                                  cfg.ckpt_name)
        ckpt, restored = _restore(model, cfg, resume_name)
        if restored[0] == restored[1]:
            opt_loaded = restore_optimizers(ckpt, optimizer, d_optimizer)
        if "scheduler" in ckpt:
            try:
                scheduler.load_state_dict(ckpt["scheduler"])
            except (KeyError, TypeError):
                print("loading scheduler failed!")
        start_epoch = int(ckpt.get("epoch", -1))
    replicate_training(model, (optimizer, d_optimizer), mesh)
    scheduler_at_start = scheduler.state_dict()
    if is_writer():
        cfg.snapshot_txt(cfg.ckpt_path)
    history = train(cfg, model, optimizer, loaders, start_epoch, scheduler,
                    guard=guard, device=device, d_optimizer=d_optimizer,
                    mesh=mesh)
    on_device = not isinstance(loaders[0], BatchLoader)
    per_card = lambda c: getattr(c, "nbytes_per_card", c.nbytes)
    return {"ckpt_path": cfg.ckpt_path, "mesh": n if mesh else 1,
            "loader": "device" if on_device else "host",
            "gather": None if on_device else loaders[0].gather,
            "cache_bytes": sum(ld.cache.nbytes for ld in loaders)
            if on_device else 0,
            "cache_bytes_per_card": sum(per_card(ld.cache) for ld in loaders)
            if on_device else 0,
            "start_epoch": start_epoch, "restored": restored,
            "resume_name": resume_name, "optimizer_loaded": opt_loaded,
            "scheduler_at_start": scheduler_at_start, "epochs": history}


def jax_params_fn(cfg: Config):
    """The conversion of the JAX ``MultimodalModel``'s trees of ``cfg``
    (``weights.from_jax_params``) for ``from_jax_checkpoint``."""
    return lambda params, stats: from_jax_params(
        params, stats, modality_num=cfg.modality_num,
        input_size=cfg.input_size, target_model_name=cfg.target_model_name)


def _restore(model, cfg: Config, name: str):
    """Load checkpoint ``name`` of the run (the port's, or the JAX
    package's, converted) into ``model`` by the shape-tolerant merge.
    Returns (checkpoint, [n_restored, n_total])."""
    ckpt, merged, n_res, n_tot = restore_model_state(
        model.state_dict(), cfg.ckpt_path, name,
        params_fn=jax_params_fn(cfg),
        param_names=[n for n, _ in model.named_parameters()])
    print(f"restored {n_res}/{n_tot} param tensors")
    model.load_state_dict(merged)
    return ckpt, [n_res, n_tot]


def _test(cfg: Config, model, loaders, device, store, eval_set: str,
          eval_info: str, writer, bank) -> dict:
    """The test phase: ``ckpt_name`` restored (the test phase reads no
    preempt state and no optimizer), then one evaluation of the set with
    the dump."""
    _restore(model, cfg, cfg.ckpt_name)
    if eval_set == "test_dropoff":
        loader = make_dropoff_loader(cfg, store, device=device)
    else:
        loader = loaders[("train", "val", "test").index(eval_set)]
    stat = evaluate(model, cfg, loader, phase="test", set_name=eval_set,
                    save_res=True, info=eval_info, writer=writer, bank=bank)
    print(stat)
    return stat


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="config.yaml")
    ap.add_argument("--ckpt-root", default="../ckpt")
    ap.add_argument("--data-root", default=None,
                    help="override the config's data_path (the directory "
                         "holding <dataset>_All_*.h5 + fold txts)")
    ap.add_argument("--set", dest="eval_set", default="test",
                    choices=["test", "val", "train", "test_dropoff"],
                    help="the set the test phase evaluates (reference "
                         "main_missing.py:611-623)")
    ap.add_argument("--info", default="",
                    help="tag of the test phase's dump; 'nearest_neighbour' "
                         "/ 'mean' (or '<mode>_src=<c>') retrieve z from "
                         "the set's earlier results_all.h5")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    if args.data_root:
        cfg.data_path = args.data_root.rstrip("/") + "/"
    return run(cfg, ckpt_root=args.ckpt_root, device=device,
               eval_set=args.eval_set, eval_info=args.info)


if __name__ == "__main__":
    main()
