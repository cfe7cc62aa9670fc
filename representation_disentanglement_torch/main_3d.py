"""Whole-volume 3D entry point (NVNet3D) on one CUDA card (JAX
``main_3d.py``; the reference ships the modules and datasets but no
training script, SURVEY §2.6).

Usage:
  python -m representation_disentanglement_torch.main_3d \\
      --data-path ../data --dataset BraTS --epochs 10 --batch-size 1

Expects the 2D path's HDF5 + fold-txt artifacts (BraTS reads the
``fold_BraTS_{k}_{split}_noval.txt`` folds, other datasets
``fold_{dataset}_{k}_{split}.txt``) and trains on whole-volume slabs
([45:45+D] of each volume, the reference's [45:-46] for BraTS).
``run(args, store=VolumeStore(data=...))`` takes the volumes from memory
where ``h5py`` is absent; the fold txts still come from ``--data-path``.

``--phase train`` runs the epochs: training steps (``--accum``
microbatches per optimizer step), the validation fold's mean per-class
Dice, a ``stat.csv`` row per epoch with ``val_dice``, ``epochNNN.ckpt``
each epoch and ``model_best.ckpt`` on ``1 - val_dice``; ``--resume`` picks
the newest epoch checkpoint (or a newer ``preempt.ckpt``); SIGTERM or
SIGINT (or ``guard.request()``) saves ``preempt.ckpt`` after the current
step and stops.  ``--phase test`` restores ``--ckpt-name``, scores the
test fold per subject (Dice, IoU), writes a ``test`` row and exports each
subject's predicted label volume ([D, H, W], labels 0-3) to
``<ckpt-dir>/result_test/`` as NIfTI when ``nibabel`` imports, else
``.npy``.

Depth sharding (``--depth-shards``) and data sharding (``--data-shards``)
over several cards are ROADMAP item 16 and raise here.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from representation_disentanglement_torch.data.dataset import (
    _H5_NAMES, VolumeStore, load_idx_list)
from representation_disentanglement_torch.data.dataset3d import (
    VolumeDataset3D, collate_volumes)
from representation_disentanglement_torch.main_missing import _device
from representation_disentanglement_torch.metrics import (
    compute_segmentation_metrics)
from representation_disentanglement_torch.models.unet3d import build_nvnet3d
from representation_disentanglement_torch.training.checkpoint import (
    load_checkpoint, load_partial_params, save_checkpoint)
from representation_disentanglement_torch.training.stats import (
    save_result_stat)
from representation_disentanglement_torch.training.train3d import (
    METRIC_KEYS, create_state_3d, make_eval_step_3d, make_train_step_3d)
from representation_disentanglement_torch.utils.preempt import (
    PREEMPT_NAME, PreemptionGuard, clear_stale_preempt,
    drop_preempt_sidecar, latest_resume_checkpoint, tag_preempt_epoch)


def volume_loader(ds, batch_size, shuffle, seed=10, drop_last=True):
    """A generator factory of collated batches.  ``drop_last=True`` for
    training; eval passes False so that a tail smaller than the batch (a
    1-subject val fold) still yields."""
    rng = np.random.default_rng(seed)

    def gen():
        order = np.arange(len(ds))
        if shuffle:
            rng.shuffle(order)
        buf = []
        for i in order:
            s = ds[int(i)]
            if s is None:
                continue
            buf.append(s)
            if len(buf) == batch_size:
                yield collate_volumes(buf)
                buf = []
        if buf and not drop_last:
            yield collate_volumes(buf)
    return gen


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--dataset", default="BraTS")
    ap.add_argument("--contrasts", nargs="+",
                    default=["T1", "T1c", "T2", "T2_FLAIR"])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--init-channels", type=int, default=16)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--image-size", type=int, nargs=3,
                    default=[160, 192, 64], help="H W D slab")
    ap.add_argument("--slab-start", type=int, default=None,
                    help="first slab slice (default 45, the reference's)")
    ap.add_argument("--depth-shards", type=int, default=0,
                    help="not ported (ROADMAP item 16): raises when > 1")
    ap.add_argument("--data-shards", type=int, default=0,
                    help="not ported (ROADMAP item 16): raises when > 1")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--resume", action="store_true",
                    help="resume params/opt-state/epoch from --ckpt-dir")
    ap.add_argument("--ckpt-dir", default="../ckpt3d")
    ap.add_argument("--phase", choices=["train", "test"], default="train",
                    help="test: restore --ckpt-name, evaluate the test "
                         "fold (per-subject + mean dice/IoU) and export "
                         "predicted label volumes")
    ap.add_argument("--ckpt-name", default="model_best.ckpt",
                    help="checkpoint restored by --phase test")
    ap.add_argument("--no-export", action="store_true",
                    help="skip writing per-subject prediction volumes")
    return ap


def main(argv=None, device=None):
    return run(build_parser().parse_args(argv), device=device)


def _fold_subjects(args, split: str) -> np.ndarray:
    name = (f"fold_BraTS_{args.fold}_{split}_noval.txt"
            if args.dataset == "BraTS"
            else f"fold_{args.dataset}_{args.fold}_{split}.txt")
    return np.unique(load_idx_list(os.path.join(args.data_path, name))[0])


def _checkpoint(epoch, model, opt, monitor, is_val_dice, stat) -> dict:
    return {"epoch": epoch, "params": model.state_dict(),
            "opt_state": opt.state_dict(), "monitor_metric": monitor,
            "monitor_is_val_dice": int(is_val_dice), "stat": stat}


def _resume(args, model, opt):
    """Restore the newest state of ``args.ckpt_dir``: the epoch checkpoint
    of the highest number (numeric sort: ``epoch1000`` after
    ``epoch999``), or ``preempt.ckpt`` when it is at least as recent.
    Returns (start epoch, best monitor so far, summary dict)."""
    epochs = sorted(
        glob.glob(os.path.join(args.ckpt_dir, "epoch*.ckpt")),
        key=lambda p: int("".join(filter(str.isdigit,
                                         os.path.basename(p))) or 0))
    name = os.path.basename(epochs[-1]) if epochs else "model_best.ckpt"
    name, pre = latest_resume_checkpoint(args.ckpt_dir, name)
    ckpt = pre if pre is not None else load_checkpoint(args.ckpt_dir, name)
    merged, n_res, n_tot = load_partial_params(model.state_dict(),
                                               ckpt.get("params"))
    model.load_state_dict(merged)
    print(f"[resume] restored {n_res}/{n_tot} param tensors")
    opt_loaded = False
    if "opt_state" in ckpt and n_res == n_tot:
        try:
            opt.load_state_dict(ckpt["opt_state"])
            opt_loaded = True
        except (KeyError, ValueError):
            print("loading optimizer failed!")
    start_epoch = int(ckpt.get("epoch", -1)) + 1
    # the best-so-far monitor (model_best.ckpt) may be better than the
    # epoch the state resumes from
    try:
        best_ckpt = load_checkpoint(args.ckpt_dir)
    except ValueError:
        best_ckpt = ckpt
    best = float(best_ckpt.get("monitor_metric", float("inf")))
    # a train-loss monitor (no positives in the val fold, or no tag) is
    # incommensurable with 1 - val_dice: restart the best tracking
    if int(best_ckpt.get("monitor_is_val_dice", 0)) != 1:
        print("[resume] checkpoint monitor is not 1-val_dice; resetting "
              "best-monitor tracking")
        best = float("inf")
    print(f"[resume] from epoch {start_epoch} ({name}, best monitor "
          f"{best:.4f})")
    return start_epoch, best, {"resume_name": name,
                               "restored": [n_res, n_tot],
                               "optimizer_loaded": opt_loaded}


def run(args, device=None, store: Optional[VolumeStore] = None,
        guard: Optional[PreemptionGuard] = None):
    """Train or test as ``args`` (``build_parser()``'s namespace) say, on
    ``device`` (default CUDA), reading volumes from ``store`` (default the
    dataset's z-scored HDF5 file under ``--data-path``) under ``guard``
    (default: one entered here, on SIGTERM/SIGINT).

    Train returns {"ckpt_dir", "start_epoch", "resume" (None or the resume
    summary), "epochs": one record per epoch (steps, train means,
    val_dice, seconds, volumes/s, checkpoint bytes and save seconds; a
    preempted epoch's record says after how many steps)}.  Test returns
    the ``test`` row's stat with the per-subject scores, the restored
    count and the exported files."""
    if args.depth_shards > 1 or args.data_shards > 1:
        raise NotImplementedError(
            "--depth-shards/--data-shards > 1: multi-GPU 3D is not ported "
            "yet (ROADMAP.md, queue 1, item 16)")
    device = _device(device)
    if store is None:
        store = VolumeStore(os.path.join(args.data_path,
                                         _H5_NAMES[args.dataset][1]))
    test = args.phase == "test"
    H, W, D = args.image_size
    # the reference's slabs [45:-46] (BraTS, D=155) and [45:-47]
    # (ZeroDose, D=156) both equal [45 : 45+64]; generalized to the depth
    start = 45 if args.slab_start is None else args.slab_start
    slab = slice(start, start + D)
    mk = lambda split, aug=False: VolumeDataset3D(
        args.dataset, store, _fold_subjects(args, split), args.contrasts,
        aug=aug, image_size=(H, W, D), slab=slab)
    if test:
        test_ds = mk("test")
    else:
        train_ds, val_ds = mk("train", aug=True), mk("val")
        # the JAX package draws one batch here to shape its initialization,
        # which advances the train set's augmentation RNG; drawing it too
        # keeps the two packages' batches equal from the same seed
        next(volume_loader(train_ds, args.batch_size, False,
                           drop_last=False)())

    model = build_nvnet3d((H, W, D), in_channels=len(args.contrasts),
                          out_channels=3, init_channels=args.init_channels,
                          device=device)
    opt = create_state_3d(model, lr=args.lr)
    eval_step = make_eval_step_3d(model)
    os.makedirs(args.ckpt_dir, exist_ok=True)

    def infer(inputs):
        return eval_step(torch.as_tensor(inputs, device=device))[0]

    if test:
        return _test(args, model, test_ds, infer)

    def validate():
        """Mean per-class Dice over the val fold (the reference's: +1
        smoothing, classes 1-3, threshold 0.5; src/util.py:980-992)."""
        dices = []
        for batch in volume_loader(val_ds, args.batch_size, False,
                                   drop_last=False)():
            probs = infer(batch["inputs"]).cpu().numpy()
            seg = batch["targets"][:, 0]
            for b in range(probs.shape[0]):
                for c in range(3):
                    gt = seg[b] == c + 1
                    pr = probs[b, c] > 0.5
                    inter = np.logical_and(gt, pr).sum()
                    dices.append((2 * inter + 1) / (gt.sum() + pr.sum() + 1))
        return float(np.mean(dices)) if dices else float("nan")

    start_epoch, best, resumed = 0, float("inf"), None
    if args.resume:
        start_epoch, best, resumed = _resume(args, model, opt)
    summary = {"ckpt_dir": args.ckpt_dir, "start_epoch": start_epoch,
               "resume": resumed, "epochs": []}
    with PreemptionGuard() if guard is None else nullcontext(guard) as g:
        return _train(args, model, opt, train_ds, validate, start_epoch,
                      best, g, device, summary)


def _train(args, model, opt, train_ds, validate, start_epoch, best, guard,
           device, summary):
    step = make_train_step_3d(model, opt, accum=args.accum)
    generator = torch.Generator(device=device).manual_seed(10)
    val_dice = float("nan")
    records = summary["epochs"]
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        terms, micro = [], []
        for batch in volume_loader(train_ds, args.batch_size, True,
                                   seed=10 + epoch)():
            micro.append(batch)
            if len(micro) < args.accum:
                continue
            stack = lambda k: torch.as_tensor(
                micro[0][k] if args.accum == 1
                else np.stack([m[k] for m in micro]), device=device)
            m = step({"inputs": stack("inputs"),
                      "targets": stack("targets")}, generator)
            micro = []
            # one device-to-host copy per step
            mvals = torch.stack([m[k] for k in METRIC_KEYS]).cpu().numpy()
            if not np.isfinite(mvals).all():
                raise FloatingPointError(
                    f"non-finite metric at epoch {epoch} step {len(terms)}: "
                    f"{dict(zip(METRIC_KEYS, map(float, mvals)))}")
            terms.append(dict(zip(METRIC_KEYS, map(float, mvals))))
            if guard.requested:
                # persist the live state tagged with the last completed
                # epoch, so that a resume replays this one; the stale
                # sidecar goes first (utils/preempt.py)
                drop_preempt_sidecar(args.ckpt_dir)
                save_checkpoint(_checkpoint(
                    epoch - 1, model, opt, best,
                    np.isfinite(val_dice) and np.isfinite(best), {}),
                    False, args.ckpt_dir, name=PREEMPT_NAME)
                tag_preempt_epoch(args.ckpt_dir, epoch - 1)
                print(f"[preempt] saved {PREEMPT_NAME} mid-epoch {epoch} "
                      f"after {len(terms)} steps; exiting", flush=True)
                records.append({"epoch": epoch,
                                "preempted_after_steps": len(terms)})
                return summary
        if micro:
            print(f"[accum] dropping {len(micro)} leftover microbatch(es) "
                  "at epoch end (epoch yielded a non-multiple of --accum)")
        if not terms:
            raise ValueError(f"no optimizer step ran in epoch {epoch}: "
                             f"fewer batches than --accum {args.accum}")
        train_s = time.perf_counter() - t0
        stat_train = {k: float(np.mean([t[k] for t in terms]))
                      for k in terms[0]}
        t1 = time.perf_counter()
        val_dice = validate()
        val_s = time.perf_counter() - t1
        # monitor 1 - dice, lower is better; a val fold without positives
        # (nan) falls back to the train loss
        monitor_is_val = bool(np.isfinite(val_dice))
        monitor = 1.0 - val_dice if monitor_is_val else stat_train["loss"]
        # one row per epoch: the val metric joins the train terms
        save_result_stat(dict(stat_train, val_dice=val_dice), args.ckpt_dir,
                         info=f"epoch[{epoch:2d}]")
        is_best = monitor <= best
        best = min(best, monitor)
        t1 = time.perf_counter()
        path = save_checkpoint(_checkpoint(epoch, model, opt, monitor,
                                           monitor_is_val, stat_train),
                               is_best, args.ckpt_dir)
        save_s = time.perf_counter() - t1
        clear_stale_preempt(args.ckpt_dir, epoch)
        vols = len(terms) * args.accum * args.batch_size
        print(f"epoch {epoch}: loss {stat_train['loss']:.4f} val dice "
              f"{val_dice:.4f} ({train_s:.1f}s, {len(terms)} steps, "
              f"{vols / train_s:.2f} volumes/s)")
        records.append({"epoch": epoch, "steps": len(terms),
                        "train": stat_train, "val_dice": val_dice,
                        "monitor": monitor, "is_best": is_best,
                        "train_s": train_s, "volumes_per_s": vols / train_s,
                        "val_s": val_s, "ckpt_bytes": os.path.getsize(path),
                        "ckpt_save_s": save_s})
        if guard.requested:
            print(f"[preempt] stopped cleanly after epoch {epoch}",
                  flush=True)
            break
    if start_epoch >= args.epochs:        # an eval-only invocation
        val_dice = validate()
        summary["val_dice"] = val_dice
    print(f"val mean dice: {val_dice:.4f}")
    return summary


def _test(args, model, test_ds, infer) -> dict:
    """Per-subject and mean Dice/IoU over the test fold with the 2D path's
    metric definitions, and the predicted label volumes: 0 where no class
    probability clears 0.5, else the argmax class 1-3, in the JAX
    package's [D, H, W] order."""
    ckpt = load_checkpoint(args.ckpt_dir, args.ckpt_name)
    merged, n_res, n_tot = load_partial_params(model.state_dict(),
                                               ckpt.get("params"))
    model.load_state_dict(merged)
    print(f"[test] restored {n_res}/{n_tot} param tensors from "
          f"{args.ckpt_name}")
    res_dir = os.path.join(args.ckpt_dir, "result_test")
    os.makedirs(res_dir, exist_ok=True)
    per_subject, files = {}, []
    for batch in volume_loader(test_ds, args.batch_size, False,
                               drop_last=False)():
        probs = infer(batch["inputs"]).cpu().numpy()        # [B, 3, H, W, D]
        m = compute_segmentation_metrics(
            np.moveaxis(batch["targets"], 1, -1), np.moveaxis(probs, 1, -1))
        for b, subj in enumerate(batch["subj_id"]):
            per_subject[subj] = {"dice": m["dice"][b], "iou": m["iou"][b]}
            print(f"[test] {subj}: dice {m['dice'][b]:.4f} "
                  f"iou {m['iou'][b]:.4f}")
            if args.no_export:
                continue
            pr = probs[b]
            lab = np.where(pr.max(0) > 0.5, pr.argmax(0) + 1, 0)
            lab = np.transpose(lab, (2, 0, 1)).astype(np.float32)
            base = os.path.join(res_dir, f"{subj}_pred")
            try:
                from representation_disentanglement_torch.utils.visualize \
                    import save_volume_nifti
                save_volume_nifti(base + ".nii.gz", lab)
                files.append(base + ".nii.gz")
            except ImportError:
                np.save(base + ".npy", lab)
                files.append(base + ".npy")
    dices = [s["dice"] for s in per_subject.values()]
    ious = [s["iou"] for s in per_subject.values()]
    stat = {"dice": float(np.mean(dices)) if dices else float("nan"),
            "iou": float(np.mean(ious)) if ious else float("nan"),
            "n_subjects": len(dices)}
    save_result_stat(stat, args.ckpt_dir, info="test")
    print(f"[test] mean dice {stat['dice']:.4f} iou {stat['iou']:.4f} "
          f"over {len(dices)} subjects -> {res_dir}")
    return dict(stat, per_subject=per_subject, restored=[n_res, n_tot],
                files=files)


if __name__ == "__main__":
    main()
