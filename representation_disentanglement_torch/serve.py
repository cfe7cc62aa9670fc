"""Missing-modality serving: the imputation product as an entry point
(JAX ``serve.py``).

``make_serve_step`` is one call of ``MultimodalModel.synthesize`` (M
decodes from one anatomy source plus the fused y decode) on a batch whose
absent contrasts are zero-filled; ``make_serve_step_retrieval`` takes the
missing contrasts' z from a bank of latents (a ``results_all.h5`` dump,
typically of ``--set train``) keyed by compact anatomy.  ``serve_requests``
answers requests on in-memory slice blocks; ``serve`` runs the CLI
over a trained run::

    python -m representation_disentanglement_torch.serve config.yaml \
        --missing T1,T2_FLAIR [--source T2] [--out-dir serve_out] \
        [--ckpt-root ../ckpt] [--format auto|npy|nifti] [--subjects a,b] \
        [--z-bank results_all.h5 --z-mode nearest_neighbour|mean] \
        [--batch N] [--no-y]

It resolves the run directory as ``phase: test`` does (``ckpt_timelabel``),
restores ``ckpt_name``, and walks the test fold subject by subject:
contrasts named by ``missing`` are zero-filled and their mask columns
cleared, the background mask (quirk Q6) comes from contrast 0, or from the
source when contrast 0 is served, the tail batch is padded by repeating its
last row, and the centre slice of each block is kept.  Each subject gives
one [D, H, W] volume per synthesized contrast and for the source, and the
fused y (a BraTS label map, else an image).  ``--format auto`` writes NIfTI
when ``nibabel`` imports, else ``.npy``.  ``serve(store=..., bank=...)``
takes the volumes and the z bank in memory where ``h5py`` is absent.
``--export-aot PATH`` writes the serve step exported for the config's
batch (``utils/aot.py``; the artifact runs on the device type it was
exported on) and returns; ``--aot PATH`` serves from such an artifact with
the restored checkpoint's weights loaded into it, after checking its
source, ``with_y``, batch, compute dtype and device type.  Neither goes
with ``--z-bank``.  ``--aot-platforms`` (JAX: lowering for several
platforms) is refused.

Example (on the card)::

    from representation_disentanglement_torch import config, serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    cfg = config.flagship()
    model = build_model(cfg)                  # CUDA; device="cpu" for CPU
    out = serve.serve_requests(model, cfg, inputs, missing=["T1"])
    out["x_hat"]["T1"]                        # [N, H, W] synthesized T1
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from representation_disentanglement_torch import losses as L
from representation_disentanglement_torch.config import (
    Config, load_config, resolve_run)
from representation_disentanglement_torch.data.dataset import DataAll
from representation_disentanglement_torch.main_missing import _restore
from representation_disentanglement_torch.models.layers import (
    resolve_device)
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training.evaluate import (
    bank_keys, read_bank)
from representation_disentanglement_torch.training.train import (
    make_vgg_ctx)
from representation_disentanglement_torch.utils.profiling import span


def _on_device(model, cfg: Config, inputs, mask, mask_img):
    """The step's inputs as tensors on the model's device: x in the
    compute dtype, the masks in f32."""
    x, m, mi = as_f32_tensors(model.device, inputs, mask, mask_img)
    if cfg.compute_dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    return x, m, mi


def as_f32_tensors(device, *arrays):
    """Numpy arrays or tensors as f32 tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device, dtype=torch.float32)
                 for a in arrays)


class SynthesizeStep(torch.nn.Module):
    """The serve step's body as a module, the program that
    ``utils/aot.export_serve_step`` exports: f32 inputs [M, B, H, W, Cb],
    mask [B, M], mask_img [B, H, W] on the model's device; x cast to the
    compute dtype, one ``synthesize``; returns (x_hat f32,) or (x_hat,
    y_fused) in f32.  The model is its submodule ``model``, so that its
    state dict's names gain the prefix ``model.``."""

    def __init__(self, model, cfg: Config, source: int,
                 with_y: bool = True):
        super().__init__()
        self.model = model
        self.source, self.with_y = int(source), bool(with_y)
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
            else torch.float32

    def forward(self, x, mask, mask_img):
        x_hat, y = self.model.synthesize(x.to(self.dtype), mask, mask_img,
                                         source=self.source,
                                         with_y=self.with_y)
        return (x_hat.float(), y.float()) if self.with_y \
            else (x_hat.float(),)


def make_serve_step(model, cfg: Config, source: int, with_y: bool = True):
    """Returns ``step(inputs, mask, mask_img) -> (x_hat, y)``.

    inputs [M, B, H, W, Cb] (absent contrasts zero-filled), mask [B, M],
    mask_img [B, H, W], as numpy arrays or tensors; x_hat [M, B, H, W, Cb]
    and y [B, H, W, out] come back as f32 tensors on the model's device
    (y is None when ``with_y`` is off: the fused decode is skipped)."""
    body = SynthesizeStep(model, cfg, source, with_y)

    def step(inputs, mask, mask_img):
        with span("rdt.serve.step"), torch.inference_mode():
            out = body(*as_f32_tensors(model.device, inputs, mask,
                                       mask_img))
            return out[0], (out[1] if with_y else None)

    return step


def make_serve_step_retrieval(model, cfg: Config, source: int,
                              miss_idx: Sequence[int], z_mode: str,
                              with_y: bool = True):
    """Returns ``step(inputs, mask, mask_img, s_bank_key, z_bank) -> (x_hat,
    y)``: the serving step with the missing contrasts' z retrieved from the
    bank (the reference's test-time imputation, src/main_missing.py:
    402-428, queried with the source's compact anatomy), the present ones
    keeping their encoder z.  s_bank_key [N, D] and z_bank [N, M, z] come
    from ``load_z_bank``.  The anatomy is encoded once and handed to
    ``synthesize``.  With ``s_compact_method: 'vgg'`` the query key runs
    through VGG16 (the model's ``vgg_pre``, ``cfg.vgg_npz``)."""
    miss = frozenset(int(i) for i in miss_idx)
    vgg_ctx = make_vgg_ctx(model, cfg)

    def step(inputs, mask, mask_img, s_bank_key, z_bank):
        with span("rdt.serve.step"), torch.inference_mode():
            x, m, mi = _on_device(model, cfg, inputs, mask, mask_img)
            s = model.encode_anatomy(x, mi)
            z_enc, _ = model.encode_modality(x, s)
            s_key = L.compact_s(s[source].float(), cfg.s_compact_method,
                                vgg_ctx)
            rows = []
            for i in range(cfg.modality_num):
                if i not in miss:
                    rows.append(z_enc[i].float())
                elif z_mode == "nearest_neighbour":
                    rows.append(L.nearest_neighbour_z_by_s(
                        s_bank_key, z_bank[:, i], s_key))
                else:
                    rows.append(L.mean_z(z_bank[:, i]).expand(
                        s_key.shape[0], -1))
            x_hat, y = model.synthesize(x, m, mi, source=source,
                                        z=torch.stack(rows, 0), s=s,
                                        with_y=with_y)
            return x_hat.float(), (y.float() if with_y else None)

    return step


def load_z_bank(bank_path: Optional[str], cfg: Config, source: int,
                bank=None, device=None, vgg_ctx=None):
    """The z bank of a ``results_all.h5`` dump, or of ``bank`` = (s_list
    [N, M, Cs, H, W], z_list [N, M, z]) numpy arrays: the compact anatomy
    keys of the source modality and every modality's z, both f32 on
    ``device``.  Returns (s_bank_key [N, D], z_bank [N, M, z]).  The whole
    s_list is read into host memory, as in the JAX package.  The VGG key
    (``s_compact_method: 'vgg'``) needs ``vgg_ctx`` (``training.train.
    make_vgg_ctx``)."""
    s_saved, z_saved = bank if bank is not None else read_bank(bank_path)
    key = bank_keys(s_saved, source, cfg.s_compact_method, device, vgg_ctx)
    return key, torch.as_tensor(np.asarray(z_saved), device=device,
                                dtype=torch.float32)


def _label_map(cfg: Config, yv: np.ndarray) -> np.ndarray:
    """[N, H, W, C] fused y -> [N, H, W]: for BraTS the label map by the
    reference's per-class rule, channel i the class i+1 thresholded at 0.5
    (src/util.py:946-953), else channel 0."""
    if cfg.dataset_name == "BraTS" and yv.shape[-1] >= 4:
        fg = yv[..., 1:4]
        return (np.argmax(fg, axis=-1) + 1).astype(np.float32) \
            * (np.max(fg, axis=-1) > 0.5)
    return yv[..., 0]


def _group_by_subject(subj_list, idx_list) -> Dict[str, List[int]]:
    """Dataset-row indices per subject, in slice order (the fold txts list
    each subject's slices contiguously; sorted by slice index within)."""
    rows: Dict[str, List[int]] = {}
    for i, s in enumerate(subj_list):
        rows.setdefault(str(s), []).append(i)
    for ii in rows.values():
        ii.sort(key=lambda i: int(idx_list[i]))
    return rows


def _save_volume(base: str, vol: np.ndarray, fmt: str) -> str:
    if fmt == "nifti":
        from representation_disentanglement_torch.utils.visualize import (
            save_volume_nifti)
        save_volume_nifti(base + ".nii", vol)
        return base + ".nii"
    np.save(base + ".npy", vol)
    return base + ".npy"


def resolve_request(contrasts: Sequence[str], missing: Sequence[str],
                    source: Optional[str]):
    """(missing indices, source index) by contrast name."""
    contrasts = list(contrasts)
    miss_idx = []
    for m in missing:
        if m not in contrasts:
            raise ValueError(f"missing contrast {m!r} not in {contrasts}")
        miss_idx.append(contrasts.index(m))
    if source is None:
        present = [c for c in contrasts if c not in missing]
        if not present:
            raise ValueError("every contrast is missing; nothing to anchor "
                             "the anatomy on")
        source = present[0]
    if source in missing:
        raise ValueError(f"source {source!r} is in missing")
    if source not in contrasts:
        raise ValueError(f"source {source!r} not in {contrasts}")
    return miss_idx, contrasts.index(source)


def serve_requests(model, cfg: Config, inputs: np.ndarray,
                   missing: Sequence[str], source: Optional[str] = None,
                   batch: Optional[int] = None) -> Dict:
    """Synthesize the ``missing`` contrasts of N slice blocks.

    inputs: [M, N, H, W, Cb] f32, every contrast present before ``missing``
    is applied.  Returns
    {"x_hat": {contrast: [N, H, W]} for the missing contrasts and the
    source, "y": [N, H, W], "steps": serve steps run, "source": name}."""
    contrasts = list(cfg.contrast_list)
    miss_idx, src_idx = resolve_request(contrasts, missing, source)
    B = batch or cfg.batch_size
    M, N = inputs.shape[:2]
    if M != len(contrasts):
        raise ValueError(f"inputs hold {M} contrasts; config has "
                         f"{len(contrasts)}")
    step = make_serve_step(model, cfg, src_idx, with_y=True)
    keep_idx = miss_idx + ([src_idx] if src_idx not in miss_idx else [])
    ref_mod = 0 if 0 not in miss_idx else src_idx
    centre = cfg.block_size
    per_mod = {mi: [] for mi in keep_idx}
    y_slices = []
    steps = 0
    for lo in range(0, N, B):
        rows = list(range(lo, min(lo + B, N)))
        n_valid = len(rows)
        rows += [rows[-1]] * (B - n_valid)
        x = inputs[:, rows].astype(np.float32, copy=True)
        m = np.ones((B, M), np.float32)
        for mi in miss_idx:
            x[mi] = 0.0
            m[:, mi] = 0.0
        mask_img = (x[ref_mod, :, :, :, 0] == 0).astype(np.float32)
        x_hat, y = step(x, m, mask_img)
        kept = x_hat[keep_idx, :n_valid, :, :, centre].cpu().numpy()
        for k, mi in enumerate(keep_idx):
            per_mod[mi].append(kept[k])
        y_slices.append(y[:n_valid].cpu().numpy())
        steps += 1
    yv = _label_map(cfg, np.concatenate(y_slices, axis=0))
    return {"x_hat": {contrasts[mi]: np.concatenate(per_mod[mi], axis=0)
                      for mi in keep_idx},
            "y": yv, "steps": steps, "source": contrasts[src_idx]}


def serve(cfg: Config, missing: Sequence[str], source: Optional[str],
          out_dir: str, fmt: str = "auto",
          subjects: Optional[Sequence[str]] = None, save_y: bool = True,
          z_bank: Optional[str] = None, z_mode: str = "nearest_neighbour",
          batch: Optional[int] = None, *, export_aot: Optional[str] = None,
          aot: Optional[str] = None, device=None, store=None,
          bank=None) -> Dict[str, list]:
    """Missing-modality synthesis over the test fold of the run ``cfg``
    names (``cfg.ckpt_path`` resolved; module docstring).  Returns
    {subject: [written paths]}.

    ``z_bank``: a results_all.h5 whose latents the missing contrasts take
    (``z_mode`` nearest_neighbour or mean), or ``bank`` = (s_list, z_list)
    in memory.  ``batch``: the serving batch (default ``cfg.batch_size``).
    ``export_aot``: write the AOT artifact of the serve step at this batch
    to that path and return {} (JAX serve.py:227-243); ``aot``: serve with
    the artifact at that path (JAX serve.py:254-271).
    ``device``: default CUDA; ``store``: the volumes in memory (a
    ``VolumeStore``) in place of the HDF5 file."""
    device = resolve_device(device)
    contrasts = list(cfg.contrast_list)
    miss_idx, src_idx = resolve_request(contrasts, missing, source)
    if fmt == "auto":
        try:
            import nibabel  # noqa: F401
            fmt = "nifti"
        except ImportError:
            fmt = "npy"
    elif fmt == "nifti":
        from representation_disentanglement_torch.utils.visualize import (
            require_nibabel)
        require_nibabel()

    B = batch or cfg.batch_size
    data = DataAll(cfg.dataset_name, cfg.data_path, norm_type=cfg.norm_type,
                   fold=cfg.fold, block_size=cfg.block_size,
                   contrast_list=contrasts, dropoff=False,
                   skull_strip=cfg.skull_strip, image_size=cfg.input_size,
                   seed=cfg.seed, store=store)
    ds = data.test_dataset
    rows = _group_by_subject(ds.subj_list, ds.idx_list)
    if subjects:
        unknown = [s for s in subjects if s not in rows]
        if unknown:
            raise ValueError(f"subjects not in test fold: {unknown}")
        rows = {s: rows[s] for s in subjects}
    if not rows:
        raise ValueError("test fold is empty")

    model = build_model(cfg, device=device)
    _restore(model, cfg, cfg.ckpt_name)
    if (export_aot or aot) and (z_bank or bank is not None):
        raise ValueError("AOT artifacts cover the plain serving step; "
                         "--z-bank retrieval is a live-bank computation")
    if export_aot:
        from representation_disentanglement_torch.utils.aot import (
            export_serve_step)
        sample = ds.get_batch(rows[next(iter(rows))][:1] * B)
        blob = export_serve_step(model, cfg, source=src_idx, sample=sample,
                                 with_y=save_y)
        with open(export_aot, "wb") as f:
            f.write(blob)
        print(f"[serve] wrote AOT artifact {export_aot} "
              f"({len(blob) / 1e6:.2f} MB, batch {B})")
        return {}
    if aot:
        step = load_checked_aot(aot, cfg, src_idx, save_y, B, device)
        from representation_disentanglement_torch.utils.aot import (
            load_weights)
        load_weights(step, model.state_dict())
        print(f"[serve] AOT step from {aot} (exported on "
              f"{step.header['device']})")
    elif z_bank or bank is not None:
        bank_key, bank_z = load_z_bank(z_bank, cfg, src_idx, bank=bank,
                                       device=device,
                                       vgg_ctx=make_vgg_ctx(model, cfg))
        print(f"[serve] z retrieval ({z_mode}) from "
              f"{z_bank or 'the given bank'}: {bank_key.shape[0]} entries")
        ret_step = make_serve_step_retrieval(model, cfg, src_idx, miss_idx,
                                             z_mode, with_y=save_y)
        step = lambda x, m, mi: ret_step(x, m, mi, bank_key, bank_z)
    else:
        step = make_serve_step(model, cfg, src_idx, with_y=save_y)
    os.makedirs(out_dir, exist_ok=True)
    b = cfg.block_size
    written: Dict[str, list] = {}
    n_slices = 0
    t0 = time.perf_counter()
    keep_idx = miss_idx + ([src_idx] if src_idx not in miss_idx else [])
    ref_mod = 0 if 0 not in miss_idx else src_idx     # the Q6 mask's source
    for subj, ii in rows.items():
        per_mod = {mi: [] for mi in keep_idx}
        y_slices = []
        for lo in range(0, len(ii), B):
            chunk = ii[lo:lo + B]
            n_valid = len(chunk)
            chunk = chunk + [chunk[-1]] * (B - n_valid)
            got = ds.get_batch(chunk)
            inputs, mask = got["inputs"], got["mask"]
            for mi in miss_idx:
                inputs[mi] = 0.0
                mask[:, mi] = 0.0
            mask_img = (inputs[ref_mod, :, :, :, 0] == 0).astype(np.float32)
            x_hat, y = step(inputs, mask, mask_img)
            kept = x_hat[keep_idx, :n_valid, :, :, b].cpu().numpy()
            for k, mi in enumerate(keep_idx):
                per_mod[mi].append(kept[k])
            if save_y:
                y_slices.append(y[:n_valid].cpu().numpy())
            n_slices += n_valid
        paths = []
        for mi in keep_idx:
            tag = "synth" if mi in miss_idx else "recon"
            paths.append(_save_volume(
                os.path.join(out_dir, f"{subj}_{contrasts[mi]}_{tag}"),
                np.concatenate(per_mod[mi], axis=0), fmt))
        if save_y:
            paths.append(_save_volume(
                os.path.join(out_dir, f"{subj}_y"),
                _label_map(cfg, np.concatenate(y_slices, axis=0)), fmt))
        written[subj] = paths
        print(f"[serve] {subj}: {len(ii)} slices -> {len(paths)} volumes")
    dt = time.perf_counter() - t0
    print(f"[serve] {len(rows)} subjects, {n_slices} slices in {dt:.1f}s "
          f"({n_slices / dt:.1f} slices/s incl. IO)")
    return written


def load_checked_aot(path: str, cfg: Config, source: int, with_y: bool,
                     batch: int, device):
    """The artifact at ``path`` as a serve step, refused (as JAX
    serve.py:256-271) unless it was exported for this source, ``with_y``,
    batch and compute dtype, and on the device type of ``device``.  The
    step carries its ``header``."""
    from representation_disentanglement_torch.utils.aot import (
        load_serve_step, read_header)
    with open(path, "rb") as f:
        blob = f.read()
    hdr = read_header(blob)
    if hdr["source"] != source or hdr["with_y"] != with_y:
        raise ValueError(
            f"AOT artifact was exported for source={hdr['source']}, "
            f"with_y={hdr['with_y']}; requested source={source}, "
            f"with_y={with_y}")
    if hdr["inputs_shape"][1] != batch:
        raise ValueError(f"AOT artifact batch {hdr['inputs_shape'][1]} != "
                         f"serving batch {batch}")
    if hdr["compute_dtype"] != cfg.compute_dtype:
        raise ValueError(
            f"AOT artifact was exported with compute_dtype="
            f"{hdr['compute_dtype']!r} baked into its cast; config "
            f"requests {cfg.compute_dtype!r} — re-export or match the "
            f"config")
    if hdr["device_type"] != torch.device(device).type:
        raise ValueError(
            f"AOT artifact was exported on {hdr['device']} "
            f"({hdr['device_type']}); serving on {torch.device(device)}: "
            "an artifact runs on the device type it was traced for")
    step, _ = load_serve_step(blob)
    step.header = hdr
    return step


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="config.yaml")
    ap.add_argument("--missing", required=True,
                    help="comma-separated contrasts to zero-fill and "
                         "synthesize (e.g. T1,T2_FLAIR)")
    ap.add_argument("--source", default=None,
                    help="present contrast whose anatomy drives the "
                         "synthesis (default: first non-missing)")
    ap.add_argument("--out-dir", default="serve_out")
    ap.add_argument("--ckpt-root", default="../ckpt")
    ap.add_argument("--format", default="auto",
                    choices=("auto", "npy", "nifti"))
    ap.add_argument("--subjects", default=None,
                    help="comma-separated subset of test-fold subjects")
    ap.add_argument("--no-y", action="store_true",
                    help="skip the fused y output volume")
    ap.add_argument("--z-bank", default=None,
                    help="results_all.h5 latent bank (from a `--set train` "
                         "test phase); the missing modalities' z is then "
                         "retrieved by compact-anatomy similarity instead "
                         "of encoded from the zero-filled input")
    ap.add_argument("--z-mode", default="nearest_neighbour",
                    choices=("nearest_neighbour", "mean"))
    ap.add_argument("--export-aot", default=None, metavar="PATH",
                    help="write the serve step as an AOT artifact "
                         "(torch.export; utils/aot.py) for this config's "
                         "batch, then exit")
    ap.add_argument("--aot-platforms", default=None, metavar="P1,P2",
                    help="refused: JAX lowers for several platforms; an "
                         "artifact of the port runs on the device type it "
                         "was exported on")
    ap.add_argument("--aot", default=None, metavar="PATH",
                    help="serve with an artifact of --export-aot and the "
                         "restored checkpoint's weights")
    ap.add_argument("--batch", type=int, default=None,
                    help="serving batch size (default: the config's "
                         "batch_size)")
    args = ap.parse_args(argv)
    if args.aot_platforms:
        raise ValueError(
            "--aot-platforms: lowering for several platforms has no meaning "
            "for the port; its artifact runs on the device type it was "
            "exported on (one card)")
    cfg = load_config(args.config)
    cfg.phase = "test"            # resolve_run: reuse ckpt_timelabel's dir
    cfg = resolve_run(cfg, ckpt_root=args.ckpt_root).derive().validate()
    return serve(cfg, [m for m in args.missing.split(",") if m],
                 args.source, args.out_dir, fmt=args.format,
                 subjects=args.subjects.split(",") if args.subjects
                 else None, save_y=not args.no_y, z_bank=args.z_bank,
                 z_mode=args.z_mode, batch=args.batch,
                 export_aot=args.export_aot, aot=args.aot, device=device)


if __name__ == "__main__":
    main()
