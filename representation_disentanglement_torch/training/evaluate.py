"""The validation step and loop, the result dump and the z retrieval, with
the JAX package's semantics (JAX training/evaluate.py; reference
src/main_missing.py:337-609).

``make_eval_step`` runs the model in eval mode with z = the encoder mean,
the same loss terms as training, and the per-slice metrics on the device:
SSIM/PSNR/MSE of the mix reconstructions while no y-loss is on, else
Dice/IoU (BraTS) or SSIM/PSNR/MSE of the fused y.  The losses come back as
one [11] f32 vector and the metrics as one [n_metrics, n_slices] matrix, so
a batch costs two small host fetches.  Under ``compute_dtype: bfloat16``
the model sees bf16 inputs while the metrics score the uncast f32 inputs.

``evaluate`` runs the loop over a loader: an iterable of dicts with
``inputs`` [M, B, H, W, Cb], ``targets`` [B, H, W, Ct], ``mask`` [B, M],
``mask_img`` [B, H, W] (numpy arrays or tensors), optionally ``valid`` [B]
(False on padding rows, whose metrics and dump rows are dropped), and for
the dump ``subj_id`` and ``slice_idx``.  With ``phase="test"`` and
``save_res`` it writes ``<ckpt_path>/result_<set>/results_all<info>.h5``
in the JAX package's layout (NCHW, f32):
  inputs [B, M*Cb, H, W], targets [B, Ct, H, W], mask [B, M], subj_id (S),
  slice_idx [B], y_fake_fused [B, Co, H, W], y_fake_list [B, M, Co, H, W],
  xi_fake_list [B, M, Cb, H, W], xi_fake_mix [B, M(M-1), Cb, H, W],
  s_list [B, M, Cs, H, W], z_list [B, M, z], and z_list_find_all [B, M, z]
  under retrieval.
The layout permutes run on the device and each key crosses to the host
once per batch, in f32 into pinned memory, so that the host only writes.
``info`` ``nearest_neighbour`` / ``mean`` (or ``<mode>_src=<c>``)
re-decodes the grid with the z retrieved from the set's earlier
``results_all.h5``.

With a data ``mesh`` (``parallel.mesh.Axis``; JAX evaluate.py:192-254)
each rank evaluates its rows of a batch inside ``data_parallel(mesh)``: the
losses are the global batch's and the per-slice metrics are gathered, so
every rank returns the unsharded stat dict.  A loader whose batches are
already the rank's rows says so with ``rank_local = True``
(``data.device_store.ShardedEvalBatchLoader``); a global batch is cut to
the rank's rows when its size divides by N, and else evaluated whole on
every rank.  The dump and the retrieval run without a mesh (the test
phase).

Two seams serve a machine without ``h5py``: ``writer`` (a factory
``writer(path)`` of an object with ``append(key, array)`` and ``close()``,
default the HDF5 ``_H5Stream``) and ``bank`` (``(s_list, z_list)`` numpy
arrays in place of the bank file).  Without ``h5py`` and without the seam,
the dump and the retrieval raise ``ImportError``.

Example (on the card)::

    eval_steps = make_eval_step(model, cfg)
    stat = evaluate(model, cfg, batches, eval_steps=eval_steps)
    monitor = stat["recon_x_mix"]
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from representation_disentanglement_torch import losses as L
from representation_disentanglement_torch.metrics import (
    recon_metrics_device, seg_metrics_device)
from representation_disentanglement_torch.parallel.mesh import (
    data_parallel, gather_rows, shard_batch)
from representation_disentanglement_torch.training.train import (
    LOSS_KEYS, assemble_losses, draw_pairs, make_vgg_ctx, prepare_batch)


def parse_retrieval_info(info: str):
    """The eval ``info`` tag -> (retrieval_mode, query_source).

    ``nearest_neighbour`` / ``mean``: the reference's rule (query modality
    |1-i|, src/main_missing.py:416-425).  ``nearest_neighbour_src=<c>`` /
    ``mean_src=<c>``: every missing modality is queried with modality c's
    anatomy.  Anything else: (None, None)."""
    for mode in ("nearest_neighbour", "mean"):
        if info == mode:
            return mode, None
        if info.startswith(mode + "_src="):
            return mode, int(info[len(mode) + 5:])
    return None, None


def _mix_pairs(m: int):
    """Off-diagonal (i, j) index lists in reference order (i-major,
    j != i; JAX evaluate.py:144-147)."""
    pairs = [(i, j) for i in range(m) for j in range(m) if i != j]
    return [i for i, _ in pairs], [j for _, j in pairs]


def mix_metric_mat(inputs, grid):
    """Per-slice (ssim, psnr, mse) of the mix reconstructions, channel 0,
    in the reference's i-major, j != i order (src/main_missing.py:519-527).
    inputs [M, B, H, W, Cb] ground truth; grid [M_i, M_j, B, H, W, Cb]
    -> [3, M(M-1)*B]."""
    ii, jj = _mix_pairs(grid.shape[0])
    gts = torch.cat([inputs[j, ..., 0] for j in jj], 0)
    preds = torch.cat([grid[i, j, ..., 0] for i, j in zip(ii, jj)], 0)
    return torch.stack(recon_metrics_device(gts, preds))


def make_eval_step(model, cfg, mesh=None):
    """Returns ``(eval_step, decode_with_z, metric_names)``.

    ``eval_step(batch, sim_pair, adv_pair=None, compute_y=True)`` -> (out,
    loss_vec [11] f32, metric_mat [n_metrics, n_slices] f32), both on the
    model's device; ``out`` is the forward's dict.  With the s
    discriminator the forward scores ``adv_pair`` and the adversarial terms
    join the losses (JAX evaluate.py:105-113).  ``decode_with_z(s, z)``
    re-decodes the grid from anatomy codes [M, B, H, W, Cs] and z
    [M, B, z].  With a data ``mesh`` a batch holds the rank's rows, the
    losses are the global batch's and the metric matrix covers the global
    batch's slices (the ranks' columns gathered in batch order)."""
    needs_y = cfg.lambda_recon_y > 0 or cfg.lambda_recon_y_fused > 0
    device = model.device
    vgg_ctx = make_vgg_ctx(model, cfg)
    if not needs_y:
        metric_names = ("ssim", "psnr", "rmse")          # on the mix recon
    elif cfg.dataset_name == "BraTS":
        metric_names = ("dice", "iou")                   # on the fused y
    else:
        metric_names = ("ssim", "psnr", "rmse")          # on the fused y

    def device_metrics(inputs, targets, out):
        if not needs_y:
            return mix_metric_mat(inputs, out["x_fake_grid"])
        yf = out["y_fake_fused"]
        tgt = targets[..., 0]
        if cfg.dataset_name == "BraTS":
            # channel i+1 of the logits is class i+1 (JAX evaluate.py:96-98)
            return torch.stack(seg_metrics_device(tgt, yf[..., 1:]))
        return torch.stack(recon_metrics_device(tgt, yf[..., 0]))

    def eval_step(batch, sim_pair, adv_pair=None, compute_y: bool = True):
        model.eval()
        with torch.no_grad(), data_parallel(mesh):
            inputs = torch.as_tensor(batch["inputs"], device=device,
                                     dtype=torch.float32)
            cb = prepare_batch(dict(batch, inputs=inputs), device, cfg)
            adv = adv_pair if cfg.is_discrim_s else None
            out = model(cb["inputs"], cb["mask"], cb["mask_img"], None,
                        compute_y=compute_y or needs_y,
                        latent_cycle=cfg.lambda_latent_z > 0, adv_pair=adv)
            l = assemble_losses(cfg, cb, out, sim_pair, adv, vgg_ctx)
            loss_vec = torch.stack([l[k].float() for k in LOSS_KEYS])
            targets = torch.as_tensor(batch["targets"], device=device,
                                      dtype=torch.float32)
            mat = device_metrics(inputs, targets, out)
            if mesh is not None:     # [K, reps * b] -> [K, reps * B]
                b = targets.shape[0]
                mat = gather_rows(mat.reshape(mat.shape[0], -1, b), 2)
                mat = mat.reshape(mat.shape[0], -1)
            return out, loss_vec, mat

    def decode_with_z(s, z_find):
        """Re-decode with retrieved z (src/main_missing.py:427-428)."""
        model.eval()
        with torch.no_grad():
            return model.decode_inputs_grid(s, z_find)

    return eval_step, decode_with_z, metric_names


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py required for result dumps / retrieval "
                          "(or pass a writer / bank)") from e
    return h5py


class _H5Stream:
    """Incremental ``results_all<info>.h5`` writer (JAX evaluate.py:150-186):
    each batch is appended to resizable datasets, so host memory stays at
    one batch whatever the fold's size, while the file's layout (names,
    dtypes, row order) is the reference's concatenation.  ``subj_id`` is
    written at ``close`` as one ``S`` dataset of the global max width."""

    def __init__(self, path: str):
        self.f = _h5py().File(path, "w")
        self._str_rows: list = []

    def append(self, key: str, arr) -> None:
        arr = np.asarray(arr)
        if key == "subj_id":
            self._str_rows.append(arr)
            return
        if key not in self.f:
            self.f.create_dataset(
                key, data=arr, maxshape=(None,) + arr.shape[1:],
                chunks=(max(1, arr.shape[0]),) + arr.shape[1:])
        else:
            d = self.f[key]
            n = d.shape[0]
            d.resize(n + arr.shape[0], axis=0)
            d[n:] = arr

    def close(self) -> None:
        if self._str_rows:
            self.f.create_dataset(
                "subj_id", data=np.concatenate(self._str_rows, 0))
        self.f.close()


def read_bank(path: str):
    """(s_list [N, M, Cs, H, W], z_list [N, M, z]) of a results_all.h5."""
    with _h5py().File(path, "r") as f:
        return np.asarray(f["s_list"]), np.asarray(f["z_list"])


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., C, H, W]."""
    return t.movedim(-1, -3)


def _host(t, sel=None) -> np.ndarray:
    """One copy to the host, in f32 for floating tensors; ``sel`` (a
    boolean row mask) is applied on the tensor's device first.  A CUDA
    tensor lands in pinned host memory: from pageable memory the copy ran
    about 20 times slower on the H100's host (PERF.md §5)."""
    if isinstance(t, torch.Tensor):
        if sel is not None:
            t = t[torch.as_tensor(sel, device=t.device)]
        if t.is_floating_point():
            t = t.to(torch.float32)
        if t.is_cuda:
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t).numpy()
        return t.contiguous().numpy()
    a = np.asarray(t)
    return a if sel is None else a[sel]


def _dump_batch(dump, batch, inputs, out, z_find, sel, stale_y) -> None:
    """Append one batch in the JAX package's layout and row order (JAX
    evaluate.py:306-340).  inputs: the uncast [M, B, H, W, Cb] on the
    model's device; ``stale_y``: the host (y_fake_fused, y_fake_list) to
    append, or None."""
    M, B = inputs.shape[:2]
    grid = _nchw(out["x_fake_grid"]).permute(2, 0, 1, 3, 4, 5)  # [B,Mi,Mj,.]
    ar = list(range(M))
    ii, jj = _mix_pairs(M)
    dump.append("inputs", _host(_nchw(inputs).transpose(0, 1).reshape(
        B, -1, *inputs.shape[2:4]), sel))
    dump.append("targets", _host(_nchw(torch.as_tensor(
        batch["targets"], device=inputs.device)), sel))
    dump.append("mask", _host(batch["mask"], sel))
    subj = np.array(batch["subj_id"], dtype="S")
    dump.append("subj_id", subj if sel is None else subj[sel])
    dump.append("slice_idx", _host(batch["slice_idx"], sel))
    if stale_y is not None:
        rows = slice(None) if sel is None else sel
        dump.append("y_fake_fused", stale_y[0][rows])
        dump.append("y_fake_list", stale_y[1][rows])
    dump.append("xi_fake_list", _host(grid[:, ar, ar], sel))
    dump.append("xi_fake_mix", _host(grid[:, ii, jj], sel))
    dump.append("s_list", _host(_nchw(out["s"]).transpose(0, 1), sel))
    dump.append("z_list", _host(out["z"].transpose(0, 1), sel))
    if z_find is not None:
        dump.append("z_list_find_all", _host(z_find.transpose(0, 1), sel))


BANK_KEY_ROWS = 1024      # bank rows per compact_s call on the device
VGG_KEY_ROWS = 64         # the same through VGG16 at 224x224


def bank_keys(s_saved, modality: int, method: str, device,
              vgg_ctx=None) -> torch.Tensor:
    """Compact anatomy keys [N, D] (f32, on ``device``) of one modality of
    a bank's s_list [N, M, Cs, H, W], ``BANK_KEY_ROWS`` (``VGG_KEY_ROWS``
    for the VGG key, ``vgg_ctx``) at a time on the device."""
    s = np.asarray(s_saved)[:, modality]
    n = VGG_KEY_ROWS if method == "vgg" else BANK_KEY_ROWS
    with torch.no_grad():
        return torch.cat([L.compact_s(torch.as_tensor(
            s[lo:lo + n], device=device, dtype=torch.float32).movedim(-3, -1),
            method, vgg_ctx) for lo in range(0, len(s), n)])


class _Retrieval:
    """The z retrieval of one eval run (JAX evaluate.py:218-288): the bank's
    compact anatomy keys per modality and its z, on the model's device."""

    def __init__(self, cfg, mode: str, src: Optional[int], bank, device,
                 vgg_ctx=None):
        M = cfg.modality_num
        if src is None and M > 2:
            print(f"[retrieval] WARNING: the reference's retrieval query "
                  f"rule src=|1-i| assumes 2 contrasts; with M={M} every "
                  f"missing modality i>1 is queried with modality 1's "
                  f"anatomy key. Pass --info {mode}_src=<c> for the "
                  f"generalized single-source rule.")
        s_saved, z_saved = bank
        self.keys = [bank_keys(s_saved, i, cfg.s_compact_method, device,
                               vgg_ctx) for i in range(M)]
        self.z = torch.as_tensor(np.asarray(z_saved), device=device,
                                 dtype=torch.float32)
        self.mode, self.src, self.cfg = mode, src, cfg
        self.vgg_ctx = vgg_ctx

    def __call__(self, s):
        """s: [M, B, H, W, Cs] -> z_find [M, B, z]: modality i assumed
        missing, queried with the anatomy of |1-i| (or of ``src``)."""
        cols = []
        for i in range(s.shape[0]):
            src = self.src if self.src is not None else abs(1 - i)
            q = L.compact_s(s[src], self.cfg.s_compact_method, self.vgg_ctx)
            if self.mode == "nearest_neighbour":
                cols.append(L.nearest_neighbour_z_by_s(self.keys[src],
                                                       self.z[:, i], q))
            else:
                cols.append(L.mean_z(self.z[:, i]).expand(q.shape[0], -1))
        return torch.stack(cols, 0)


def evaluate(model, cfg, loader, *, phase: str = "val",
             set_name: str = "val", save_res: bool = False, info: str = "",
             sim_rng: Optional[np.random.Generator] = None,
             eval_steps=None, writer=None, bank=None,
             mesh=None) -> Dict[str, float]:
    """The evaluation loop: per batch one eval step (the y decodes at the
    first batch only, unless a y-loss is on), a sim pair and an adversarial
    pair drawn from ``sim_rng`` (default ``default_rng(10)``), loss sums and
    the per-slice metrics of the ``valid`` rows; it stops after batch
    ``eval_max_iters`` (src/main_missing.py:561).  Returns the mean of each
    loss term over the batches and the mean of each metric over the slices.

    ``phase="test"`` with ``save_res`` dumps every batch (module docstring)
    through ``writer`` (default ``_H5Stream``); a retrieval ``info`` reads
    ``bank`` (default the set's ``results_all.h5``).

    With a data ``mesh`` (module docstring) ``eval_steps`` must be built
    with it too; every rank returns the same stat dict."""
    retrieval_mode, retrieval_src = parse_retrieval_info(info)
    dumping = phase == "test" and save_res
    if mesh is not None and (dumping or retrieval_mode is not None):
        raise ValueError("the dump and the retrieval run without a mesh "
                         "(the test phase)")
    if (save_res and writer is None) or (retrieval_mode is not None
                                         and bank is None):
        _h5py()
    eval_step, decode_with_z, metric_names = \
        eval_steps or make_eval_step(model, cfg, mesh)
    whole_step = eval_step if mesh is None else None
    local = getattr(loader, "rank_local", False)
    sim_rng = sim_rng or np.random.default_rng(10)
    M = cfg.modality_num
    needs_y = cfg.lambda_recon_y > 0 or cfg.lambda_recon_y_fused > 0
    loss_sums = np.zeros(len(LOSS_KEYS), np.float64)
    metrics_acc: Dict[str, list] = {}

    res_path = os.path.join(cfg.ckpt_path or "", "result_" + set_name)
    if dumping or retrieval_mode is not None:
        os.makedirs(res_path, exist_ok=True)
    retrieve = None
    if retrieval_mode is not None:
        if bank is None:
            bank = read_bank(os.path.join(res_path, "results_all.h5"))
        retrieve = _Retrieval(cfg, retrieval_mode, retrieval_src, bank,
                              model.device, make_vgg_ctx(model, cfg))
    dump = (writer or _H5Stream)(
        os.path.join(res_path, "results_all" + info + ".h5")) \
        if dumping else None

    n_iter = 0
    stale_y = None      # the reference appends the y of batch 0 at every
                        # batch when no y-loss is on (main_missing.py:
                        # 435-443, 548-549), so y rows follow the batches
    for it, batch in enumerate(loader):
        sim_pair = draw_pairs(sim_rng, M, 1)[0]
        adv_pair = draw_pairs(sim_rng, M, 1)[0]
        step = eval_step
        if mesh is not None and not local:
            if len(batch["mask"]) % mesh.size == 0:
                batch = shard_batch(batch, mesh)
            else:               # evaluated whole on every rank
                if whole_step is None:
                    whole_step = make_eval_step(model, cfg)[0]
                step = whole_step
        if "valid" in batch and step is not whole_step:
            valid_t = torch.as_tensor(np.asarray(_host(batch["valid"]),
                                                 np.float32),
                                      device=model.device)
            batch = dict(batch, valid=gather_rows(valid_t, 0, mesh))
        out, loss_vec, metric_mat = step(batch, sim_pair, adv_pair,
                                         compute_y=(it == 0))
        z_find = inputs = None
        if retrieve is not None or dump is not None:
            inputs = torch.as_tensor(batch["inputs"], device=model.device,
                                     dtype=torch.float32)
        if retrieve is not None:
            with torch.no_grad():
                z_find = retrieve(out["s"])
            out = dict(out, x_fake_grid=decode_with_z(out["s"], z_find))
            if not needs_y:
                # the re-decoded grid replaces the mix reconstructions the
                # metrics score (src/main_missing.py:519-527)
                metric_mat = mix_metric_mat(inputs, out["x_fake_grid"])
        loss_sums += torch.as_tensor(loss_vec).cpu().numpy().astype(
            np.float64)
        mat = torch.as_tensor(metric_mat).float().cpu().numpy()
        valid = None
        if "valid" in batch:
            valid = _host(batch["valid"]).astype(bool)
            reps = mat.shape[1] // valid.shape[0]   # 1 (y) or M(M-1) (mix)
            mat = mat[:, np.tile(valid, reps)]
        for k, row in zip(metric_names, mat):
            metrics_acc.setdefault(k, []).extend(row.astype(float).tolist())
        if dump is not None:
            if out.get("y_fake_fused") is not None:
                stale_y = (_host(_nchw(out["y_fake_fused"])),
                           _host(_nchw(out["y_fake_list"]).transpose(0, 1)))
            _dump_batch(dump, batch, inputs, out, z_find, valid, stale_y)
        n_iter = it + 1
        if it > cfg.eval_max_iters - 1:
            break
    stat = {k: float(v) / max(n_iter, 1)
            for k, v in zip(LOSS_KEYS, loss_sums)}
    for k, v in metrics_acc.items():
        stat[k] = float(np.mean(v))
    if dump is not None:
        dump.close()
    return stat
