"""Config for the PyTorch port: the fields the serving path, the training
run (``main_missing``) and the validation step read.

A copy of ``Config`` from the JAX package, cut to what the ported paths
use, with the same defaults, the same ``derive()`` rules (reference
main_missing.py:26-28, 75-86) and the checks of ``validate()`` that apply
to those fields.  ``flagship()``, ``seg_stage2()``, ``zerodose()`` and
``ncanda()`` return the values of the four shipped ``configs/*.yaml`` in
code, so nothing on the card's path needs a YAML parser; ``load_config``
imports ``yaml`` only when called.

The run directory follows the JAX package (``resolve_run``,
reference main_missing.py:30-56): ``<ckpt_root>/<dataset>/<model_name>/
<time label>`` with a ``config.yaml`` snapshot that a resumed run merges
back (``merge_saved``; ``phase`` and ``continue_train`` stay live).  The
port writes that snapshot as JSON, which is valid YAML, so the JAX package
and ``yaml.safe_load`` read it unchanged and the port needs no YAML writer;
its floats always carry a decimal point (``1.0e-05``), since YAML 1.1
reads ``1e-05`` as a string.  The port reads a snapshot with ``json`` and, for one that is not JSON (a
JAX package run directory), with ``yaml.safe_load``, imported only then.

``load_config`` drops, on purpose, the JAX keys the port has no use for:
``remat`` (the port does not rematerialize, which is what the flagship
runs, ``remat: False``) and ``gpu`` (kept by the JAX package for the
reference's YAML and unused there too; the port's entry points take a
``device``).  It reads ``mesh_shape`` (``{data: N}``: ``main_missing.run``
trains on N cards, one process each, parallel/mesh.py),
``shard_data_cache`` and ``shard_eval_cache`` (the train and the val/test
device caches sharded over those cards), with the JAX defaults.  ``cond_mode`` is read: 'grouped' or
'sum_experts', set on every CondConv by ``build_model``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Keys the resume-merge never takes from the saved snapshot
# (reference main_missing.py:47-48).
_LIVE_KEYS = ("phase", "continue_train")


@dataclass
class Config:
    # ---- run control ----
    phase: str = "train"                     # 'train' | 'test'
    load_yaml: bool = True
    epochs: int = 50

    # ---- data ----
    dataset_name: str = "BraTS"              # BraTS | ZeroDose | NCANDA | Tau
    contrast_list: List[str] = field(
        default_factory=lambda: ["T1", "T1c", "T2", "T2_FLAIR"])
    norm_type: str = "z-score"               # 'z-score' | 'mean'
    block_size: int = 3                      # 7-slice blocks (2*3+1)
    data_path: str = "../data/"
    batch_size: int = 8
    num_fold: int = 5
    fold: int = 0
    shuffle: bool = True

    # ---- optimization ----
    lr: float = 2e-4
    model_name: str = "MultimodalModel"
    p: int = 1                               # recon-loss norm (1=L1, 2=L2)

    # ---- loss weights ----
    lambda_recon_y: float = 0.0
    lambda_recon_y_fused: float = 0.0
    lambda_recon_x: float = 1.0
    lambda_recon_x_mix: float = 2.0
    lambda_sim_s: float = 10.0
    lambda_sim_z: float = 2.0
    lambda_kl: float = 0.0
    lambda_latent_z: float = 0.1
    lambda_adv_s: float = 0.0

    # ---- similarity methods ----
    s_compact_method: str = "max"            # max | mean | vgg
    s_sim_method: str = "cosine"             # cosine | perceptual
    z_sim_method: str = "cosine"             # cosine | mse

    # ---- model dims ----
    s_num_ch: int = 4
    z_size: int = 16
    out_num_ch: int = 1
    input_height: int = 160
    input_width: int = 192

    # ---- architecture switches ----
    is_cond: bool = True
    is_distri_z: bool = False                # learned z prior for the KL
    shared_ana_enc: bool = True
    shared_mod_enc: bool = True
    shared_inp_dec: bool = False
    others: Dict[str, Any] = field(default_factory=lambda: {
        "mod_enc_s": False, "ana_dec_act": "softmax", "old": False,
        "softmax_remove_mask": True})
    dropoff: bool = False
    skull_strip: bool = False
    fuse_method: str = "mean"                # mean | max | mean-max-min
    target_model_name: str = "U+SA"          # U | U+SA | U+SA+CA | U+SSA+CA

    # ---- resume ----
    continue_train: bool = False
    fix_pretrain: bool = False
    ckpt_name: str = "model_best.ckpt"
    ckpt_timelabel: Optional[str] = None

    # ---- derived; filled by `derive()` and `resolve_run` ----
    is_discrim_s: bool = False
    in_num_ch: int = 28
    target_output_act: str = "no"
    input_output_act: str = "no"
    ckpt_path: str = ""

    # ---- execution ----
    compute_dtype: str = "float32"           # 'float32' | 'bfloat16'
    seed: int = 10
    fix_activation_bug: bool = False         # quirk Q1 (ops/activations.py)
    notshared_impl: str = "loop"             # 'loop' | 'vmap': the JAX
                                             # package's parameter layout
                                             # of the decoder halves
    cond_mode: str = "grouped"               # CondConv execution:
                                             # 'grouped' | 'sum_experts'
                                             # (models/layers.py)
    use_pallas: bool = True                  # fused SPADE interior kernel
    effective_batch: int = 16                # grad accumulation target
    grad_clip_norm: float = 1.0
    weight_decay: float = 1e-5               # L2 added to the gradient
    fuse_bn: bool = False                    # fused BN train pass (K6/K7)
    vgg_npz: Optional[str] = None            # VGG16 weights npz for the
                                             # perceptual / vgg-compact
                                             # paths (models.vgg.dump_
                                             # torchvision_vgg16 makes it)
    prefetch_depth: int = 2                  # host loader's queue depth
    device_data_cache: bool = True           # volumes in device memory,
                                             # blocks gathered there (host
                                             # loading when over budget)
    device_cache_budget_gb: float = 10.0     # per card
    mesh_shape: Dict[str, int] = field(      # {data: N}: data-parallel over
        default_factory=lambda: {"data": 1})  # N cards (parallel/mesh.py)
    shard_data_cache: bool = True            # under {data: N}: the train
                                             # cache sharded over the cards
                                             # (False replicates it)
    shard_eval_cache: bool = True            # the val/test caches too
    epoch_chunk_steps: int = 32              # optimizer steps between
                                             # preemption polls (0 = the
                                             # whole epoch)
    log_every: int = 10
    eval_max_iters: int = 501                # (main_missing.py:561-562)

    def derive(self) -> "Config":
        self.is_discrim_s = self.lambda_adv_s > 0
        self.in_num_ch = len(self.contrast_list) * (2 * self.block_size + 1)
        if self.dataset_name == "BraTS" or self.norm_type == "z-score":
            self.target_output_act = "no"
        else:
            self.target_output_act = "softplus"
        self.input_output_act = "softplus" if self.norm_type == "mean" else "no"
        return self

    @property
    def block_ch(self) -> int:
        return 2 * self.block_size + 1

    @property
    def modality_num(self) -> int:
        return len(self.contrast_list)

    @property
    def input_size(self):
        return (self.input_height, self.input_width)

    def validate(self) -> "Config":
        errs = []
        if self.input_height % 32 or self.input_width % 32:
            errs.append(f"input size {self.input_size} must be divisible "
                        "by 32 (5 stride-2 stages)")
        # quirk Q9: the BraTS segmentation losses index logit channels 1-3
        if (self.dataset_name == "BraTS"
                and (self.lambda_recon_y > 0 or self.lambda_recon_y_fused > 0)
                and self.out_num_ch != 4):
            errs.append("BraTS segmentation losses require out_num_ch=4 "
                        "(quirk Q9: the reference ships 1 and indexes "
                        "channels 1-3)")
        if self.fuse_method not in ("mean", "max", "mean-max-min"):
            errs.append(f"unknown fuse_method {self.fuse_method!r}")
        if self.target_model_name not in ("U", "U+SA", "U+SA+CA", "U+SSA+CA"):
            errs.append(f"unknown target_model_name {self.target_model_name!r}")
        if self.cond_mode not in ("grouped", "sum_experts"):
            errs.append(f"unknown cond_mode {self.cond_mode!r}: 'grouped' "
                        "or 'sum_experts'")
        if self.compute_dtype not in ("float32", "bfloat16"):
            errs.append(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.s_sim_method not in ("cosine", "perceptual"):
            errs.append(f"unknown s_sim_method {self.s_sim_method!r}")
        if self.s_compact_method not in ("max", "mean", "vgg"):
            errs.append(f"unknown s_compact_method {self.s_compact_method!r}")
        if self.z_sim_method not in ("cosine", "mse"):
            errs.append(f"unknown z_sim_method {self.z_sim_method!r}")
        if (self.s_sim_method == "perceptual"
                or self.s_compact_method == "vgg"):
            if not self.vgg_npz:
                errs.append(
                    "s_sim_method='perceptual' / s_compact_method='vgg' "
                    "need VGG16 weights: set vgg_npz (produce it with "
                    "models.vgg.dump_torchvision_vgg16 where torchvision "
                    "is available)")
            elif not os.path.exists(self.vgg_npz):
                errs.append(f"vgg_npz not found: {self.vgg_npz}")
        if self.batch_size > self.effective_batch:
            self.effective_batch = self.batch_size
        if self.effective_batch % self.batch_size:
            errs.append("effective_batch must be a multiple of batch_size "
                        "(ref accumulates 16//batch_size iters, "
                        "main_missing.py:282)")
        if errs:
            raise ValueError("config validation failed:\n  - " +
                             "\n  - ".join(errs))
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def snapshot_yaml(self, ckpt_path: str) -> None:
        """Write the ``config.yaml`` snapshot into the run directory
        (reference util.py:913-925), as JSON (valid YAML)."""
        os.makedirs(ckpt_path, exist_ok=True)
        with open(os.path.join(ckpt_path, "config.yaml"), "w") as f:
            f.write("{\n" + ",\n".join(
                f" {json.dumps(k)}: {_yaml_json(v)}"
                for k, v in sorted(self.to_dict().items())) + "\n}\n")

    def snapshot_txt(self, ckpt_path: str) -> None:
        """Write the ``key: value`` txt snapshot (reference
        util.py:846-851)."""
        os.makedirs(ckpt_path, exist_ok=True)
        with open(os.path.join(ckpt_path, "config.txt"), "w") as f:
            for k, v in self.to_dict().items():
                f.write(f"{k}: {v}\n")

    def merge_saved(self, saved: Dict[str, Any]) -> "Config":
        """Resume-merge: saved values win except ``_LIVE_KEYS``; keys the
        port does not know are skipped; derivations re-run afterwards."""
        known = {f.name for f in dataclasses.fields(self)}
        for k, v in saved.items():
            if k in _LIVE_KEYS:
                continue
            if k in known:
                setattr(self, k, copy.deepcopy(v))
        return self.derive()


def _yaml_json(v) -> str:
    """``v`` (a config value) as JSON that YAML 1.1 reads back equal."""
    if isinstance(v, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_yaml_json(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_json(x) for x in v) + "]"
    if isinstance(v, float):
        text = repr(v)
        if not math.isfinite(v):
            raise ValueError(f"a config value is not finite: {v}")
        mant, e, exp = text.partition("e")
        return mant + ("" if "." in mant or not e else ".0") + e + exp
    return json.dumps(v)


def _read_snapshot(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text) or {}
    except json.JSONDecodeError:
        import yaml                # a snapshot the JAX package wrote
        return yaml.safe_load(text) or {}


def _from_dict(d: Dict[str, Any]) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in known}).derive()


def load_config(path: str) -> Config:
    """Load a reference-compatible YAML file.  Keys the port does not read
    are dropped: those of the reference it never had, and the JAX
    package's ``remat`` and ``gpu`` (see the module docstring)."""
    import yaml
    with open(path) as f:
        d = yaml.safe_load(f)
    return _from_dict(d or {})


def resolve_run(cfg: Config, ckpt_root: str = "../ckpt") -> Config:
    """Compute the run directory and apply the resume-merge (reference
    main_missing.py:30-56): a new directory gets the snapshot; an existing
    one with a snapshot (and ``load_yaml``) merges it into ``cfg``."""
    if cfg.ckpt_timelabel and (cfg.phase == "test" or cfg.continue_train):
        # YAML reads an unquoted 2026_8_21_2_31 as an int
        time_label = str(cfg.ckpt_timelabel)
    else:
        lt = time.localtime(time.time())
        time_label = (f"{lt.tm_year}_{lt.tm_mon}_{lt.tm_mday}"
                      f"_{lt.tm_hour}_{lt.tm_min}")
    cfg.ckpt_path = os.path.join(
        ckpt_root, cfg.dataset_name, cfg.model_name, time_label)
    saved_yaml = os.path.join(cfg.ckpt_path, "config.yaml")
    if not os.path.exists(cfg.ckpt_path):
        os.makedirs(cfg.ckpt_path, exist_ok=True)
        cfg.snapshot_yaml(cfg.ckpt_path)
    elif cfg.load_yaml and os.path.exists(saved_yaml):
        cfg.merge_saved(_read_snapshot(saved_yaml))
    else:
        cfg.snapshot_yaml(cfg.ckpt_path)
    return cfg


# The body shared by the four shipped YAML files (configs/*.yaml); a field
# they leave out keeps the code default, as in the JAX package
# (use_pallas True, notshared_impl 'loop', fuse_bn False).
_SHIPPED = dict(
    phase="train", load_yaml=True, epochs=50, dataset_name="BraTS",
    contrast_list=["T1", "T1c", "T2", "T2_FLAIR"], norm_type="z-score",
    block_size=3, data_path="../data/", batch_size=8, num_fold=5, fold=0,
    shuffle=True, lr=2e-4, model_name="MultimodalModel", p=1,
    lambda_recon_y=0.0, lambda_recon_y_fused=0.0, lambda_recon_x=1.0,
    lambda_recon_x_mix=2.0, lambda_sim_s=10.0, lambda_sim_z=2.0,
    lambda_kl=0.0, lambda_latent_z=0.1, lambda_adv_s=0.0,
    s_compact_method="max", s_sim_method="cosine", z_sim_method="cosine",
    s_num_ch=4, z_size=16, out_num_ch=1, input_height=160, input_width=192,
    is_cond=True, is_distri_z=False, shared_ana_enc=True,
    shared_mod_enc=True, shared_inp_dec=False,
    dropoff=False, skull_strip=False, fuse_method="mean",
    target_model_name="U+SA", continue_train=False, fix_pretrain=False,
    ckpt_name="model_best.ckpt", compute_dtype="bfloat16",
    effective_batch=16, device_data_cache=True)

def _shipped(**kw) -> Config:
    d = copy.deepcopy(_SHIPPED)
    d["others"] = {"mod_enc_s": False, "ana_dec_act": "softmax",
                   "old": False, "softmax_remove_mask": True}
    d.update(kw)
    return Config(**d).derive().validate()


def flagship() -> Config:
    """``configs/brats_4mod.yaml``: BraTS, 4 contrasts, 7-slice blocks,
    160x192, batch 16 in one microbatch, bf16, fused SPADE interior, loop
    decoder halves, the shipped five losses, Adam lr 2e-4, 50 epochs over
    the device volume cache, a preemption poll every 32 steps."""
    return _shipped(batch_size=16)


def seg_stage2(ckpt_timelabel: str) -> Config:
    """``configs/brats_seg_stage2.yaml``: BraTS tumour segmentation, stage
    2.  Resumes the stage-1 run directory ``ckpt_timelabel`` (under
    ``<ckpt_root>/BraTS/MultimodalModel/``) with the stage-1 modules frozen
    (``continue_train`` + ``fix_pretrain``) and trains the 4-class output
    decoder on the y losses alone (recon_y 1, recon_y_fused 2), batch 8 in
    two microbatches.  ``load_yaml: False`` keeps these weights over the
    stage-1 snapshot."""
    return _shipped(load_yaml=False, lambda_recon_y=1.0,
                    lambda_recon_y_fused=2.0, lambda_recon_x=0.0,
                    lambda_recon_x_mix=0.0, lambda_sim_s=0.0,
                    lambda_sim_z=0.0, lambda_latent_z=0.0, out_num_ch=4,
                    continue_train=True, fix_pretrain=True,
                    ckpt_timelabel=ckpt_timelabel)


def zerodose() -> Config:
    """``configs/zerodose_pet.yaml``: FDG-PET synthesis from T1 and
    T2-FLAIR: the shipped five losses plus the PET reconstruction (recon_y
    1, recon_y_fused 2, L1), train-time dropoff, batch 8 in two
    microbatches."""
    return _shipped(dataset_name="ZeroDose", contrast_list=["T1", "T2_FLAIR"],
                    lambda_recon_y=1.0, lambda_recon_y_fused=2.0,
                    dropoff=True)


def ncanda() -> Config:
    """``configs/ncanda_t1t2.yaml``: NCANDA T1/T2 disentanglement and
    cross-contrast synthesis with the shipped five losses, batch 8 in two
    microbatches."""
    return _shipped(dataset_name="NCANDA", contrast_list=["T1", "T2"])
