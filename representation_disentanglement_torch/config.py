"""Config for the PyTorch port: the fields the serving path reads.

A copy of ``Config`` from the JAX package, cut to what the missing-modality
serving path uses, with the same defaults, the same ``derive()`` rules
(reference main_missing.py:26-28, 75-86) and the checks of ``validate()``
that apply to those fields.  ``flagship()`` returns the values of
``configs/brats_4mod.yaml`` in code, so nothing on the card's path needs a
YAML parser; ``load_config`` imports ``yaml`` only when called.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class Config:
    # ---- data ----
    dataset_name: str = "BraTS"              # BraTS | ZeroDose | NCANDA | Tau
    contrast_list: List[str] = field(
        default_factory=lambda: ["T1", "T1c", "T2", "T2_FLAIR"])
    norm_type: str = "z-score"               # 'z-score' | 'mean'
    block_size: int = 3                      # 7-slice blocks (2*3+1)
    batch_size: int = 8

    # ---- model dims ----
    s_num_ch: int = 4
    z_size: int = 16
    out_num_ch: int = 1
    input_height: int = 160
    input_width: int = 192

    # ---- architecture switches ----
    is_cond: bool = True
    shared_ana_enc: bool = True
    shared_mod_enc: bool = True
    shared_inp_dec: bool = False
    others: Dict[str, Any] = field(default_factory=lambda: {
        "mod_enc_s": False, "ana_dec_act": "softmax", "old": False,
        "softmax_remove_mask": True})
    fuse_method: str = "mean"                # mean | max | mean-max-min
    target_model_name: str = "U+SA"          # U | U+SA | U+SA+CA | U+SSA+CA

    # ---- derived; filled by `derive()` ----
    in_num_ch: int = 28
    target_output_act: str = "no"
    input_output_act: str = "no"

    # ---- execution ----
    compute_dtype: str = "float32"           # 'float32' | 'bfloat16'
    seed: int = 10
    fix_activation_bug: bool = False         # quirk Q1 (ops/activations.py)
    notshared_impl: str = "loop"             # only 'loop' is ported
    use_pallas: bool = True                  # fused SPADE interior kernel

    def derive(self) -> "Config":
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
        if self.fuse_method not in ("mean", "max", "mean-max-min"):
            errs.append(f"unknown fuse_method {self.fuse_method!r}")
        if self.target_model_name not in ("U", "U+SA", "U+SA+CA", "U+SSA+CA"):
            errs.append(f"unknown target_model_name {self.target_model_name!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            errs.append(f"unknown compute_dtype {self.compute_dtype!r}")
        if errs:
            raise ValueError("config validation failed:\n  - " +
                             "\n  - ".join(errs))
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _from_dict(d: Dict[str, Any]) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in known}).derive()


def load_config(path: str) -> Config:
    """Load a reference-compatible YAML file; keys the port does not read
    are dropped."""
    import yaml
    with open(path) as f:
        d = yaml.safe_load(f)
    return _from_dict(d or {})


def flagship() -> Config:
    """``configs/brats_4mod.yaml``: BraTS, 4 contrasts, 7-slice blocks,
    160x192, batch 16, bf16, fused SPADE interior, loop decoder halves."""
    return Config(
        dataset_name="BraTS", contrast_list=["T1", "T1c", "T2", "T2_FLAIR"],
        norm_type="z-score", block_size=3, batch_size=16, s_num_ch=4,
        z_size=16, out_num_ch=1, input_height=160, input_width=192,
        is_cond=True, shared_ana_enc=True, shared_mod_enc=True,
        shared_inp_dec=False,
        others={"mod_enc_s": False, "ana_dec_act": "softmax", "old": False,
                "softmax_remove_mask": True},
        fuse_method="mean", target_model_name="U+SA",
        compute_dtype="bfloat16", use_pallas=True,
        notshared_impl="loop").derive().validate()
