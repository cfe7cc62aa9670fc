"""JAX parameter trees -> the port's ``state_dict``.

``from_jax_params`` is the inverse of the JAX package's
``utils/transplant.py::transplant_multimodal`` with
``notshared_impl='loop'``: it takes the ``params`` and ``batch_stats`` trees
of the JAX ``MultimodalModel`` (nested dicts of numpy arrays) and returns a
``state_dict`` with the reference torch names, which the port's model loads
with ``strict=True``.

Layout conversions (each the inverse of the transplant's):
- HWIO conv kernel [kh, kw, I, O]           -> [O, I, kh, kw]
- CondConv expert bank [E, kh, kw, I, O]    -> [E, O, I, kh, kw]
- Linear kernel [in, out]                   -> weight [out, in]
- ``modality_encoder.fcs``: the JAX model flattens HWC-major, torch
  CHW-major; the input rows are put back in CHW order
- BatchNorm scale/bias -> weight/bias; mean/var -> running_mean/running_var
- ``input_decoder_notshared_{m}`` -> ``input_decoder_list.{m}``;
  ``input_decoder_shared`` -> ``input_decoder_list.{M}``
- ``discrim_s`` (when present): ``conv_{i}`` -> ``discrim_s.discrim.
  {0,2,5,8,11}``, ``bn_{i}`` -> ``discrim_s.discrim.{3,6,9,12}``, ``fc_0``
  (HWC-major rows, put back in CHW order) and ``fc_1`` -> ``discrim_s.
  fc.{1,3}``; ``distri_z``: ``linear_{0,1}`` -> ``distri_z.linear.{0,2}``

``from_jax_grads`` carries a JAX gradient tree (the structure of
``params``) the same way, onto the port's parameter names, so gradients
compare leaf by leaf with ``p.grad`` of ``model.named_parameters()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from representation_disentanglement_torch.models.discriminator import (
    Discriminator)


def chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """Index permutation p with flat_hwc[i] == flat_chw[p[i]]."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


class _Reader:
    """Walks the JAX trees, emitting torch-named arrays and recording every
    leaf it reads, so that a leaf left over is an error."""

    def __init__(self, params: Dict, stats: Dict):
        self.params, self.stats = params, stats
        self.sd: Dict[str, np.ndarray] = {}
        self.used = set()

    def _get(self, tree_name: str, path: Tuple[str, ...]) -> np.ndarray:
        node = self.params if tree_name == "params" else self.stats
        for p in path:
            node = node[p]
        self.used.add((tree_name,) + path)
        return np.asarray(node, np.float32)

    def _has(self, path: Tuple[str, ...]) -> bool:
        node = self.params
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return False
            node = node[p]
        return True

    def conv(self, jpath, tname):
        if self._has(jpath + ("experts",)):
            self.sd[f"{tname}.weight"] = np.transpose(
                self._get("params", jpath + ("experts",)), (0, 4, 3, 1, 2))
            self.sd[f"{tname}._routing_fn.fc.weight"] = np.transpose(
                self._get("params", jpath + ("route_kernel",)))
            self.sd[f"{tname}._routing_fn.fc.bias"] = self._get(
                "params", jpath + ("route_bias",))
        else:
            self.sd[f"{tname}.weight"] = np.transpose(
                self._get("params", jpath + ("kernel",)), (3, 2, 0, 1))
        if self._has(jpath + ("bias",)):
            self.sd[f"{tname}.bias"] = self._get("params", jpath + ("bias",))

    def bn(self, jpath, tname):
        self.sd[f"{tname}.weight"] = self._get("params", jpath + ("scale",))
        self.sd[f"{tname}.bias"] = self._get("params", jpath + ("bias",))
        if self.stats is None:
            return
        self.sd[f"{tname}.running_mean"] = self._get("stats", jpath + ("mean",))
        self.sd[f"{tname}.running_var"] = self._get("stats", jpath + ("var",))

    def linear(self, jpath, tname, in_perm=None):
        w = self._get("params", jpath + ("kernel",))        # [in, out]
        if in_perm is not None:
            unperm = np.empty_like(w)
            unperm[in_perm] = w
            w = unperm
        self.sd[f"{tname}.weight"] = np.transpose(w)
        self.sd[f"{tname}.bias"] = self._get("params", jpath + ("bias",))

    def spade_block(self, jpath, tname):
        for sub in ("si_layers", "gamma", "beta", "out"):
            self.conv(jpath + (sub,), f"{tname}.{sub}")

    def unused_leaves(self):
        out = []

        def walk(tree_name, node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(tree_name, v, path + (k,))
            elif (tree_name,) + path not in self.used:
                out.append("/".join((tree_name,) + path))

        walk("params", self.params, ())
        if self.stats is not None:
            walk("stats", self.stats, ())
        return out


def from_jax_params(params: Dict, batch_stats: Optional[Dict], *,
                    modality_num: int, input_size,
                    target_model_name: str = "U+SA",
                    mod_enc_first_ch: int = 16) -> Dict[str, torch.Tensor]:
    """Convert the JAX ``MultimodalModel`` trees (``notshared_impl='loop'``,
    split SPADE decoder) into the port's ``state_dict``.  With
    ``batch_stats=None`` only the parameters are converted."""
    if target_model_name != "U+SA":
        raise NotImplementedError(
            f"output decoder {target_model_name!r} is not ported yet")
    r = _Reader(params, batch_stats)
    M = modality_num

    enc, jenc = "anatomy_encoder_enc_list.0", ("anatomy_encoder_enc",)
    r.conv(jenc + ("down_1",), f"{enc}.down_1")
    for i in (2, 3, 4, 5):
        r.conv(jenc + (f"down_{i}", "conv"), f"{enc}.down_{i}.conv")
        r.bn(jenc + (f"down_{i}", "bn"), f"{enc}.down_{i}.bn")
    dec, jdec = "anatomy_encoder_dec", ("anatomy_encoder_dec",)
    for i in (4, 3, 2, 1):
        r.conv(jdec + (f"up_{i}", "conv"), f"{dec}.up_{i}.conv")
        r.bn(jdec + (f"up_{i}", "bn"), f"{dec}.up_{i}.bn")
    r.conv(jdec + ("output", "conv"), f"{dec}.output.conv")

    me, jme = "modality_encoder_list.0", ("modality_encoder",)
    for i in range(1, 6):
        r.conv(jme + (f"conv{i}",), f"{me}.conv{i}")
    h32, w32 = input_size[0] // 32, input_size[1] // 32
    r.linear(jme + ("fcs",), f"{me}.fcs.0",
             in_perm=chw_to_hwc_perm(8 * mod_enc_first_ch, h32, w32))
    r.linear(jme + ("mean",), f"{me}.mean")
    r.linear(jme + ("log_var",), f"{me}.log_var")

    shared, jsh = f"input_decoder_list.{M}", ("input_decoder_shared",)
    r.linear(jsh + ("ZScaler_0", "zi_scaler"), f"{shared}.zi_scaler")
    for i in (1, 2, 3):
        r.spade_block(jsh + (f"sp{i}",), f"{shared}.sp{i}")
    for m in range(M):
        jns, ns = (f"input_decoder_notshared_{m}",), f"input_decoder_list.{m}"
        for i in (4, 5, 6):
            r.spade_block(jns + (f"sp{i}",), f"{ns}.sp{i}")
        r.conv(jns + ("out",), f"{ns}.out")

    od, jod = "output_decoder", ("output_decoder",)
    r.conv(jod + ("down_1",), f"{od}.down_1.0")
    for i in (2, 3, 4, 5):
        r.conv(jod + (f"down_{i}", "conv"), f"{od}.down_{i}.conv.0")
        r.bn(jod + (f"down_{i}", "bn"), f"{od}.down_{i}.conv.1")
    for i in (4, 3, 2, 1):
        r.conv(jod + (f"up_{i}", "conv"), f"{od}.up_{i}.up.1")
        r.bn(jod + (f"up_{i}", "bn"), f"{od}.up_{i}.bn")
        ja, ta = jod + (f"att_{i}",), f"{od}.att_{i}"
        for sub in ("W_x", "W_g", "W_psi"):
            r.conv(ja + (sub,), f"{ta}.{sub}")
        r.conv(ja + ("W_out_conv",), f"{ta}.W_out.0")
        r.bn(ja + ("W_out_bn",), f"{ta}.W_out.1")
    r.conv(jod + ("output", "conv"), f"{od}.output.up.1")

    if r._has(("discrim_s",)):
        bn_idx = (None, 3, 6, 9, 12)
        for i, (ci, bi) in enumerate(zip(Discriminator.CONV_IDX, bn_idx)):
            r.conv(("discrim_s", f"conv_{i}"), f"discrim_s.discrim.{ci}")
            if bi is not None:
                r.bn(("discrim_s", f"bn_{i}"), f"discrim_s.discrim.{bi}")
        r.linear(("discrim_s", "fc_0"), "discrim_s.fc.1",
                 in_perm=chw_to_hwc_perm(64, h32, w32))
        r.linear(("discrim_s", "fc_1"), "discrim_s.fc.3")
    if r._has(("distri_z",)):
        r.linear(("distri_z", "linear_0"), "distri_z.linear.0")
        r.linear(("distri_z", "linear_1"), "distri_z.linear.2")

    left = r.unused_leaves()
    if left:
        raise ValueError(f"JAX leaves with no place in the port: {left}")
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in r.sd.items()}


def from_jax_grads(grads: Dict, **kw) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree (the structure of ``params``) -> {port parameter
    name: gradient}, with the layout conversions of ``from_jax_params``."""
    return from_jax_params(grads, None, **kw)
