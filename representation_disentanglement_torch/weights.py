"""JAX parameter trees -> the port's ``state_dict``.

``from_jax_params`` is the inverse of the JAX package's
``utils/transplant.py::transplant_multimodal``: it takes the ``params`` and
``batch_stats`` trees of the JAX ``MultimodalModel`` (nested dicts of numpy
arrays) in any of its 2D configurations and returns a ``state_dict`` with
the reference torch names, which the port's model of the same
configuration loads with ``strict=True``.  The layout of the tree says
which configuration it is: per-modality encoders and 'vmap' decoder halves
are ``nn.vmap`` trees, each leaf stacked on a leading axis of M.

Layout conversions (each the inverse of the transplant's):
- HWIO conv kernel [kh, kw, I, O]           -> [O, I, kh, kw]
- CondConv expert bank [E, kh, kw, I, O]    -> [E, O, I, kh, kw]
- Linear kernel [in, out]                   -> weight [out, in]
- ``modality_encoder.fcs``: the JAX model flattens HWC-major, torch
  CHW-major; the input rows are put back in CHW order
- BatchNorm scale/bias -> weight/bias; mean/var -> running_mean/running_var
- ``input_decoder_notshared_{m}`` ('loop') or entry m of the stacked
  ``input_decoder_notshared`` ('vmap') -> ``input_decoder_list.{m}``;
  ``input_decoder_shared`` -> ``input_decoder_list.{M}``; the single
  ``input_decoder`` (SPADEFull) -> ``input_decoder_list.0``
- entry m of a stacked ``anatomy_encoder_enc`` / ``modality_encoder``
  (params and batch_stats) -> ``anatomy_encoder_enc_list.{m}`` /
  ``modality_encoder_list.{m}``; with ``mod_enc_s`` the first conv of the
  modality encoder takes Cb + Cs inputs, which the conversion carries as
  it is
- the output decoder: ``att_{i}`` ('U+SA'), none ('U'), or ``att_{i}_c``
  (``W_down``, ``W_up``, linear) and ``att_{i}_s`` ('U+SA+CA': ``W_x``,
  ``W_g``, ``W_psi``, ``W_out_conv`` -> ``W_out.0``, ``W_out_bn`` ->
  ``W_out.1``; 'U+SSA+CA': ``W_g``, ``W_g_diff``, ``W_psi``, ``W_out.0``,
  ``W_out.1``).  The JAX transplant names the first three
  (transplant.py:119-129, 208-220); it has no symmetry gate, so
  ``W_g_diff`` keeps the JAX module's name, after the pattern of the
  spatial gate's ``W_g``
- ``vgg_pre_kernel`` (HWIO) / ``vgg_pre_bias`` -> ``vgg_pre.weight`` (OIHW)
  / ``vgg_pre.bias``
- ``discrim_s`` (when present): ``conv_{i}`` -> ``discrim_s.discrim.
  {0,2,5,8,11}``, ``bn_{i}`` -> ``discrim_s.discrim.{3,6,9,12}``, ``fc_0``
  (HWC-major rows, put back in CHW order) and ``fc_1`` -> ``discrim_s.
  fc.{1,3}``; ``distri_z``: ``linear_{0,1}`` -> ``distri_z.linear.{0,2}``

``from_jax_legacy`` does the same for the modules beside the
``MultimodalModel`` (``models/zcond_generator.py``, ``legacy.py``,
``legacy_generators.py``, ``resnet.py``, ``danet.py``): it walks the JAX
tree and renames each module path after the port's layout, which ``kind``
selects (``LEGACY_KINDS``):
- 'zcond', 'unet', 'lowdose': the JAX path joined with dots;
- 'generator' (the Conv_BN_Act generators, ``VariationNet`` and the
  attention layers): ``down_1`` -> ``down_1.0``; ``split_down_1``'s
  ``down_1_{i}`` / ``down_1_comb`` -> ``down_1_{i}.0`` / ``down_1_comb.0``
  and ``down_1_ca`` at the top; ``down_i/conv``, ``down_i/bn`` ->
  ``down_i.conv.0``, ``down_i.conv.1`` (``down_i.conv`` without a BN);
  ``up_i/conv``, ``output/conv``, ``up_i_conv``, ``output_conv`` ->
  ``.up.1``, ``up_i_bn`` -> ``up_i.bn``; ``W_out_conv``, ``W_out_bn`` ->
  ``W_out.0``, ``W_out.1`` (``W_out`` without a BN);
- 'resnet18', 'danet': ``layer{l}_{b}`` -> ``layer{l}.{b}``,
  ``downsample_conv`` / ``_bn`` -> ``downsample.0`` / ``.1``; the head's
  ``conv5a_conv`` / ``_bn`` (and ``conv5c``, ``conv51``, ``conv52``) ->
  ``.0`` / ``.1``, ``conv6`` .. ``conv8`` -> ``conv6.1`` ..; PAM's and
  CAM's ``gamma`` as it is.

``from_jax_grads`` carries a JAX gradient tree (the structure of
``params``) the same way, onto the port's parameter names, so gradients
compare leaf by leaf with ``p.grad`` of ``model.named_parameters()``.

``from_jax_nvnet3d`` does the same for the JAX ``NVNet3D`` (the inverse of
tests/test_unet3d.py's transplant of the reference ``state_dict``): conv
kernels [kD, kH, kW, I, O] -> [O, I, kH, kW, kD] (the port's volumes are
[B, C, H, W, D], the JAX package's [B, D, H, W, C]), linear kernels
transposed, GroupNorm scale/bias -> weight/bias, and the VAE's
reconstruction layer's output features put back from JAX's (C, D/16, H/16,
W/16) order into the reference's (C, H/16, W/16, D/16).
"""

from __future__ import annotations

import re
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


def _unstack(tree: Optional[Dict], key: str, m: int) -> Optional[Dict]:
    """A shallow copy of ``tree`` with the stacked subtree ``key`` replaced
    by its M entries ``key#0`` .. ``key#{M-1}``."""
    if tree is None or key not in tree:
        return tree
    out = dict(tree)
    stacked = out.pop(key)

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    for i in range(m):
        out[f"{key}#{i}"] = take(stacked, i)
    return out


def _stacked(params: Dict, path: Tuple[str, ...], ndim: int) -> bool:
    node = params
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return False
        node = node[p]
    return np.ndim(node) > ndim


_ATT_SA = ("W_x", "W_g", "W_psi")
_ATT_SSA = ("W_g", "W_g_diff", "W_psi")
_OUTPUT_GATES = {"U": (), "U+SA": (("", _ATT_SA),),
                 "U+SA+CA": (("_c", None), ("_s", _ATT_SA)),
                 "U+SSA+CA": (("_c", None), ("_s", _ATT_SSA))}


def from_jax_params(params: Dict, batch_stats: Optional[Dict], *,
                    modality_num: int, input_size,
                    target_model_name: str = "U+SA",
                    mod_enc_first_ch: int = 16) -> Dict[str, torch.Tensor]:
    """Convert the JAX ``MultimodalModel`` trees into the port's
    ``state_dict``.  With ``batch_stats=None`` only the parameters are
    converted.  Raises ValueError for an unknown ``target_model_name`` and
    for a leaf with no place in the port."""
    if target_model_name not in _OUTPUT_GATES:
        raise ValueError(f"unknown target_model_name {target_model_name!r}")
    M = modality_num
    # nn.vmap trees: every leaf carries a leading axis of M
    stacked = [k for k, path, nd in (
        ("anatomy_encoder_enc", ("down_2", "bn", "scale"), 1),
        ("modality_encoder", ("mean", "bias"), 1),
        ("input_decoder_notshared", ("out", "bias"), 1))
        if _stacked(params, (k,) + path, nd)]
    for k in stacked:
        params = _unstack(params, k, M)
        batch_stats = _unstack(batch_stats, k, M)
    r = _Reader(params, batch_stats)

    enc_roots = ([("anatomy_encoder_enc_list.0", ("anatomy_encoder_enc",))]
                 if "anatomy_encoder_enc" not in stacked else
                 [(f"anatomy_encoder_enc_list.{m}",
                   (f"anatomy_encoder_enc#{m}",)) for m in range(M)])
    for enc, jenc in enc_roots:
        r.conv(jenc + ("down_1",), f"{enc}.down_1")
        for i in (2, 3, 4, 5):
            r.conv(jenc + (f"down_{i}", "conv"), f"{enc}.down_{i}.conv")
            r.bn(jenc + (f"down_{i}", "bn"), f"{enc}.down_{i}.bn")
    dec, jdec = "anatomy_encoder_dec", ("anatomy_encoder_dec",)
    for i in (4, 3, 2, 1):
        r.conv(jdec + (f"up_{i}", "conv"), f"{dec}.up_{i}.conv")
        r.bn(jdec + (f"up_{i}", "bn"), f"{dec}.up_{i}.bn")
    r.conv(jdec + ("output", "conv"), f"{dec}.output.conv")

    h32, w32 = input_size[0] // 32, input_size[1] // 32
    mod_roots = ([("modality_encoder_list.0", ("modality_encoder",))]
                 if "modality_encoder" not in stacked else
                 [(f"modality_encoder_list.{m}", (f"modality_encoder#{m}",))
                  for m in range(M)])
    for me, jme in mod_roots:
        for i in range(1, 6):
            r.conv(jme + (f"conv{i}",), f"{me}.conv{i}")
        r.linear(jme + ("fcs",), f"{me}.fcs.0",
                 in_perm=chw_to_hwc_perm(8 * mod_enc_first_ch, h32, w32))
        r.linear(jme + ("mean",), f"{me}.mean")
        r.linear(jme + ("log_var",), f"{me}.log_var")

    if r._has(("input_decoder",)):                   # SPADEFull
        full, jfull = "input_decoder_list.0", ("input_decoder",)
        r.linear(jfull + ("ZScaler_0", "zi_scaler"), f"{full}.zi_scaler")
        for i in range(1, 7):
            r.spade_block(jfull + (f"sp{i}",), f"{full}.sp{i}")
        r.conv(jfull + ("out",), f"{full}.out")
    else:
        shared, jsh = f"input_decoder_list.{M}", ("input_decoder_shared",)
        r.linear(jsh + ("ZScaler_0", "zi_scaler"), f"{shared}.zi_scaler")
        for i in (1, 2, 3):
            r.spade_block(jsh + (f"sp{i}",), f"{shared}.sp{i}")
        sep = "#" if "input_decoder_notshared" in stacked else "_"
        for m in range(M):
            jns = (f"input_decoder_notshared{sep}{m}",)
            ns = f"input_decoder_list.{m}"
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
        for suffix, convs in _OUTPUT_GATES[target_model_name]:
            ja, ta = jod + (f"att_{i}{suffix}",), f"{od}.att_{i}{suffix}"
            if convs is None:                        # channel attention
                r.linear(ja + ("W_down",), f"{ta}.W_down")
                r.linear(ja + ("W_up",), f"{ta}.W_up")
                continue
            for sub in convs:
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
    if r._has(("vgg_pre_kernel",)):
        r.sd["vgg_pre.weight"] = np.transpose(
            r._get("params", ("vgg_pre_kernel",)), (3, 2, 0, 1))
        r.sd["vgg_pre.bias"] = r._get("params", ("vgg_pre_bias",))

    left = r.unused_leaves()
    if left:
        raise ValueError(f"JAX leaves with no place in the port: {left}")
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in r.sd.items()}


def from_jax_grads(grads: Dict, **kw) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree (the structure of ``params``) -> {port parameter
    name: gradient}, with the layout conversions of ``from_jax_params``."""
    return from_jax_params(grads, None, **kw)


_UNET3D_CONVS = ("conv1a", "ds1", "ds2", "ds3", "up4conva", "up3conva",
                 "up2conva", "up1conv")
_UNET3D_BLOCKS = ("conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                  "conv4a", "conv4b", "conv4c", "conv4d", "up4convb",
                  "up3convb", "up2convb")
# JAX VAEBranch module -> the reference's name (``reconstraction`` sic)
_VAE3D_NAMES = {"hidden_gn": "hidden_conv.0", "hidden_conv": "hidden_conv.2",
                "vconv4_conv": "vconv4.0", "vconv3_conv": "vconv3.0",
                "vconv3_block": "vconv3.2", "vconv2_conv": "vconv2.0",
                "vconv2_block": "vconv2.2", "vconv1_conv": "vconv1.0",
                "vconv1_block": "vconv1.2", "vconv0": "vconv0"}


def from_jax_nvnet3d(params: Dict, input_shape) -> Dict[str, torch.Tensor]:
    """Convert the JAX ``NVNet3D`` ``params`` tree (nested dicts of numpy
    arrays) into the port's ``state_dict``.  ``input_shape`` is the JAX
    model's (D, H, W)."""
    r = _Reader(params, None)

    def conv(jpath, tname):
        r.sd[f"{tname}.weight"] = np.transpose(
            r._get("params", jpath + ("kernel",)), (4, 3, 1, 2, 0))
        r.sd[f"{tname}.bias"] = r._get("params", jpath + ("bias",))

    def block(jpath, tname):
        for sub in ("gn1", "gn2"):
            r.bn(jpath + (sub,), f"{tname}.{sub}")
        for sub in ("conv1", "conv2"):
            conv(jpath + (sub,), f"{tname}.{sub}")

    for name in _UNET3D_CONVS:
        conv(("unet", name), f"unet.{name}")
    for name in _UNET3D_BLOCKS:
        block(("unet", name), f"unet.{name}")
    for jname, tname in _VAE3D_NAMES.items():
        jpath, tname = ("vae_branch", jname), f"vae_branch.{tname}"
        if "gn" in jname:
            r.bn(jpath, tname)
        elif "block" in jname:
            block(jpath, tname)
        else:
            conv(jpath, tname)
    for name in ("mu_fc", "logvar_fc"):
        r.linear(("vae_branch", name), f"vae_branch.{name}")
    # output feature i of JAX's (C, D/16, H/16, W/16) order is feature
    # perm[i] of the reference's (C, H/16, W/16, D/16)
    d, h, w = (s // 16 for s in input_shape)
    jpath = ("vae_branch", "reconstruction")
    kernel = r._get("params", jpath + ("kernel",))           # [z, out]
    bias = r._get("params", jpath + ("bias",))
    idx = np.arange(bias.shape[0]).reshape(-1, h, w, d)
    perm = np.transpose(idx, (0, 3, 1, 2)).reshape(-1)
    w_t, b_t = np.empty_like(kernel), np.empty_like(bias)
    w_t[:, perm], b_t[perm] = kernel, bias
    r.sd["vae_branch.reconstraction.0.weight"] = np.transpose(w_t)
    r.sd["vae_branch.reconstraction.0.bias"] = b_t

    left = r.unused_leaves()
    if left:
        raise ValueError(f"JAX leaves with no place in the port: {left}")
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in r.sd.items()}


LEGACY_KINDS = ("zcond", "unet", "lowdose", "generator", "resnet18",
                "danet")
_HEAD_BLOCKS = re.compile(r"(conv5a|conv5c|conv51|conv52)_(conv|bn)")


def _legacy_part(kind: str, path: Tuple[str, ...], i: int,
                 siblings) -> Optional[str]:
    """The port's name of component ``path[i]`` of a JAX module path
    (None drops it); ``siblings`` are the keys beside it."""
    p, parent = path[i], path[i - 1] if i else ""
    last = i == len(path) - 1
    if kind in ("resnet18", "danet"):
        m = _HEAD_BLOCKS.fullmatch(p)
        if m:
            return f"{m[1]}.{0 if m[2] == 'conv' else 1}"
        if parent == "head" and p in ("conv6", "conv7", "conv8"):
            return p + ".1"
        p = re.sub(r"^layer(\d)_(\d+)$", r"layer\1.\2", p)
        return {"downsample_conv": "downsample.0",
                "downsample_bn": "downsample.1"}.get(p, p)
    if kind != "generator":
        return p
    if p == "split_down_1":
        return None
    if last and re.fullmatch(r"down_1(_\d+|_comb)?", p):
        return p + ".0"
    if re.fullmatch(r"down_\d", parent):
        if p == "conv":
            return "conv.0" if "bn" in siblings else "conv"
        if p == "bn":
            return "conv.1"
    if p == "conv" and re.fullmatch(r"up_\d|output", parent):
        return "up.1"
    m = re.fullmatch(r"(up_\d|output)_(conv|bn)", p)
    if m:
        return m[1] + (".up.1" if m[2] == "conv" else ".bn")
    if p == "W_out_conv":
        return "W_out.0" if "W_out_bn" in siblings else "W_out"
    return "W_out.1" if p == "W_out_bn" else p


def from_jax_legacy(params: Dict, batch_stats: Optional[Dict],
                    kind: str) -> Dict[str, torch.Tensor]:
    """Convert the JAX trees of a module beside ``MultimodalModel`` into
    the port's ``state_dict`` (see the module docstring for ``kind``).
    With ``batch_stats=None`` only the parameters are converted (a
    gradient tree goes through so).  Raises on an unknown kind and on any
    leaf left unread."""
    if kind not in LEGACY_KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {LEGACY_KINDS}")
    r = _Reader(params, batch_stats)

    def walk(node: Dict, path: Tuple[str, ...], names: Tuple[str, ...]):
        leaves = [k for k, v in node.items() if not isinstance(v, dict)]
        tname = ".".join(names)
        if "scale" in leaves:
            r.bn(path, tname)
        elif "experts" in leaves or (
                "kernel" in leaves and np.ndim(node["kernel"]) == 4):
            r.conv(path, tname)
        elif "kernel" in leaves:
            r.linear(path, tname)
        if "gamma" in leaves:                        # PAM / CAM
            r.sd[f"{tname}.gamma"] = r._get("params", path + ("gamma",))
        for k, v in node.items():
            if isinstance(v, dict):
                part = _legacy_part(kind, path + (k,), len(path), node)
                walk(v, path + (k,), names + ((part,) if part else ()))

    walk(params, (), ())
    left = r.unused_leaves()
    if left:
        raise ValueError(f"JAX leaves with no place in the port: {left}")
    # a module at the root of the tree (a lone layer) has no prefix
    return {k.lstrip("."): torch.from_numpy(np.array(v, np.float32,
                                                     order="C"))
            for k, v in r.sd.items()}
