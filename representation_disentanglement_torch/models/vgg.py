"""VGG16 feature extractor for the perceptual similarity loss and the VGG
compact anatomy key (JAX ``models/vgg.py``).

Reference: ``compute_perceptual`` (src/model.py:3417-3445) pads the anatomy
codes to 224x224, maps their channels to RGB with a learned 3x3 conv
(``vgg_pre``, src/model.py:2946) and runs torchvision's pretrained VGG16:
- content: the conv4_2 features (``features[:21]``);
- style: Gram matrices of the outputs of ``features[:i]`` for i in
  [0, 5, 10, 17, 24] (the input itself, pool1 .. pool4), weighted 1e3 and
  divided by C^2;
and ``compute_compact_s_vgg`` (src/model.py:3460-3467) runs the whole of
``features`` and a 7x7 average pool to a [B, 512] key.

Everything here runs in f32 whatever the model's compute dtype, as in the
JAX package.  The VGG16 weights are constants, not parameters: they come
from an npz (``conv{i}_kernel`` HWIO and ``conv{i}_bias``, the JAX
package's format) that ``dump_torchvision_vgg16`` writes wherever
torchvision and its pretrained weights exist; ``load_vgg_npz`` reads it
and ``vgg_constants`` puts it on a device in the OIHW layout.  The
convolutions are ordinary cuDNN convolutions.  Tensors here are NCHW.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# channel plan of VGG16 'features'; 'M' = 2x2 max-pool
VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]
CONTENT_TAP = 21
STYLE_TAPS = (0, 5, 10, 17, 24)
STYLE_WEIGHT = 1e3
COMPACT_TAP = 31                    # the whole of 'features'


def dump_torchvision_vgg16(npz_path: str) -> None:   # pragma: no cover
    """Run where torchvision IS available to produce the weights npz."""
    import torchvision
    m = torchvision.models.vgg16(pretrained=True)
    out = {}
    conv_i = 0
    for layer in m.features:
        if layer.__class__.__name__ == "Conv2d":
            out[f"conv{conv_i}_kernel"] = np.transpose(
                layer.weight.detach().numpy(), (2, 3, 1, 0))
            out[f"conv{conv_i}_bias"] = layer.bias.detach().numpy()
            conv_i += 1
    np.savez(npz_path, **out)


def load_vgg_npz(npz_path: str) -> Dict[str, np.ndarray]:
    return dict(np.load(npz_path))


def vgg_constants(params: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """The npz's arrays as f32 tensors on ``device``: ``conv{i}_weight``
    [O, I, 3, 3] and ``conv{i}_bias`` [O]."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v, np.float32))
        if k.endswith("_kernel"):
            k, t = k[:-len("_kernel")] + "_weight", t.permute(3, 2, 0, 1)
        out[k] = t.contiguous().to(device)
    return out


def vgg16_features(x: torch.Tensor, params: Dict[str, torch.Tensor],
                   taps: Tuple[int, ...]) -> List[torch.Tensor]:
    """Run VGG16 'features' on x [B, 3, H, W] and return the activations at
    torchvision's Sequential indices ``taps``: conv, ReLU and pool each
    count one slot, and tap i is the output of features[:i]."""
    outs = {}
    seq_idx, conv_i, h = 0, 0, x

    def slot(t):
        nonlocal seq_idx
        if seq_idx in taps:
            outs[seq_idx] = t
        seq_idx += 1

    for item in VGG16_PLAN:
        if seq_idx >= max(taps):
            break
        if item == "M":
            slot(h)
            h = F.max_pool2d(h, 2)
            continue
        slot(h)
        h = F.conv2d(h, params[f"conv{conv_i}_weight"],
                     params[f"conv{conv_i}_bias"], padding=1)
        conv_i += 1
        slot(h)
        h = F.relu(h)
    if seq_idx in taps:
        outs[seq_idx] = h
    return [outs[t] for t in taps]


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """Gram over the spatial dims (src/model.py:3430-3434): [B, C, H, W] ->
    [B, C, C] / (H*W), in f32."""
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w).float()
    return torch.bmm(f, f.transpose(1, 2)) / (h * w)


def _pad224(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad [B, C, H, W] to 224x224, the odd row or column at the end
    (src/model.py:3418-3421)."""
    ph = (224 - x.shape[-2]) // 2
    pw = (224 - x.shape[-1]) // 2
    return F.pad(x, (pw, 224 - x.shape[-1] - pw, ph, 224 - x.shape[-2] - ph))


def _rgb(x, pre_weight, pre_bias):
    """[B, Cs, H, W] -> the learned RGB projection at 224x224, in f32."""
    return F.conv2d(_pad224(x.float()), pre_weight.float(), pre_bias.float(),
                    padding=1)


def compact_s_vgg(x: torch.Tensor, pre_weight, pre_bias,
                  vgg_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """compute_compact_s_vgg: pad to 224, the learned 3x3 RGB projection,
    the whole of VGG16 'features', a 7x7 average pool, flattened:
    [B, Cs, H, W] -> [B, 512]."""
    (feat,) = vgg16_features(_rgb(x, pre_weight, pre_bias), vgg_params,
                             (COMPACT_TAP,))
    return F.avg_pool2d(feat, 7).flatten(1)


def perceptual_similarity(x: torch.Tensor, y: torch.Tensor, pre_weight,
                          pre_bias, vgg_params: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
    """compute_perceptual: the negated content + 1e3 x style loss of x and
    y [B, Cs, H, W], a similarity score (one scalar for the batch).

    Both terms are means over the batch of per-sample means; inside a
    ``data_parallel`` scope the per-sample scores are gathered over the
    ranks first, so the score is the global batch's."""
    from representation_disentanglement_torch.parallel.mesh import (
        gather_rows)
    taps = STYLE_TAPS[:4] + (CONTENT_TAP,) + STYLE_TAPS[4:]
    fx = vgg16_features(_rgb(x, pre_weight, pre_bias), vgg_params, taps)
    fy = vgg16_features(_rgb(y, pre_weight, pre_bias), vgg_params, taps)
    content = (fx[4] - fy[4]).square().mean(dim=(1, 2, 3))
    style = torch.zeros((), device=x.device)
    for i in (0, 1, 2, 3, 5):
        gx, gy = gram_matrix(fx[i]), gram_matrix(fy[i])
        style = style + (gx - gy).square().mean(dim=(1, 2)) \
            / gx.shape[-1] ** 2
    return -gather_rows(content + STYLE_WEIGHT * style, 0).mean()
