"""Ahead-of-time serve artifacts through ``torch.export`` (the JAX
package's ``utils/aot.py``).

The serve step's body (``serve.SynthesizeStep``: the cast to the compute
dtype and one ``MultimodalModel.synthesize``) is exported once with
``torch.export.export`` and saved with ``torch.export.save``; a serving
process loads it and runs it without building the model.  The kernels sit
in the program as the custom ops ``rdt::in_modulate`` (and, in a train
graph, ``rdt::bn_stats`` / ``rdt::bn_norm``), so loading imports the port's
``ops`` to register them.  torch.export lifts the weights out of the
program: ``load_weights`` loads a checkpoint's ``state_dict`` into a loaded
artifact, so that one artifact serves every checkpoint of a run, as JAX's
does with its weights as arguments.

An artifact holds what the export traced: the device type (a CUDA artifact
runs CUDA kernels, a CPU one the plain versions), the batch and input
shape, the compute dtype, the source and ``with_y``.  A JSON header ahead of
the payload records them with the card's name and the torch version, and
``serve`` checks them before use (JAX serve.py:250-271).  An artifact is
not carried between torch versions.  The JAX package's ``RDTAOT1``
artifacts hold StableHLO and are refused by name.

Usage (see also ``serve.py --export-aot / --aot``)::

    blob = export_serve_step(model, cfg, source=0, sample=batch)
    open("serve_B16.rdt", "wb").write(blob)
    # in the serving process, without the model:
    step, header = load_serve_step("serve_B16.rdt")
    x_hat, y = step(inputs, mask, mask_img)
"""

from __future__ import annotations

import io
import json
import os
from typing import Mapping, Tuple

import torch

from representation_disentanglement_torch.ops import fused_bn, kernels  # noqa: F401 (register rdt::)

MAGIC = b"RDTTORCHAOT1\n"
JAX_MAGIC = b"RDTAOT1\n"
_PREFIX = "model."


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def export_serve_step(model, cfg, *, source: int, sample,
                      with_y: bool = True) -> bytes:
    """The serve step of ``model`` exported for ``sample``-shaped batches,
    as bytes: MAGIC, a 4-byte header length, the JSON header, then the
    ``torch.export.save`` payload.

    ``sample``: ``inputs`` [M, B, H, W, Cb], ``mask`` [B, M], ``mask_img``
    [B, H, W] (numpy arrays or tensors; their shapes are traced, their
    values are not kept).  The model must be in eval mode."""
    from representation_disentanglement_torch.serve import (
        SynthesizeStep, as_f32_tensors)
    if model.training:
        raise ValueError("export_serve_step: the model is in train mode; "
                         "the serve step runs it in eval mode")
    device = model.device
    args = as_f32_tensors(device, sample["inputs"], sample["mask"],
                          sample["mask_img"])
    with torch.no_grad():           # inference tensors cannot be exported
        ep = torch.export.export(SynthesizeStep(model, cfg, source, with_y),
                                 args, strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    header = json.dumps({
        "source": int(source), "with_y": bool(with_y),
        "inputs_shape": list(args[0].shape),
        "compute_dtype": cfg.compute_dtype,
        "device_type": device.type, "device": _device_name(device),
        "torch": torch.__version__}).encode()
    return MAGIC + len(header).to_bytes(4, "big") + header + buf.getvalue()


def read_header(blob: bytes) -> dict:
    if blob.startswith(JAX_MAGIC):
        raise ValueError("a JAX package AOT artifact (RDTAOT1, StableHLO): "
                         "it does not run in torch; export the port's own "
                         "with serve --export-aot")
    if not blob.startswith(MAGIC):
        raise ValueError("not a port AOT artifact (bad magic)")
    n = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 4], "big")
    off = len(MAGIC) + 4
    return json.loads(blob[off:off + n].decode())


def load_serve_step(path_or_blob) -> Tuple[object, dict]:
    """Load an artifact: returns ``(step, header)``, ``step(inputs, mask,
    mask_img) -> (x_hat, y or None)`` as ``serve.make_serve_step``'s, run
    on the device type it was exported on.  ``step.module`` is the loaded
    program (a ``torch.nn.Module``)."""
    blob = path_or_blob
    if isinstance(blob, (str, os.PathLike)):
        with open(blob, "rb") as f:
            blob = f.read()
    header = read_header(blob)
    if header["torch"] != torch.__version__:
        raise ValueError(f"AOT artifact was exported with torch "
                         f"{header['torch']}; this is torch "
                         f"{torch.__version__}: re-export it here")
    if header["device_type"] == "cuda" and not torch.cuda.is_available():
        raise ValueError("AOT artifact was exported on a CUDA device "
                         f"({header['device']}); none is available here")
    n = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 4], "big")
    ep = torch.export.load(io.BytesIO(blob[len(MAGIC) + 4 + n:]))
    module = ep.module()
    device = torch.device(header["device_type"])
    with_y = header["with_y"]

    def step(inputs, mask, mask_img):
        args = (torch.as_tensor(a, device=device, dtype=torch.float32)
                for a in (inputs, mask, mask_img))
        with torch.no_grad():
            out = module(*args)
        return out[0], (out[1] if with_y else None)

    step.module = module
    return step, header


def load_weights(step, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a model's ``state_dict`` (a checkpoint's ``params``, reference
    torch names) into a loaded artifact, every tensor of the program
    replaced (strict)."""
    module = step.module
    own = module.state_dict()
    missing = [k for k in own if k[len(_PREFIX):] not in state_dict]
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} tensors of the "
                       f"artifact, e.g. {missing[:3]}")
    with torch.no_grad():
        for k, t in own.items():
            t.copy_(state_dict[k[len(_PREFIX):]])
