"""Reference-format checkpoints: ``pytorch_model.bin.{epoch}`` in and out
(counterpart of ``load_torch_state_dict`` / ``remap_gamma_beta`` /
``merge_params`` in ``hmmc_tpu/train/checkpoint.py`` and
``save_reference_checkpoint`` in ``hmmc_tpu/train/orbax_io.py``).

The port's module names are the reference checkpoint's (OpenAI CLIP / HMMC
``state_dict`` keys), so a file maps onto ``BirdModel.state_dict()`` by
name. Files are pickled state dicts read with ``weights_only=True``; an
OpenAI CLIP TorchScript archive (``ViT-B-32.pt``) is refused until
``--clip_model`` is ported. Orbax directories (the JAX package's own
training state) are not read.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Dict

import torch

logger = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]


def _is_torchscript(path: str) -> bool:
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("constants.pkl") or "/code/" in n
                   for n in z.namelist())


def load_torch_state_dict(path: str) -> StateDict:
    """A pickled torch state dict as CPU tensors, floating ones in fp32."""
    if _is_torchscript(path):
        raise NotImplementedError(
            f"{path} is a TorchScript archive (an OpenAI CLIP .pt): loading "
            "those waits for the port of --clip_model (ROADMAP.md Queue A)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not hold a state dict "
                         f"(got {type(sd).__name__})")
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            for k, v in sd.items()}


def remap_gamma_beta(sd: StateDict) -> StateDict:
    """gamma->weight, beta->bias key remap (until_module.py:104-118)."""
    return {k.replace("gamma", "weight").replace("beta", "bias"): v
            for k, v in sd.items()}


def merge_into(model: torch.nn.Module, sd: StateDict,
               log: logging.Logger = logger) -> None:
    """Overlay ``sd`` onto ``model``'s parameters by name (the partial-load
    semantics of until_module.py:129-160 / ``merge_params``): entries the
    file lacks keep their init, entries the model lacks are dropped, both
    are logged; a shape mismatch raises unless only the shape differs (a
    scalar stored as [1])."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing:
        log.info("Weights not initialized from checkpoint:\n   %s",
                 "\n   ".join(missing))
    if unexpected:
        log.info("Checkpoint weights not used:\n   %s",
                 "\n   ".join(unexpected))
    with torch.no_grad():
        for name, dst in own.items():
            if name not in sd:
                continue
            src = sd[name]
            if tuple(src.shape) != tuple(dst.shape):
                if src.numel() != dst.numel():
                    raise ValueError(
                        f"shape mismatch at {name}: checkpoint "
                        f"{tuple(src.shape)} vs model {tuple(dst.shape)}")
                src = src.reshape(dst.shape)
            dst.copy_(src.to(dst.dtype))


def save_reference_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Write ``model``'s state dict in fp32 under the reference names,
    readable by the reference and by ``hmmc_tpu``'s
    ``load_torch_state_dict``. Atomic: a crash mid-save leaves no file under
    the final name."""
    sd = {k: v.detach().float().cpu().contiguous()
          for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)
