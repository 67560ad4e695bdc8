"""Reference-format checkpoints: OpenAI CLIP archives and
``pytorch_model.bin.{epoch}`` in, ``pytorch_model.bin.{epoch}`` out
(counterpart of ``load_torch_state_dict`` / ``remap_gamma_beta`` /
``merge_params`` / the CLIP split of ``import_clip_weights`` in
``hmmc_tpu/train/checkpoint.py`` and ``save_reference_checkpoint`` in
``hmmc_tpu/train/orbax_io.py``, its pretrain files included).

The port's module names are the reference checkpoint's (OpenAI CLIP / HMMC
``state_dict`` keys), so a file maps onto ``BirdModel.state_dict()`` by
name; an OpenAI CLIP file's keys get the port's tower prefixes
(:func:`clip_to_port`). A file is a TorchScript archive (OpenAI's
``ViT-B-32.pt``: its module's ``state_dict()``) or a pickled state dict
(read with ``weights_only=True``). Orbax directories (the JAX package's
own training state) are not read. :func:`inflate_3d` turns a CLIP file's
2d patch kernel into the 3d tube's.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch

from hmmc_tpu_torch.models.pretrain import MOMENTUM_SUBTREES, MoCoQueues

logger = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A TorchScript archive's state dict (``torch.jit.load``, as the
    reference's CLIP loader tries first, module_clip.py:432-439) or else a
    pickled state dict, as CPU tensors, floating ones in fp32 (OpenAI's
    archives hold fp16)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not hold a state dict "
                         f"(got {type(sd).__name__})")
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            for k, v in sd.items()}


# an OpenAI CLIP file's text-tower keys (module_clip.py:470-487)
_CLIP_TEXT = ("token_embedding.", "positional_embedding", "transformer.",
              "ln_final.", "text_projection")


def clip_to_port(sd: StateDict, language: str) -> StateDict:
    """An OpenAI CLIP state dict under the port's names: ``visual.*`` ->
    ``visual_encoder.visual.*`` (a ModifiedResNet's BatchNorm
    ``running_mean``, ``running_var`` and ``num_batches_tracked`` among
    them), ``logit_scale`` ->
    ``text_encoder.logit_scale``, and in English the text tower's keys ->
    ``text_encoder.*`` (the split of ``import_clip_weights`` and of the JAX
    factory's overlay, ``hmmc_tpu/factory.py:151-167``). Other keys
    (``input_resolution``, ``context_length``, ``vocab_size`` in OpenAI's
    archives) are dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            out["visual_encoder." + k] = v
        elif k == "logit_scale":
            out["text_encoder.logit_scale"] = v
        elif language == "english" and k.startswith(_CLIP_TEXT):
            out["text_encoder." + k] = v
    return out


def inflate_3d(sd: StateDict, prefix: str = "visual") -> StateDict:
    """``sd`` with its 2d patch kernel ``{prefix}.conv1.weight`` [O, I, kh,
    kw] replaced by the 3d tube kernel ``{prefix}.conv2.weight`` [O, I, 3,
    kh, kw] that holds it on the middle temporal tap and zeros on the other
    two (the CLIP4Clip init for ``linear_patch="3d"``; the counterpart of
    ``import_clip_visual(inflate_3d=True)``,
    ``hmmc_tpu/train/checkpoint.py:151-176``). Apply it to an OpenAI CLIP
    state dict before :func:`clip_to_port` to start a 3d tower from it."""
    out = dict(sd)
    conv = out.pop(f"{prefix}.conv1.weight")
    tube = conv.new_zeros((*conv.shape[:2], 3, *conv.shape[2:]))
    tube[:, :, 1] = conv
    out[f"{prefix}.conv2.weight"] = tube
    return out


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


# the reference's buffer name of each MoCoQueues field
QUEUE_NAMES = {f: f"queue_{f}_ng" for f in MoCoQueues.NAMES}


def _cpu(v: torch.Tensor) -> torch.Tensor:
    v = v.detach().cpu().contiguous()
    return v.float() if v.is_floating_point() else v


def save_reference_checkpoint(path: str, model: torch.nn.Module,
                              pretrain_state=None) -> None:
    """Write ``model``'s state dict in fp32 under the reference names,
    readable by the reference and by ``hmmc_tpu``'s
    ``load_torch_state_dict`` (a ModifiedResNet's BatchNorm buffers
    included, which ``import_hmmc_state_dict`` reads as its
    ``batch_stats``). With ``pretrain_state`` (a
    ``PretrainState``; ``model`` is its query model) the file is the
    reference pretrain's (modeling.py:88-157; the JAX package's
    ``save_reference_checkpoint``, ``hmmc_tpu/train/orbax_io.py:189-260``):
    the query towers, projectors and predictor with their BatchNorm running
    statistics and ``cls.*``, the key towers as ``text_encoder_k.*``,
    ``visual_encoder_k.*``, ``t_projector_k.*`` and ``v_projector_k.*``
    (with the key statistics), and the five ``queue_*_ng`` buffers with
    ``queue_ptr``. Atomic: a crash mid-save leaves no file under the final
    name."""
    sd = {k: _cpu(v) for k, v in model.state_dict().items()}
    if pretrain_state is not None:
        for k, v in pretrain_state.towers.state_dict().items():
            tower, rest = k.split(".", 1)
            sd[f"{tower}_k.{rest}"] = _cpu(v)
        q = pretrain_state.queues
        for field, name in QUEUE_NAMES.items():
            sd[name] = _cpu(getattr(q, field))
        sd["queue_ptr"] = torch.tensor([q.ptr], dtype=torch.int64)
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)


def split_pretrain_state_dict(sd: StateDict):
    """A pretrain checkpoint's state dict -> (the query model's entries,
    the key towers' under the towers' own names, the queues by
    ``MoCoQueues`` field and ``ptr``): the reverse import of
    ``_apply_pretrain_import`` (``hmmc_tpu/runner.py:349``)."""
    query, keys, queues = {}, {}, {}
    names = {v: k for k, v in QUEUE_NAMES.items()}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head.endswith("_k") and head[:-2] in MOMENTUM_SUBTREES and rest:
            keys[f"{head[:-2]}.{rest}"] = v
        elif k in names:
            queues[names[k]] = v
        elif k == "queue_ptr":
            queues["ptr"] = int(v.reshape(-1)[0])
        else:
            query[k] = v
    return query, keys, queues
