"""Model construction (counterpart of ``hmmc_tpu/factory.py``).

:func:`build_model` builds the retrieval ``BirdModel`` (or, with
``pretrain=True``, the ``BirdPretrainModel``) with seeded random
weights drawn on the CPU from an explicit ``torch.Generator`` (so a seed
gives the same weights on every device), overlays an OpenAI CLIP file
(``--clip_model``: its architecture read from its tensor shapes, its
visual tower, a ModifiedResNet's BatchNorm running statistics included,
``logit_scale`` and, in English, its text tower), then an
HMMC checkpoint (``pytorch_model.bin.N``, ``--init_model``), which wins, as
in the JAX factory; then it moves the model to the device. Orbax
directories are not read. A pretrain checkpoint's key towers and queues
are not the query model's: with ``pretrain=True`` they are kept on the
model as ``pretrain_import`` for the run to load into its state (the JAX
factory's ``_pretrain_import``, ``hmmc_tpu/factory.py:206-234``); for the
retrieval model they are dropped and logged.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from hmmc_tpu_torch.config import ClipArch, CrossConfig, TaskConfig
from hmmc_tpu_torch.models.pretrain import BirdPretrainModel
from hmmc_tpu_torch.models.retrieval import BirdModel
from hmmc_tpu_torch.train import checkpoint

logger = logging.getLogger(__name__)

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device. Without a card and without ``device`` it raises:
    the port never drops to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def build_model(task: TaskConfig, cross: CrossConfig,
                arch: Optional[ClipArch] = None, device=None,
                generator: Optional[torch.Generator] = None,
                init_model_path: Optional[str] = None,
                clip_model_path: Optional[str] = None,
                pretrain: bool = False, vocab_size: int = 49408):
    """A ``BirdModel`` (``pretrain``: a ``BirdPretrainModel`` with an MLM
    head of ``vocab_size``) in eval mode on ``device`` with weights drawn from
    ``generator`` (a CPU generator; default: seeded with ``task.seed``),
    overlaid first by the OpenAI CLIP file at ``clip_model_path`` (whose
    tensor shapes give the architecture), then by the checkpoint at
    ``init_model_path``, with the JAX factory's semantics (gamma/beta
    remapped; keys a file lacks keep what they had and are logged).
    ``arch`` defaults to the CLIP file's, else to
    ``cross.pretrained_clip_name``."""
    task.validate()
    device = resolve_device(device)
    clip_sd = None
    if clip_model_path:
        clip_sd = checkpoint.load_torch_state_dict(clip_model_path)
        arch = ClipArch.from_state_dict(clip_sd)
        logger.info(
            "CLIP arch from checkpoint shapes: embed_dim=%d res=%d "
            "vision_layers=%s width=%d patch=%s", arch.embed_dim,
            arch.image_resolution, arch.vision_layers, arch.vision_width,
            arch.vision_patch_size or None)
        if task.image_resolution not in (0, arch.image_resolution):
            raise ValueError(
                f"{clip_model_path} holds a tower for "
                f"{arch.image_resolution}-px frames, but frames decode at "
                f"{task.image_resolution}: name its tower as "
                "pretrained_clip_name in the --cross_model JSON")
    elif arch is None:
        arch = ClipArch.by_name(cross.pretrained_clip_name)
    common = dict(language=task.language, use_temp=task.use_temp,
                  dtype=COMPUTE_DTYPES[task.compute_dtype],
                  use_fused=task.use_fused_attention == "on")
    if pretrain:
        model = BirdPretrainModel(arch, cross, vocab_size=vocab_size,
                                  **common)
        model.pretrain_import = None
    else:
        model = BirdModel(arch, cross, **common)
    if generator is None:
        generator = torch.Generator().manual_seed(task.seed)
    model.reset_parameters(generator)
    if clip_sd is not None:
        checkpoint.merge_into(model, checkpoint.clip_to_port(
            clip_sd, task.language), logger)
        logger.info("loaded CLIP weights from %s", clip_model_path)
    if init_model_path:
        if os.path.isdir(init_model_path):
            raise NotImplementedError(
                f"{init_model_path} is a directory: Orbax checkpoints are "
                "not read by the port; pass a pytorch_model.bin.N file")
        sd = checkpoint.remap_gamma_beta(
            checkpoint.load_torch_state_dict(init_model_path))
        if pretrain:
            sd, keys, queues = checkpoint.split_pretrain_state_dict(sd)
            if keys or queues:
                model.pretrain_import = {"towers": keys, "queues": queues}
        checkpoint.merge_into(model, sd, logger)
        logger.info("loaded checkpoint %s", init_model_path)
    return model.to(device).eval()
