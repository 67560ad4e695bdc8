"""Configuration of the port (counterpart of ``hmmc_tpu/config.py``).

:class:`CrossConfig`, :data:`CLIP_ARCH` and :class:`ClipArch` (with
``from_state_dict``) are copies of the JAX package's (field names and
defaults match the reference's ``cross_config.json`` and CLIP model zoo).
:class:`TaskConfig` carries only the fields the retrieval eval, the
fine-tune, the pretrain, the extract and the CLI read, plus the
attention switch ``use_fused_attention`` ("on": the hand-written CUDA kernel for every
unmasked or causal attention; "off": the plain PyTorch attention). The JAX
package's automatic kernel choice is not carried over: its crossover was
measured on a TPU, and any such rule for the port is derived from H100
measurements (PERF.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CrossConfig:
    """Architecture + loss-weight config (reference: cross_config.json)."""

    # temporal transformer over the frame axis
    max_position_embeddings: int = 48
    temporal_hidden_size: int = 512
    temporal_attention_heads: int = 8
    temporal_hidden_layers: int = 4
    # chinese text tower (roberta-base geometry by default)
    chinese_hidden_size: int = 768
    chinese_num_layers: int = 12
    chinese_num_heads: int = 12
    chinese_intermediate_size: int = 3072
    # MLM
    mlm_probability: float = 0.15
    # projector / predictor MLPs (MoCo pretrain heads)
    proj_num_layers: int = 2
    pred_num_layers: int = 2
    # pretrain loss weights (modeling.py:424)
    weight_FAM: float = 0.05
    weight_VTM: float = 0.45
    weight_FTM: float = 0.45
    weight_MLM: float = 0.05
    # finetune loss weights (modeling.py:703-709)
    weight_VTM_finetune: float = 0.85
    weight_FTM_finetune: float = 0.15
    # retrieval_VT title mixing weight
    weight_title: float = 0.5
    # CLIP backbone selection
    pretrained_clip_name: str = "ViT-B/32"
    # kept for config-file compat; unused (legacy co-attention model)
    co_attention_layers: int = 4

    @classmethod
    def from_json(cls, path: str) -> "CrossConfig":
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


# Shapes of the supported CLIP towers, keyed like the reference's
# pretrained_clip_name (module_clip.py:20-29).
CLIP_ARCH = {
    "ViT-B/32": dict(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=32, context_length=77, vocab_size=49408,
        transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
    "ViT-B/16": dict(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=16, context_length=77, vocab_size=49408,
        transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
    "ViT-L/14": dict(
        embed_dim=768, image_resolution=224, vision_layers=24, vision_width=1024,
        vision_patch_size=14, context_length=77, vocab_size=49408,
        transformer_width=768, transformer_heads=12, transformer_layers=12,
    ),
    "ViT-L/14@336px": dict(
        embed_dim=768, image_resolution=336, vision_layers=24, vision_width=1024,
        vision_patch_size=14, context_length=77, vocab_size=49408,
        transformer_width=768, transformer_heads=12, transformer_layers=12,
    ),
    # ResNet towers: a tuple vision_layers selects the ModifiedResNet
    "RN50": dict(
        embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3),
        vision_width=64, vision_patch_size=0, context_length=77,
        vocab_size=49408, transformer_width=512, transformer_heads=8,
        transformer_layers=12,
    ),
    "RN101": dict(
        embed_dim=512, image_resolution=224, vision_layers=(3, 4, 23, 3),
        vision_width=64, vision_patch_size=0, context_length=77,
        vocab_size=49408, transformer_width=512, transformer_heads=8,
        transformer_layers=12,
    ),
    "RN50x4": dict(
        embed_dim=640, image_resolution=288, vision_layers=(4, 6, 10, 6),
        vision_width=80, vision_patch_size=0, context_length=77,
        vocab_size=49408, transformer_width=640, transformer_heads=10,
        transformer_layers=12,
    ),
    "RN50x16": dict(
        embed_dim=768, image_resolution=384, vision_layers=(6, 8, 18, 8),
        vision_width=96, vision_patch_size=0, context_length=77,
        vocab_size=49408, transformer_width=768, transformer_heads=12,
        transformer_layers=12,
    ),
    "RN50x64": dict(
        embed_dim=1024, image_resolution=448, vision_layers=(3, 15, 36, 10),
        vision_width=128, vision_patch_size=0, context_length=77,
        vocab_size=49408, transformer_width=1024, transformer_heads=16,
        transformer_layers=12,
    ),
}


@dataclasses.dataclass(frozen=True)
class ClipArch:
    embed_dim: int
    image_resolution: int
    vision_layers: object  # int (ViT depth) | tuple (ResNet stage blocks)
    vision_width: int
    vision_patch_size: int
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int
    linear_patch: str = "2d"  # '2d' | '3d' (module_clip.py:291-295)

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, (tuple, list))

    @property
    def vision_heads(self) -> int:
        if self.is_resnet:
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @classmethod
    def by_name(cls, name: str, linear_patch: str = "2d") -> "ClipArch":
        if name not in CLIP_ARCH:
            raise ValueError(
                f"unknown CLIP arch {name!r}; known: {list(CLIP_ARCH)}")
        return cls(linear_patch=linear_patch, **CLIP_ARCH[name])

    @classmethod
    def from_state_dict(cls, sd, linear_patch: str = "2d") -> "ClipArch":
        """The architecture of an OpenAI CLIP state dict, read from its
        tensor shapes and key names as the reference's build_model does
        (module_clip.py:530-579; ``hmmc_tpu.config.ClipArch.
        from_state_dict``): ``"visual.proj" in sd`` tells a ViT from a
        ModifiedResNet. ``sd`` maps CLIP names to anything with a
        ``.shape``."""
        def shape(k):
            return tuple(sd[k].shape)

        if "visual.proj" in sd:
            vision_width = shape("visual.conv1.weight")[0]
            vision_layers = len([
                k for k in sd
                if k.startswith("visual.") and k.endswith(
                    ".attn.in_proj_weight")])
            vision_patch_size = shape("visual.conv1.weight")[-1]
            grid = round((shape("visual.positional_embedding")[0] - 1)
                         ** 0.5)
            image_resolution = vision_patch_size * grid
        else:
            counts = [len({k.split(".")[2] for k in sd
                           if k.startswith(f"visual.layer{b}")})
                      for b in (1, 2, 3, 4)]
            vision_layers = tuple(counts)
            vision_width = shape("visual.layer1.0.conv1.weight")[0]
            tokens = shape("visual.attnpool.positional_embedding")[0]
            out_width = round((tokens - 1) ** 0.5)
            if out_width ** 2 + 1 != tokens:
                raise ValueError(f"attnpool positional embedding of {tokens} "
                                 "rows is not a square grid plus one")
            vision_patch_size = 0
            image_resolution = out_width * 32
        transformer_width = shape("ln_final.weight")[0]
        return cls(
            embed_dim=shape("text_projection")[1],
            image_resolution=image_resolution,
            vision_layers=vision_layers,
            vision_width=vision_width,
            vision_patch_size=vision_patch_size,
            context_length=shape("positional_embedding")[0],
            vocab_size=shape("token_embedding.weight")[0],
            transformer_width=transformer_width,
            transformer_heads=transformer_width // 64,
            transformer_layers=len({
                k.split(".")[2] for k in sd
                if k.startswith("transformer.resblocks")}),
            linear_patch=linear_patch)


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """The run flags the retrieval eval, the fine-tune, the pretrain and
    the CLI read (names and defaults as in ``hmmc_tpu.config.TaskConfig``)."""

    # mode
    do_pretrain: bool = False
    do_train: bool = False
    do_eval: bool = False
    do_extract: bool = False
    do_params: bool = False
    task: str = "retrieval"          # retrieval (retrieval_VT not ported)
    dataset: str = "msrvtt"
    language: str = "english"
    use_temp: bool = True
    use_frame_fea: bool = True
    top_frames: int = 3
    cross_model: str = "cross-base"
    init_model: Optional[str] = None
    clip_model: Optional[str] = None    # an OpenAI CLIP .pt to start from
    # data
    data_dir: Optional[str] = None
    # input resolution; 0 = derive from the CLIP arch (224 for ViT-B)
    image_resolution: int = 0
    num_thread_reader: int = 1
    max_words: int = 32
    max_frames: int = 12
    frame_sample: str = "uniform"    # uniform | random | uniform_random
    frame_sample_len: str = "fix"    # fix (dynamic: bird datasets only)
    # optimization
    lr: float = 1e-4
    text_lr: float = 1e-5
    coef_lr: float = 1.0
    weight_decay: float = 0.2
    warmup_proportion: float = 0.1
    epochs: int = 20
    batch_size: int = 256
    batch_size_val: int = 3500
    gradient_accumulation_steps: int = 1
    # pretrain contrast engine (main_pretrain.py:61-63)
    contrast_num_negative: int = 1024
    contrast_momentum: float = 0.99
    contrast_temperature: float = 0.07
    seed: int = 42
    n_display: int = 100
    output_dir: Optional[str] = None
    logdir: Optional[str] = None
    compute_dtype: str = "bfloat16"   # bfloat16 | float32
    use_fused_attention: str = "on"   # on | off
    # store BertAdam's m/v moments in bf16 (the update computes in fp32)
    optim_bf16_state: bool = False
    # the reference's temporal attention mask is all ones even over padded
    # frames (module_cross.py:201-203); True masks padded frames
    use_frame_mask: bool = False
    # ZeRO-1: BertAdam's m/v sharded over the ranks by whole parameters
    zero_opt: bool = False
    # train-state checkpoints (train/state_io.py) under output_dir/ckpt
    resume: bool = False
    save_steps: int = 0
    async_save: bool = False
    # torch.profiler trace of the first 10 train steps
    profile_dir: Optional[str] = None

    def validate(self) -> None:
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.use_fused_attention not in ("on", "off"):
            raise ValueError(
                f"use_fused_attention must be on/off, got "
                f"{self.use_fused_attention!r}")
        if self.language not in ("english", "chinese"):
            raise ValueError(f"unknown language {self.language!r}")
        if self.task not in ("retrieval", "retrieval_VT"):
            raise ValueError(f"unknown task {self.task!r}")
        if self.frame_sample not in ("uniform", "random", "uniform_random"):
            raise ValueError(f"unknown frame_sample {self.frame_sample!r}")
        if self.frame_sample_len not in ("fix", "dynamic"):
            raise ValueError(
                f"unknown frame_sample_len {self.frame_sample_len!r}")

    @property
    def aug_size(self) -> int:
        """The pretrain decode's short side and square crop: 8/7 of the
        input resolution (224 -> 256; ``hmmc_tpu/data/registry.py:50``)."""
        return (self.image_resolution or 224) * 8 // 7

    @property
    def micro_batch_size(self) -> int:
        # the reference divides the flag batch by the accumulation steps up
        # front (main_task_retrieval.py:95)
        return self.batch_size // self.gradient_accumulation_steps

    def replace(self, **kw) -> "TaskConfig":
        return dataclasses.replace(self, **kw)


def load_cross_config(name_or_path: str = "cross-base") -> CrossConfig:
    """A cross-model config by name or JSON path (``hmmc_tpu.config.
    load_cross_config``): a file path is read; "cross-base" is the
    defaults. The JAX package's other sources (bundled assets, URLs) are
    not carried over: it bundles none, and the card's machine has no
    network."""
    if os.path.isfile(name_or_path):
        return CrossConfig.from_json(name_or_path)
    if name_or_path == "cross-base":
        return CrossConfig()
    raise FileNotFoundError(f"cross config {name_or_path!r} not found")
