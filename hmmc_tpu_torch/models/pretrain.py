"""The pretrain model and its MoCo engine (counterpart of
``hmmc_tpu/models/pretrain.py``; reference BirdPreTrainedModel,
modeling.py:88-436).

- :class:`BirdPretrainModel`: the query towers, ``t_projector``,
  ``v_projector``, ``v_predictor`` and the MLM head ``cls``, under the
  reference checkpoint's names. Its ``encode_video`` runs a ModifiedResNet
  tower's BatchNorm on its running statistics (frozen, as the JAX
  pretrain step keeps them); the key towers' copy carries the same
  buffers, which the EMA leaves alone (it pairs parameters only).
- :class:`MomentumTowers`: the key side, copies of the four
  :data:`MOMENTUM_SUBTREES` (:func:`init_key_params`), never trained; its
  projectors keep their own BatchNorm running statistics (the JAX
  package's ``batch_stats_k``). :func:`momentum_update` is the EMA
  ``k <- m * k + (1 - m) * q`` over every paired parameter, in two
  ``torch._foreach_*`` passes under ``no_grad``.
- :class:`MoCoQueues`: the five negative queues, columns ``[H, K]`` (the
  frame queues ``[H, K * F]``), unit-norm, and the write pointer (a host
  int: ``K % B == 0`` makes its path fixed).
- :func:`mask_tokens`: BERT's 80/10/10 masking, split into a sampler
  (:func:`sample_mask_decisions`, from a ``torch.Generator``) and a
  deterministic apply (:func:`apply_mask_decisions`) that the tests feed
  the JAX package's draws. The pad and cls ids are protected; the English
  pad id is the EOT id (49407) while the real padding is 0, so padding
  stays maskable (the reference's quirk, kept).
- :func:`mlm_loss`: cross entropy over the labels that are not -100.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hmmc_tpu_torch.config import ClipArch, CrossConfig
from hmmc_tpu_torch.models.heads import MLMHead, ProjectorMLP
from hmmc_tpu_torch.models.text import TextEncoder
from hmmc_tpu_torch.models.visual import VisualEncoder

# subtrees with momentum twins (modeling.py:131-135)
MOMENTUM_SUBTREES = ("text_encoder", "visual_encoder", "t_projector",
                     "v_projector")


def _project(mlp: ProjectorMLP, frame_fea: torch.Tensor,
             train: bool) -> torch.Tensor:
    b, f, h = frame_fea.shape
    return mlp(frame_fea.reshape(b * f, h), train).reshape(b, f, -1)


class BirdPretrainModel(nn.Module):
    """Query towers, projectors and the MLM head (modeling.py:88-157).
    ``encode_text`` / ``encode_video`` / ``logit_scale`` are
    ``BirdModel``'s, so the evaluator takes this model as it is."""

    def __init__(self, arch: ClipArch, cross_config: CrossConfig = CrossConfig(),
                 language: str = "english", use_temp: bool = True,
                 vocab_size: int = 49408, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False):
        super().__init__()
        cc = cross_config
        self.arch = arch
        self.cross_config = cc
        self.use_temp = use_temp
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.use_fused = use_fused
        h = arch.embed_dim
        self.text_encoder = TextEncoder(arch, cc, language, dtype, use_fused)
        self.visual_encoder = VisualEncoder(arch, cc, use_temp, dtype,
                                            use_fused)
        self.t_projector = ProjectorMLP(cc.proj_num_layers, h, 4096, h, dtype)
        self.v_projector = ProjectorMLP(cc.proj_num_layers, h, 4096, h, dtype)
        self.v_predictor = ProjectorMLP(cc.pred_num_layers, h, 4096, h, dtype)
        self.cls = MLMHead(h, vocab_size, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for m in (self.text_encoder, self.visual_encoder, self.t_projector,
                  self.v_projector, self.v_predictor, self.cls):
            m.reset_parameters(generator)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids)

    def encode_video(self, video: torch.Tensor,
                     frame_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.visual_encoder(video, frame_mask)

    def project_frames(self, frame_fea: torch.Tensor, train: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """v_projector then v_predictor over the flattened frames
        (modeling.py:354-360). frame_fea [B, F, H] -> (proj, pred)."""
        proj = _project(self.v_projector, frame_fea, train)
        return proj, _project(self.v_predictor, proj, train)

    def mlm_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        _, hidden = self.text_encoder(input_ids, return_hidden=True)
        return self.cls(hidden)

    def logit_scale(self) -> torch.Tensor:
        return self.text_encoder.get_logit_scale()


class MomentumTowers(nn.Module):
    """The key side: ``text_encoder``, ``visual_encoder``, ``t_projector``
    and ``v_projector`` of a :class:`BirdPretrainModel`, as copies. Only the
    v projector runs (modeling.py:375-378, no predictor); ``t_projector``
    is paired and saved, never called."""

    def __init__(self, model: BirdPretrainModel):
        super().__init__()
        for name in MOMENTUM_SUBTREES:
            setattr(self, name, copy.deepcopy(getattr(model, name)))
        self.requires_grad_(False)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids)

    def encode_video(self, video: torch.Tensor):
        return self.visual_encoder(video)

    def project_frames_key(self, frame_fea: torch.Tensor,
                           train: bool = True) -> torch.Tensor:
        return _project(self.v_projector, frame_fea, train)


def init_key_params(model: BirdPretrainModel) -> MomentumTowers:
    """Key towers as real copies of the query's (copy_params,
    modeling.py:231-236), BatchNorm statistics included."""
    return MomentumTowers(model)


def momentum_pairs(model: BirdPretrainModel, towers: MomentumTowers):
    """(key parameters, query parameters), paired by name."""
    keys, queries = [], []
    for name in MOMENTUM_SUBTREES:
        q = dict(getattr(model, name).named_parameters())
        for n, k in getattr(towers, name).named_parameters():
            keys.append(k)
            queries.append(q[n])
    return keys, queries


@torch.no_grad()
def momentum_update(model: BirdPretrainModel, towers: MomentumTowers,
                    momentum: float, pairs=None) -> None:
    """k <- m * k + (1 - m) * q over every paired parameter
    (modeling.py:238-242), in place. ``pairs``: :func:`momentum_pairs`,
    to skip the pairing on every call."""
    keys, queries = pairs or momentum_pairs(model, towers)
    torch._foreach_mul_(keys, momentum)
    torch._foreach_add_(keys, queries, alpha=1.0 - momentum)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@dataclasses.dataclass
class MoCoQueues:
    """Negative queues in the reference's column layout
    (modeling.py:137-151): ``v_cross``, ``title_cross``, ``tag_cross``
    [H, K]; ``frame_proj``, ``frame_cross`` [H, K * F]; ``ptr`` the next
    column (of the [H, K] queues)."""

    v_cross: torch.Tensor
    frame_proj: torch.Tensor
    frame_cross: torch.Tensor
    title_cross: torch.Tensor
    tag_cross: torch.Tensor
    ptr: int = 0

    NAMES = ("v_cross", "frame_proj", "frame_cross", "title_cross",
             "tag_cross")

    @classmethod
    def create(cls, generator: torch.Generator, hidden: int,
               num_negative: int, max_frames: int, device=None
               ) -> "MoCoQueues":
        """Unit-norm random columns (modeling.py:139-151), drawn on the
        CPU from ``generator`` and moved to ``device``."""
        def q(cols):
            x = torch.randn(hidden, cols, generator=generator)
            return (x / torch.linalg.vector_norm(x, dim=0, keepdim=True)
                    ).to(device)

        k, f = num_negative, num_negative * max_frames
        return cls(v_cross=q(k), frame_proj=q(f), frame_cross=q(f),
                   title_cross=q(k), tag_cross=q(k), ptr=0)

    @torch.no_grad()
    def enqueue(self, v_k: torch.Tensor, tag_k: torch.Tensor,
                title_k: torch.Tensor, frame_k: torch.Tensor,
                frame_proj_k: torch.Tensor) -> None:
        """Write a batch's L2-normalised keys at ``ptr`` (modeling.py:
        244-284), in place. v_k / tag_k / title_k [B, H]; frame_k /
        frame_proj_k [B, F, H]. Needs ``K % B == 0``. In place: call it only
        after the backward of every loss that read the queues."""
        b, f = v_k.shape[0], frame_k.shape[1]
        k = self.v_cross.shape[1]
        if k % b:
            raise ValueError(f"{k} negatives are not a multiple of the "
                             f"batch {b}")
        p = self.ptr
        for queue, keys in ((self.v_cross, v_k), (self.tag_cross, tag_k),
                            (self.title_cross, title_k)):
            queue[:, p:p + b] = _l2norm(keys.float()).T
        for queue, keys in ((self.frame_proj, frame_proj_k),
                            (self.frame_cross, frame_k)):
            queue[:, p * f:(p + b) * f] = _l2norm(
                keys.float()).reshape(b * f, -1).T
        self.ptr = (p + b) % k


@dataclasses.dataclass
class MaskDecisions:
    """The draws of one :func:`mask_tokens` call, each of the ids' shape:
    ``select`` (Bernoulli(p)), ``replace`` (Bernoulli(0.8)), ``randomize``
    (Bernoulli(0.5)) bools and ``words`` (uniform ids)."""

    select: torch.Tensor
    replace: torch.Tensor
    randomize: torch.Tensor
    words: torch.Tensor


def sample_mask_decisions(generator: torch.Generator, shape,
                          vocab_size: int, mlm_probability: float = 0.15,
                          device=None) -> MaskDecisions:
    """The draws of :func:`mask_tokens` from ``generator`` (on
    ``device``)."""
    def coin(p):
        return torch.rand(shape, generator=generator, device=device) < p

    return MaskDecisions(
        select=coin(mlm_probability), replace=coin(0.8), randomize=coin(0.5),
        words=torch.randint(0, vocab_size, shape, generator=generator,
                            device=device))


def apply_mask_decisions(input_ids: torch.Tensor, d: MaskDecisions,
                         mask_token_id: int, pad_token_id: int,
                         cls_token_id: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked ids, labels): labels are -100 where nothing was masked
    (modeling.py:181-205: bernoulli(0.8) of the masked -> [MASK], then
    bernoulli(0.5) of the rest -> a random word, the others unchanged)."""
    masked = (d.select & (input_ids != pad_token_id)
              & (input_ids != cls_token_id))
    labels = torch.where(masked, input_ids, torch.full_like(input_ids, -100))
    replaced = d.replace & masked
    randomized = d.randomize & masked & ~replaced
    out = torch.where(replaced, torch.full_like(input_ids, mask_token_id),
                      input_ids)
    out = torch.where(randomized, d.words.to(input_ids.dtype), out)
    return out, labels


def mask_tokens(generator: torch.Generator, input_ids: torch.Tensor,
                vocab_size: int, mask_token_id: int, pad_token_id: int,
                cls_token_id: int, mlm_probability: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    d = sample_mask_decisions(generator, input_ids.shape, vocab_size,
                              mlm_probability, input_ids.device)
    return apply_mask_decisions(input_ids, d, mask_token_id, pad_token_id,
                                cls_token_id)


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over the labels that are not -100, in fp32 (0
    when there are none; modeling.py:173-180). One fused
    ``F.cross_entropy``: at full width the logits are [64, 32, 49408].
    ``count`` replaces the number of labels as the divisor: over several
    ranks, the global count of masked tokens (which differs between
    ranks), so that the ranks' results sum to the global mean."""
    vocab = logits.shape[-1]
    labels = labels.reshape(-1)
    total = F.cross_entropy(logits.reshape(-1, vocab).float(), labels,
                            ignore_index=-100, reduction="sum")
    if count is None:
        count = (labels != -100).sum()
    return total / count.clamp(min=1)
