"""BertAdam and its parameter groups (counterpart of
``hmmc_tpu/train/optimization.py``; reference modules/optimization.py and
the grouping of main_task_retrieval.py:171-212).

- Adam WITHOUT bias correction: m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g^2;
  update = m/(sqrt(v)+eps) + wd*p; p -= lr * schedule(progress) * update.
- Each parameter's gradient is clipped by its own norm (1.0, with a floor of
  1e-6 on the norm) inside the step; :func:`build_optimizer` puts the train
  loop's global clip by norm 1.0 in front (main_task_retrieval.py:290).
- ``progress = step / t_total`` is read BEFORE the step counter moves, so
  under ``warmup_cosine`` the first update is multiplied by 0.
  ``warmup_cosine``'s cosine phase ignores the warmup offset (a reference
  quirk, optimization.py:26-29).
- A parameter whose ``grad`` is None takes a zero gradient and is still
  updated, as the JAX package updates every leaf: ``logit_scale``, which
  never gets a gradient, is shrunk by its weight decay every step.
- ``state_dtype`` (``optim_bf16_state``) stores m and v in that dtype; the
  moment and parameter updates compute in fp32.
- Over several ranks the gradients reach :meth:`BertAdam.step` already
  summed over ranks (``trainer.reduce_gradients``), so the global clip
  reads the norm of the full gradient on every rank. ``--zero_opt``
  (:meth:`BertAdam.shard`) is ZeRO-1 by WHOLE parameters: each parameter's
  m and v live on one rank (:func:`zero_owners`), which clips and updates
  it (the per-parameter clip stays local) and then broadcasts it. The JAX
  package shards each moment's first dp-divisible axis instead
  (``hmmc_tpu/parallel/mesh.py:230-266``); either is a placement and
  changes no result. :meth:`BertAdam.moments` / :meth:`BertAdam.
  load_moments` move the moments by parameter name, gathered from their
  owners, so a ZeRO run's state resumes without ZeRO and the other way
  round.

Groups by state_dict name: ``visual_encoder.visual.*`` (the CLIP ViT) take
``lr * coef_lr``, ``text_encoder.*`` take ``text_lr``, ``t_projector.*``
take 0 (the pretrain model builds it but never calls it, so the reference
never updates it; an lr of 0 also stops its decoupled weight decay),
everything else ``lr``. No weight decay for a name whose last part contains
``bias`` (the MLM head's ``cls.bias`` too) and for the BERT-style
LayerNorm weights (``*.LayerNorm.weight``: the MLM head's). The CLIP
LayerNorm weights (``ln_*.weight``) and the projectors' BatchNorm weights
DO decay: the reference's no-decay match is the substring
``LayerNorm.weight``, which they do not contain.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from hmmc_tpu_torch.parallel import distributed

# ---------------------------------------------------------------------------
# schedules (multiplier over progress = step / t_total)
# ---------------------------------------------------------------------------


def warmup_cosine(x: float, warmup: float = 0.002) -> float:
    """optimization.py:26-29: the cosine phase ignores the warmup offset."""
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


def scheduled_lr(lr: float, step: int, t_total: int,
                 schedule: str = "warmup_cosine",
                 warmup: float = 0.002) -> float:
    """The lr BertAdam applies at ``step`` (the reference's
    ``optimizer.get_lr()[0]``)."""
    if t_total <= 0:
        return float(lr)
    return float(lr * SCHEDULES[schedule](step / t_total, warmup))


# ---------------------------------------------------------------------------
# parameter groups over state_dict names
# ---------------------------------------------------------------------------


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True where weight decay applies."""
    return {n: "bias" not in n.rsplit(".", 1)[-1]
            and not n.endswith("LayerNorm.weight") for n in names}


def lr_tree(names: Iterable[str], lr: float, text_lr: float,
            coef_lr: float) -> Dict[str, float]:
    """Base learning rate per name (main_task_retrieval.py:192-199)."""
    def base(name: str) -> float:
        if name.startswith("t_projector."):
            return 0.0
        if name.startswith("visual_encoder.visual."):
            return lr * coef_lr
        if name.startswith("text_encoder."):
            return text_lr
        return lr

    return {n: base(n) for n in names}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def zero_owners(sizes: List[int], world: int) -> List[int]:
    """The rank that holds each parameter's moments under ZeRO-1: the
    largest first, each to the least loaded rank (the lowest on a tie)."""
    load = [0] * world
    owner = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(world), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += sizes[i]
    return owner


class BertAdam(torch.optim.Optimizer):
    """Each param group carries ``lr`` and ``weight_decay``. ``t_total=-1``
    turns the schedule off (multiplier 1); ``global_clip_norm > 0`` clips
    all gradients together by their global norm before the per-parameter
    clip."""

    def __init__(self, params, lr: float = 1e-4,
                 schedule: str = "warmup_cosine", warmup: float = -1.0,
                 t_total: int = -1, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 max_grad_norm: float = 1.0,
                 state_dtype: Optional[torch.dtype] = None,
                 global_clip_norm: float = 0.0):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.schedule = SCHEDULES[schedule]
        self.warmup, self.t_total = warmup, t_total
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.state_dtype = state_dtype
        self.global_clip_norm = global_clip_norm
        self.names: Dict[torch.nn.Parameter, str] = {}
        self.owner: Optional[Dict[torch.nn.Parameter, int]] = None

    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.param_groups for p in g["params"]]

    def shard(self) -> None:
        """ZeRO-1 over the process group's ranks: from now on this rank
        keeps and updates the moments of its own parameters only."""
        params = self.params()
        owners = zero_owners([p.numel() for p in params],
                             distributed.world_size())
        self.owner = dict(zip(params, owners))
        me = distributed.rank()
        for p in params:
            if self.owner[p] != me:
                self.state.pop(p, None)

    def _owns(self, p) -> bool:
        return self.owner is None or self.owner[p] == distributed.rank()

    def _owned_by(self, r: int) -> List[torch.nn.Parameter]:
        return [p for p in self.params() if self.owner[p] == r]

    def multiplier(self, step: int) -> float:
        if self.t_total == -1:
            return 1.0
        return self.schedule(step / self.t_total, self.warmup)

    @torch.no_grad()
    def step(self) -> None:
        coef = None
        if self.global_clip_norm > 0:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = torch.nn.utils.get_total_norm(grads)
            coef = torch.clamp(self.global_clip_norm / norm, max=1.0)
        b1, b2 = self.b1, self.b2
        for group in self.param_groups:
            for p in group["params"]:
                if not self._owns(p):
                    continue
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if coef is not None:
                    g = g * coef.to(g.dtype)
                if self.max_grad_norm > 0:
                    n = torch.linalg.vector_norm(g.float())
                    g = g * torch.clamp(
                        self.max_grad_norm / torch.clamp(n, min=1e-6),
                        max=1.0).to(g.dtype)
                state = self.state[p]
                if not state:
                    dtype = self.state_dtype or p.dtype
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p, dtype=dtype)
                    state["v"] = torch.zeros_like(p, dtype=dtype)
                g32 = g.float()
                state["m"].copy_(state["m"].float() * b1 + g32 * (1 - b1))
                state["v"].copy_(state["v"].float() * b2
                                 + g32.square() * (1 - b2))
                u = state["m"].float() / (state["v"].float().sqrt()
                                          + self.eps)
                u = u + group["weight_decay"] * p.float()
                mult = self.multiplier(state["step"])
                p.add_((u * -(group["lr"] * mult)).to(p.dtype))
                state["step"] += 1
        if self.owner is not None:
            for r in range(distributed.world_size()):
                distributed.broadcast_(self._owned_by(r), src=r)

    @torch.no_grad()
    def moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{"m": {name: tensor}, "v": {...}}`` for every parameter that
        has taken a step, as CPU copies; under ZeRO each rank's moments
        are broadcast from their owner first (a collective: every rank
        calls it)."""
        out: Dict[str, Dict[str, torch.Tensor]] = {"m": {}, "v": {}}
        params = [p for p in self.params()
                  if self.owner is not None or p in self.state]
        if self.owner is not None:
            for r in range(distributed.world_size()):
                mine = self._owned_by(r)
                bufs = []
                for p in mine:
                    if p not in self.state:
                        dtype = self.state_dtype or p.dtype
                        self.state[p] = {"m": torch.empty_like(p, dtype=dtype),
                                         "v": torch.empty_like(p, dtype=dtype)}
                    bufs += [self.state[p]["m"], self.state[p]["v"]]
                distributed.broadcast_(bufs, src=r)
        for p in params:
            for k in ("m", "v"):
                out[k][self.names[p]] = self.state[p][k].to("cpu", copy=True)
        if self.owner is not None:
            for p in params:
                if not self._owns(p):
                    del self.state[p]
        return out

    @torch.no_grad()
    def load_moments(self, moments: Dict[str, Dict[str, torch.Tensor]],
                     step: int) -> None:
        """The inverse of :meth:`moments`: each parameter of this rank
        takes its saved m and v (cast to the state dtype) and ``step``."""
        by_name = {n: p for p, n in self.names.items()}
        for name, m in moments["m"].items():
            p = by_name[name]
            if not self._owns(p):
                continue
            dtype = self.state_dtype or p.dtype
            self.state[p] = {
                "step": int(step),
                "m": m.to(p.device, dtype),
                "v": moments["v"][name].to(p.device, dtype)}


def build_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                    lr: float, text_lr: float, coef_lr: float,
                    weight_decay: float, warmup_proportion: float,
                    t_total: int, schedule: str = "warmup_cosine",
                    global_clip_norm: float = 1.0,
                    state_dtype: Optional[torch.dtype] = None,
                    zero: bool = False) -> BertAdam:
    """The reference chain: global clip by norm ``global_clip_norm`` ->
    BertAdam(b2 .98, eps 1e-6, per-parameter clip 1.0) over the groups of
    :func:`lr_tree` x :func:`decay_mask` (``named_params``: e.g.
    ``model.named_parameters()``); ``zero``: ZeRO-1 over the process
    group (:meth:`BertAdam.shard`)."""
    named = list(named_params)
    names = [n for n, _ in named]
    lrs = lr_tree(names, lr, text_lr, coef_lr)
    decay = decay_mask(names)
    groups: Dict[Tuple[float, bool], List[torch.nn.Parameter]] = {}
    for n, p in named:
        groups.setdefault((lrs[n], decay[n]), []).append(p)
    param_groups = [dict(params=ps, lr=base,
                         weight_decay=weight_decay if dec else 0.0)
                    for (base, dec), ps in groups.items()]
    opt = BertAdam(param_groups, lr=lr, schedule=schedule,
                   warmup=warmup_proportion, t_total=t_total, b1=0.9,
                   b2=0.98, eps=1e-6, weight_decay=weight_decay,
                   max_grad_norm=1.0, state_dtype=state_dtype,
                   global_clip_norm=global_clip_norm)
    opt.names = {p: n for n, p in named}
    if zero:
        opt.shard()
    return opt
