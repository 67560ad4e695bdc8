"""Data parallelism over N ranks with ``torch.distributed`` (counterpart of
``hmmc_tpu/parallel/mesh.py``'s data axis).

The JAX package is data-parallel through GSPMD: its arrays are global, so
every loss, gradient, BatchNorm statistic and queue write is the
single-device one over the GLOBAL batch, with one gradient psum a step.
The port keeps those semantics with explicit collectives:

- :func:`init_distributed` joins the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL for a CUDA device, gloo for the CPU, or the
  backend the caller names. It sets the rank's CUDA device before anything
  else touches the card. A failed init raises; nothing drops to one
  process or to the CPU.
- :func:`all_gather_rows`: the ranks' rows concatenated in rank order, as
  a ``torch.autograd.Function`` whose backward returns this rank's rows of
  the incoming gradient. Every rank computes the same global loss, and
  the sum over ranks of the parameter gradients is the global gradient
  (the reference's ``AllGather``, until_module.py:279-295, averages
  instead and so trains on 1/world of it).
- :func:`all_reduce_sum`: a differentiable sum over ranks (its backward
  sums the incoming gradients), for the BatchNorm statistics of the
  global batch.
- :func:`all_reduce_grads`: one flat sum of the accumulated gradients a
  step (the JAX step's one psum); :func:`broadcast_` and
  :func:`broadcast_module`: parameters from one rank to all.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: both
backends take them for CPU and CUDA tensors. Without a process group every
helper is the identity and the rank is 0 of 1.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

TP_SP_ITEM = "ROADMAP.md Queue A 13, tensor and sequence parallelism"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def under_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


def check_parallel_flags(args) -> None:
    """The flags that no world size makes valid: ``--tp_size`` and
    ``--sp_size`` above 1 (the JAX package's tensor-parallel parameter
    specs and frame-axis sharding, ``hmmc_tpu/parallel/mesh.py:178-220``)."""
    for flag in ("tp_size", "sp_size"):
        value = getattr(args, flag, 1)
        if value != 1:
            raise ValueError(
                f"--{flag} {value!r}: the port is data-parallel only "
                f"({TP_SP_ITEM})")


def _check_world_flags(args, world: int) -> None:
    dp = getattr(args, "dp_size", 0)
    if dp not in (0, world):
        raise ValueError(f"--dp_size {dp} must be 0 or the world size "
                         f"{world} (torchrun's WORLD_SIZE)")
    dcn = getattr(args, "dcn_dp_size", 1)
    if dcn < 1 or world % dcn:
        raise ValueError(f"--dcn_dp_size {dcn} must divide the world size "
                         f"{world}")


def init_distributed(args, device=None, backend: Optional[str] = None
                     ) -> Tuple[Optional[torch.device], bool]:
    """Join the process group torchrun describes, where the environment
    has one and no group exists yet; check the parallel flags against the
    world size. Returns (device, created): ``device`` is the caller's, or
    ``cuda:LOCAL_RANK`` where this call joins torchrun's group, or None
    (the entry point then takes the current CUDA device); ``created`` says
    whether this call made the group (its caller then destroys it,
    :func:`shutdown`)."""
    check_parallel_flags(args)
    created = False
    if not is_initialized() and under_torchrun():
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "torchrun started this rank but no CUDA device is "
                    "available; pass device='cpu' for a gloo run on the CPU")
            device = torch.device("cuda", local_rank)
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]), **kw)
        created = True
        logger.info("rank %d of %d joined (%s, %s)", rank(), world_size(),
                    backend, device)
    if getattr(args, "multihost", False):
        if not is_initialized():
            raise ValueError("--multihost needs torchrun's multi-node "
                             f"environment ({', '.join(TORCHRUN_ENV)})")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
        logger.info("multi-node: %d ranks, %d per node", world_size(), local)
    _check_world_flags(args, world_size())
    return device, created


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _flat_apply(tensors: Sequence[torch.Tensor],
                fn: Callable[[torch.Tensor], None]) -> None:
    """``fn`` over one flat buffer per (device, dtype) holding ``tensors``,
    written back in place."""
    groups: Dict[Tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> None:
    """Sum the gradients over ranks in place: one flat all-reduce (the JAX
    step's one psum)."""
    if is_initialized() and grads:
        _flat_apply(grads, dist.all_reduce)


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over ranks in place."""
    if is_initialized() and tensors:
        _flat_apply(tensors, dist.all_reduce)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """``tensors`` from rank ``src`` to every rank, in place."""
    if is_initialized() and tensors:
        _flat_apply(tensors, lambda t: dist.broadcast(t, src))


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """A module's parameters and buffers from rank ``src`` to all."""
    broadcast_(list(module.state_dict().values()), src)


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on any (an all-reduce of
    the max)."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_object(obj, device, src: int = 0):
    """A JSON-able object from rank ``src`` (a byte tensor's broadcast)."""
    if not is_initialized():
        return obj
    data = (np.frombuffer(json.dumps(obj, default=lambda o: o.item())
                          .encode(), np.uint8)
            if rank() == src else np.zeros(0, np.uint8))
    size = torch.tensor([data.size], dtype=torch.int64, device=device)
    dist.broadcast(size, src)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=device)
    if rank() == src:
        buf.copy_(torch.from_numpy(data.copy()))
    dist.broadcast(buf, src)
    return json.loads(bytes(buf.cpu().numpy()).decode())


MAX_DIMS = 6


def all_gather_arrays(x: Optional[np.ndarray], device) -> List[np.ndarray]:
    """Every rank's float32 array (rows may differ; None for none), in
    rank order. The shapes go first, so a rank without rows learns the
    others' trailing shape."""
    if not is_initialized():
        return [x] if x is not None else []
    head = torch.zeros(MAX_DIMS + 2, dtype=torch.int64, device=device)
    if x is not None:
        if x.ndim > MAX_DIMS:
            raise ValueError(f"{x.ndim}-d array: at most {MAX_DIMS} dims")
        head[0], head[1] = x.shape[0], x.ndim
        head[2:2 + x.ndim - 1] = torch.tensor(x.shape[1:])
    heads = [torch.zeros_like(head) for _ in range(world_size())]
    dist.all_gather(heads, head)
    heads = [h.tolist() for h in heads]
    shaped = [h for h in heads if h[1] > 0]
    if not shaped:
        return [np.zeros(0, np.float32) for _ in heads]
    trailing = tuple(shaped[0][2:2 + shaped[0][1] - 1])
    most = max(h[0] for h in heads)
    buf = torch.zeros((most, *trailing), dtype=torch.float32, device=device)
    if x is not None and len(x):
        buf[:len(x)] = torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(device)
    parts = [torch.empty_like(buf) for _ in heads]
    dist.all_gather(parts, buf)
    return [p[:h[0]].cpu().numpy() for p, h in zip(parts, heads)]


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = (rank() * x.shape[0], (rank() + 1) * x.shape[0])
        parts = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] on each rank -> [world * n, ...], rank r's rows at
    [r * n, (r + 1) * n); the backward keeps this rank's rows of the
    gradient."""
    if not is_initialized():
        return x
    return _GatherRows.apply(x)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks; its backward sums the incoming gradients over
    ranks, which is the global gradient when the loss is the sum of the
    ranks' losses."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x)
