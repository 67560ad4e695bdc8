"""Train-state checkpoints in torch files (counterpart of
``hmmc_tpu/train/orbax_io.py``: ``CheckpointWriter``, ``latest_step``,
``restore_state`` and the ``progress_meta`` sidecar).

A state file ``{directory}/state_{step}.pt`` holds everything a run needs
to continue exactly: the model's state dict (BatchNorm statistics
included), BertAdam's m and v by parameter name (under ZeRO gathered from
their owners first, so a ZeRO run resumes without ZeRO and the other way
round) and the global step; for the pretrain also the key towers with
their BatchNorm statistics, the five queues and ``ptr``. Its sidecar
``{directory}/progress_meta/{step}.json`` has the loader position:
``epoch``, ``batch_in_epoch``, ``steps_per_epoch``, ``epoch_end``. The
random streams come from (seed, purpose, global position)
(``runner.stream``), so no generator state is saved.

Writes are atomic (a temporary file, then ``os.replace``); a state file
exists only once it is complete, and :func:`latest_step` reads only
complete ones. :class:`CheckpointWriter` keeps the newest MAX_TO_KEEP
(5, as the JAX package's Orbax manager) and with ``async_save`` writes on
a thread: the snapshot is copied to the host before ``save`` returns (the
next step updates the tensors in place), the previous write is waited on
before the next starts, and ``close`` waits for the last. Only the rank
that writes (rank 0) makes a writer that writes; every rank takes the
snapshot, which is a collective under ZeRO.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, Optional

import torch

from hmmc_tpu_torch.parallel import distributed

_STATE = re.compile(r"^state_(\d+)\.pt$")
MAX_TO_KEEP = 5


def state_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"state_{step}.pt")


def _meta_path(directory: str, step: int) -> str:
    return os.path.join(directory, "progress_meta", f"{step}.json")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STATE.match,
                                               os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete state file's step, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_progress_meta(directory: str, step: int, meta: dict) -> None:
    path = _meta_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp, path)


def load_progress_meta(directory: str, step: int) -> Optional[dict]:
    path = _meta_path(directory, step)
    if not os.path.isfile(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_state(directory: str, step: int) -> Dict:
    return torch.load(state_path(directory, step), map_location="cpu",
                      weights_only=True)


def _host(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def snapshot(state) -> Optional[Dict]:
    """A host copy of a ``FinetuneState`` or ``PretrainState``: model,
    moments, step; the key towers, queues and ``ptr`` where the state has
    them. Every rank calls it (under ZeRO the moments are gathered from
    their owners); the ranks that do not write get None."""
    if not distributed.is_main():
        if state.optimizer.owner is not None:
            state.optimizer.moments()
        return None
    out = {"step": int(state.step), "model": _host(state.model.state_dict()),
           "moments": state.optimizer.moments()}
    towers = getattr(state, "towers", None)
    if towers is not None:
        q = state.queues
        out["towers"] = _host(towers.state_dict())
        out["queues"] = _host({f: getattr(q, f) for f in q.NAMES})
        out["ptr"] = int(q.ptr)
    return out


@torch.no_grad()
def restore(state, saved: Dict) -> None:
    """Load a :func:`snapshot` into ``state`` in place (strict names)."""
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_moments(saved["moments"], saved["step"])
    state.step = int(saved["step"])
    if "towers" in saved:
        state.towers.load_state_dict(saved["towers"], strict=True)
        for f, v in saved["queues"].items():
            getattr(state.queues, f).copy_(v)
        state.queues.ptr = int(saved["ptr"])


class CheckpointWriter:
    """Writes state files under ``directory`` (when ``enabled``: on the
    rank that writes), the newest MAX_TO_KEEP kept, synchronously or on a
    thread (``async_save``)."""

    def __init__(self, directory: str, async_save: bool = False,
                 enabled: bool = True):
        self.dir = directory
        self.async_save = async_save
        self.enabled = enabled
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, step: int, payload: Dict, meta: Optional[dict]) -> None:
        os.makedirs(self.dir, exist_ok=True)
        if meta is not None:    # first: a sidecar without its state is inert
            save_progress_meta(self.dir, step, meta)
        path = state_path(self.dir, step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in _steps(self.dir)[:-MAX_TO_KEEP]:
            os.remove(state_path(self.dir, old))
            meta_path = _meta_path(self.dir, old)
            if os.path.isfile(meta_path):
                os.remove(meta_path)

    def _write_in_thread(self, *args) -> None:
        try:
            self._write(*args)
        except Exception as e:  # noqa: BLE001 -- raised again by wait()
            self._error = e

    def save(self, step: int, payload: Dict,
             meta: Optional[dict] = None) -> None:
        """Write ``payload`` (a host :func:`snapshot`) as ``step``."""
        self.wait()
        if not self.enabled:
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_in_thread, args=(step, payload, meta),
                name=f"checkpoint-{step}", daemon=False)
            self._thread.start()
        else:
            self._write(step, payload, meta)

    def refresh_meta(self, step: int, meta: dict) -> None:
        """Rewrite the sidecar of a state already written (an epoch's end
        that falls on a ``--save_steps`` save)."""
        self.wait()
        if self.enabled:
            save_progress_meta(self.dir, step, meta)

    def wait(self) -> None:
        """Wait for the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()
