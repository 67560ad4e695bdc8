"""Frame-index sampling strategies (a verbatim copy of
``hmmc_tpu/data/sampling.py``; reference: dataloader_bird.py:173-188,
230-235; identical logic in the msrvtt/vatex loaders).

- ``uniform``: linspace over the stored frames, endpoint excluded.
- ``random``: sorted sample without replacement.
- ``uniform_random``: one random index per uniform stratum of size
  ``stored // want``.
- dynamic length: ``clamp(int(duration * 0.3), 3, max_frames)``
  (dataloader_bird.py:230-235), padded to ``max_frames`` by the caller.
"""

from __future__ import annotations

import numpy as np


def dynamic_frame_count(duration: float, max_frames: int) -> int:
    return min(max(int(duration * 0.3), 3), max_frames)


def sample_frame_indices(
    stored_frames: int,
    want: int,
    strategy: str = "uniform",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    if want > stored_frames:
        # degenerate videos: repeat the uniform grid with clamping
        idx = np.linspace(0, stored_frames, want, endpoint=False)
        return np.clip(idx.astype(int), 0, stored_frames - 1)
    if strategy == "uniform":
        return np.linspace(0, stored_frames, want, endpoint=False, dtype=int)
    if rng is None:
        rng = np.random.default_rng()
    if strategy == "random":
        return np.sort(rng.choice(stored_frames, size=want, replace=False))
    if strategy == "uniform_random":
        k = stored_frames // want
        return np.array([int(rng.integers(k * i, k * (i + 1)))
                         for i in range(want)])
    raise ValueError(f"unknown frame_sample strategy {strategy!r}")
