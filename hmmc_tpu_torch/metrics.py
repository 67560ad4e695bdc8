"""Retrieval metrics: R@1/5/10, median and mean rank (a copy of
``hmmc_tpu/metrics.py``; pure numpy).

Behavior parity with the reference ``metrics.py``:

- :func:`compute_metrics` reproduces the argsort-diagonal rank trick of
  ``metrics.py:12-39`` (rank of the diagonal element within its row, ties
  resolved the same way: rank = position of the first sorted entry equal to
  the diagonal value).
- :func:`text_to_video_metrics_3d` / :func:`video_to_text_sim` reproduce the
  multi-sentence (3-D, -inf padded) path of ``metrics.py:49-87``.
- :func:`logging_rank` reproduces the grouping/reshape logic of
  ``metrics.py:89-144`` including the cut-off-point slicing.

All host-side numpy; similarity matrices are produced on device elsewhere.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def compute_metrics(sim: np.ndarray) -> Dict[str, float]:
    """Rank metrics for a square-ish sim matrix, row = query, col = target;
    ground truth is the diagonal."""
    sim = np.asarray(sim)
    sorted_desc = np.sort(-sim, axis=1)
    diag = -np.diag(sim)[:, np.newaxis]
    # column positions where the sorted value equals the diagonal value; a
    # row with ties contributes several entries — same as metrics.py:20-28
    ranks = np.where(sorted_desc - diag == 0)[1]
    n = len(ranks)
    return {
        "R1": float(np.sum(ranks == 0)) * 100 / n,
        "R5": float(np.sum(ranks < 5)) * 100 / n,
        "R10": float(np.sum(ranks < 10)) * 100 / n,
        "MR": float(np.median(ranks) + 1),
        "MeanR": float(np.mean(ranks) + 1),
    }


def text_to_video_metrics_3d(
    sim_tensor: np.ndarray, top_k: Sequence[int] = (1, 5, 10)
) -> Dict[str, float]:
    """Multi-sentence t2v metrics on a [n_videos, max_sent, n_videos] tensor
    padded with -inf for missing sentences (metrics.py:49-76)."""
    sim_tensor = np.asarray(sim_tensor, dtype=np.float64)
    # per (video, sentence) row: rank of the correct video
    stacked = np.transpose(sim_tensor, (1, 0, 2))  # [max_sent, n_vid, n_vid]
    first_argsort = np.argsort(-stacked, axis=-1)
    second_argsort = np.argsort(first_argsort, axis=-1)
    ranks = np.diagonal(second_argsort, axis1=1, axis2=2).ravel()
    # mask out padded sentences (diagonal of the original tensor is -inf there)
    orig_diag = np.diagonal(sim_tensor, axis1=0, axis2=2).ravel()
    valid = ~(np.isinf(orig_diag) | np.isnan(orig_diag))
    ranks = ranks[valid]
    out = {
        f"R{k}": float(np.sum(ranks < k) * 100 / len(ranks)) for k in top_k
    }
    out["MedianR"] = float(np.median(ranks + 1))
    out["MeanR"] = float(np.mean(ranks + 1))
    out["Std_Rank"] = float(np.std(ranks + 1))
    out["MR"] = out["MedianR"]
    return out


def video_to_text_sim(sim_tensor: np.ndarray) -> np.ndarray:
    """Collapse [n_videos, max_sent, n_videos] to a v2t matrix by taking the
    max over each video's sentences (metrics.py:79-87)."""
    sim_tensor = np.asarray(sim_tensor, dtype=np.float64)
    sim_tensor = np.where(np.isnan(sim_tensor), -np.inf, sim_tensor)
    return np.max(sim_tensor, axis=1).T


def pad_multi_sentence(
    sim_matrix: np.ndarray, cut_off_points: Sequence[int]
) -> np.ndarray:
    """Reshape a [n_sentences, n_videos] matrix into
    [n_videos, max_sent, n_videos] with -inf padding, grouping rows by the
    inclusive cut-off index of each video's last sentence
    (metrics.py:102-113)."""
    ends = [c + 1 for c in cut_off_points]
    starts = [0] + ends[:-1]
    max_len = max(e - s for s, e in zip(starts, ends))
    groups = []
    for s, e in zip(starts, ends):
        pad = np.full((max_len - (e - s), sim_matrix.shape[1]), -np.inf)
        groups.append(np.concatenate((sim_matrix[s:e], pad), axis=0))
    return np.stack(groups, axis=0)


def logging_rank(
    sim_matrix: np.ndarray,
    multi_sentence: bool,
    cut_off_points: Sequence[int],
    log: logging.Logger = logger,
) -> Dict[str, float]:
    """Compute and log t2v + v2t metrics (metrics.py:89-144). Returns the
    t2v metrics dict (the reference's return value)."""
    sim_matrix = np.asarray(sim_matrix)
    if multi_sentence:
        log.info("before reshape, sim matrix size: %s x %s", *sim_matrix.shape)
        sim_3d = pad_multi_sentence(sim_matrix, cut_off_points)
        log.info("after reshape, sim matrix size: %s x %s x %s", *sim_3d.shape)
        tv = text_to_video_metrics_3d(sim_3d)
        vt = compute_metrics(video_to_text_sim(sim_3d))
    else:
        log.info("sim matrix size: %s, %s", *sim_matrix.shape)
        tv = compute_metrics(sim_matrix)
        vt = compute_metrics(sim_matrix.T)

    log.info("Text-to-Video:")
    log.info(
        "\t>>>  R@1: %.1f - R@5: %.1f - R@10: %.1f - Median R: %.1f - Mean R: %.1f",
        tv["R1"], tv["R5"], tv["R10"], tv["MR"], tv["MeanR"])
    log.info("Video-to-Text:")
    log.info(
        "\t>>>  V2T$R@1: %.1f - V2T$R@5: %.1f - V2T$R@10: %.1f - "
        "V2T$Median R: %.1f - V2T$Mean R: %.1f",
        vt["R1"], vt["R5"], vt["R10"], vt["MR"], vt["MeanR"])
    tv = dict(tv)
    tv.update({f"v2t_{k}": v for k, v in vt.items()})
    return tv
