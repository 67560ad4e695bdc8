"""Retrieval fine-tune losses (counterpart of the CrossEn part of
``hmmc_tpu/losses.py``; reference until_module.py:39-49, 196-217 and
modeling.py:207-229, 665-722).

- :func:`cross_en`: symmetric InfoNCE's one direction, diagonal positives;
- :func:`get_dual_matrix` / :func:`dual_cross_en`: the dual-softmax
  reweighting;
- :func:`loose_similarity`: scaled cosine logits, 2-D and 3-D (per frame);
- :func:`finetune_retrieval_loss`: VTM (symmetric CrossEn on the global
  similarity) plus FTM (the per-frame symmetric CrossEn, meaned).

- :func:`moco_contrastive`: InfoNCE of a query against its key and a
  negative queue; :func:`frame_self_loss` (FAM) and
  :func:`frame_cross_loss` (FTM), the pretrain's frame losses built on it
  (``hmmc_tpu/losses.py:97-166``; modeling.py:286-332). Keys and queues
  carry no gradient.

All math in fp32; inputs may be bf16 (cast up on entry). The MIL-NCE and
max-margin losses are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def cross_en(sim_matrix: torch.Tensor) -> torch.Tensor:
    """-mean(diag(log_softmax(sim, -1))) over the last two axes; rows are
    queries. Leading axes are a batch of matrices."""
    logpt = torch.log_softmax(sim_matrix.float(), dim=-1)
    return -torch.diagonal(logpt, dim1=-2, dim2=-1).mean(dim=-1)


def get_dual_matrix(sim_matrix: torch.Tensor) -> torch.Tensor:
    """sim * softmax(sim, 0) * softmax(sim, 1) (temperature fixed at 1, as
    in the reference)."""
    s = sim_matrix.float()
    return s * torch.softmax(s, dim=0) * torch.softmax(s, dim=1)


def dual_cross_en(sim_matrix: torch.Tensor) -> torch.Tensor:
    return cross_en(get_dual_matrix(sim_matrix))


def loose_similarity(sequence_output: torch.Tensor,
                     visual_output: torch.Tensor,
                     logit_scale: torch.Tensor) -> torch.Tensor:
    """Scaled cosine-similarity logits. sequence_output [Bq, H];
    visual_output [Bv, H] -> [Bq, Bv], or [Bv, F, H] -> [Bq, Bv, F].
    ``logit_scale`` is already exp-ed and clamped by the caller."""
    v = _l2norm(visual_output.float())
    s = _l2norm(sequence_output.float())
    if v.dim() == 2:
        return logit_scale * (s @ v.T)
    return logit_scale * torch.einsum("vfh,qh->qvf", v, s)


def finetune_retrieval_loss(query_output: torch.Tensor,
                            visual_output: torch.Tensor,
                            frame_output: Optional[torch.Tensor],
                            logit_scale: torch.Tensor, weight_vtm: float,
                            weight_ftm: float) -> Dict[str, torch.Tensor]:
    """``BirdModel.forward``'s training loss: weight_vtm * (CrossEn(sim) +
    CrossEn(sim^T)) plus, with frames, weight_ftm * the mean over frames of
    the same symmetric CrossEn on each frame's similarity matrix."""
    sim = loose_similarity(query_output, visual_output, logit_scale)
    sim_loss = cross_en(sim) + cross_en(sim.T)
    loss = weight_vtm * sim_loss
    frame_loss = sim_loss.new_zeros(())
    if frame_output is not None:
        per = loose_similarity(query_output, frame_output,
                               logit_scale).permute(2, 0, 1)   # [F, Bq, Bv]
        frame_loss = (cross_en(per) + cross_en(per.transpose(1, 2))).mean()
        loss = loss + weight_ftm * frame_loss
    return {"loss": loss, "sim_loss": sim_loss, "frame_loss": frame_loss}


def _moco_rows(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """-log softmax of the positive logit per row: q, k [..., B, H],
    queue [H, K] -> [..., B]. The positive's logit joins the queue's
    log-sum-exp through ``logaddexp``, which equals the log-sum-exp of
    their concatenation without building it."""
    q = _l2norm(q.float())
    k = _l2norm(k.float()).detach()
    pos = (q * k).sum(dim=-1) / temperature
    neg = torch.logsumexp((q @ queue.float().detach()) / temperature, dim=-1)
    return torch.logaddexp(pos, neg) - pos


def moco_contrastive(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """InfoNCE against a negative queue (modeling.py:286-313): q, k
    [..., B, H] (leading axes batch independent terms), queue [H, K]
    column-normalised. The mean over every row."""
    return _moco_rows(q, k, queue, temperature).mean()


def frame_self_loss(frame_pred: torch.Tensor, frame_proj_k: torch.Tensor,
                    queue_frame: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """FAM, adjacent-frame alignment (modeling.py:315-323): for i in
    [0, F-2], contrast(pred[:, i], proj_k[:, i+1]) + contrast(pred[:, i+1],
    proj_k[:, i]), summed and divided by F - 1. [B, F, H] each."""
    f = frame_pred.shape[1]
    q = torch.cat([frame_pred[:, :-1], frame_pred[:, 1:]], dim=1)
    k = torch.cat([frame_proj_k[:, 1:], frame_proj_k[:, :-1]], dim=1)
    per_pair = _moco_rows(q.transpose(0, 1), k.transpose(0, 1), queue_frame,
                          temperature).mean(dim=-1)          # [2(F-1)]
    return per_pair.sum() / (f - 1)


def frame_cross_loss(frame_fea: torch.Tensor, frame_fea_k: torch.Tensor,
                     queue_frame: torch.Tensor, text_fea: torch.Tensor,
                     text_fea_k: torch.Tensor, queue_text: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """FTM, per-frame text <-> frame contrast (modeling.py:325-332): for each
    frame i, contrast(text, frame_k[:, i], queue_frame) + contrast(frame[:,
    i], text_k, queue_text), summed over frames and divided by F."""
    f = frame_fea.shape[1]
    t2f = _moco_rows(text_fea.unsqueeze(0).expand(f, -1, -1),
                     frame_fea_k.transpose(0, 1), queue_frame, temperature)
    f2t = _moco_rows(frame_fea.transpose(0, 1),
                     text_fea_k.unsqueeze(0).expand(f, -1, -1), queue_text,
                     temperature)
    return (t2f.mean(dim=-1).sum() + f2t.mean(dim=-1).sum()) / f
