"""Offline retrieval over a feature bank written by ``--do_extract``
(counterpart of ``tools/retrieve.py``; numpy only).

Composes the similarity as eval_epoch's phase 2 does
(main_task_retrieval.py:443-519): ``loose_similarity(q, v)`` plus the
top-k-frame logits when the bank was extracted with ``--use_frame_fea``,
then prints the top-k video ids per query, or with ``--metrics`` the rank
metrics, which reproduce ``--do_eval`` from the bank alone.

  python -m hmmc_tpu_torch.retrieve --features out/features.npz --topk 5
  python -m hmmc_tpu_torch.retrieve --features out/features.npz --metrics
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

from hmmc_tpu_torch.metrics import logging_rank
from hmmc_tpu_torch.ops.quant import dequantize_bank


def _norm(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def similarity_from_bank(bank) -> np.ndarray:
    """[Q, V] logits from a features.npz bank (loose_similarity + the
    optional top-k frame logits, modeling.py:207-229 +
    main_task_retrieval.py:332-336). An int8 bank (``--quantize_bank
    int8``) is dequantized first, so quantized and float banks rank alike
    up to the quantization error."""
    bank = dequantize_bank(bank)
    scale = float(bank["logit_scale"])
    sim = scale * (_norm(bank["query"]) @ _norm(bank["video"]).T)
    if bool(bank.get("use_frame_fea", False)):
        fn = _norm(bank["frames"])                       # [V, F, H]
        fl = scale * np.einsum("qh,vfh->qvf", _norm(bank["query"]), fn)
        k = min(int(bank["top_frames"]), fl.shape[-1])
        top = np.sort(fl, axis=-1)[..., -k:]
        sim = sim + top.mean(axis=-1)
    if "title" in bank:
        # retrieval_VT: mix in query-vs-title similarity
        # (main_task_retrieval.py:516-518)
        sim_title = scale * (_norm(bank["query"]) @ _norm(bank["title"]).T)
        sim = sim + float(bank.get("weight_title", 0.5)) * sim_title
    return sim


def bank_metrics(bank) -> dict:
    """R@1/5/10, MedR and MeanR (t2v and v2t) of a bank, as ``--do_eval``
    computes them."""
    multi = bool(bank.get("multi_sentence", False))
    cut_off = [int(c) for c in bank.get("cut_off_points", [])]
    return logging_rank(similarity_from_bank(bank), multi, cut_off,
                        logging.getLogger("retrieve"))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--features", required=True)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--metrics", action="store_true",
                   help="print rank metrics instead of per-query top-k")
    args = p.parse_args(argv)

    bank = dict(np.load(args.features, allow_pickle=False))
    if args.metrics:
        print(json.dumps({k: float(v) for k, v in
                          bank_metrics(bank).items()}))
        return
    sim = similarity_from_bank(bank)
    ids = bank.get("video_ids")
    order = np.argsort(-sim, axis=1)[:, :args.topk]
    for qi, row in enumerate(order):
        hits = [str(ids[v]) if ids is not None else int(v) for v in row]
        scores = [round(float(sim[qi, v]), 3) for v in row]
        print(json.dumps({"query": qi, "topk": hits, "scores": scores}))


if __name__ == "__main__":
    main()
