"""Text -> video retrieval service over a ``--do_extract`` feature bank
(counterpart of ``tools/serve.py``).

Loads a checkpoint and a bank, keeps the text tower resident on the card,
and answers queries over HTTP:

  POST /search   {"text": "a dog catches a frisbee", "topk": 5}
      -> {"results": [{"video_id": ..., "score": ...}, ...],
          "latency_ms": ...}
  GET  /healthz  -> {"ok": true, "videos": N}

The video side is the bank; each query is one tokenize, one text-tower
forward at batch 1 (K1 at the causal text site in every layer) and the
ranking. Host ranking (the default) is numpy on the dequantized,
normalized bank, composed as :func:`hmmc_tpu_torch.retrieve.
similarity_from_bank` composes it (loose similarity, the mean of the
top-k frame logits, the title term), so a served top-k never disagrees
with offline retrieval. ``--device_rank`` keeps the normalized bank on
the card as int8 with per-row scales and ranks there
(:func:`hmmc_tpu_torch.ops.quant.int8_rank` / ``int8_frame_rank``) with an
exact ``torch.topk``, where the JAX package takes ``lax.approx_max_k``
(exact on its CPU path, approximate on a TPU).

``ThreadingHTTPServer`` answers each request on its own thread; one lock
holds the encode and the rank, so the kernels' launch counters and the
one CUDA stream see one query at a time.

  python -m hmmc_tpu_torch.serve --features out/features.npz \\
      --language english --use_temp --use_frame_fea [--init_model CKPT] \\
      [--clip_model ViT-B-32.pt] [--device_rank] [--port 8765]

It runs on the current CUDA device and raises without one;
``RetrievalService(args, device="cpu")`` runs it on the CPU (the tests).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

from hmmc_tpu_torch.cli import get_args, make_tokenizer, to_task_config
from hmmc_tpu_torch.config import ClipArch, load_cross_config
from hmmc_tpu_torch.data.text import encode_text
from hmmc_tpu_torch.factory import build_model, resolve_device
from hmmc_tpu_torch.ops import quant
from hmmc_tpu_torch.retrieve import _norm


class RetrievalService:
    def __init__(self, args, device=None):
        task = to_task_config(args)
        cross = load_cross_config(task.cross_model)
        if not task.image_resolution:
            task = task.replace(image_resolution=ClipArch.by_name(
                cross.pretrained_clip_name).image_resolution)
        self.task = task
        self.device = resolve_device(device)
        self.tokenizer = make_tokenizer(task)
        self.model = build_model(task, cross, device=self.device,
                                 init_model_path=task.init_model,
                                 clip_model_path=task.clip_model)
        # an int8 bank (--quantize_bank int8) is dequantized at load: host
        # ranking is fp32 numpy
        bank = quant.dequantize_bank(dict(np.load(args.features,
                                                  allow_pickle=False)))
        self.scale = float(bank["logit_scale"])
        self.video = _norm(bank["video"].astype(np.float32))
        self.video_ids = ([str(v) for v in bank["video_ids"]]
                          if "video_ids" in bank
                          else [str(i) for i in range(len(self.video))])
        self.frames = None
        self.top_frames = 0
        if bool(bank.get("use_frame_fea", False)) and "frames" in bank:
            self.frames = _norm(bank["frames"].astype(np.float32))  # [V,F,H]
            self.top_frames = min(int(bank["top_frames"]),
                                  self.frames.shape[1])
        self.title = None
        self.weight_title = 0.0
        if "title" in bank:
            self.title = _norm(bank["title"].astype(np.float32))
            self.weight_title = float(bank.get("weight_title", 0.5))
        self._lock = threading.Lock()
        self._bank_dev = None
        if getattr(args, "device_rank", False):
            self._bank_dev = {
                name: tuple(torch.from_numpy(a).to(self.device)
                            for a in quant.quantize_rows_np(arr))
                for name, arr in (("video", self.video),
                                  ("frames", self.frames),
                                  ("title", self.title)) if arr is not None}
        # the first query pays the one-time costs (kernel build and load)
        self.search("warmup query")

    def score(self, q: np.ndarray) -> np.ndarray:
        """[V] logits for one normalized query vector, composed as
        ``similarity_from_bank`` composes the whole bank's."""
        sim = self.scale * (self.video @ q)
        if self.frames is not None:
            # mean of the top-k frame logits per video
            # (main_task_retrieval.py:332-336)
            fl = self.scale * (self.frames @ q)          # [V, F]
            top = np.sort(fl, axis=-1)[:, -self.top_frames:]
            sim = sim + top.mean(axis=-1)
        if self.title is not None:
            sim = sim + self.weight_title * self.scale * (self.title @ q)
        return sim

    def rank_on_device(self, q: torch.Tensor, topk: int):
        """The same composition on the card over the int8 bank; exact
        top-k. ``q``: normalized [1, H] -> (scores [k], indices [k])."""
        bank = self._bank_dev
        sim = self.scale * quant.int8_rank(q, *bank["video"])
        if "frames" in bank:
            fl = self.scale * quant.int8_frame_rank(q, *bank["frames"])
            sim = sim + fl.topk(self.top_frames, dim=-1).values.mean(-1)
        if "title" in bank:
            sim = sim + self.weight_title * self.scale * quant.int8_rank(
                q, *bank["title"])
        scores, idx = torch.topk(sim[0], min(topk, sim.shape[-1]))
        return scores.cpu().numpy(), idx.cpu().numpy()

    def search(self, text: str, topk: int = 5):
        t0 = time.perf_counter()
        ids, _ = encode_text(self.tokenizer, text, self.task.max_words,
                             self.task.language)
        with self._lock, torch.inference_mode():
            q = self.model.encode_text(
                torch.from_numpy(ids[None]).long().to(self.device))
            q = q / q.norm(dim=-1, keepdim=True)
            if self._bank_dev is not None:
                scores, order = self.rank_on_device(q, int(topk))
            else:
                sim = self.score(q[0].cpu().numpy())
                order = np.argsort(-sim)[:topk]
                scores = sim[order]
        latency = (time.perf_counter() - t0) * 1e3
        return {
            "results": [{"video_id": self.video_ids[i],
                         "score": round(float(s), 4)}
                        for i, s in zip(order, scores)],
            "latency_ms": round(latency, 2),
        }


def make_server(service: RetrievalService, port: int):
    """The HTTP server on 127.0.0.1 (port 0: any free port; the bound one is
    ``httpd.server_address[1]``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "videos": len(service.video_ids)})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/search":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                out = service.search(str(req["text"]),
                                     int(req.get("topk", 5)))
                self._reply(200, out)
            except Exception as e:  # a bad request: answer it, keep serving
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve(service: RetrievalService, port: int):
    httpd = make_server(service, port)
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]} "
          f"({len(service.video_ids)} videos)", flush=True)
    httpd.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--features", required=True)
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--device_rank", action="store_true",
                   help="rank on the card over the int8 bank (exact top-k)")
    known, rest = p.parse_known_args(argv)
    # the model flags are the CLI's; nothing is written to --output_dir
    if "--output_dir" not in rest:
        rest += ["--output_dir", os.path.dirname(
            os.path.abspath(known.features))]
    args = get_args("HMMC retrieval server (PyTorch port)",
                    argv=rest + ["--do_eval"])
    args.features = known.features
    args.device_rank = known.device_rank
    serve(RetrievalService(args), known.port)


if __name__ == "__main__":
    main()
