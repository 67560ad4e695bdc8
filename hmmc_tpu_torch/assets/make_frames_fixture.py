#!/usr/bin/env python3
"""Write ``frames_fixture.npz`` beside this file: image-like synthetic
frames as JPEG blobs with their PIL decodes, the oracle of the card's
decode path (the card's machine has no JPEG encoder and no PIL).

    python hmmc_tpu_torch/assets/make_frames_fixture.py [--seed 0]

Frames: 8 at 341x256 (the MSR-VTT store geometry: 256 short side) and one
each at 256x341, 640x360 and 160x120, all 4:2:0 as ``hmmc_tpu/data/ingest.py``
stores frames (cv2's default); then one each in the other chroma samplings
libjpeg upsamples its own way: 4:2:2 at 325x243, 4:4:0 at 243x325 and
4:1:1 at 320x240. Smooth gradients, filled shapes with hard colour edges,
and mild noise; encoded with cv2 at JPEG quality 90. Keys:

- ``blob_{i}``: the JPEG bytes (uint8);
- ``rgb_{i}``: PIL's full-resolution RGB decode (``Image.open().convert``);
- ``crop_{i}``: the JAX package's eval decode at 224 (``_decode_eval``:
  PIL bicubic short-side resize, centre crop), written out here so this
  script needs nothing of that package;
- ``sizes``: [n, 2] (width, height);
- ``sampling``: [n] the chroma sampling, "420", "422", "440" or "411".
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np

SIZES = ([(341, 256)] * 8 + [(256, 341), (640, 360), (160, 120)]
         + [(325, 243), (243, 325), (320, 240)])
SAMPLING = ["420"] * 11 + ["422", "440", "411"]
RES = 224


def synthetic_frame(w: int, h: int, rng: np.random.Generator) -> np.ndarray:
    """uint8 [h, w, 3]: a two-axis colour gradient, a few filled circles
    and rectangles, and noise of a few levels."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1, c2 = rng.uniform(0, 255, size=(3, 3))
    img = (c0[None, None] * (x / w)[..., None]
           + c1[None, None] * (y / h)[..., None]
           + c2[None, None] * (1 - x / w)[..., None] * 0.5)
    for _ in range(int(rng.integers(3, 7))):
        colour = rng.uniform(0, 255, size=3)
        if rng.random() < 0.5:
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            r = rng.uniform(0.05, 0.25) * min(w, h)
            inside = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        else:
            x0, y0 = rng.uniform(0, w * 0.8), rng.uniform(0, h * 0.8)
            inside = ((x >= x0) & (x < x0 + rng.uniform(0.1, 0.4) * w)
                      & (y >= y0) & (y < y0 + rng.uniform(0.1, 0.4) * h))
        img[inside] = colour
    img += rng.normal(0, 3, size=img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def pil_eval_crop(rgb: np.ndarray, res: int) -> np.ndarray:
    """``hmmc_tpu.data.datasets._decode_eval`` after the decode."""
    from PIL import Image

    img = Image.fromarray(rgb)
    w, h = img.size
    if w <= h:
        nw, nh = res, max(res, round(h * res / w))
    else:
        nw, nh = max(res, round(w * res / h)), res
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - res) // 2, (nh - res) // 2
    return np.asarray(img.crop((left, top, left + res, top + res)), np.uint8)


def main(argv=None) -> None:
    import cv2
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "frames_fixture.npz"))
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    out = {"sizes": np.asarray(SIZES, np.int32),
           "sampling": np.asarray(SAMPLING)}
    for i, ((w, h), sampling) in enumerate(zip(SIZES, SAMPLING)):
        rgb = synthetic_frame(w, h, rng)
        factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
        ok, enc = cv2.imencode(".jpg", rgb[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            factor])
        assert ok
        blob = enc.tobytes()
        dec = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"),
                         np.uint8)
        out[f"blob_{i}"] = np.frombuffer(blob, np.uint8)
        out[f"rgb_{i}"] = dec
        out[f"crop_{i}"] = pil_eval_crop(dec, RES)
    np.savez_compressed(args.out, **out)
    print(args.out, os.path.getsize(args.out), "bytes")


if __name__ == "__main__":
    main()
