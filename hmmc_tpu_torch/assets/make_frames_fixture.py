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
and mild noise; encoded with cv2 at JPEG quality 90. Then three frames
whose planes are not YCbCr, written by Pillow at quality 90, 4:4:4: an
RGB-coded JPEG (``keep_rgb``: Adobe marker, transform 0) at 300x200, a
CMYK one (Adobe's inverted ink, with a black plane) at 200x300, and a YCCK
one at 257x193 (Y, Cb, Cr and a black plane written as CMYK planes, then
the Adobe transform byte set to 2, which is how libjpeg marks YCCK). Last,
one 4:2:0 frame at 512x512, whose short side halves exactly to 256 (cv2's
integer-factor area path). Keys:

- ``blob_{i}``: the JPEG bytes (uint8);
- ``rgb_{i}``: PIL's full-resolution RGB decode (``Image.open().convert``);
- ``crop_{i}``: the JAX package's eval decode at 224 (``_decode_eval``:
  PIL bicubic short-side resize, centre crop), written out here so this
  script needs nothing of that package;
- ``aug_{i}``: its aug decode at 256 (``_decode_aug``: cv2's decode,
  ``INTER_AREA`` short-side resize, centre crop), written out likewise;
- ``sizes``: [n, 2] (width, height);
- ``sampling``: [n] the chroma sampling, "420", "422", "440", "411" or
  "444";
- ``color``: [n] what the planes hold, "ycc", "rgb", "cmyk" or "ycck".
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np

SIZES = ([(341, 256)] * 8 + [(256, 341), (640, 360), (160, 120)]
         + [(325, 243), (243, 325), (320, 240)])
SAMPLING = ["420"] * 11 + ["422", "440", "411"]
# Pillow-written frames whose planes are not YCbCr
OTHER_COLORS = [("rgb", (300, 200)), ("cmyk", (200, 300)),
                ("ycck", (257, 193))]
# appended last, so the earlier frames' draws and blobs stay as they were
LAST = [("ycc", (512, 512), "420")]
RES = 224
AUG = 256
ADOBE_TRANSFORM_AT = 17     # SOI, APP14 marker and length, "Adobe" + 6


def pillow_jpeg(rgb: np.ndarray, color: str) -> bytes:
    """``rgb`` written as a JPEG whose planes hold ``color``: RGB as coded,
    CMYK (ink with three quarters of its grey moved to black), or YCCK
    (PIL's YCbCr of ``rgb`` and a black plane, stored as CMYK planes and
    marked with Adobe transform 2)."""
    from PIL import Image

    buf = io.BytesIO()
    if color == "rgb":
        Image.fromarray(rgb).save(buf, "JPEG", quality=90, keep_rgb=True)
        return buf.getvalue()
    h, w, _ = rgb.shape
    if color == "cmyk":
        ink = 255 - rgb.astype(np.int32)
        k = ink.min(-1, keepdims=True) * 3 // 4
        image = np.concatenate([ink - k, k], -1)
    else:
        # Pillow writes a CMYK image inverted (Adobe's convention), so the
        # stored planes are 255 - image: Y, Cb, Cr, and a black that
        # darkens the frame by at most 96 levels towards its right edge
        ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"), np.int32)
        black = np.linspace(0, 96, w).astype(np.int32)[None, :, None]
        image = 255 - np.concatenate([ycc, 255 - black.repeat(h, 0)], -1)
    Image.fromarray(image.astype(np.uint8), "CMYK").save(buf, "JPEG",
                                                         quality=90)
    blob = bytearray(buf.getvalue())
    assert blob[6:11] == b"Adobe" and blob[ADOBE_TRANSFORM_AT] == 0
    if color == "ycck":
        blob[ADOBE_TRANSFORM_AT] = 2
    return bytes(blob)


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


def cv2_aug_crop(blob: bytes, size: int) -> np.ndarray:
    """``hmmc_tpu.data.datasets._decode_aug``."""
    import cv2

    bgr = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    h, w = rgb.shape[:2]
    if w <= h:
        nw, nh = size, max(size, round(h * size / w))
    else:
        nw, nh = max(size, round(w * size / h)), size
    rgb = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_AREA)
    top, left = (nh - size) // 2, (nw - size) // 2
    return np.ascontiguousarray(rgb[top:top + size, left:left + size])


def main(argv=None) -> None:
    import cv2
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "frames_fixture.npz"))
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    sizes = SIZES + [s for _, s in OTHER_COLORS] + [s for _, s, _ in LAST]
    colors = (["ycc"] * len(SIZES) + [c for c, _ in OTHER_COLORS]
              + [c for c, _, _ in LAST])
    sampling = (SAMPLING + ["444"] * len(OTHER_COLORS)
                + [f for _, _, f in LAST])
    out = {"sizes": np.asarray(sizes, np.int32),
           "sampling": np.asarray(sampling), "color": np.asarray(colors)}
    for i, ((w, h), color) in enumerate(zip(sizes, colors)):
        rgb = synthetic_frame(w, h, rng)
        if color == "ycc":
            factor = getattr(cv2,
                             f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling[i]}")
            ok, enc = cv2.imencode(".jpg", rgb[..., ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
            assert ok
            blob = enc.tobytes()
        else:
            blob = pillow_jpeg(rgb, color)
        dec = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"),
                         np.uint8)
        out[f"blob_{i}"] = np.frombuffer(blob, np.uint8)
        out[f"rgb_{i}"] = dec
        out[f"crop_{i}"] = pil_eval_crop(dec, RES)
        out[f"aug_{i}"] = cv2_aug_crop(blob, AUG)
    np.savez_compressed(args.out, **out)
    print(args.out, os.path.getsize(args.out), "bytes")


if __name__ == "__main__":
    main()
