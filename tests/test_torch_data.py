"""Port frame-store data path and CLI (hmmc_tpu_torch.data, runner, cli)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed (frames encoded to JPEG by PIL, or
the committed fixture's cv2 JPEGs). What is held to what:
- FramePack files written by either package read in the other, byte for
  byte; the port's reader survives 8 threads reading a cold reader at once;
- ``sample_frame_indices``, the MSR-VTT datasets' items (ids, masks,
  nframes, idx, and the frames once decoded), the CSV rows and
  ``BatchLoader``'s order, shards and skips are equal to the JAX
  package's;
- R1's plain version (``resize_crop_reference``) is bitwise equal to PIL's
  bicubic resize and crop (at 32 and at every tower's resolution: 224,
  288, 336, 384, 448); the port's CPU decode (PIL, then R1's plain
  version) gives the JAX ``FrameSource``'s frames bit for bit;
- the CLI fine-tune from a checkpoint that the JAX package wrote: the
  displayed losses (printed to 4 decimals) within 1e-4 of the JAX run's
  (fp32, the same weights and batches; the train step's own parity is
  1e-4, tests/test_torch_train.py), and the epoch-end rank metrics equal;
  the port's ``pytorch_model.bin.0`` reloads to the same metrics and loads
  in the JAX package with the same keys;
- a ModifiedResNet CLIP file: arch, weights and running statistics in
  both factories, the video encoder on them (1e-4); the CLI fine-tune with
  it, reload, extract (the JAX package's bank from the port's checkpoint
  within 1e-4) and the retrieval service.

The ``gpu`` tests hold R1's kernel to its plain version bitwise and the
nvJPEG decode to the fixture's PIL decodes on the card; they import no JAX
and no PIL (run them with ``pytest --noconftest -m gpu``).
"""

import io
import json
import logging
import os
import re
import threading
import zipfile

import numpy as np
import pytest
import torch

from hmmc_tpu_torch import cli as pcli
from hmmc_tpu_torch import config as pconfig
from hmmc_tpu_torch import runner as prunner
from hmmc_tpu_torch.data import datasets as pds
from hmmc_tpu_torch.data import framepack as pfp
from hmmc_tpu_torch.data import jpeg
from hmmc_tpu_torch.data.loader import BatchLoader
from hmmc_tpu_torch.data.sampling import sample_frame_indices
from hmmc_tpu_torch.ops.resize_crop import (FORMATS, SAMPLING, YccFrame,
                                            output_size, resize_crop,
                                            resize_crop_reference,
                                            ycc_to_rgb_reference)
from hmmc_tpu_torch.testing import aligned_and_odd_layouts
from hmmc_tpu_torch.train import checkpoint as pckpt

try:  # the reference; the card's machine has no JAX and runs the gpu tests
    import hmmc_tpu.config as jconfig
    from hmmc_tpu.data import datasets as jds
    from hmmc_tpu.data import framepack as jfp
    from hmmc_tpu.data import loader as jloader
    from hmmc_tpu.data import sampling as jsampling
except ImportError:
    jconfig = None

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hmmc_tpu_torch", "assets",
    "frames_fixture.npz")
# nvJPEG's planes through R1's libjpeg upsampling and colour conversion
# against PIL (libjpeg) on the fixture: only the IDCTs differ, measured on
# the H100 at most 3 levels, mean 0.04; the limits sit above that
DECODE_MAX_ABS, DECODE_MEAN_ABS = 8, 0.25


@pytest.fixture
def reference(request):
    if jconfig is None:
        pytest.skip("needs hmmc_tpu (the reference)")


def _jpeg(arr, quality=90):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _image(rng, w, h):
    """Smooth gradient + a hard-edged block + noise: image-like."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x + y) * 127 // max(w + h - 2, 1)], -1).astype(np.int32)
    img[h // 4:h // 2, w // 3:2 * w // 3] = rng.integers(0, 256, 3)
    img += rng.integers(-4, 5, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_crop(arr, res):
    from PIL import Image

    img = Image.fromarray(arr)
    nw, nh = output_size(img.size[0], img.size[1], res)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - res) // 2, (nh - res) // 2
    return np.asarray(img.crop((left, top, left + res, top + res)))


def _fixture():
    z = np.load(FIXTURE)
    n = len(z["sizes"])
    return ([z[f"blob_{i}"].tobytes() for i in range(n)],
            [z[f"rgb_{i}"] for i in range(n)],
            [z[f"crop_{i}"] for i in range(n)])


# ---------------------------------------------------------------------------
# R1's plain version against PIL; the fixture
# ---------------------------------------------------------------------------

R1_SWEEP = [(341, 256), (256, 341), (320, 240), (640, 360), (1280, 720),
            (224, 224), (160, 120), (33, 57), (57, 33), (31, 31), (300, 17),
            (17, 300), (225, 224), (224, 500), (35, 1)]


# 336: ViT-L/14@336px; 288, 384, 448: RN50x4, RN50x16, RN50x64
@pytest.mark.parametrize("res", [32, 224, 336, 288, 384, 448])
def test_resize_crop_reference_equals_pil(res):
    rng = np.random.default_rng(res)
    for w, h in R1_SWEEP:
        arr = _image(rng, w, h)
        got = resize_crop_reference(torch.from_numpy(arr)[None], res)[0]
        np.testing.assert_array_equal(got.numpy(), _pil_crop(arr, res),
                                      err_msg=f"{w}x{h} -> {res}")


@pytest.mark.parametrize("w,h,sampling", [
    (64, 48, "420"), (61, 45, "420"), (77, 39, "420"), (341, 256, "420"),
    (255, 171, "420"), (4, 24, "420"), (64, 48, "444"), (37, 29, "444"),
    (64, 48, "422"), (61, 45, "422"), (325, 243, "422"), (4, 24, "422"),
    (64, 48, "440"), (61, 45, "440"), (243, 325, "440"), (64, 48, "411"),
    (77, 39, "411")])
def test_ycc_to_rgb_reference_equals_libjpeg(w, h, sampling):
    """R1's stage 0 against PIL's libjpeg, at every sampling libjpeg
    upsamples its own way (fancy h2v2, h2v1, h1v2; replication for 4:4:4,
    4:1:1 and chroma 2 samples wide). The JPEG (cv2, quality 100) holds
    32x32 blocks of one colour, so every 8x8 block of every component
    decodes flat and the components can be read back exactly: Y from a
    YCbCr decode, each chroma sample at its colour block's centre.
    libjpeg's fancy upsampling still blends at the block edges."""
    import cv2
    from PIL import Image

    rng = np.random.default_rng(w * h)
    cols = rng.integers(0, 256, size=(-(-h // 32), -(-w // 32), 3),
                        dtype=np.uint8)
    rgb = np.repeat(np.repeat(cols, 32, 0), 32, 1)[:h, :w]
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, enc = cv2.imencode(".jpg", rgb[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        factor])
    assert ok
    blob = enc.tobytes()
    ref = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    im = Image.open(io.BytesIO(blob))
    im.draft("YCbCr", im.size)
    ycc = np.asarray(im)
    assert im.mode == "YCbCr"
    hf, vf = {"420": (2, 2), "444": (1, 1), "422": (2, 1), "440": (1, 2),
              "411": (4, 1)}[sampling]
    ry = np.minimum(np.arange(-(-h // vf)) * vf // 32 * 32 + 16, h - 1)
    rx = np.minimum(np.arange(-(-w // hf)) * hf // 32 * 32 + 16, w - 1)
    chroma = ycc[ry][:, rx]
    frame = YccFrame(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        ycc[..., 0], chroma[..., 1], chroma[..., 2])))
    assert frame.fmt == FORMATS[f"ycc{sampling}"]
    np.testing.assert_array_equal(ycc_to_rgb_reference(frame).numpy(), ref)
    gray = YccFrame(torch.from_numpy(np.ascontiguousarray(ycc[..., 0])))
    np.testing.assert_array_equal(
        ycc_to_rgb_reference(gray).numpy(), np.repeat(ycc[..., :1], 3, -1))
    # through R1 (the plain route on the CPU): the same crops as on RGB
    np.testing.assert_array_equal(
        resize_crop([frame], 32)[0].numpy(), _pil_crop(ref, 32))


def test_resize_crop_descriptor_layout():
    """The kernel's descriptor as ``csrc/resize_crop.cu`` reads it: a head
    of 16 words (the plan), 8 words per geometry, then 10 per frame, the
    colour and the fourth plane last; bands shrink only where frames would
    leave CTAs of the persistent grid idle."""
    from hmmc_tpu_torch.ops import resize_crop as rc
    from hmmc_tpu_torch.ops.resize_crop import (COLORS, PADDED, descriptor,
                                                plane_batch)

    rng = np.random.default_rng(2)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, np.uint8))

    k = u8(30, 40)
    frames = [u8(30, 40, 3), None, YccFrame(u8(30, 40), u8(15, 20),
                                            u8(15, 20)),
              YccFrame(u8(30, 40), u8(30, 40), u8(30, 40), k, "cmyk"),
              YccFrame(u8(24, 24), u8(24, 24), u8(24, 24), None, "rgb")]
    batch = plane_batch(frames)
    head, tabs, items, plan = descriptor(batch, 16, torch.device("cpu"))
    words = np.concatenate([head, batch.rows.ravel()])
    assert len(tabs) == 2 and words.shape == (16 + 8 * 2 + 10 * 5,)
    head = words[:16]
    assert list(head[:3]) == [2, 5, 16]
    assert list(head[3:13]) == [plan.strip_ct, plan.n_strips, 1, 1,
                                plan.ring, plan.ring_pitch, plan.rgb_pitch,
                                plan.raw_bytes, plan.rgb_bytes,
                                plan.tile_pitch]
    assert items == 5 * plan.n_strips
    geoms = words[16:32].reshape(2, 8)
    assert geoms[0, 0] == tabs[0].data_ptr()
    assert geoms[0, 1:3].tolist() == [24, 24]
    t = rc.mma_tables(24, 24, 16)
    assert geoms[0, 3:5].tolist() == [t.ks_h, t.ks_v]
    rows = words[32:].reshape(5, 10)
    assert list(rows[:, 3]) == [FORMATS["rgb"], PADDED, FORMATS["ycc420"],
                                FORMATS["ycc444"], FORMATS["ycc444"]]
    assert list(rows[:, 7]) == [0, 0, 2 + 16 * 2, 1 + 16, 1 + 16]
    assert list(rows[:, 8]) == [0, 0, COLORS["ycc"], COLORS["cmyk"],
                                COLORS["rgb"]]
    assert rows[3, 9] == k.data_ptr() and rows[4, 9] == 0
    assert list(rows[:, 2]) == [1, 0, 1, 1, 0]     # geometries by size
    # the table the geometry points to: the bands' heads, then fragments
    np.testing.assert_array_equal(tabs[0].numpy(), t.packed())
    # the shared memory of every region within the plan's sum, and the
    # path's geometry within two CTAs an SM
    assert plan.smem == (2 * plan.raw_bytes + 2 * plan.rgb_bytes
                         + 48 * plan.strip_ct * plan.ring_pitch)
    assert plan.rgb_bytes >= 16 * plan.tile_pitch + 16
    path = rc.plan(((341, 256),), 224, ((FORMATS["ycc420"], False),))
    assert path.strip_ct == 14 and 2 * (path.smem + 1024) <= 228 * 1024
    assert path.ring_pitch % 32 == 16 and path.rgb_pitch % 32 == 16
    assert path.tile_pitch % 32 == 16
    # bands: whole frames when frames fill the grid, else narrower
    assert rc.bands(768, 14, 396) == 14 and rc.bands(3, 14, 396) == 1
    assert rc.bands(100, 14, 396) == 4


def test_resize_area_descriptor_layout_and_copy_dispatch():
    """R2's descriptor as ``csrc/resize_area.cu`` reads it: a head of 16
    words (the plan), 12 words per geometry, 10 per frame (R1's rows). The
    pretrain's 341x256 store frames (and any geometry cv2 copies) take mode
    3, the copy path: the plan holds no RGB planes and no 4-byte sums, only
    stage 0's buffers and the output tile; any other path in the batch
    brings them back."""
    from hmmc_tpu_torch.ops import resize_area as r2
    from hmmc_tpu_torch.ops.resize_crop import plane_batch

    rng = np.random.default_rng(4)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, np.uint8))

    store = [YccFrame(u8(256, 341), u8(128, 171), u8(128, 171)), None,
             u8(341, 256, 3)]
    batch = plane_batch(store)
    head, tabs, items, plan = r2.descriptor(batch, 256, torch.device("cpu"))
    words = np.concatenate([head, batch.rows.ravel()])
    assert [r2.area_tables(341, 256, 256).copy,
            r2.area_tables(256, 341, 256).copy] == [True, True]
    assert words.shape == (16 + 12 * 2 + 10 * 3,)
    assert list(words[:13]) == [2, 3, 256, plan.tile_rows, plan.n_tiles,
                                plan.rows, 0, plan.raw_bytes, 0, 0,
                                plan.tile_pitch, 9, 1]
    # copy tiles of 30 rows: 15 block rows x 33 units of 8 x 2 pixels fill
    # two passes of 256 threads
    assert plan.tile_rows == 30 and items == 3 and plan.rows == 30
    # a batch too small for the persistent grid: bands of fewer tiles
    head, _, items, _ = r2.descriptor(batch, 256, torch.device("cpu"),
                                      lambda smem: 20)
    assert list(head[11:13]) == [2, 5] and items == 15
    geoms = words[16:40].reshape(2, 12)
    assert geoms[:, 7].tolist() == [r2.MODES["copy"]] * 2
    assert geoms[0, 3:7].tolist() == [256, 341, 0, 256]     # (256, 341)
    assert geoms[1, 3:7].tolist() == [341, 256, 42, 298]    # crop at 42
    np.testing.assert_array_equal(
        tabs[1].numpy(), r2.area_tables(341, 256, 256).packed())
    assert plan.smem == 2 * plan.raw_bytes + 30 * plan.tile_pitch + 16
    path = r2.plan(((341, 256),), 256, ((FORMATS["ycc420"], False),))
    assert 2 * (path.smem + 1024) <= 228 * 1024     # two CTAs an SM
    # an area frame beside them: planes and sums come back, tiles shrink
    mixed = plane_batch(store + [u8(360, 640, 3), u8(120, 160, 3)])
    head, tabs, items, plan = r2.descriptor(mixed, 256, torch.device("cpu"))
    words = np.concatenate([head, mixed.rows.ravel()])
    geoms = words[16:16 + 12 * 4].reshape(4, 12)
    assert sorted(geoms[:, 7].tolist()) == sorted(
        [r2.MODES["copy"]] * 2 + [r2.MODES["area"], r2.MODES["linear"]])
    assert plan.rgb_bytes > 0 and plan.tmp_bytes == 12 * plan.rows * 256
    assert plan.smem <= r2.SMEM_LIMIT and items == 5
    assert list(words[-20:-10][[3, 8]]) == [FORMATS["rgb"], 0]


R1_LIMB_SIZES = [(341, 256), (1280, 720), (160, 120), (161, 121)]


def _limbs_signed(limb_bytes):
    """uint8 [3, ...] limbs as their values: the third is signed."""
    out = limb_bytes.astype(np.int64)
    out[2] = limb_bytes[2].view(np.int8)
    return out


@pytest.mark.parametrize("w,h", R1_LIMB_SIZES)
def test_resize_crop_limb_tables_equal_reference(w, h):
    """R1's tensor-core passes, read back from the fragments the kernel
    loads (byte limbs, lane layout of mma.m16n8k32), multiplied in numpy
    int64 and recombined as S0 + 2^8 S1 + 2^16 S2 + 2^21, equal
    resize_crop_reference (Pillow's taps) bit for bit; every limb sum and
    every recombined sum fits in int32, as the kernel's do."""
    from hmmc_tpu_torch.ops.resize_crop import mma_tables

    res = 224
    t = mma_tables(w, h, res)
    ah, av = t.fragments()
    n_t, ks_h = ah.shape[:2]
    ks_v = av.shape[1]

    def bands(frags):
        # lane = 4 g + t; word 2 kw + mw holds row g + 8 mw, k = 32 s +
        # 16 kw + 4 t + byte
        n, ks = frags.shape[:2]
        a = frags.view(np.uint8).reshape(n, ks, 3, 8, 4, 2, 2, 4)
        return _limbs_signed(a.transpose(2, 0, 6, 3, 1, 5, 4, 7).reshape(
            3, n, 16, 32 * ks))

    a_h, a_v = bands(ah), bands(av)
    scale = np.array([1, 1 << 8, 1 << 16], np.int64)
    # the limbs recombine into the dense bands
    np.testing.assert_array_equal(np.einsum("l,lijk->ijk", scale, a_h),
                                  t.band_h)
    np.testing.assert_array_equal(np.einsum("l,lijk->ijk", scale, a_v),
                                  t.band_v)

    def finish(s):                      # s: [3 limbs, ...] int64 sums
        assert np.abs(s).max() < 2 ** 31
        v = np.einsum("l,l...->...", scale, s) + (1 << 21)
        assert np.abs(v).max() < 2 ** 31
        return np.clip(v >> 22, 0, 255)

    rng = np.random.default_rng(w * h)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    k_h, k_v = 32 * ks_h, 32 * ks_v
    src = np.zeros((h, w + k_h, 3), np.int64)
    src[:, :w] = img
    tmp = np.zeros((h + k_v, 16 * n_t, 3), np.int64)
    for j in range(n_t):                # A = the tap band, B = the pixels
        x = src[:, t.kb_h[j]:t.kb_h[j] + k_h]                # [h, K, 3]
        tmp[:h, 16 * j:16 * j + 16] = finish(np.einsum("lmk,hkc->lhmc",
                                                       a_h[:, j], x))
    out = np.zeros((16 * n_t, 16 * n_t, 3), np.int64)
    for i in range(n_t):
        y = tmp[t.kb_v[i]:t.kb_v[i] + k_v]                   # [K, cols, 3]
        out[16 * i:16 * i + 16] = finish(np.einsum("lmk,knc->lmnc",
                                                   a_v[:, i], y))
    ref = resize_crop_reference(torch.from_numpy(img)[None], res)[0]
    np.testing.assert_array_equal(out[:res, :res], ref.numpy())


def test_resize_crop_batches_sizes_and_padded_slots():
    rng = np.random.default_rng(1)
    arrs = [_image(rng, w, h) for w, h in ((40, 30), (30, 40), (64, 64))]
    frames = [torch.from_numpy(a) for a in arrs]
    out = resize_crop([frames[0], None, frames[1], frames[2], None], 32)
    assert out.shape == (5, 32, 32, 3) and out.dtype == torch.uint8
    for i, a in zip((0, 2, 3), arrs):
        np.testing.assert_array_equal(out[i].numpy(), _pil_crop(a, 32))
    assert int(out[[1, 4]].sum()) == 0
    with pytest.raises(TypeError, match="uint8"):
        resize_crop([frames[0].float()], 32)


def test_fixture_holds_pil_decodes_and_jax_crops(reference):
    from PIL import Image

    blobs, rgb, crops = _fixture()
    assert os.path.getsize(FIXTURE) <= 8 * 2 ** 20 and len(blobs) == 18
    assert [jpeg.parse_header(b).color for b in blobs] == list(
        np.load(FIXTURE)["color"])
    for b, r, c in zip(blobs, rgb, crops):
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(b)).convert("RGB")), r)
        np.testing.assert_array_equal(jds._decode_eval(b, 224), c)
    np.testing.assert_array_equal(
        jpeg.decode_frames(blobs, 224, "cpu").numpy(), np.stack(crops))
    # at 336 (ViT-L/14@336px: the store's frames up-scaled) the CPU decode,
    # PIL's and R1's plain version, is the JAX package's eval decode
    np.testing.assert_array_equal(
        jpeg.decode_frames(blobs, 336, "cpu").numpy(),
        np.stack([jds._decode_eval(b, 336) for b in blobs]))


def _with_segment(blob, marker, payload):
    """``blob`` with a marker segment inserted after its SOI."""
    seg = bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big")
    return blob[:2] + seg + payload + blob[2:]


def _without_app14(blob):
    assert blob[2:4] == b"\xff\xee"        # Pillow writes APP14 first
    return blob[:2] + blob[4 + int.from_bytes(blob[4:6], "big"):]


def _with_transform(blob, t):
    assert blob[6:11] == b"Adobe"
    return blob[:17] + bytes([t]) + blob[18:]


def _with_ids(blob, ids):
    """The component ids renamed in the frame header and in the scan's."""
    out = bytearray(blob)
    sof, sos = out.index(b"\xff\xc0"), out.index(b"\xff\xda")
    for c, cid in enumerate(ids):
        out[sof + 10 + 3 * c] = out[sos + 5 + 2 * c] = cid
    return bytes(out)


def test_jpeg_header_colour_and_plain_conversion_equal_pil():
    """C1: what the planes hold, read from the header as libjpeg reads it,
    and R1's plain stage 0 on the planes as coded, against PIL's decode of
    the same blob. Pillow writes an RGB-coded (``keep_rgb``) and a CMYK
    JPEG; the variants patch their headers (Adobe transform, JFIF, the
    component ids). The planes as coded come from PIL's decode of the
    blob read without conversion (RGB-coded, or CMYK read inverted)."""
    from PIL import Image

    rng = np.random.default_rng(9)
    arr = _image(rng, 61, 45)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=90, keep_rgb=True)
    rgb_coded = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([255 - arr, arr[..., :1]], -1),
                    "CMYK").save(buf, "JPEG", quality=90)
    cmyk = buf.getvalue()
    jfif = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    three = np.asarray(Image.open(io.BytesIO(rgb_coded)))
    four = 255 - np.asarray(Image.open(io.BytesIO(cmyk)))
    cases = [(rgb_coded, "rgb"), (_with_transform(rgb_coded, 1), "ycc"),
             (_without_app14(rgb_coded), "rgb"),
             (_with_ids(_without_app14(rgb_coded), (1, 2, 3)), "ycc"),
             (_with_segment(rgb_coded, 0xE0, jfif), "ycc"),
             (cmyk, "cmyk"), (_with_transform(cmyk, 2), "ycck"),
             (_with_transform(cmyk, 1), "ycck"),
             (_without_app14(cmyk), "cmyk")]
    for blob, color in cases:
        head = jpeg.parse_header(blob)
        assert head.color == color, (head, color)
        planes = three if len(head.components) == 3 else four
        t = [torch.from_numpy(np.ascontiguousarray(planes[..., c]))
             for c in range(planes.shape[-1])]
        frame = YccFrame(*t[:3], t[3] if len(t) == 4 else None, color)
        pil = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        np.testing.assert_array_equal(ycc_to_rgb_reference(frame).numpy(),
                                      pil, err_msg=color)
        np.testing.assert_array_equal(
            jpeg.decode_frames([blob], 32, "cpu")[0].numpy(),
            _pil_crop(pil, 32))
    assert jpeg.parse_header(b"not a jpeg") is None
    assert jpeg.parse_header(rgb_coded[:20]) is None


def test_decompression_bomb_frame_zero_filled_in_both(reference, caplog,
                                                      monkeypatch):
    """C2: a frame PIL refuses as a decompression bomb is zero-filled,
    warned and counted, as the JAX package's ``_decode_eval`` does."""
    from PIL import Image

    good = _jpeg(_image(np.random.default_rng(3), 40, 30))
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 100)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(good))
    before = jpeg.decode_frames.decode_failures
    with caplog.at_level(logging.WARNING):
        out = jpeg.decode_frames([good, None], 32, "cpu")
        ref = jds._decode_eval(good, 32)
    assert int(out.sum()) == 0 and int(np.abs(ref).sum()) == 0
    assert jpeg.decode_frames.decode_failures == before + 1
    assert caplog.text.count("corrupt JPEG frame (zero-filled)") == 2


def test_corrupt_blob_zero_filled_with_warning_in_both(reference, caplog):
    good = _fixture()[0][0]
    before = jpeg.decode_frames.decode_failures
    with caplog.at_level(logging.WARNING):
        out = jpeg.decode_frames([good, b"\xff\xd8 not a jpeg"], 32, "cpu")
        ref = jds._decode_eval(b"\xff\xd8 not a jpeg", 32)
    assert int(out[1].sum()) == 0 and int(np.abs(ref).sum()) == 0
    np.testing.assert_array_equal(out[0].numpy(), jds._decode_eval(good, 32))
    assert jpeg.decode_frames.decode_failures == before + 1
    assert caplog.text.count("corrupt JPEG frame (zero-filled)") == 2


# ---------------------------------------------------------------------------
# FramePack and sampling
# ---------------------------------------------------------------------------

def _blob_videos(rng, n_videos=5, frames=4):
    return {f"video{i}": [rng.bytes(int(rng.integers(1, 300)))
                          for _ in range(frames)] for i in range(n_videos)}


def test_framepack_files_cross_read(reference, tmp_path):
    rng = np.random.default_rng(2)
    videos = _blob_videos(rng)
    for writer, reader in ((pfp.FramePackWriter, jfp.FramePackReader),
                           (jfp.FramePackWriter, pfp.FramePackReader)):
        path = str(tmp_path / f"{writer.__module__}.fpk")
        with writer(path) as w:
            for vid, blobs in videos.items():
                w.add_video(vid, blobs)
            w.set_metadata(num_frames=4, source="test")
        r = reader(path)
        assert sorted(r.video_ids()) == sorted(videos)
        assert r.metadata == {"num_frames": 4, "source": "test"}
        for vid, blobs in videos.items():
            assert r.num_frames(vid) == len(blobs)
            assert [bytes(b) for b in r.get_frames(vid, [3, 0, 2])] == \
                [blobs[3], blobs[0], blobs[2]]
            assert bytes(r.get_frame(vid, 1)) == blobs[1]
        r.close()
    a, b = (open(str(tmp_path / f"{w.__module__}.fpk"), "rb").read()
            for w in (pfp.FramePackWriter, jfp.FramePackWriter))
    assert a == b


def test_framepack_cold_reads_from_8_threads(tmp_path):
    """The first map of a reader, raced by 8 threads, 50 times over (with
    a short switch interval, so the threads interleave inside it)."""
    import sys

    rng = np.random.default_rng(3)
    videos = _blob_videos(rng, n_videos=16, frames=6)
    path = str(tmp_path / "f.fpk")
    with pfp.FramePackWriter(path) as w:
        for vid, blobs in videos.items():
            w.add_video(vid, blobs)
    errors, done = [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(50):
            reader = pfp.FramePackReader(path)
            start = threading.Barrier(8)

            def read():
                try:
                    start.wait(timeout=30)
                    for vid, blobs in videos.items():
                        got = [bytes(b)
                               for b in reader.get_frames(vid, range(6))]
                        assert got == blobs
                    done.append(1)
                except Exception as e:       # collected, raised below
                    errors.append(e)

            threads = [threading.Thread(target=read) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            reader.close()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert len(done) == 50 * 8


def test_open_frame_store_refuses_other_stores(tmp_path):
    path = tmp_path / "lmdb"
    path.mkdir()
    with pytest.raises(ValueError, match="LMDB"):
        pfp.open_frame_store(str(path))


@pytest.mark.parametrize("strategy", ["uniform", "random", "uniform_random"])
def test_sample_frame_indices_equal(reference, strategy):
    for stored in (1, 3, 12, 30, 48):
        for want in (1, 5, 12, 40):
            for seed in (0, 7):
                got = sample_frame_indices(stored, want, strategy,
                                           np.random.default_rng(seed))
                ref = jsampling.sample_frame_indices(
                    stored, want, strategy, np.random.default_rng(seed))
                np.testing.assert_array_equal(got, ref)
                assert got.dtype == ref.dtype


# ---------------------------------------------------------------------------
# FrameSource, datasets, CSV, loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    """Six videos of 5 stored fixture JPEGs (varied sizes), a 6-row test
    CSV with awkward sentences, a 4-video train CSV, 2 captions each."""
    root = tmp_path_factory.mktemp("msrvtt_data")
    blobs = _fixture()[0]
    vids = [f"video{7010 + i}" for i in range(6)]
    with pfp.FramePackWriter(str(root / "frames.fpk")) as w:
        for i, vid in enumerate(vids):
            w.add_video(vid, [blobs[(i + j) % len(blobs)] for j in range(5)])
    m = root / "msrvtt"
    m.mkdir()
    sentences = ['a man, "quoted", sings', "123", "ünïcödé café",
                 "two  spaces", "1.5e3", "a dog runs"]
    with open(m / "MSRVTT_JSFUSION_test.1k.csv", "w", newline="") as f:
        import csv

        wr = csv.writer(f)
        wr.writerow(["key", "vid_key", "video_id", "sentence"])
        for i, (vid, s) in enumerate(zip(vids, sentences)):
            wr.writerow([f"ret{i}", f"msr{7010 + i}", vid, s])
    (m / "MSRVTT_train.9k.csv").write_text(
        "video_id\n" + "\n".join(vids[:4]) + "\n")
    (m / "MSRVTT_data.json").write_text(json.dumps({"sentences": [
        {"video_id": v, "caption": f"clip {v} caption {j}"}
        for v in vids for j in range(2)]}))
    return str(root)


def test_csv_rows_match_pandas(reference, msrvtt_root):
    import pandas as pd

    path = os.path.join(msrvtt_root, "msrvtt", "MSRVTT_JSFUSION_test.1k.csv")
    rows, df = pds.read_csv(path), pd.read_csv(path)
    assert list(rows[0]) == list(df.columns)
    for col in df.columns:       # pandas keeps these columns as strings
        assert all(isinstance(v, str) for v in df[col])
        assert [r[col] for r in rows] == list(df[col])


@pytest.mark.parametrize("res", [32, 224])
def test_frame_source_frames_equal_jax(reference, msrvtt_root, res):
    store = os.path.join(msrvtt_root, "frames.fpk")
    src = pds.FrameSource(store, resolution=res)
    ref = jds.FrameSource(store, mode="eval", resolution=res,
                          use_native=False)
    for vid in ("video7010", "video7013"):
        assert src.stored_frames(vid) == ref.stored_frames(vid) == 5
        np.testing.assert_array_equal(src.load(vid, [4, 0, 2]),
                                      ref.load(vid, [4, 0, 2]))
    blobs, nframes = pds._get_video(src, "video7012", 3, 5, "uniform", None)
    frames, jn = jds._get_video(ref, "video7012", 3, 5, "uniform", None)
    assert nframes == jn == 3 and blobs[3:] == [None, None]
    np.testing.assert_array_equal(
        jpeg.decode_frames(blobs, res, "cpu").numpy(), frames)


def _tokenizers():
    from hmmc_tpu.tokenization import ClipTokenizer as JaxTok

    from hmmc_tpu_torch.tokenization import ClipTokenizer

    return ClipTokenizer(), JaxTok()


def _assert_items_equal(item, ref, res):
    for k in ("query_ids", "query_mask", "nframes", "idx"):
        np.testing.assert_array_equal(item[k], ref[k])
        assert np.asarray(item[k]).dtype == np.asarray(ref[k]).dtype
    np.testing.assert_array_equal(
        jpeg.decode_frames(item["video_blobs"], res, "cpu").numpy(),
        ref["video"])


def test_msrvtt_datasets_items_equal_jax(reference, msrvtt_root):
    tok, jtok = _tokenizers()
    store = os.path.join(msrvtt_root, "frames.fpk")
    base = os.path.join(msrvtt_root, "msrvtt")
    res, kw = 32, dict(max_words=16, max_frames=6)
    ev = pds.MsrvttEvalDataset(
        pds.FrameSource(store, resolution=res),
        os.path.join(base, "MSRVTT_JSFUSION_test.1k.csv"), tok, **kw)
    jev = jds.MsrvttEvalDataset(
        jds.FrameSource(store, resolution=res, use_native=False),
        os.path.join(base, "MSRVTT_JSFUSION_test.1k.csv"), jtok, **kw)
    assert len(ev) == len(jev) == 6
    for i in range(6):
        _assert_items_equal(ev[i], jev[i], res)
    args = (os.path.join(base, "MSRVTT_train.9k.csv"),
            os.path.join(base, "MSRVTT_data.json"))
    tr = pds.MsrvttTrainDataset(pds.FrameSource(store, resolution=res),
                                *args, tok, **kw, frame_sample="random")
    jtr = jds.MsrvttTrainDataset(
        jds.FrameSource(store, resolution=res, use_native=False), *args,
        jtok, **kw, frame_sample="random")
    assert tr.samples == jtr.samples and len(tr) == 8
    for seed, epoch in ((42, 0), (42, 1), (3, 2)):
        tr.set_epoch(epoch, seed=seed)
        jtr.set_epoch(epoch, seed=seed)
        for i in (0, 5, 7):
            _assert_items_equal(tr[i], jtr[i], res)


class _Indexed:
    """Samples that only say which index they are."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int32(i), "video_blobs": [b"%d" % i, None]}


@pytest.mark.parametrize("shuffle,drop_last,count", [
    (False, False, 1), (True, True, 1), (True, False, 2), (True, True, 2)])
def test_batch_loader_order_shards_and_skips_equal(reference, shuffle,
                                                   drop_last, count):
    for index in range(count):
        for epoch in (0, 3):
            for skip in (0, 1):
                loaders = []
                for cls in (BatchLoader, jloader.BatchLoader):
                    ld = cls(_Indexed(23), batch_size=6, shuffle=shuffle,
                             drop_last=drop_last, num_workers=3, seed=5,
                             process_index=index, process_count=count)
                    ld.set_epoch(epoch)
                    ld.skip_batches(skip)
                    loaders.append(ld)
                got = [b["idx"].tolist() for b in loaders[0]]
                ref = [b["idx"].tolist() for b in loaders[1]]
                assert got == ref and len(loaders[0]) == len(loaders[1])
    batch = next(iter(BatchLoader(_Indexed(4), batch_size=3)))
    assert batch["video_blobs"] == [[b"0", None], [b"1", None], [b"2", None]]


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

TINY_NAME = "ViT-Test/16"
TINY_ARCH = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=64, vocab_size=49408,
    transformer_width=32, transformer_heads=2, transformer_layers=2)
N_VIDEOS, FRAMES_STORED = 12, 4
# torch's FLOP counter over XLA's cost analysis at the tiny geometry,
# measured 0.9616 (XLA adds the elementwise work; the counter takes only
# the matrix products and the convolution)
PARAMS_FLOPS_RATIO = (0.9, 1.0)


@pytest.fixture(scope="module")
def tiny_arch():
    pconfig.CLIP_ARCH[TINY_NAME] = TINY_ARCH
    if jconfig is not None:
        jconfig.CLIP_ARCH[TINY_NAME] = TINY_ARCH
    yield
    pconfig.CLIP_ARCH.pop(TINY_NAME, None)
    if jconfig is not None:
        jconfig.CLIP_ARCH.pop(TINY_NAME, None)


@pytest.fixture(scope="module")
def cli_layout(tmp_path_factory):
    """The MSR-VTT layout of tests/test_cli_smoke.py: 12 videos of 4
    random 40x40 JPEGs, one test sentence and two train captions each; and
    the tiny cross config."""
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    with pfp.FramePackWriter(str(root / "frames.fpk")) as w:
        for i in range(N_VIDEOS):
            w.add_video(f"video{i}", [_jpeg(rng.integers(
                0, 255, size=(40, 40, 3), dtype=np.uint8), quality=75)
                for _ in range(FRAMES_STORED)])
    m = root / "msrvtt"
    m.mkdir()
    vids = [f"video{i}" for i in range(N_VIDEOS)]
    (m / "MSRVTT_JSFUSION_test.1k.csv").write_text(
        "video_id,sentence\n" + "".join(
            f"{v},test sentence {i}\n" for i, v in enumerate(vids)))
    (m / "MSRVTT_train.9k.csv").write_text("video_id\n" + "\n".join(vids))
    (m / "MSRVTT_data.json").write_text(json.dumps({
        "sentences": [{"video_id": v, "caption": f"a clip about {v} "
                       f"number {j}"} for v in vids for j in range(2)]}))
    cross = root / "cross-tiny.json"
    cross.write_text(json.dumps({
        "pretrained_clip_name": TINY_NAME, "temporal_hidden_size": 32,
        "temporal_attention_heads": 2, "temporal_hidden_layers": 2,
        "max_position_embeddings": 8}))
    return str(root), str(cross)


def _argv(data_dir, cross, out, extra=()):
    return ["--output_dir", out, "--data_dir", data_dir,
            "--cross_model", cross, "--dataset", "msrvtt",
            "--language", "english", "--use_temp", "--use_frame_fea",
            "--max_words", "16", "--max_frames", "4", "--batch_size", "8",
            "--batch_size_val", "8", "--epochs", "1",
            "--num_thread_reader", "1", "--n_display", "1",
            "--compute_dtype", "float32", *extra]


LOSS_LINE = re.compile(r"epoch (\d+) step (\d+) lr \S+ loss ([0-9.]+)")


def _losses(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [(int(e), int(s), float(v))
                for e, s, v in LOSS_LINE.findall(f.read())]


@pytest.fixture(scope="module", autouse=True)
def fast_jax_reference():
    """Two changes to how the JAX reference runs in this module, none to
    what it computes: its factory's parameter init is jitted (op by op it
    compiles dozens of small programs), and its runner's Orbax state save,
    which nothing here reads back, is skipped (12 s of serialization on a
    CPU)."""
    try:
        import jax
        import jax.numpy as jnp

        from hmmc_tpu import factory as jfactory
        from hmmc_tpu.train import orbax_io
    except ImportError:     # the card's machine: no JAX, no reference runs
        yield
        return

    def init_variables(model, task, arch, pretrain):
        res = arch.image_resolution
        return jax.jit(model.init)(
            jax.random.PRNGKey(task.seed),
            jnp.zeros((1, task.max_words), jnp.int32),
            jnp.ones((1, task.max_words), jnp.int32),
            jnp.zeros((1, task.max_frames, res, res, 3), jnp.float32))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfactory, "_init_variables", init_variables)
        mp.setattr(orbax_io.CheckpointWriter, "save",
                   lambda self, step, state, meta=None: None)
        yield


def test_cli_finetune_matches_jax_and_reloads(reference, tiny_arch,
                                              cli_layout, tmp_path):
    import jax

    from hmmc_tpu import factory as jfactory
    from hmmc_tpu.cli import get_args as jax_args
    from hmmc_tpu.runner import run_finetune as jax_run_finetune
    from hmmc_tpu.train.checkpoint import load_torch_state_dict
    from hmmc_tpu.train.orbax_io import save_reference_checkpoint

    data_dir, cross = cli_layout
    # one starting point for both: a checkpoint the JAX package writes
    jtask = jconfig.TaskConfig(do_train=True, max_frames=4, max_words=16,
                               compute_dtype="float32")
    _, variables = jfactory.build_model(jtask,
                                        jconfig.load_cross_config(cross))
    init = str(tmp_path / "init.bin")
    save_reference_checkpoint(init, variables["params"])
    extra = ("--do_train", "--init_model", init)

    jax_out = str(tmp_path / "jax")
    jax_metrics = jax_run_finetune(jax_args(argv=_argv(data_dir, cross,
                                                       jax_out, extra)))
    out = str(tmp_path / "port")
    run = prunner.run_finetune(pcli.get_args(argv=_argv(data_dir, cross, out,
                                                        extra)), device="cpu")
    assert jax.default_backend() == "cpu"
    got, ref = _losses(out), _losses(jax_out)
    assert [r[:2] for r in got] == [r[:2] for r in ref] == \
        [(0, 1), (0, 2), (0, 3)]
    assert max(abs(a[2] - b[2]) for a, b in zip(got, ref)) <= 1e-4 + 1e-9
    assert run.best_metrics == jax_metrics and len(run.epoch_metrics) == 1

    saved = os.path.join(out, "pytorch_model.bin.0")
    again = prunner.main(pcli.get_args(argv=_argv(
        data_dir, cross, str(tmp_path / "eval"),
        ("--do_eval", "--init_model", saved))), device="cpu")
    assert again == run.best_metrics
    assert set(load_torch_state_dict(saved)) == set(
        run.state.model.state_dict()) == set(load_torch_state_dict(init))


def test_checkpoint_refuses_torchscript_and_merges_by_name(tmp_path):
    """A TorchScript archive is read (its module's state dict, floats as
    fp32), no longer refused; a pickled dict as before; merge by name."""
    scripted = torch.jit.script(torch.nn.Linear(2, 2).half())
    path = str(tmp_path / "clip.pt")
    scripted.save(path)
    assert zipfile.is_zipfile(path)
    sd = pckpt.load_torch_state_dict(path)
    assert set(sd) == {"weight", "bias"} and sd["weight"].dtype == \
        torch.float32
    assert torch.equal(sd["weight"], scripted.weight.float())
    with pytest.raises(ValueError, match="state dict"):
        torch.save([1], str(tmp_path / "list.pt"))
        pckpt.load_torch_state_dict(str(tmp_path / "list.pt"))
    model = torch.nn.Linear(2, 3)
    sd = pckpt.remap_gamma_beta({"gamma": torch.ones(3, 2),
                                 "extra": torch.zeros(1)})
    pckpt.merge_into(model, sd)
    assert torch.equal(model.weight, torch.ones(3, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        pckpt.merge_into(model, {"bias": torch.zeros(4)})


def test_cli_flags(tmp_path):
    def task(*extra):
        return pcli.to_task_config(pcli.get_args(argv=[
            "--output_dir", str(tmp_path), "--do_eval",
            "--language", "english", *extra]))

    assert task().use_fused_attention == "on"
    assert task("--use_pallas_attention").use_fused_attention == "on"
    assert task("--use_pallas_attention", "off").use_fused_attention == "off"
    assert task("--n_gpu", "4", "--local_rank", "1").dataset == "bird"
    for flag in (["--tp_size", "2"], ["--sp_size", "2"], ["--fused_ema"]):
        with pytest.raises(ValueError, match=flag[0]):
            task(*flag)
    # data parallelism is ported (ROADMAP Queue A 6): the world size is
    # checked when the ranks join (parallel.distributed.init_distributed)
    assert task("--zero_opt").zero_opt
    task("--dp_size", "2", "--dcn_dp_size", "2", "--multihost")
    assert task("--clip_model", "x.pt").clip_model == "x.pt"
    for mode in ("--do_extract", "--do_params"):      # alone, as in JAX
        assert pcli.to_task_config(pcli.get_args(argv=[
            "--output_dir", str(tmp_path), mode, "--language",
            "english"]))
    with pytest.raises(ValueError, match="do_extract"):
        pcli.to_task_config(pcli.get_args(argv=["--output_dir",
                                                str(tmp_path)]))
    with pytest.raises(NotImplementedError, match="--do_pretrain"):
        task("--do_pretrain")
    with pytest.raises(NotImplementedError, match="Queue A"):
        pcli.make_tokenizer(pconfig.TaskConfig(language="chinese"))
    from hmmc_tpu_torch.data.registry import get_factory

    with pytest.raises(NotImplementedError, match="Queue A"):
        get_factory("bird", "train")
    with pytest.raises(NotImplementedError, match="Queue A"):
        get_factory("msrvtt", "pretrain")


# ---------------------------------------------------------------------------
# serving: OpenAI CLIP archives, the feature bank, params, the service
# ---------------------------------------------------------------------------

def _clip_state_dict(arch, seed=0):
    """A seeded state dict under OpenAI CLIP's names at ``arch`` (a
    TINY_ARCH-like dict)."""
    g = np.random.default_rng(seed)
    vw, tw, emb = arch["vision_width"], arch["transformer_width"], \
        arch["embed_dim"]
    patch, grid = arch["vision_patch_size"], (
        arch["image_resolution"] // arch["vision_patch_size"])

    def t(*shape):
        return torch.tensor(g.normal(size=shape).astype(np.float32) * 0.05)

    sd = {"visual.conv1.weight": t(vw, 3, patch, patch),
          "visual.class_embedding": t(vw),
          "visual.positional_embedding": t(grid * grid + 1, vw),
          "visual.proj": t(vw, emb),
          "visual.ln_pre.weight": 1 + t(vw), "visual.ln_pre.bias": t(vw),
          "visual.ln_post.weight": 1 + t(vw), "visual.ln_post.bias": t(vw),
          "token_embedding.weight": t(arch["vocab_size"], tw),
          "positional_embedding": t(arch["context_length"], tw),
          "text_projection": t(tw, emb),
          "ln_final.weight": 1 + t(tw), "ln_final.bias": t(tw),
          "logit_scale": torch.tensor(np.float32(3.5))}
    for tower, n, w in (("visual.transformer", arch["vision_layers"], vw),
                        ("transformer", arch["transformer_layers"], tw)):
        for i in range(n):
            b = f"{tower}.resblocks.{i}"
            sd.update({
                f"{b}.attn.in_proj_weight": t(3 * w, w),
                f"{b}.attn.in_proj_bias": t(3 * w),
                f"{b}.attn.out_proj.weight": t(w, w),
                f"{b}.attn.out_proj.bias": t(w),
                f"{b}.ln_1.weight": 1 + t(w), f"{b}.ln_1.bias": t(w),
                f"{b}.ln_2.weight": 1 + t(w), f"{b}.ln_2.bias": t(w),
                f"{b}.mlp.c_fc.weight": t(4 * w, w),
                f"{b}.mlp.c_fc.bias": t(4 * w),
                f"{b}.mlp.c_proj.weight": t(w, 4 * w),
                f"{b}.mlp.c_proj.bias": t(w)})
    return sd


def _save_torchscript(sd, path):
    """``sd`` as OpenAI ships CLIP: a scripted module (here a container
    whose parameters carry CLIP's names), fp16, ``torch.jit.save``."""
    root = torch.nn.Module()
    for k, v in sd.items():
        *path_, name = k.split(".")
        m = root
        for part in path_:
            if not hasattr(m, part):
                m.add_module(part, torch.nn.Module())
            m = getattr(m, part)
        m.register_parameter(name, torch.nn.Parameter(
            v.half(), requires_grad=False))
    torch.jit.save(torch.jit.script(root), path)


# a CLIP file's arch is read from its shapes, heads as width // 64
CLIP_TEST_ARCH = dict(TINY_ARCH, vision_width=64, transformer_width=64,
                      transformer_heads=1, context_length=16,
                      vocab_size=512)


def test_clip_archive_both_forms_match_jax(reference, tmp_path):
    """--clip_model: one seeded CLIP state dict in fp16, as OpenAI ships
    it, saved as a TorchScript archive and as a torch.save dict, each fed
    to the JAX factory and to the port's. The arch read from the shapes
    and the overlaid weights agree; the encoders (fp32, 1e-4) are compared
    on the first form, and the second gives both packages the same
    models. Then a ModifiedResNet file: the arch, its weights and
    BatchNorm running statistics in both packages, and the video encoder
    on them (1e-4)."""
    import dataclasses

    from hmmc_tpu import factory as jfactory

    from hmmc_tpu_torch import factory as pfactory
    from hmmc_tpu_torch.weights import from_jax_params

    # the dict as OpenAI ships it, fp16, saved in both forms
    sd = {k: v.half() for k, v in _clip_state_dict(CLIP_TEST_ARCH).items()}
    cross = pconfig.CrossConfig(temporal_hidden_size=32,
                                temporal_attention_heads=2,
                                temporal_hidden_layers=2,
                                max_position_embeddings=8)
    jcross = jconfig.CrossConfig(**dataclasses.asdict(cross))
    task = pconfig.TaskConfig(max_frames=4, max_words=16,
                              compute_dtype="float32")
    jtask = jconfig.TaskConfig(do_eval=True, language="english",
                               max_frames=4, max_words=16,
                               compute_dtype="float32")
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 500, size=(3, 16)).astype(np.int32)
    ids[:, 9], ids[:, 10:] = CLIP_TEST_ARCH["vocab_size"] - 1, 0
    video = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    expected = {k: v.float() for k, v in sd.items()}
    first = None
    for form in ("torchscript", "state_dict"):
        path = str(tmp_path / f"ViT-Tiny.{form}.pt")
        if form == "torchscript":
            _save_torchscript(sd, path)
        else:
            torch.save(sd, path)
        loaded = pckpt.load_torch_state_dict(path)
        assert all(torch.equal(loaded[k], v) for k, v in expected.items())
        arch = pconfig.ClipArch.from_state_dict(loaded)
        assert dataclasses.asdict(arch) == dataclasses.asdict(
            jconfig.ClipArch.from_state_dict(loaded))
        assert arch == pconfig.ClipArch(**CLIP_TEST_ARCH)
        jmodel, variables = jfactory.build_model(jtask, jcross,
                                                 clip_model_path=path)
        model = pfactory.build_model(task, cross, device="cpu",
                                     clip_model_path=path)
        jsd = from_jax_params(variables["params"])
        own = model.state_dict()
        clip_keys = pckpt.clip_to_port(expected, "english")
        assert len(clip_keys) == len(sd) and set(clip_keys) < set(own)
        for k, v in clip_keys.items():
            assert torch.equal(own[k], v.reshape(own[k].shape)), k
            np.testing.assert_allclose(jsd[k].numpy(), own[k].numpy(),
                                       atol=1e-7, err_msg=k)
        # the temporal tower is seeded in each package its own way: give
        # the port JAX's draw of what the CLIP file lacks
        model.load_state_dict({k: v for k, v in jsd.items()
                               if k not in clip_keys}, strict=False)
        if first is not None:
            # the same weights from the other form: the same models
            assert all(torch.equal(first[0][k], v)
                       for k, v in model.state_dict().items())
            assert all(torch.equal(first[1][k], v) for k, v in jsd.items())
            continue
        first = (model.state_dict(), jsd)
        with torch.no_grad():
            q = model.encode_text(torch.from_numpy(ids).long()).numpy()
            v, f = (t.numpy() for t in model.encode_video(
                torch.from_numpy(video)))
        jq = jmodel.apply(variables, ids, (ids > 0).astype(np.int32),
                          method="encode_text")
        jv, jf = jmodel.apply(variables, video, method="encode_video")
        np.testing.assert_allclose(q, np.asarray(jq), atol=1e-4)
        np.testing.assert_allclose(v, np.asarray(jv), atol=1e-4)
        np.testing.assert_allclose(f, np.asarray(jf), atol=1e-4)
    # a ModifiedResNet file (OpenAI's RN names, running statistics and
    # num_batches_tracked included), as a torch.save dict in fp16
    rn = _rn_clip_state_dict(CLIP_TEST_RN_ARCH, sd)
    path = str(tmp_path / "RN-Tiny.pt")
    torch.save(rn, path)
    arch = pconfig.ClipArch.from_state_dict(rn)
    assert arch == pconfig.ClipArch(**CLIP_TEST_RN_ARCH)
    assert dataclasses.asdict(arch) == dataclasses.asdict(
        jconfig.ClipArch.from_state_dict(rn))
    jmodel, variables = jfactory.build_model(jtask, jcross,
                                             clip_model_path=path)
    model = pfactory.build_model(task, cross, device="cpu",
                                 clip_model_path=path)
    jsd = from_jax_params(variables["params"], variables["batch_stats"])
    own = model.state_dict()
    clip_keys = pckpt.clip_to_port(
        {k: v.float() if v.is_floating_point() else v for k, v in rn.items()},
        "english")
    assert any(k.endswith("running_var") for k in clip_keys)
    assert len(clip_keys) == len(rn) and set(clip_keys) < set(own)
    for k, v in clip_keys.items():
        assert torch.equal(own[k], v.reshape(own[k].shape)), k
        if not k.endswith("num_batches_tracked"):    # flax keeps no count
            np.testing.assert_allclose(jsd[k].numpy(), own[k].numpy(),
                                       atol=1e-7, err_msg=k)
    model.load_state_dict({k: v for k, v in jsd.items()
                           if k not in clip_keys}, strict=False)
    with torch.no_grad():
        v, f = (t.numpy() for t in model.encode_video(
            torch.from_numpy(video)))
    jv, jf = jmodel.apply(variables, video, method="encode_video")
    np.testing.assert_allclose(v, np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(f, np.asarray(jf), atol=1e-4)


# the tiny RN the JAX tests pretrain (tests/test_resnet_import.py), its
# text tower CLIP_TEST_ARCH's
CLIP_TEST_RN_ARCH = dict(CLIP_TEST_ARCH, vision_layers=(1, 1, 1, 1),
                         vision_width=8, vision_patch_size=0)


def _rn_clip_state_dict(arch, text_sd, seed=1):
    """An OpenAI ModifiedResNet CLIP state dict at ``arch`` in fp16: the
    visual part seeded at the port tower's names and shapes (running
    means N(0, 0.05), variances 1 + |N(0, 0.05)|, ``num_batches_tracked``
    int64), the text part ``text_sd``'s."""
    from hmmc_tpu_torch.models.resnet import ModifiedResNet

    a = pconfig.ClipArch(**arch)
    tower = ModifiedResNet(a.vision_layers, a.embed_dim, a.vision_heads,
                           a.image_resolution, a.vision_width)
    g = np.random.default_rng(seed)
    sd = {k: v for k, v in text_sd.items() if not k.startswith("visual.")}
    for k, v in tower.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd["visual." + k] = torch.tensor(7)
            continue
        x = g.normal(size=tuple(v.shape)) * 0.05
        if k.endswith("running_var"):
            x = 1.0 + np.abs(x)
        elif k.endswith("weight") and v.ndim == 1:      # BatchNorm scales
            x = 1.0 + x
        sd["visual." + k] = torch.tensor(x, dtype=torch.float16)
    return sd


RN_TINY_NAME = "RN-Test"


def test_cli_resnet_runs_reload_and_serve(reference, cli_layout, tmp_path):
    """The CLI with a ModifiedResNet tower from an OpenAI-named file
    (--clip_model): --do_train --do_eval (train-mode BatchNorm, 3 steps of
    8 in 2 micro-batches), the saved ``pytorch_model.bin.0`` (its running
    statistics moved, as the model's) --do_eval'd again to the same
    metrics; the JAX package imports the file with those statistics and
    its --do_extract bank from it equals the port's (1e-4); the retrieval
    service answers from the port's bank."""
    from hmmc_tpu.cli import get_args as jax_args
    from hmmc_tpu.runner import run_extract as jax_run_extract
    from hmmc_tpu.train.checkpoint import (import_hmmc_state_dict,
                                           load_torch_state_dict)

    from hmmc_tpu_torch import serve

    data_dir, _ = cli_layout
    arch = dict(CLIP_TEST_RN_ARCH, context_length=64, vocab_size=49408)
    text = _clip_state_dict(dict(CLIP_TEST_ARCH, context_length=64,
                                 vocab_size=49408))
    clip_path = str(tmp_path / "RN-Test.pt")
    torch.save(_rn_clip_state_dict(arch, text), clip_path)
    cross = tmp_path / "cross-rn.json"
    cross.write_text(json.dumps({
        "pretrained_clip_name": RN_TINY_NAME, "temporal_hidden_size": 32,
        "temporal_attention_heads": 2, "temporal_hidden_layers": 2,
        "max_position_embeddings": 8}))
    cross = str(cross)
    for cfg in (pconfig, jconfig):
        cfg.CLIP_ARCH[RN_TINY_NAME] = arch
    try:
        out = str(tmp_path / "train")
        run = prunner.main(pcli.get_args(argv=_argv(data_dir, cross, out, (
            "--do_train", "--do_eval", "--clip_model", clip_path,
            "--gradient_accumulation_steps", "2"))), device="cpu")
        saved = os.path.join(out, "pytorch_model.bin.0")
        again = prunner.main(pcli.get_args(argv=_argv(
            data_dir, cross, str(tmp_path / "eval"),
            ("--do_eval", "--init_model", saved))), device="cpu")
        extract = ("--do_extract", "--init_model", saved)
        bank = prunner.main(pcli.get_args(argv=_argv(
            data_dir, cross, str(tmp_path / "extract"), extract)),
            device="cpu")
        jbank = jax_run_extract(jax_args(argv=_argv(
            data_dir, cross, str(tmp_path / "jax_extract"), extract)))
        sargs = pcli.get_args(argv=_argv(data_dir, cross, str(tmp_path),
                                         ("--do_eval", "--init_model",
                                          saved)))
        sargs.features, sargs.device_rank = bank, False
        answer = serve.RetrievalService(sargs, device="cpu").search(
            "a clip about video3", topk=3)
    finally:
        for cfg in (pconfig, jconfig):
            cfg.CLIP_ARCH.pop(RN_TINY_NAME, None)
    assert run.state.model.arch.is_resnet and run.state.step == 3
    assert again == run.best_metrics
    file = load_torch_state_dict(saved)
    own = run.state.model.state_dict()
    moved = 0
    for k, v in own.items():
        np.testing.assert_array_equal(np.asarray(file[k]), v.numpy(),
                                      err_msg=k)
        if "running_" in k:
            start = torch.load(clip_path, weights_only=True)[
                k[len("visual_encoder."):]].float()
            moved += not torch.equal(v, start)
    assert moved == sum("running_" in k for k in own)
    stats = import_hmmc_state_dict(file, language="english",
                                   use_temp=True)["batch_stats"]
    np.testing.assert_array_equal(
        np.asarray(stats["visual_encoder"]["visual"]["layer4_0"]["bn3"]
                   ["var"]),
        own["visual_encoder.visual.layer4.0.bn3.running_var"].numpy())
    pb, jb = dict(np.load(bank)), dict(np.load(jbank))
    assert pb["video"].shape == (N_VIDEOS, 32)
    for k in ("query", "video", "frames"):
        np.testing.assert_allclose(pb[k], jb[k], atol=1e-4, err_msg=k)
    assert len(answer["results"]) == 3


@pytest.fixture(scope="module")
def banks(tiny_arch, cli_layout, tmp_path_factory):
    """One JAX-written checkpoint; its --do_extract banks from the JAX
    runner (float; its int8 bank is ``hmmc_tpu.ops.quant.quantize_bank``
    of that payload, which is all ``--quantize_bank int8`` adds there,
    hmmc_tpu/runner.py:614-617) and from the port's runner (float and
    int8)."""
    if jconfig is None:
        pytest.skip("needs hmmc_tpu (the reference)")
    from hmmc_tpu import factory as jfactory
    from hmmc_tpu.cli import get_args as jax_args
    from hmmc_tpu.ops.quant import quantize_bank as jax_quantize_bank
    from hmmc_tpu.runner import run_extract as jax_run_extract
    from hmmc_tpu.train.orbax_io import save_reference_checkpoint

    data_dir, cross = cli_layout
    root = tmp_path_factory.mktemp("banks")
    _, variables = jfactory.build_model(
        jconfig.TaskConfig(do_eval=True, max_frames=4, max_words=16,
                           compute_dtype="float32"),
        jconfig.load_cross_config(cross))
    init = str(root / "init.bin")
    save_reference_checkpoint(init, variables["params"])
    extra = ("--do_extract", "--init_model", init)
    out = {"init": init, "jax": jax_run_extract(jax_args(argv=_argv(
        data_dir, cross, str(root / "jax"), extra)))}
    out["jax_int8"] = str(root / "jax" / "features_int8.npz")
    np.savez(out["jax_int8"], **jax_quantize_bank(dict(np.load(out["jax"]))))
    for name, more in (("", ()), ("_int8", ("--quantize_bank", "int8"))):
        out["port" + name] = prunner.main(pcli.get_args(argv=_argv(
            data_dir, cross, str(root / ("port" + name)), extra + more)),
            device="cpu")
    return out


def test_extract_banks_match_jax(reference, banks):
    """--do_extract: the port's banks against the JAX runner's (keys and
    dtypes equal; float arrays within 1e-4, int8 arrays bitwise, scales
    within 1e-6), and tools/retrieve.py's similarity on each (1e-4, equal
    metrics), which the port's own retrieve reproduces."""
    from hmmc_tpu.metrics import logging_rank as jax_logging_rank
    from tools.retrieve import similarity_from_bank as jax_similarity

    from hmmc_tpu_torch import retrieve

    assert banks["port"].endswith("features.npz")
    pairs = [tuple(dict(np.load(banks[side + q])) for side in ("port", "jax"))
             for q in ("", "_int8")]
    for pbank, jbank in pairs:
        assert sorted(pbank) == sorted(jbank)
        for k in jbank:
            assert pbank[k].dtype == jbank[k].dtype, k
            if k.endswith("_scale"):
                np.testing.assert_allclose(pbank[k], jbank[k], atol=1e-6)
            elif jbank[k].dtype.kind == "f":
                np.testing.assert_allclose(pbank[k], jbank[k], atol=1e-4,
                                           err_msg=k)
            else:       # int8 features, ids, flags, cut-offs: bitwise
                np.testing.assert_array_equal(pbank[k], jbank[k], err_msg=k)
    assert str(pairs[1][0]["quant"]) == "int8"

    def metrics(sim, bank):
        return jax_logging_rank(sim, bool(bank["multi_sentence"]),
                                list(bank["cut_off_points"]))

    for port_bank, jax_bank in pairs:
        sim, jsim = jax_similarity(port_bank), jax_similarity(jax_bank)
        np.testing.assert_allclose(sim, jsim, atol=1e-4)
        assert metrics(sim, port_bank) == metrics(jsim, jax_bank)
        np.testing.assert_allclose(retrieve.similarity_from_bank(port_bank),
                                   sim, atol=1e-6)
        assert retrieve.bank_metrics(port_bank) == metrics(sim, port_bank)


def test_run_params_matches_jax(reference, tiny_arch, cli_layout, tmp_path):
    """--do_params: the parameter count equals JAX's; the forward FLOPs
    (torch's counter: matrix products and convolutions) against XLA's
    cost analysis (which adds the elementwise work) at this geometry."""
    from hmmc_tpu.cli import get_args as jax_args
    from hmmc_tpu.runner import run_params as jax_run_params

    data_dir, cross = cli_layout
    argv = _argv(data_dir, cross, str(tmp_path), ("--do_params",))
    ref = jax_run_params(jax_args(argv=argv))
    got = prunner.main(pcli.get_args(argv=argv), device="cpu")
    assert got["params"] == ref["params"]
    ratio = got["flops"] / ref["flops"]
    assert PARAMS_FLOPS_RATIO[0] <= ratio <= PARAMS_FLOPS_RATIO[1], ratio


def _serve_args(cli_layout, banks, device_rank=False, get_args=None):
    data_dir, cross = cli_layout
    args = (get_args or pcli.get_args)(argv=_argv(
        data_dir, cross, os.path.dirname(banks["port"]),
        ("--do_eval", "--init_model", banks["init"])))
    args.features, args.device_rank = banks["port"], device_rank
    return args


SERVE_QUERIES = ["test sentence 3", "a clip about video2 number 1",
                 "test sentence 10", "nothing like any caption"]


def test_retrieval_service_matches_jax_and_serves(reference, banks,
                                                  cli_layout):
    """The port's RetrievalService on the CPU: host-ranked top-5 ids equal
    tools/serve.py's on the same bank and checkpoint; scores as
    similarity_from_bank's; one HTTP round trip and two concurrent
    requests; --device_rank ranks the int8 bank with the same top-1."""
    import urllib.request

    from hmmc_tpu.cli import get_args as jax_args
    from tools.serve import RetrievalService as JaxService

    from hmmc_tpu_torch import serve
    from hmmc_tpu_torch.retrieve import _norm, similarity_from_bank

    jsvc = JaxService(_serve_args(cli_layout, banks, get_args=jax_args))
    svc = serve.RetrievalService(_serve_args(cli_layout, banks),
                                 device="cpu")
    for text in SERVE_QUERIES:
        ids = [r["video_id"] for r in svc.search(text, topk=5)["results"]]
        assert ids == [r["video_id"] for r in jsvc.search(
            text, topk=5)["results"]], text
    bank = dict(np.load(banks["port"]))
    np.testing.assert_allclose(
        np.stack([svc.score(q) for q in _norm(bank["query"])]),
        similarity_from_bank(bank), rtol=1e-5, atol=1e-5)

    httpd = serve.make_server(svc, 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(text, out, i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search",
            data=json.dumps({"text": text, "topk": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out[i] = json.loads(r.read())

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True,
                                            "videos": N_VIDEOS}
        one = [None]
        post(SERVE_QUERIES[0], one, 0)
        both = [None, None]
        threads = [threading.Thread(target=post, args=(t, both, i))
                   for i, t in enumerate(SERVE_QUERIES[:2])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        httpd.shutdown()
        httpd.server_close()
    for got, text in zip([one[0], *both], [SERVE_QUERIES[0],
                                           *SERVE_QUERIES[:2]]):
        assert [r["video_id"] for r in got["results"]] == [
            r["video_id"] for r in svc.search(text, topk=3)["results"]]

    dsvc = serve.RetrievalService(_serve_args(cli_layout, banks, True),
                                  device="cpu")
    for text in SERVE_QUERIES:
        assert dsvc.search(text, topk=1)["results"][0]["video_id"] == \
            svc.search(text, topk=1)["results"][0]["video_id"], text


def test_extract_and_serve_without_cuda_raise(reference, banks, cli_layout,
                                              monkeypatch):
    """No fallback: without a card and without device="cpu" the extract
    and the service raise; they never drop to the CPU by themselves."""
    from hmmc_tpu_torch import serve

    data_dir, cross = cli_layout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prunner.main(pcli.get_args(argv=_argv(
            data_dir, cross, os.path.dirname(banks["port"]),
            ("--do_extract",))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.RetrievalService(_serve_args(cli_layout, banks))


# ---------------------------------------------------------------------------
# on the card: R1's kernel and the nvJPEG decoder
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def persistent_grid_edges(run, plain, make, wrapper, ctas):
    """The work list's two edges on the card: fewer items than the
    persistent grid has CTAs, and a count that is not a multiple of it (the
    last pass ragged); bitwise against ``plain`` both times. ``run(frames)``
    launches ``wrapper`` (whose ``last_launch`` holds items, grid and shared
    memory), ``make(n)`` gives n frames of one size, ``ctas(smem)`` the
    grid's CTAs."""
    few = make(2)
    assert torch.equal(run(few), plain(few))
    last = wrapper.last_launch
    grid = ctas(last["smem"])
    assert last["items"] < grid and last["grid"] == last["items"]
    many = make(grid + 5)
    assert torch.equal(run(many), plain(many))
    last = wrapper.last_launch
    assert last["grid"] == grid and last["items"] > grid
    assert last["items"] % grid != 0


@pytest.mark.gpu
@pytest.mark.parametrize("res", [32, 224])
def test_resize_crop_kernel_equals_plain_on_card(cuda, res):
    from hmmc_tpu_torch.ops import resize_crop as rc

    gen = torch.Generator(device=cuda).manual_seed(res)

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                             generator=gen)

    for w, h in R1_SWEEP:
        src = u8(4, h, w, 3)
        ycc = [YccFrame(u8(h, w), u8(-(-h // vf), -(-w // hf)),
                        u8(-(-h // vf), -(-w // hf)))
               for hf, vf in SAMPLING.values()]
        ycc.append(YccFrame(u8(h, w)))                       # grayscale
        for color in ("rgb", "cmyk", "ycck"):                # other planes
            hf, vf = SAMPLING[FORMATS["ycc420"]]
            ycc.append(YccFrame(
                u8(h, w), u8(-(-h // vf), -(-w // hf)),
                u8(-(-h // vf), -(-w // hf)),
                u8(h, w) if color != "rgb" else None, color))
        # 4:2:0 planes at 16-byte aligned bases and pitches (stage 0's fast
        # path) and at odd ones (staged with a row skew); RGB at an aligned
        # pitch and at an odd base and pitch (src[0..2] are views at the
        # unaligned pitch w * 3)
        y, c = u8(h, w), u8(2, -(-h // 2), -(-w // 2))
        rgb_aligned, rgb_odd, *planes = aligned_and_odd_layouts(
            src[3], y, c[0], c[1])
        ycc += planes
        frames = [src[0], None, src[1], *ycc, src[2], rgb_aligned, rgb_odd]
        before = resize_crop.launches
        out = resize_crop(frames, res)
        again = resize_crop(frames, res)
        assert resize_crop.launches == before + 2
        assert torch.equal(out, again)
        rgb_ref = resize_crop_reference(src, res)
        ref = torch.cat([rgb_ref[:3]] + [
            resize_crop_reference(ycc_to_rgb_reference(f)[None], res)
            for f in ycc] + [rgb_ref[3:], rgb_ref[3:]])
        got = torch.cat([out[[0, 2, len(ycc) + 3]], out[3:len(ycc) + 3],
                         out[-2:]])
        assert torch.equal(got, ref), f"{w}x{h} -> {res}"
        assert int(out[1].sum()) == 0
    if res == 32:
        persistent_grid_edges(
            lambda fs: resize_crop(fs, res),
            lambda fs: resize_crop_reference(torch.stack(fs), res),
            lambda n: list(u8(n, 45, 61, 3).unbind(0)), resize_crop,
            rc.persistent_ctas)


@pytest.mark.gpu
def test_nvjpeg_decode_matches_fixture_on_card(cuda):
    blobs, rgb, crops = _fixture()
    batch, buf = jpeg._decoder(cuda).decode_planes(blobs)
    frames = jpeg.frame_views(batch, buf)
    assert [f.fmt for f in frames] == [
        FORMATS[f"ycc{s}"] for s in np.load(FIXTURE)["sampling"]]
    # C1: RGB-coded, CMYK and YCCK frames hold their planes as coded
    assert [f.color for f in frames] == list(np.load(FIXTURE)["color"])
    diffs = [(ycc_to_rgb_reference(f).int().cpu()
              - torch.from_numpy(r).int()).abs() for f, r in zip(frames, rgb)]
    assert max(int(d.max()) for d in diffs) <= DECODE_MAX_ABS
    assert (sum(float(d.float().sum()) for d in diffs)
            / sum(d.numel() for d in diffs)) <= DECODE_MEAN_ABS
    # R1 on the decoded planes against its plain version, and R1 on PIL's
    # own pixels against PIL's crops: both exact
    out = resize_crop(frames, 224)
    assert torch.equal(out, torch.cat([resize_crop_reference(
        ycc_to_rgb_reference(f)[None], 224) for f in frames]))
    pil = resize_crop([torch.from_numpy(r).to(cuda) for r in rgb], 224)
    assert torch.equal(pil.cpu(), torch.from_numpy(np.stack(crops)))


@pytest.mark.gpu
def test_decode_batch_with_padded_slots_on_card(cuda):
    blobs = _fixture()[0]
    dense = jpeg.decode_frames(blobs[:3], 224, cuda)
    failures = jpeg.decode_frames.decode_failures
    out = jpeg.decode_video_blobs([[blobs[0], None, blobs[1]],
                                   [b"not a jpeg", blobs[2], None]],
                                  224, cuda)
    assert out.shape == (2, 3, 224, 224, 3) and out.device.type == "cuda"
    assert torch.equal(out[0, 0], dense[0]) and torch.equal(out[0, 2],
                                                            dense[1])
    assert torch.equal(out[1, 1], dense[2])
    assert int(out[0, 1].sum()) == int(out[1, 0].sum()) == \
        int(out[1, 2].sum()) == 0
    assert jpeg.decode_frames.decode_failures == failures + 1
