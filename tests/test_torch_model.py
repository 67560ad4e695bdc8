"""Port model (hmmc_tpu_torch) against the JAX package at tiny geometry.

A JAX ``BirdModel`` is initialized from a seed, its parameters cross the
weight bridge (``hmmc_tpu_torch.weights.from_jax_params``) into the port's
``BirdModel`` with a strict ``load_state_dict``, and the same numpy inputs
go through both. Tolerance: 1e-4 absolute in fp32, as in
tests/test_full_parity.py. With ``use_pallas`` the JAX kernel runs in
interpret mode and the port's ``fused_attention`` takes its plain version.

The towers past the ViT-B/32 geometry: a tiny tower whose patch grid
gives L = 170 (> 128, no multiple of 64: the tiled kernels' lengths, their
plain versions here) forward and through one fine-tune step, the 3d tube
patch embedding with its CLIP inflate, and the architecture read from
shape-only OpenAI state dicts of ViT-B/16, ViT-L/14 and ViT-L/14@336px.
The fine-tune step's tolerances are tests/test_torch_train.py's: loss atol
1e-4, each gradient within 1e-3 of its own largest magnitude.

Head_dims past 64 (the kernels take 64, 80, 96 and 128): the plain K1 and
K2 at 80, 96 and 128 against the JAX kernels, and a tiny model whose
temporal transformer has head_dim 96 (as cross-base's 8 heads give at
ViT-L/14's embed_dim 768) forward and through one fine-tune step.

The ModifiedResNet towers: the tower alone against the JAX
``ModifiedResNet.apply`` in eval mode (1e-4) and in train mode (output
1e-4, the updated ``batch_stats`` 1e-5) at the JAX tests' tiny RN arch;
at ``tests/test_resnet_import.py``'s scaled RN (3, 4, 6, 3 blocks) in eval
mode at fp32 and in train mode at fp64 on both sides (statistics 1e-9,
output 1e-6 behind the attention pool's fp32 logits; in fp32 the JAX
side's own error, against its fp64 run, exceeds those bounds there:
train-mode BatchNorm over 16 values a channel at layer4 amplifies the
rounding of 16 blocks); the BatchNorm's hand-written backward against
autograd of its formula (fp64); the bridge against the JAX package's
``export_clip_resnet`` and ``save_reference_checkpoint``; all five zoo
towers built on the meta device and loaded strictly from
``from_jax_params`` of their JAX shapes.

The tokenizer copy (stdlib ``re`` instead of ``regex``) must give the JAX
tokenizer's ids.
"""

import functools
import sys
import types
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hmmc_tpu.ops.pallas_attention as pa
from hmmc_tpu.config import CLIP_ARCH as JAX_CLIP_ARCH
from hmmc_tpu.config import ClipArch as JaxClipArch
from hmmc_tpu.config import CrossConfig as JaxCrossConfig
from hmmc_tpu.models.resnet import ModifiedResNet as JaxModifiedResNet
from hmmc_tpu.models.retrieval import BirdModel as JaxBirdModel
from hmmc_tpu.train import optimization as jax_opt
from hmmc_tpu.train.trainer import FinetuneState as JaxFinetuneState
from hmmc_tpu.train.trainer import make_finetune_step as jax_finetune_step
from hmmc_tpu_torch.config import ClipArch, CrossConfig, TaskConfig
from hmmc_tpu_torch.factory import build_model
from hmmc_tpu_torch.models import resnet
from hmmc_tpu_torch.models.retrieval import BirdModel
from hmmc_tpu_torch.train import checkpoint as ckpt_io
from hmmc_tpu_torch.train import optimization as opt
from hmmc_tpu_torch.train.trainer import FinetuneState, make_finetune_step
from hmmc_tpu_torch.weights import from_jax_params

# tiny geometry of tests/test_full_parity.py (ViT-B/32 ratios, shrunk)
W, V_LAYERS, T_LAYERS, HEADS = 64, 2, 2, 2
EMB, CTX, VOCAB = 32, 16, 512
RES, PATCH, FRAMES, B = 32, 16, 3, 4
ARCH_KW = dict(
    embed_dim=EMB, image_resolution=RES, vision_layers=V_LAYERS,
    vision_width=W, vision_patch_size=PATCH, context_length=CTX,
    vocab_size=VOCAB, transformer_width=W, transformer_heads=HEADS,
    transformer_layers=T_LAYERS)
CROSS_KW = dict(temporal_hidden_size=EMB, temporal_attention_heads=HEADS,
                temporal_hidden_layers=2, max_position_embeddings=8)
ATOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pa.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


@pytest.fixture(scope="module")
def jax_params():
    model = JaxBirdModel(JaxClipArch(**ARCH_KW), JaxCrossConfig(**CROSS_KW))
    params = jax.jit(model.init)(
        jax.random.PRNGKey(7), jnp.zeros((1, CTX), jnp.int32),
        jnp.ones((1, CTX), jnp.int32),
        jnp.zeros((1, FRAMES, RES, RES, 3), jnp.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, use_fused):
    model = BirdModel(ClipArch(**ARCH_KW), CrossConfig(**CROSS_KW),
                      use_fused=use_fused)
    model.load_state_dict(from_jax_params(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 400, size=(B, CTX)).astype(np.int32)
    ids[:, 0] = 1
    for r in range(B):
        ids[r, 5 + r] = VOCAB - 1      # unique row max = EOT position
        ids[r, 6 + r:] = 0
    video = rng.normal(size=(B, FRAMES, RES, RES, 3)).astype(np.float32)
    return ids, video


def test_from_jax_params_round_trip(jax_params):
    sd = from_jax_params(jax_params)
    model = _port_model(jax_params, use_fused=True)
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_bridge_matches_reference_export(jax_params, tmp_path):
    """Keys and values equal the JAX package's own reference-checkpoint
    export (export_clip_visual / export_clip_text, and the full
    save_reference_checkpoint state dict)."""
    from hmmc_tpu.train.checkpoint import export_clip_text, export_clip_visual
    from hmmc_tpu.train.orbax_io import save_reference_checkpoint

    sd = from_jax_params(jax_params)
    visual = export_clip_visual(jax_params["visual_encoder"]["visual"],
                                prefix="visual_encoder.visual.")
    text = export_clip_text(jax_params["text_encoder"]["clip_text"],
                            prefix="text_encoder.")
    for ref in (visual, text):
        for k, v in ref.items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    path = str(tmp_path / "pytorch_model.bin.0")
    save_reference_checkpoint(path, jax_params, language="english")
    full = torch.load(path, map_location="cpu", weights_only=True)
    assert set(full) == set(sd)
    for k, v in full.items():
        np.testing.assert_array_equal(sd[k].numpy(),
                                      np.asarray(v).reshape(sd[k].shape),
                                      err_msg=k)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_encode_text_matches_jax(jax_params, batch, use_pallas):
    ids, _ = batch
    jmodel = JaxBirdModel(JaxClipArch(**ARCH_KW), JaxCrossConfig(**CROSS_KW),
                          use_pallas=use_pallas)
    ref = np.asarray(jmodel.apply(
        {"params": jax_params}, jnp.asarray(ids),
        jnp.asarray((ids > 0).astype(np.int32)), method="encode_text"))
    model = _port_model(jax_params, use_fused=use_pallas)
    with torch.no_grad():
        ours = model.encode_text(torch.tensor(ids).long())
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_encode_video_matches_jax(jax_params, batch, use_pallas):
    _, video = batch
    jmodel = JaxBirdModel(JaxClipArch(**ARCH_KW), JaxCrossConfig(**CROSS_KW),
                          use_pallas=use_pallas)
    v_ref, f_ref = jmodel.apply({"params": jax_params}, jnp.asarray(video),
                                method="encode_video")
    model = _port_model(jax_params, use_fused=use_pallas)
    with torch.no_grad():
        v, f = model.encode_video(torch.tensor(video))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=ATOL)


def test_logit_scale_is_clamped_constant(jax_params):
    model = _port_model(jax_params, use_fused=False)
    assert float(model.logit_scale()) == pytest.approx(100.0, rel=1e-6)


def test_build_model_seeded_and_on_cpu(jax_params):
    task = TaskConfig(compute_dtype="float32", seed=3)
    arch = ClipArch(**ARCH_KW)
    a = build_model(task, CrossConfig(**CROSS_KW), arch=arch, device="cpu")
    b = build_model(task, CrossConfig(**CROSS_KW), arch=arch, device="cpu")
    assert not a.training
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.device.type == "cpu"
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    # the same parameter set as the JAX model's (strict load both ways)
    a.load_state_dict(from_jax_params(jax_params), strict=True)


@pytest.mark.parametrize("what", ["3d", "resnet", "chinese"])
def test_unported_paths_raise(what):
    """The Chinese text tower raises naming the ROADMAP; the 3d tube patch
    is ported and builds its ``conv2`` (and no ``conv1``), as the JAX tower
    does; RN50 is ported and builds its tower under OpenAI's names (the
    JAX package's ``export_clip_resnet`` of the JAX tower's variables)."""
    cross = CrossConfig(**CROSS_KW)
    if what == "3d":
        model = BirdModel(ClipArch(**ARCH_KW, linear_patch="3d"), cross)
        names = set(model.state_dict())
        assert "visual_encoder.visual.conv2.weight" in names
        assert "visual_encoder.visual.conv1.weight" not in names
        return
    if what == "resnet":
        from hmmc_tpu.train.checkpoint import export_clip_resnet

        views = _jax_shape_views("RN50")
        want = export_clip_resnet(views["params"]["visual_encoder"]["visual"],
                                  views["batch_stats"]["visual_encoder"]
                                  ["visual"], prefix="visual_encoder.visual.")
        with torch.device("meta"):
            model = BirdModel(ClipArch.by_name("RN50"), cross)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()
               if k.startswith("visual_encoder.visual.")}
        assert got == {k: np.shape(v) for k, v in want.items()}
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BirdModel(ClipArch(**ARCH_KW), cross, language="chinese")


# ---------------------------------------------------------------------------
# towers past ViT-B/32: a long patch sequence, the 3d tube, the CLIP zoo
# ---------------------------------------------------------------------------

# 52 px in patches of 4: a 13 x 13 grid, L = 170; widths 128 (head_dim 64)
LONG_ARCH_KW = dict(ARCH_KW, image_resolution=52, vision_patch_size=4,
                    vision_width=128, embed_dim=64, transformer_width=128)
LONG_CROSS_KW = dict(CROSS_KW, temporal_hidden_size=64)
LONG_B, LONG_FRAMES = 2, 2
GRAD_REL = 1e-3
STEP_LOSS_ATOL = 1e-4


@pytest.fixture(scope="module")
def long_params():
    arch = JaxClipArch(**LONG_ARCH_KW)
    assert arch.grid_size ** 2 + 1 == 170
    model = JaxBirdModel(arch, JaxCrossConfig(**LONG_CROSS_KW))
    params = jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, CTX), jnp.int32),
        jnp.ones((1, CTX), jnp.int32),
        jnp.zeros((1, LONG_FRAMES, 52, 52, 3), jnp.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _long_batch():
    rng = np.random.default_rng(17)
    ids = rng.integers(1, 400, size=(LONG_B, CTX)).astype(np.int32)
    mask = np.ones((LONG_B, CTX), np.int32)
    for r in range(LONG_B):
        ids[r, 0] = 1
        ids[r, 5 + r] = VOCAB - 1      # EOT, the row max
        ids[r, 6 + r:] = 0
        mask[r, 6 + r:] = 0
    video = rng.normal(size=(LONG_B, LONG_FRAMES, 52, 52, 3))
    return {"query_ids": ids, "query_mask": mask,
            "video": video.astype(np.float32)}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,d", [
    (129, 64), (197, 64), (257, 64), (577, 64),
    # the other head_dims: the temporal site's L and one past 128
    (12, 80), (129, 80), (12, 96), (129, 96), (12, 128), (129, 128)])
def test_plain_kernels_match_jax_at_tower_lengths(l, d, causal):
    """K1's and K2's plain versions (the CPU path of the tiled bodies) at
    one past the short bodies and at ViT-B/16's, ViT-L/14's and
    ViT-L/14@336px's lengths, and at head_dim 80, 96 and 128 (the
    temporal site's L = 12 and L = 129), against the JAX kernels in
    interpret mode. fp32 tolerances of tests/test_torch_attention.py:
    outputs atol 2e-5, rtol 1e-4; gradients atol 5e-5, rtol 1e-3."""
    from hmmc_tpu_torch.ops.fused_attention import (
        fused_attention_backward_reference, fused_attention_reference)

    rng = np.random.default_rng(l + d + causal)
    q, k, v, g = (rng.normal(size=(1, 2, l, d)).astype(np.float32)
                  for _ in range(4))
    out = fused_attention_reference(*(torch.tensor(t) for t in (q, k, v)),
                                    causal)
    ref = pa.fused_attention(*(jnp.asarray(t) for t in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)
    grads = fused_attention_backward_reference(
        *(torch.tensor(t) for t in (q, k, v, g)), causal)
    refs = pa._flash_backward(*(jnp.asarray(t) for t in (q, k, v, g)), causal)
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-5,
                                   rtol=1e-3, err_msg=name)


def _video_matches_jax(arch_kw, cross_kw, params, video):
    """encode_video through the fused attention (JAX: its Pallas kernel in
    interpret mode; the port: the kernels' plain versions) within ATOL."""
    jmodel = JaxBirdModel(JaxClipArch(**arch_kw), JaxCrossConfig(**cross_kw),
                          use_pallas=True)
    v_ref, f_ref = jmodel.apply({"params": params}, jnp.asarray(video),
                                method="encode_video")
    model = BirdModel(ClipArch(**arch_kw), CrossConfig(**cross_kw),
                      use_fused=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        v, f = model.eval().encode_video(torch.tensor(video))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=ATOL)


def test_long_sequence_tower_matches_jax(long_params):
    """L = 170 through the fused attention (JAX: its Pallas kernel in
    interpret mode; the port: the plain version of the tiled bodies)."""
    _video_matches_jax(LONG_ARCH_KW, LONG_CROSS_KW, long_params,
                       _long_batch()["video"])


def _grab_grads():
    """An optax stage that keeps the latest gradients in its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _finetune_step_matches_jax(arch_kw, cross_kw, params, host):
    """One fine-tune step: loss, grad norm and every gradient against the
    JAX step (fused attention on both sides)."""
    kw = dict(lr=1e-3, text_lr=1e-4, coef_lr=0.5, weight_decay=0.2,
              warmup_proportion=0.1)
    cross = JaxCrossConfig(**cross_kw)
    jmodel = JaxBirdModel(JaxClipArch(**arch_kw), cross, use_pallas=True)
    tx = optax.chain(_grab_grads(), jax_opt.build_optimizer(
        params, t_total=4, **kw))
    jstep = jax_finetune_step(jmodel, tx, cross, use_frame_fea=True)
    jstate, jmetrics = jstep(JaxFinetuneState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx),
        {k: jnp.asarray(v) for k, v in host.items()})

    model = BirdModel(ClipArch(**arch_kw), CrossConfig(**cross_kw),
                      use_fused=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    state = FinetuneState(model, opt.build_optimizer(
        model.named_parameters(), t_total=4, **kw))
    step = make_finetune_step(CrossConfig(**cross_kw), use_frame_fea=True)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    batch["query_ids"] = batch["query_ids"].long()
    state, metrics = step(state, batch)
    for k in ("loss", "sim_loss", "frame_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=STEP_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=GRAD_REL)
    named = dict(model.named_parameters())
    grads = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   jstate.opt_state[0]))
    for n, ref in grads.items():
        got = named[n].grad
        if n.endswith("logit_scale"):
            assert got is None and float(ref) == 0.0
            continue
        err = float((got - ref).abs().max())
        assert err <= GRAD_REL * float(ref.abs().max()), (n, err)


def test_long_sequence_finetune_step_matches_jax(long_params):
    """One fine-tune step at L = 170: loss, grad norm and every gradient
    against the JAX step (fused attention on both sides)."""
    _finetune_step_matches_jax(LONG_ARCH_KW, LONG_CROSS_KW, long_params,
                               _long_batch())


# embed_dim 192 with 2 temporal heads: the temporal transformer's head_dim
# is 96, as cross-base's 8 heads give at ViT-L/14's embed_dim 768
HD96_ARCH_KW = dict(ARCH_KW, embed_dim=192)
HD96_CROSS_KW = dict(CROSS_KW, temporal_hidden_size=192)


@pytest.fixture(scope="module")
def hd96_params():
    model = JaxBirdModel(JaxClipArch(**HD96_ARCH_KW),
                         JaxCrossConfig(**HD96_CROSS_KW))
    assert (HD96_CROSS_KW["temporal_hidden_size"]
            // HD96_CROSS_KW["temporal_attention_heads"]) == 96
    params = jax.jit(model.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, CTX), jnp.int32),
        jnp.ones((1, CTX), jnp.int32),
        jnp.zeros((1, FRAMES, RES, RES, 3), jnp.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _hd96_batch():
    rng = np.random.default_rng(23)
    ids = rng.integers(1, 400, size=(B, CTX)).astype(np.int32)
    mask = np.ones((B, CTX), np.int32)
    for r in range(B):
        ids[r, 0] = 1
        ids[r, 5 + r] = VOCAB - 1      # EOT, the row max
        ids[r, 6 + r:] = 0
        mask[r, 6 + r:] = 0
    video = rng.normal(size=(B, FRAMES, RES, RES, 3))
    return {"query_ids": ids, "query_mask": mask,
            "video": video.astype(np.float32)}


def test_head_dim_96_temporal_matches_jax(hd96_params):
    """A temporal transformer of head_dim 96 through the fused attention,
    forward (1e-4) and one fine-tune step (loss 1e-4, each gradient within
    1e-3 of its largest magnitude) against JAX."""
    host = _hd96_batch()
    _video_matches_jax(HD96_ARCH_KW, HD96_CROSS_KW, hd96_params, host["video"])
    _finetune_step_matches_jax(HD96_ARCH_KW, HD96_CROSS_KW, hd96_params, host)


def test_tube_tower_matches_jax():
    """The 3d tube patch (kernel (3, p, p), stride (1, p, p), a frame of
    zero padding each side) and the tower after it, across the bridge
    (``conv2`` [kt, kh, kw, I, O] -> [O, I, kt, kh, kw])."""
    arch_kw = dict(ARCH_KW, linear_patch="3d")
    jmodel = JaxBirdModel(JaxClipArch(**arch_kw), JaxCrossConfig(**CROSS_KW),
                          use_pallas=True)
    rng = np.random.default_rng(23)
    video = rng.normal(size=(B, FRAMES, RES, RES, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(9), jnp.zeros((1, CTX), jnp.int32),
        jnp.ones((1, CTX), jnp.int32),
        jnp.zeros((1, FRAMES, RES, RES, 3), jnp.float32))["params"])
    assert "conv2" in params["visual_encoder"]["visual"]
    v_ref, f_ref = jmodel.apply({"params": params}, jnp.asarray(video),
                                method="encode_video")
    model = BirdModel(ClipArch(**arch_kw), CrossConfig(**CROSS_KW),
                      use_fused=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        v, f = model.eval().encode_video(torch.tensor(video))
    assert f.shape == (B, FRAMES, EMB)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=ATOL)


def test_inflate_3d_matches_jax_import(jax_params):
    """``checkpoint.inflate_3d`` of an OpenAI-named state dict gives the
    tube kernel ``import_clip_visual(inflate_3d=True)`` gives (centre tap),
    and the inflated file loads into a 3d tower."""
    from hmmc_tpu.train.checkpoint import import_clip_visual

    port = _port_model(jax_params, use_fused=True).state_dict()
    pre = "visual_encoder.visual."
    sd = {"visual." + k[len(pre):]: v for k, v in port.items()
          if k.startswith(pre)}
    ref = import_clip_visual({k: v.numpy() for k, v in sd.items()},
                             inflate_3d=True)["conv2"]["kernel"]
    tube = ckpt_io.inflate_3d(sd)
    assert "visual.conv1.weight" not in tube
    np.testing.assert_array_equal(tube["visual.conv2.weight"].numpy(),
                                  ref.transpose(4, 3, 0, 1, 2))
    model = BirdModel(ClipArch(**ARCH_KW, linear_patch="3d"),
                      CrossConfig(**CROSS_KW))
    ckpt_io.merge_into(model, ckpt_io.clip_to_port(tube, "english"))
    torch.testing.assert_close(
        model.state_dict()[pre + "conv2.weight"], tube["visual.conv2.weight"],
        rtol=0, atol=0)


def _clip_shapes(name):
    """An OpenAI CLIP state dict of ``name``'s shapes, values left out (a
    ResNet's visual part: the port's tower built on the meta device)."""
    a = ClipArch.by_name(name)
    w, e, tw = a.vision_width, a.embed_dim, a.transformer_width
    shapes = {"text_projection": (tw, e),
              "positional_embedding": (a.context_length, tw),
              "token_embedding.weight": (a.vocab_size, tw),
              "ln_final.weight": (tw,), "logit_scale": ()}
    if a.is_resnet:
        with torch.device("meta"):
            tower = resnet.ModifiedResNet(a.vision_layers, e, a.vision_heads,
                                          a.image_resolution, w)
        shapes.update({f"visual.{k}": tuple(v.shape)
                       for k, v in tower.state_dict().items()})
    else:
        shapes.update({
            "visual.conv1.weight": (w, 3, a.vision_patch_size,
                                    a.vision_patch_size),
            "visual.class_embedding": (w,),
            "visual.positional_embedding": (a.grid_size ** 2 + 1, w),
            "visual.proj": (w, e)})
        for i in range(a.vision_layers):
            shapes[f"visual.transformer.resblocks.{i}.attn.in_proj_weight"] \
                = (3 * w, w)
    for i in range(a.transformer_layers):
        shapes[f"transformer.resblocks.{i}.attn.in_proj_weight"] = (3 * tw,
                                                                     tw)
    return {k: types.SimpleNamespace(shape=v) for k, v in shapes.items()}


@pytest.mark.parametrize("name", ["ViT-B/16", "ViT-L/14", "ViT-L/14@336px",
                                  "RN50", "RN101", "RN50x4", "RN50x16",
                                  "RN50x64"])
def test_clip_arch_from_state_dict_matches_jax(name):
    """The towers' architecture from shapes alone equals the named one and
    the JAX package's reading; every head is 64 wide (the kernels'; a
    ResNet's attention pool heads over its width * 32 channels)."""
    sd = _clip_shapes(name)
    ours = ClipArch.from_state_dict(sd)
    ref = JaxClipArch.from_state_dict(sd)
    assert ours == ClipArch.by_name(name)
    assert ({f: getattr(ours, f) for f in ours.__dataclass_fields__}
            == {f: getattr(ref, f) for f in ref.__dataclass_fields__})
    assert JAX_CLIP_ARCH[name] == {
        f: getattr(ours, f) for f in JAX_CLIP_ARCH[name]}
    pooled = ours.vision_width * (32 if ours.is_resnet else 1)
    assert pooled // ours.vision_heads == 64
    assert ours.transformer_width // ours.transformer_heads == 64
    assert ours.embed_dim % 64 == 0   # the temporal transformer's width


# ---------------------------------------------------------------------------
# the ModifiedResNet towers
# ---------------------------------------------------------------------------

# the JAX tests' tiny RN (tests/test_resnet_import.py's pretrain test) and
# their scaled RN (``_rn_clip_sd``: the RN50 stage pattern at width 16)
RN_ARCH_KW = dict(
    embed_dim=32, image_resolution=32, vision_layers=(1, 1, 1, 1),
    vision_width=8, vision_patch_size=0, context_length=CTX,
    vocab_size=VOCAB, transformer_width=32, transformer_heads=2,
    transformer_layers=2)
RN_CROSS_KW = dict(temporal_hidden_size=32, temporal_attention_heads=2,
                   temporal_hidden_layers=1, max_position_embeddings=8)
SCALED_RN_ARCH_KW = dict(RN_ARCH_KW, embed_dim=48, image_resolution=64,
                         vision_layers=(3, 4, 6, 3), vision_width=16,
                         transformer_width=64, transformer_layers=1)
SCALED_RN_CROSS_KW = dict(RN_CROSS_KW, temporal_hidden_size=48)
RN_FRAMES = 8
STATS_ATOL = 1e-5


def _jax_shape_views(name):
    """The JAX ``BirdModel`` variables of zoo tower ``name`` as zero-stride
    numpy views of their shapes (``jax.eval_shape``: no memory)."""
    a = JaxClipArch.by_name(name)
    res = a.image_resolution
    shapes = jax.eval_shape(
        JaxBirdModel(a, JaxCrossConfig()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, 2, res, res, 3), jnp.float32))
    return jax.tree_util.tree_map(
        lambda t: np.broadcast_to(np.zeros((), np.float32), t.shape), shapes)


def _rn_variables(arch_kw, cross_kw, seed):
    """A JAX ``BirdModel``'s params and ``batch_stats``, the running
    statistics drawn away from their init (means N(0, 0.1), variances
    1 + 0.5 |N(0, 1)|)."""
    model = JaxBirdModel(JaxClipArch(**arch_kw), JaxCrossConfig(**cross_kw))
    res = arch_kw["image_resolution"]
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, CTX), jnp.int32),
        jnp.ones((1, CTX), jnp.int32),
        jnp.zeros((1, 2, res, res, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        z = rng.normal(size=np.shape(a)).astype(np.float32)
        return 1.0 + 0.5 * np.abs(z) if path[-1].key == "var" else 0.1 * z

    return (jax.tree_util.tree_map(np.asarray, variables["params"]),
            jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]))


def _jax_tower(arch_kw, dtype=jnp.float32):
    a = JaxClipArch(**arch_kw)
    return JaxModifiedResNet(
        layers=tuple(a.vision_layers), output_dim=a.embed_dim,
        heads=a.vision_heads, input_resolution=a.image_resolution,
        width=a.vision_width, dtype=dtype, param_dtype=dtype)


def _tower_matches_jax(arch_kw, cross_kw, seed, train, dtype=torch.float32,
                       atol=ATOL, stats_atol=STATS_ATOL):
    """The port's tower (loaded through ``from_jax_params``) against
    ``ModifiedResNet.apply`` on RN_FRAMES frames; in train mode also the
    running statistics after the forward against JAX's mutated
    ``batch_stats`` (in its dtype, through ``export_clip_resnet``)."""
    from hmmc_tpu.train.checkpoint import export_clip_resnet

    params, stats = _rn_variables(arch_kw, cross_kw, seed)
    res = arch_kw["image_resolution"]
    frames = np.random.default_rng(seed + 1).normal(
        size=(RN_FRAMES, res, res, 3))
    model = BirdModel(ClipArch(**arch_kw), CrossConfig(**cross_kw))
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    tower = model.visual_encoder.visual.to(dtype)
    tower.dtype = dtype
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        cast = functools.partial(jax.tree_util.tree_map,
                                 lambda a: jnp.asarray(a, jdtype))
        variables = {"params": cast(params["visual_encoder"]["visual"]),
                     "batch_stats": cast(stats["visual_encoder"]["visual"])}
        x = jnp.asarray(frames, jdtype)
        if train:
            ref, mutated = _jax_tower(arch_kw, jdtype).apply(
                variables, x, True, mutable=["batch_stats"])
            want = export_clip_resnet(
                params["visual_encoder"]["visual"], jax.tree_util.tree_map(
                    np.asarray, mutated["batch_stats"]),
                prefix="visual_encoder.visual.")
        else:
            ref = _jax_tower(arch_kw, jdtype).apply(variables, x)
        ref = np.asarray(ref)
    with torch.no_grad():
        out = tower(torch.tensor(frames, dtype=dtype), train)
    assert out.shape == (RN_FRAMES, arch_kw["embed_dim"])
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0)
    if train:
        got = model.state_dict()
        for k, v in want.items():
            if "running_" in k:
                np.testing.assert_allclose(got[k].numpy(), v,
                                           atol=stats_atol, rtol=0,
                                           err_msg=k)
            elif k.endswith("num_batches_tracked"):
                assert int(got[k]) == 1, k


@pytest.mark.parametrize("train", [False, True])
def test_resnet_tower_matches_jax(train):
    """The tiny RN tower: output within 1e-4; in train mode the updated
    running statistics within 1e-5 (an unbiased running variance would be
    8/7 of flax's over the 8 values a channel of layer4's 1x1 grid)."""
    _tower_matches_jax(RN_ARCH_KW, RN_CROSS_KW, 31, train)


@pytest.mark.parametrize("train", [False, True])
def test_scaled_resnet_tower_matches_jax(train):
    """The scaled RN (3, 4, 6, 3 blocks, width 16, 64 px): eval mode in
    fp32 within 1e-4; train mode in fp64 on both sides, the running
    statistics within 1e-9 and the output within 1e-6 (the attention
    pool's logits and softmax are fp32 on both sides whatever the compute
    dtype, as the shared attention op computes them)."""
    if train:
        _tower_matches_jax(SCALED_RN_ARCH_KW, SCALED_RN_CROSS_KW, 37, True,
                           torch.float64, atol=1e-6, stats_atol=1e-9)
    else:
        _tower_matches_jax(SCALED_RN_ARCH_KW, SCALED_RN_CROSS_KW, 37, False)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_batch_norm_backward_matches_autograd(train):
    """The BatchNorm's hand-written backward (x, weight, bias) against
    autograd of its formula, fp64: batch statistics (biased variance, fast
    form) in train mode, running statistics otherwise; and the running
    statistics it moves by momentum 0.1 with the biased variance."""
    g = torch.Generator().manual_seed(3)
    bn = resnet.BatchNorm2d(5).double()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(5, generator=g, dtype=torch.float64))
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    x = torch.randn(3, 5, 4, 2, generator=g, dtype=torch.float64) * 2 + 1
    dy = torch.randn(3, 5, 4, 2, generator=g, dtype=torch.float64)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    y = bn(xs[0], train)
    y.backward(dy)
    view = (1, -1, 1, 1)
    if train:
        mean = xs[1].mean((0, 2, 3))
        var = (xs[1] * xs[1]).mean((0, 2, 3)) - mean * mean
    else:
        mean, var = rm, rv
    y_ref = ((xs[1] - mean.view(view)) * torch.rsqrt(var + 1e-5).view(view)
             * bn.weight.view(view) + bn.bias.view(view))
    grads = torch.autograd.grad(y_ref, [xs[1], bn.weight, bn.bias], dy)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-12)
    for got, want in zip((xs[0].grad, bn.weight.grad, bn.bias.grad), grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    if train:
        torch.testing.assert_close(bn.running_mean,
                                   0.9 * rm + 0.1 * mean.detach())
        torch.testing.assert_close(bn.running_var,
                                   0.9 * rv + 0.1 * var.detach())
    else:
        assert torch.equal(bn.running_mean, rm)
        assert int(bn.num_batches_tracked) == 0


def test_resnet_bridge_matches_reference_export(tmp_path):
    """``from_jax_params(params, batch_stats)``: keys and values equal the
    JAX package's ``export_clip_resnet`` (the tower, running statistics
    and zeroed ``num_batches_tracked``) and its whole
    ``save_reference_checkpoint`` file, and load strictly into the port."""
    from hmmc_tpu.train.checkpoint import export_clip_resnet
    from hmmc_tpu.train.orbax_io import save_reference_checkpoint

    params, stats = _rn_variables(SCALED_RN_ARCH_KW, SCALED_RN_CROSS_KW, 41)
    sd = from_jax_params(params, stats)
    visual = export_clip_resnet(params["visual_encoder"]["visual"],
                                stats["visual_encoder"]["visual"],
                                prefix="visual_encoder.visual.")
    assert set(visual) == {k for k in sd
                           if k.startswith("visual_encoder.visual.")}
    for k, v in visual.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    path = str(tmp_path / "pytorch_model.bin.0")
    save_reference_checkpoint(path, params, language="english",
                              batch_stats=stats)
    full = torch.load(path, map_location="cpu", weights_only=True)
    assert set(full) == set(sd)
    for k, v in full.items():
        np.testing.assert_array_equal(sd[k].numpy(),
                                      np.asarray(v).reshape(sd[k].shape),
                                      err_msg=k)
    model = BirdModel(ClipArch(**SCALED_RN_ARCH_KW),
                      CrossConfig(**SCALED_RN_CROSS_KW))
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4", "RN50x16",
                                  "RN50x64"])
def test_resnet_zoo_towers_load_strictly_from_jax_params(name):
    """Each zoo ResNet's ``BirdModel`` (built on the meta device) loads
    ``from_jax_params`` of the JAX model's variable shapes strictly: the
    same names, shapes and buffers; its temporal transformer's head_dim is
    embed_dim / 8 under cross-base (128, 64, 80, 96, 128)."""
    views = _jax_shape_views(name)
    arch = ClipArch.by_name(name)
    with torch.device("meta"):
        sd = from_jax_params(views["params"], views["batch_stats"])
        model = BirdModel(arch, CrossConfig())
    model.load_state_dict(sd, strict=True)
    assert sum(k.endswith("running_var") for k in sd) == sum(
        isinstance(m, resnet.BatchNorm2d) for m in model.modules())
    block = model.visual_encoder.temporal_transformer.resblocks[0]
    assert arch.embed_dim // block.attn.num_heads == {
        "RN50": 128, "RN101": 64, "RN50x4": 80, "RN50x16": 96,
        "RN50x64": 128}[name]


# ---------------------------------------------------------------------------
# tokenizer: stdlib ``re`` copy against the JAX (``regex``) tokenizer
# ---------------------------------------------------------------------------

SENTENCES = [
    "a man is driving a car down the road",
    "A Woman's dog isn't running; they'll've gone!",
    "people dancing at 3:45pm on 2024-05-06 (101 guests)",
    "Café crème brûlée — naïve façade, São Paulo, Zürich",
    "Ελληνικά κείμενα και русский текст",
    "中文字幕的视频 日本語のテキスト",
    "x² + ½ of Ⅻ items cost ¥100 & €5",
    "snake_case __init__ --flag  tabs\tand\nnewlines",
    "emoji 🎉🎬 and &amp;amp; html &lt;b&gt;",
]


@pytest.fixture(scope="module")
def tokenizers():
    from hmmc_tpu.tokenization import ClipTokenizer as JaxTokenizer
    from hmmc_tpu_torch.tokenization import ClipTokenizer

    return JaxTokenizer(), ClipTokenizer()


@pytest.mark.parametrize("sentence", SENTENCES)
def test_tokenizer_ids_match_jax(tokenizers, sentence):
    from hmmc_tpu.data.text import encode_text as jax_encode_text
    from hmmc_tpu_torch.data.text import encode_text

    jtok, tok = tokenizers
    assert tok.encode(sentence) == jtok.encode(sentence)
    for a, b in zip(encode_text(tok, sentence, 32),
                    jax_encode_text(jtok, sentence, 32)):
        np.testing.assert_array_equal(a, b)


def test_tokenizer_specials_match_jax(tokenizers):
    jtok, tok = tokenizers
    for name in ("pad_token_id", "cls_token_id", "mask_token_id",
                 "sep_token_id", "vocab_size"):
        assert getattr(tok, name) == getattr(jtok, name)
    assert tok.encoder == jtok.encoder


def test_word_split_matches_regex_on_every_code_point():
    """The stdlib classes split text like ``regex``'s \\p{L}/\\p{N}/\\s on
    every assigned code point, alone and next to letters, punctuation,
    digits and spaces (the text is lowercased first, as in tokenize)."""
    from hmmc_tpu.tokenization.clip_bpe import _WORD_PAT
    from hmmc_tpu_torch.tokenization.clip_bpe import word_pattern

    pat = word_pattern()
    bad = []
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        if unicodedata.category(c) in ("Cn", "Cs"):
            continue
        s = f"a{c}b!{c}?1{c}2 {c} {c}".lower()
        if _WORD_PAT.findall(s) != pat.findall(s):
            bad.append(hex(cp))
    assert not bad, bad[:20]
