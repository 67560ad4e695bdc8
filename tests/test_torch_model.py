"""Port model (hmmc_tpu_torch) against the JAX package at tiny geometry.

A JAX ``BirdModel`` is initialized from a seed, its parameters cross the
weight bridge (``hmmc_tpu_torch.weights.from_jax_params``) into the port's
``BirdModel`` with a strict ``load_state_dict``, and the same numpy inputs
go through both. Tolerance: 1e-4 absolute in fp32, as in
tests/test_full_parity.py. With ``use_pallas`` the JAX kernel runs in
interpret mode and the port's ``fused_attention`` takes its plain version.

The tokenizer copy (stdlib ``re`` instead of ``regex``) must give the JAX
tokenizer's ids.
"""

import functools
import sys
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmmc_tpu.ops.pallas_attention as pa
from hmmc_tpu.config import ClipArch as JaxClipArch
from hmmc_tpu.config import CrossConfig as JaxCrossConfig
from hmmc_tpu.models.retrieval import BirdModel as JaxBirdModel
from hmmc_tpu_torch.config import ClipArch, CrossConfig, TaskConfig
from hmmc_tpu_torch.factory import build_model
from hmmc_tpu_torch.models.retrieval import BirdModel
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
    cross = CrossConfig(**CROSS_KW)
    if what == "3d":
        arch, lang = ClipArch(**ARCH_KW, linear_patch="3d"), "english"
    elif what == "resnet":
        arch, lang = ClipArch.by_name("RN50"), "english"
    else:
        arch, lang = ClipArch(**ARCH_KW), "chinese"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BirdModel(arch, cross, language=lang)


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
