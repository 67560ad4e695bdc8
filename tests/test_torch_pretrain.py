"""Port pretrain slice (hmmc_tpu_torch heads, MoCo engine, losses, SimCLR
augmentation, R2 and the aug decode, VATEX, the pretrain step and
``--do_pretrain``) against the JAX package, on the CPU in fp32.

The JAX side runs as its own tests run it on the CPU (plain attention;
the aug decode through ``FrameSource(mode="aug", use_native=False)``, the
cv2 route). Weights, key towers, statistics and queues come from a JAX
``PretrainState`` across ``weights.from_jax_pretrain_state``; random draws
cannot be matched with ``jax.random``, so each random op's deterministic
apply is fed JAX's draws and its sampler is held by its distribution.

Tolerances, each with its reason:
- the MoCo losses and ``mlm_loss``: atol 1e-5 (fp32, the same formulas,
  the log-sum-exp taken in another order);
- the masking apply, the enqueue (wrap-around included) and R2's plain
  version against ``cv2.resize``: exact (integer and copy work; the area
  path's float sums are kept in cv2's order);
- BatchNorm running statistics after two micro-batches and the image ops'
  applies: atol 1e-5 (fp32, reductions in another order);
- the samplers: each probability within 4 sigma of its binomial spread
  over the draws, each uniform's mean within 4 sigma and its range inside
  the bounds;
- the pretrain step: losses rtol 1e-5; parameters, key towers, queues and
  BatchNorm statistics atol 1e-4 after one and two steps (the towers'
  fp32 forward agrees to ~1e-6; BertAdam's first update is multiplied by
  0, its second moves parameters by at most lr = 1e-4, and an Adam step
  turns a gradient difference at the noise floor into a step difference
  of at most that size). The same with a ModifiedResNet tower (the JAX
  tests' tiny RN), whose BatchNorm running statistics stay bit for bit
  unchanged in the query model and in the key towers (frozen, as the JAX
  step keeps them) while the projectors' move.

The ``gpu`` tests hold R2 against its plain version on the card.
"""

import functools
import io
import json
import os
import signal

import numpy as np
import pytest
import torch

from hmmc_tpu_torch import cli as pcli
from hmmc_tpu_torch import config as pconfig
from hmmc_tpu_torch import losses
from hmmc_tpu_torch import runner as prunner
from hmmc_tpu_torch.data import framepack as pfp
from hmmc_tpu_torch.data import jpeg
from hmmc_tpu_torch.data.datasets import FrameSource
from hmmc_tpu_torch.factory import build_model
from hmmc_tpu_torch.ops import image_ops
from hmmc_tpu_torch.ops import resize_area as r2
from hmmc_tpu_torch.ops.resize_crop import YccFrame
from hmmc_tpu_torch.testing import aligned_and_odd_layouts
from hmmc_tpu_torch.train import checkpoint as pckpt
from hmmc_tpu_torch.config import ClipArch, CrossConfig
from hmmc_tpu_torch.models.heads import BatchNorm, ProjectorMLP
from hmmc_tpu_torch.models.pretrain import (BirdPretrainModel, MaskDecisions,
                                            MoCoQueues, apply_mask_decisions,
                                            init_key_params, mlm_loss,
                                            sample_mask_decisions)
from hmmc_tpu_torch.train import optimization as opt
from hmmc_tpu_torch.train.trainer import PretrainState, make_pretrain_step
from hmmc_tpu_torch.weights import from_jax_pretrain_params as \
    weights_pretrain
from hmmc_tpu_torch.weights import from_jax_pretrain_state

try:  # the reference; the card's machine has no JAX and runs the gpu tests
    import jax
    import jax.numpy as jnp

    from hmmc_tpu import losses as jax_losses
    from hmmc_tpu.config import ClipArch as JaxClipArch
    from hmmc_tpu.config import CrossConfig as JaxCrossConfig
    from hmmc_tpu.config import TaskConfig as JaxTaskConfig
    from hmmc_tpu.data import datasets as jds
    from hmmc_tpu.ops import image_ops as jax_image_ops
    from hmmc_tpu.train import checkpoint as jax_ckpt
    from hmmc_tpu.train import orbax_io as jax_orbax
    from hmmc_tpu.models import heads as jax_heads
    from hmmc_tpu.models import pretrain as jax_pretrain
    from hmmc_tpu.train import optimization as jax_opt
    from hmmc_tpu.train import trainer as jax_trainer
except ImportError:
    jax = None

try:  # cv2 decodes the CPU aug route; the card's machine has no cv2
    import cv2
except ImportError:
    cv2 = None

# tiny geometry of tests/test_torch_model.py (ViT-B/32 ratios, shrunk)
ARCH_KW = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=16, vocab_size=512,
    transformer_width=64, transformer_heads=2, transformer_layers=2)
CROSS_KW = dict(temporal_hidden_size=32, temporal_attention_heads=2,
                temporal_hidden_layers=2, max_position_embeddings=8)
FRAMES, CTX, B, K = 3, 16, 4, 16
MASK_ID, PAD_ID, CLS_ID = 500, 511, 510
LR, TEXT_LR = 1e-4, 1e-5
MOMENTUM, TEMP = 0.9, 0.07


@pytest.fixture(autouse=True)
def needs_reference(request):
    if request.node.get_closest_marker("gpu") is None and jax is None:
        pytest.skip("needs jax and hmmc_tpu (the reference)")
    yield


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_moco_losses_match_jax():
    rng = np.random.default_rng(0)
    h, b, f, k = 8, 5, 4, 6
    queue = _normal(rng, h, k)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)
    qf = _normal(rng, h, k * f)
    qf /= np.linalg.norm(qf, axis=0, keepdims=True)
    q, kk = _normal(rng, 2, b, h), _normal(rng, 2, b, h)
    fr, frk, tx, txk = (_normal(rng, b, f, h), _normal(rng, b, f, h),
                        _normal(rng, b, h), _normal(rng, b, h))
    T = torch.tensor
    jit = functools.partial(jax.jit, static_argnums=(-1,))
    cases = [
        (losses.moco_contrastive(T(q), T(kk), T(queue), TEMP),
         jit(jax_losses.moco_contrastive)(q, kk, queue, TEMP)),
        (losses.frame_self_loss(T(fr), T(frk), T(qf), TEMP),
         jit(jax_losses.frame_self_loss)(fr, frk, qf, TEMP)),
        (losses.frame_cross_loss(T(fr), T(frk), T(qf), T(tx), T(txk),
                                 T(queue), TEMP),
         jit(jax_losses.frame_cross_loss)(fr, frk, qf, tx, txk, queue,
                                          TEMP)),
    ]
    for got, ref in cases:
        np.testing.assert_allclose(float(got), float(ref), atol=1e-5)
    # the keys and the queue carry no gradient
    qt, kt, qq = (T(q, requires_grad=True), T(kk, requires_grad=True),
                  T(queue, requires_grad=True))
    losses.moco_contrastive(qt, kt, qq, TEMP).backward()
    assert qt.grad is not None and kt.grad is None and qq.grad is None


def test_mask_apply_and_mlm_loss_match_jax():
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 512, (6, CTX)).astype(np.int32)
    ids[:, 0], ids[:, -3:] = CLS_ID, 0         # zero padding stays maskable
    ids[0, 5] = PAD_ID
    ref_ids, ref_labels = jax_pretrain.mask_tokens(
        key, jnp.asarray(ids), 512, MASK_ID, PAD_ID, CLS_ID, 0.3)
    dec = _jax_decisions(key, ids.shape, 512, 0.3)
    got_ids, got_labels = apply_mask_decisions(
        torch.tensor(ids).long(), dec, MASK_ID, PAD_ID, CLS_ID)
    np.testing.assert_array_equal(_np(got_ids), np.asarray(ref_ids))
    np.testing.assert_array_equal(_np(got_labels), np.asarray(ref_labels))
    logits = _normal(rng, 6, CTX, 512, scale=3.0)
    np.testing.assert_allclose(
        float(mlm_loss(torch.tensor(logits), got_labels)),
        float(jax_pretrain.mlm_loss(logits, ref_labels)), atol=1e-5)
    none = torch.full((2, 3), -100)
    assert float(mlm_loss(torch.zeros(2, 3, 7), none)) == 0.0


def _jax_decisions(key, shape, vocab, p) -> MaskDecisions:
    """The draws ``jax_pretrain.mask_tokens`` makes from ``key``."""
    r_sel, r_rep, r_rand, r_words = jax.random.split(key, 4)
    T = functools.partial(torch.tensor)
    return MaskDecisions(
        select=T(np.asarray(jax.random.bernoulli(r_sel, p, shape))),
        replace=T(np.asarray(jax.random.bernoulli(r_rep, 0.8, shape))),
        randomize=T(np.asarray(jax.random.bernoulli(r_rand, 0.5, shape))),
        words=T(np.asarray(jax.random.randint(r_words, shape, 0, vocab,
                                              dtype=jnp.int32))).long())


def test_mask_sampler_distribution():
    n, p = 20000, 0.15
    d = sample_mask_decisions(torch.Generator().manual_seed(0), (n,), 512, p)
    for got, prob in ((d.select, p), (d.replace, 0.8), (d.randomize, 0.5)):
        sigma = (prob * (1 - prob) / n) ** 0.5
        assert abs(got.float().mean().item() - prob) < 4 * sigma
    assert 0 <= int(d.words.min()) and int(d.words.max()) < 512
    sigma = (512 ** 2 / 12 / n) ** 0.5
    assert abs(d.words.float().mean().item() - 255.5) < 4 * sigma


# ---------------------------------------------------------------------------
# queues and BatchNorm
# ---------------------------------------------------------------------------

def test_enqueue_matches_jax_with_wraparound():
    rng = np.random.default_rng(5)
    h, k, f, b = 8, 6, 2, 2
    jq = jax_pretrain.MoCoQueues.create(jax.random.PRNGKey(0), h, k, f)
    fields = ("v_cross", "frame_proj", "frame_cross", "title_cross",
              "tag_cross")
    pq = MoCoQueues(**{n: torch.tensor(np.asarray(getattr(jq, n)))
                       for n in fields}, ptr=0)
    for _ in range(4):       # 4 x 2 columns of 6: wraps once
        keys = [_normal(rng, b, h), _normal(rng, b, h), _normal(rng, b, h),
                _normal(rng, b, f, h), _normal(rng, b, f, h)]
        jq = jq.enqueue(*keys)
        pq.enqueue(*[torch.tensor(x) for x in keys])
        assert pq.ptr == int(jq.ptr)
        for n in fields:
            np.testing.assert_allclose(_np(getattr(pq, n)),
                                       np.asarray(getattr(jq, n)), atol=1e-6)
    with pytest.raises(ValueError):
        pq.enqueue(*[torch.zeros(4, h)] * 3, *[torch.zeros(4, f, h)] * 2)


def test_batchnorm_running_stats_match_jax_and_batchnorm1d():
    rng = np.random.default_rng(6)
    xs = [_normal(rng, 12, 8, scale=2.0) + 1.0 for _ in range(2)]
    jbn = jax_heads.TorchBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), xs[0], True)
    params, stats = variables["params"], variables["batch_stats"]
    ours = BatchNorm(8)
    torch_bn = torch.nn.BatchNorm1d(8)
    for x in xs:
        y_ref, mut = jbn.apply({"params": params, "batch_stats": stats}, x,
                               True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        y = ours(torch.tensor(x), True)
        y_bn = torch_bn.train()(torch.tensor(x))
        np.testing.assert_allclose(_np(y), np.asarray(y_ref), atol=1e-5)
        np.testing.assert_allclose(_np(y), _np(y_bn), atol=1e-6)
    for name, ref in (("running_mean", stats["mean"]),
                      ("running_var", stats["var"])):
        np.testing.assert_allclose(_np(getattr(ours, name)), np.asarray(ref),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(getattr(ours, name)),
                                   _np(getattr(torch_bn, name)), atol=1e-6)
    x = torch.tensor(xs[0])
    np.testing.assert_allclose(_np(ours(x, False)),
                               _np(torch_bn.eval()(x)), atol=1e-6)
    # the projector's names are the reference Sequential's
    names = set(ProjectorMLP(2, 8, 16, 8).state_dict())
    assert {"linear_hidden.1.weight", "linear_hidden.2.running_var",
            "linear_out.bias"} <= names


# ---------------------------------------------------------------------------
# the pretrain step
# ---------------------------------------------------------------------------

# the JAX tests' tiny RN (tests/test_resnet_import.py) at ARCH_KW's text
RN_ARCH_KW = dict(ARCH_KW, vision_layers=(1, 1, 1, 1), vision_width=8,
                  vision_patch_size=0)


def _arch(arch_kw=ARCH_KW):
    return ClipArch(**arch_kw), CrossConfig(**CROSS_KW)


@pytest.fixture(scope="module")
def jax_setup():
    return _jax_setup(ARCH_KW)


def _jax_setup(arch_kw):
    """One JAX ``PretrainState`` at the tiny geometry ``arch_kw`` (numpy
    leaves), its optimizer, and a batch. The state is created under one
    jit: op by op, its optimizer init, key-tower copies and queues are
    dozens of small programs to compile."""
    arch, cross = JaxClipArch(**arch_kw), JaxCrossConfig(**CROSS_KW)
    model = jax_pretrain.BirdPretrainModel(arch, cross, vocab_size=512)
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 500, (B, CTX)).astype(np.int32)
    ids[:, 0] = CLS_ID
    for i in range(B):           # EOT (the row's maximum) then zero padding
        ids[i, 8 + i] = PAD_ID   # EOT: the pad id, as in CLIP
        ids[i, 9 + i:] = 0
    video = _normal(rng, B, FRAMES, 32, 32, 3)
    mask = (ids > 0).astype(np.int32)
    tags = ids.copy()
    tags[:, 1:6] = rng.integers(1, 500, (B, 5))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), ids, mask, video)
    tx = jax_opt.build_optimizer(
        variables["params"], lr=LR, text_lr=TEXT_LR, coef_lr=1.0,
        weight_decay=0.2, warmup_proportion=0.1, t_total=10)

    def create(v, key):
        queues = jax_pretrain.MoCoQueues.create(
            key, ARCH_KW["embed_dim"], K, FRAMES)
        return jax_trainer.PretrainState.create(v, tx, queues)

    start = jax.tree_util.tree_map(np.asarray, jax.jit(create)(
        variables, jax.random.PRNGKey(1)))
    batch = {"title_ids": ids, "title_mask": mask, "video": video,
             "tag_ids": tags, "tag_mask": (tags > 0).astype(np.int32)}
    return model, jax.tree_util.tree_map(np.asarray, variables), batch, \
        start, tx


def _jax_run(jax_setup, n_accum, steps, use_tag):
    model, _, batch, start, tx = jax_setup
    cross = JaxCrossConfig(**CROSS_KW)
    task = JaxTaskConfig(do_pretrain=True,
                         dataset="bird" if use_tag else "vatex",
                         contrast_num_negative=K, max_frames=FRAMES,
                         contrast_temperature=TEMP,
                         contrast_momentum=MOMENTUM)
    step = jax_trainer.make_pretrain_step(
        model, tx, cross, task, mask_token_id=MASK_ID, pad_token_id=PAD_ID,
        cls_token_id=CLS_ID, n_accum=n_accum)
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if use_tag or not k.startswith("tag")}
    # fresh device arrays: the step donates its input state
    state = jax.tree_util.tree_map(jnp.asarray, start)
    states, out, rngs = [], [], []
    for s in range(steps):
        rng = jax.random.PRNGKey(100 + s)
        state, metrics = step(state, jb, rng)
        rngs.append(rng)
        states.append(jax.tree_util.tree_map(np.asarray, state))
        out.append({k: float(v) for k, v in metrics.items()})
    return start, states, out, rngs


def _step_decisions(rng, n_accum):
    """The MLM draws of one JAX pretrain step from its ``rng``, per
    micro-batch (``make_pretrain_step``'s splits: titles, then tags)."""
    micro = B // n_accum
    keys = ([rng] if n_accum == 1 else list(jax.random.split(rng, n_accum)))
    return [{name: _jax_decisions(k, (micro, CTX), 512, 0.15)
             for name, k in zip(("title", "tag"), jax.random.split(r))}
            for r in keys]


def _port_state(start, arch_kw=ARCH_KW):
    arch, cross = _arch(arch_kw)
    conv = from_jax_pretrain_state(start)
    model = BirdPretrainModel(arch, cross, vocab_size=512, use_fused=True)
    model.load_state_dict(conv["model"], strict=True)
    towers = init_key_params(model)
    towers.load_state_dict(conv["towers"], strict=True)
    queues = MoCoQueues(**conv["queues"], ptr=conv["ptr"])
    optimizer = opt.build_optimizer(
        model.named_parameters(), lr=LR, text_lr=TEXT_LR, coef_lr=1.0,
        weight_decay=0.2, warmup_proportion=0.1, t_total=10)
    return PretrainState(model, towers, queues, optimizer), cross


def test_decay_mask_and_lr_tree_match_jax(jax_setup):
    """BertAdam's groups over the pretrain model: ``t_projector`` at lr 0,
    no decay on biases (``cls.bias`` too) and on the MLM head's LayerNorm,
    decay on the projectors' BatchNorm weights."""
    params = jax_setup[1]["params"]
    model = BirdPretrainModel(*_arch(), vocab_size=512)
    names = [n for n, _ in model.named_parameters()]
    for ours, ref in (
            (opt.decay_mask(names), jax_opt.decay_mask(params)),
            (opt.lr_tree(names, LR, TEXT_LR, 0.5),
             jax_opt.lr_tree(params, LR, TEXT_LR, 0.5))):
        want = weights_pretrain(jax.tree_util.tree_map(
            lambda p, x: np.full(np.shape(p), float(x), np.float32),
            params, ref))
        for n in names:
            np.testing.assert_allclose(_np(want[n]), float(ours[n]),
                                       rtol=1e-7, err_msg=n)
    decay = opt.decay_mask(names)
    assert not decay["cls.transform.LayerNorm.weight"]
    assert not decay["cls.bias"]
    assert decay["v_projector.linear_hidden.2.weight"]
    assert opt.lr_tree(names, LR, TEXT_LR, 0.5)[
        "t_projector.linear_out.weight"] == 0.0


@pytest.mark.parametrize("n_accum,use_tag", [(1, False), (2, True)])
def test_pretrain_step_matches_jax(jax_setup, n_accum, use_tag, tmp_path):
    """Two steps (losses held after each), at n_accum 1 (VATEX: no tags)
    and 2 (the bird datasets' tag branch)."""
    steps = 2
    start, ref, ref_metrics, rngs = _jax_run(jax_setup, n_accum, steps,
                                             use_tag)
    state, cross = _port_state(start)
    step = make_pretrain_step(cross, MASK_ID, PAD_ID, CLS_ID,
                              temperature=TEMP, momentum=MOMENTUM,
                              use_tag=use_tag, n_accum=n_accum)
    batch = {k: torch.tensor(v).long() if k.endswith("_ids")
             else torch.tensor(v) for k, v in jax_setup[2].items()
             if not k.endswith("_mask")
             and (use_tag or not k.startswith("tag"))}
    for s in range(steps):
        state, metrics = step(state, batch,
                              decisions=_step_decisions(rngs[s], n_accum))
        for k in ("loss", "loss_FAM", "loss_VTM", "loss_FTM", "loss_MLM"):
            np.testing.assert_allclose(float(metrics[k]), ref_metrics[s][k],
                                       rtol=1e-5, err_msg=f"step {s} {k}")
        want = from_jax_pretrain_state(ref[s])
        _assert_state(state, want, atol=1e-4)
    ref = ref[-1]
    # a JAX pretrain checkpoint loads in the port: query model, key towers
    # (with their statistics) and queues
    if n_accum == 2:
        path = str(tmp_path / "jax_pretrain.bin")
        jax_orbax.save_reference_checkpoint(path, ref.params,
                                            pretrain_state=ref)
        task = pconfig.TaskConfig(do_pretrain=True, max_frames=FRAMES,
                                  contrast_num_negative=K,
                                  compute_dtype="float32")
        model = build_model(task, cross, arch=_arch()[0], device="cpu",
                            init_model_path=path, pretrain=True,
                            vocab_size=512)
        loaded = prunner.pretrain_state(task, model, 10)
        _assert_state(loaded, want)


def test_resnet_pretrain_step_keeps_visual_bn_frozen_as_jax():
    """Two pretrain steps (2 micro-batches each) with a ModifiedResNet
    tower against ``make_pretrain_step``: the losses (1e-5 relative) and
    the whole state after each step (1e-4: parameters, key towers, the
    projectors' running statistics, which move) as in
    ``test_pretrain_step_matches_jax``; the tower's running statistics, in
    the query model and in the key towers, stay bit for bit what they
    were (its BatchNorm runs on them, frozen, as in JAX)."""
    setup = _jax_setup(RN_ARCH_KW)
    start, ref, ref_metrics, rngs = _jax_run(setup, 2, 2, False)
    state, cross = _port_state(start, RN_ARCH_KW)

    def stats(module, prefix):
        return {k: v.clone() for k, v in module.state_dict().items()
                if k.startswith(prefix) and "running_" in k}

    visual = "visual_encoder.visual."
    before = [stats(state.model, visual), stats(state.towers, visual),
              stats(state.model, "v_projector.")]
    assert before[0] and before[2]
    step = make_pretrain_step(cross, MASK_ID, PAD_ID, CLS_ID,
                              temperature=TEMP, momentum=MOMENTUM, n_accum=2)
    batch = {k: torch.tensor(v).long() if k.endswith("_ids")
             else torch.tensor(v) for k, v in setup[2].items()
             if not k.endswith("_mask") and not k.startswith("tag")}
    for s in range(2):
        state, metrics = step(state, batch,
                              decisions=_step_decisions(rngs[s], 2))
        for k in ("loss", "loss_FAM", "loss_VTM", "loss_FTM", "loss_MLM"):
            np.testing.assert_allclose(float(metrics[k]), ref_metrics[s][k],
                                       rtol=1e-5, err_msg=f"step {s} {k}")
        _assert_state(state, from_jax_pretrain_state(ref[s]), atol=1e-4)
    for module, was in ((state.model, before[0]), (state.towers, before[1])):
        for k, v in stats(module, visual).items():
            assert torch.equal(v, was[k]), k
    moved = stats(state.model, "v_projector.")
    assert all(not torch.equal(v, before[2][k]) for k, v in moved.items())
    assert int(state.model.visual_encoder.visual.bn1.num_batches_tracked) \
        == 0


def _assert_state(state, want, atol=0.0):
    got = {"model": state.model.state_dict(),
           "towers": state.towers.state_dict()}
    for part in ("model", "towers"):
        for name, ref_t in want[part].items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(_np(got[part][name]), _np(ref_t),
                                           atol=atol, err_msg=name)
    assert state.queues.ptr == want["ptr"]
    for name, ref_t in want["queues"].items():
        np.testing.assert_allclose(_np(getattr(state.queues, name)),
                                   _np(ref_t), atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# SimCLR augmentation
# ---------------------------------------------------------------------------

def _jax_simclr_decisions(rng, n, h, w) -> image_ops.SimclrDecisions:
    """The draws ``jax_image_ops.simclr_augment`` makes from ``rng``, the
    crop box computed as its ``random_resized_crop`` computes it."""
    r = jax.random.split(rng, 5)
    r_area, r_ratio, r_y, r_x = jax.random.split(r[0], 4)
    area = h * w * jax.random.uniform(r_area, (n,), minval=0.2, maxval=1.0)
    log_r = jax.random.uniform(r_ratio, (n,), minval=jnp.log(3 / 4),
                               maxval=jnp.log(4 / 3))
    aspect = jnp.exp(log_r)
    bw = jnp.clip(jnp.sqrt(area * aspect), 1.0, w)
    bh = jnp.clip(jnp.sqrt(area / aspect), 1.0, h)
    y0 = jax.random.uniform(r_y, (n,)) * (h - bh)
    x0 = jax.random.uniform(r_x, (n,)) * (w - bw)
    c_jit, f_jit = jax.random.split(r[1])
    rb, rc, rs, rh = jax.random.split(f_jit, 4)
    factors = jnp.stack([
        jax.random.uniform(rb, (n,), minval=0.6, maxval=1.4),
        jax.random.uniform(rc, (n,), minval=0.6, maxval=1.4),
        jax.random.uniform(rs, (n,), minval=0.6, maxval=1.4),
        jax.random.uniform(rh, (n,), minval=-0.1, maxval=0.1)], 1)
    c_blur, f_blur = jax.random.split(r[3])
    T = torch.tensor
    return image_ops.SimclrDecisions(
        box=T(np.asarray(jnp.stack([y0, x0, bh, bw], 1))),
        jitter=T(np.asarray(jax.random.bernoulli(c_jit, 0.8, (n,)))),
        factors=T(np.asarray(factors)),
        gray=T(np.asarray(jax.random.bernoulli(r[2], 0.2, (n,)))),
        blur=T(np.asarray(jax.random.bernoulli(c_blur, 0.5, (n,)))),
        sigma=T(np.asarray(jax.random.uniform(f_blur, (n,), minval=0.1,
                                              maxval=2.0))),
        flip=T(np.asarray(jax.random.bernoulli(r[4], 0.5, (n,)))))


def _jax_simclr_by_op(key, frames, out, d):
    """``jax_image_ops.simclr_augment`` at ``key``, composed of its own ops
    each jitted alone (its random crop, the four jitter ops, grayscale,
    blur, flip, normalize) and selected by the draws in ``d``. Not one jit
    of the whole: there XLA recomputes the fused jitter chain inside the
    hue's max-and-compare (``mx == r``), and the hue branch flips at ~23%
    of these pixels, where each op jitted alone equals its eager value."""
    J = jax_image_ops
    r = jax.random.split(key, 5)
    x = jax.jit(J.random_resized_crop, static_argnames="out")(
        r[0], frames, out=out)

    def pick(take, a, b):
        return jnp.where(jnp.asarray(_np(take))[:, None, None, None], a, b)

    f = jnp.asarray(_np(d.factors))
    j = jax.jit(J.adjust_brightness)(x, f[:, 0])
    j = jax.jit(J.adjust_contrast)(j, f[:, 1])
    j = jax.jit(J.adjust_saturation)(j, f[:, 2])
    j = jax.jit(J.adjust_hue)(j, f[:, 3])
    x = pick(d.jitter, j, x)
    x = jax.jit(J.random_grayscale)(r[2], x)
    c_blur, f_blur = jax.random.split(r[3])
    x = pick(d.blur, jax.jit(J.gaussian_blur)(f_blur, x), x)
    x = jax.jit(J.random_hflip)(r[4], x)
    return np.asarray(J.normalize(x, J.BIRD_PRETRAIN_MEAN, J.CLIP_STD))


def test_simclr_apply_matches_jax_at_equal_decisions():
    n, h, w, out = 12, 20, 18, 12
    frames = np.random.default_rng(8).integers(0, 256, (n, h, w, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    d = _jax_simclr_decisions(key, n, h, w)
    ref = _jax_simclr_by_op(key, frames, out, d)
    for flag in ("jitter", "gray", "blur", "flip"):    # every branch taken
        assert 0 < int(getattr(d, flag).sum()) < n, flag
    got = image_ops.simclr_apply(torch.tensor(frames), d, out)
    np.testing.assert_allclose(_np(got), ref, atol=1e-5)
    # the hue rotation alone, over a grid of hues and a turn each way
    x = np.random.default_rng(10).random((6, 5, 7, 3)).astype(np.float32)
    x[0, 0, 0] = x[0, 0, 0, 0]                         # a grey pixel
    delta = np.array([-0.5, -0.1, 0.0, 0.05, 0.1, 0.5], np.float32)
    np.testing.assert_allclose(
        _np(image_ops.adjust_hue(torch.tensor(x), torch.tensor(delta))),
        np.asarray(jax_image_ops.adjust_hue(x, delta)), atol=1e-5)


def test_simclr_sampler_distribution():
    n, h, w = 20000, 256, 256
    d = image_ops.sample_simclr(torch.Generator().manual_seed(1), n, h, w)
    for flag, p in (("jitter", 0.8), ("gray", 0.2), ("blur", 0.5),
                    ("flip", 0.5)):
        sigma = (p * (1 - p) / n) ** 0.5
        assert abs(getattr(d, flag).float().mean().item() - p) < 4 * sigma
    for col, lo, hi in ((0, 0.6, 1.4), (1, 0.6, 1.4), (2, 0.6, 1.4),
                        (3, -0.1, 0.1)):
        f = d.factors[:, col]
        assert lo <= f.min().item() and f.max().item() <= hi
        sigma = (hi - lo) / 12 ** 0.5 / n ** 0.5
        assert abs(f.mean().item() - (lo + hi) / 2) < 4 * sigma
    assert 0.1 <= d.sigma.min().item() and d.sigma.max().item() <= 2.0
    y0, x0, bh, bw = d.box.T
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + bh <= h + 1e-3).all() and (x0 + bw <= w + 1e-3).all()
    # unclamped boxes cover U[0.2, 1] of the area
    share = (bh * bw / (h * w))[(bh < h) & (bw < w)]
    assert 0.2 - 1e-4 <= share.min().item() and share.max().item() <= 1.0
    out = image_ops.simclr_augment(torch.Generator().manual_seed(2),
                                   torch.zeros(5, 40, 36, 3,
                                               dtype=torch.uint8), 24,
                                   chunk=2)
    assert out.shape == (5, 24, 24, 3) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# R2 and the aug decode
# ---------------------------------------------------------------------------

R2_SIZES = [(341, 256), (256, 341), (640, 360), (1280, 720), (512, 512),
            (768, 768), (1024, 512), (160, 120), (320, 240), (257, 193),
            (100, 700), (17, 13)]


def _cv2_aug(rgb, size=256):
    h, w = rgb.shape[:2]
    nw, nh = r2.output_size(w, h, size)
    out = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_AREA)
    top, left = (nh - size) // 2, (nw - size) // 2
    return out[top:top + size, left:left + size]


def test_resize_area_reference_equals_cv2():
    """Bitwise on every cv2 path: copy, integer factors (2 x 2, 3 x 3,
    2 x 1), the float area cells, the bilinear upscale (R2's plain version
    against the installed cv2.resize)."""
    if cv2 is None:
        pytest.skip("needs cv2")
    rng = np.random.default_rng(11)
    modes = set()
    for w, h in R2_SIZES:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = r2.resize_area_reference(torch.tensor(img)[None], 256)[0]
        np.testing.assert_array_equal(_np(got), _cv2_aug(img),
                                      err_msg=f"{w}x{h}")
        modes.add(r2.area_tables(w, h, 256).mode)
    assert modes == {"fast", "area", "linear"}
    assert r2.area_tables(512, 512, 256).fast_shift
    assert not r2.area_tables(768, 768, 256).fast_shift


def _fixture():
    return np.load(os.path.join(os.path.dirname(jpeg.__file__), "..",
                                "assets", "frames_fixture.npz"))


def test_aug_decode_equals_jax_cv2_route_and_fixture(tmp_path):
    """The CPU aug decode (cv2 + R2's plain version) equals the fixture's
    cv2 crops and the JAX FrameSource's aug mode on its cv2 route;
    CMYK / YCCK planes take OpenCV's rule in R2's plain stage 0."""
    if cv2 is None:
        pytest.skip("needs cv2")
    fx = _fixture()
    n = len(fx["sizes"])
    blobs = [bytes(fx[f"blob_{i}"]) for i in range(n)]
    got = jpeg.decode_frames(blobs + [None], 256, "cpu", mode="aug")
    assert not got[n].any()
    for i in range(n):
        np.testing.assert_array_equal(_np(got[i]), fx[f"aug_{i}"],
                                      err_msg=str(i))
    path = str(tmp_path / "frames.fpk")
    with pfp.FramePackWriter(path) as wr:
        wr.add_video("v", blobs)
    ours = FrameSource(path, resolution=224, mode="aug", aug_size=256)
    ref = jds.FrameSource(path, frames_per_video=n, mode="aug",
                          resolution=224, aug_size=256, use_native=False)
    idx = list(range(n))
    np.testing.assert_array_equal(ours.load("v", idx), ref.load("v", idx))
    # OpenCV's CMYK rule on planes: k - ((ink * k) >> 8)
    rng = np.random.default_rng(12)
    planes = [torch.tensor(rng.integers(0, 256, (9, 11), dtype=np.uint8))
              for _ in range(4)]
    f = YccFrame(*planes[:3], k=planes[3], color="cmyk")
    y, k = planes[0].int(), planes[3].int()
    r = (k - (((255 - y) * k) >> 8)).clamp(0, 255)
    from hmmc_tpu_torch.ops.resize_crop import ycc_to_rgb_reference
    assert torch.equal(ycc_to_rgb_reference(f, cmyk="cv2")[..., 0].int(), r)


@pytest.mark.gpu
def test_resize_area_kernel_equals_plain_on_card():
    """R2 on the card against its plain version, bitwise: random RGB rows at
    sizes of every path (at the unaligned pitch w * 3), then RGB at an
    aligned pitch and at an odd base and pitch, and 4:2:0 planes at aligned
    and odd bases and pitches (cp.async and byte staging), and the work
    list's two edges (fewer items than the persistent grid has CTAs; a
    count that is not a multiple of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(13)
    frames = [torch.tensor(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for w, h in R2_SIZES] + [None]
    ref = r2.resize_area(frames, 256, device="cpu")
    got = r2.resize_area([None if f is None else f.cuda() for f in frames],
                         256)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)

    def u8(*shape):
        return torch.tensor(rng.integers(0, 256, shape, dtype=np.uint8))

    host, card = [], []
    for w, h in ((341, 256), (343, 259), (640, 360), (160, 120), (257, 193),
                 (512, 512)):
        img = u8(h, w, 3)
        y, cb, cr = u8(h, w), u8(-(-h // 2), -(-w // 2)), u8(-(-h // 2),
                                                              -(-w // 2))
        host += [img] * 2 + [YccFrame(y, cb, cr)] * 2
        card += aligned_and_odd_layouts(img.cuda(), y.cuda(), cb.cuda(),
                                        cr.cuda())
    got = r2.resize_area(card, 256)
    assert torch.equal(got.cpu(), r2.resize_area(host, 256, device="cpu"))
    # the work list's edges, at the pretrain's store size (the copy path)
    few = [u8(256, 341, 3).cuda() for _ in range(2)]
    assert torch.equal(r2.resize_area(few, 256).cpu(), r2.resize_area(
        [f.cpu() for f in few], 256, device="cpu"))
    last = r2.resize_area.last_launch
    grid = r2.persistent_ctas(last["smem"])
    assert last["items"] < grid and last["grid"] == last["items"]
    many = list(torch.randint(0, 256, (grid + 5, 256, 341, 3),   # an item
                              dtype=torch.uint8, device="cuda").unbind(0))
    got = r2.resize_area(many, 256)
    last = r2.resize_area.last_launch
    assert last["grid"] == grid and last["items"] > grid
    assert last["items"] % grid != 0
    assert torch.equal(got, r2.resize_area_reference(torch.stack(many), 256))


@pytest.mark.gpu
def test_aug_decode_on_card_near_cv2():
    """nvJPEG + R2 within 8 levels (mean 0.25) of the fixture's cv2 crops:
    only the IDCT differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fx = _fixture()
    n = len(fx["sizes"])
    got = jpeg.decode_frames([bytes(fx[f"blob_{i}"]) for i in range(n)],
                             256, "cuda", mode="aug").cpu().numpy()
    for i in range(n):
        d = np.abs(got[i].astype(int) - fx[f"aug_{i}"])
        assert d.max() <= 8 and d.mean() <= 0.25, (i, d.max(), d.mean())


# ---------------------------------------------------------------------------
# VATEX and --do_pretrain
# ---------------------------------------------------------------------------

TINY_NAME = "ViT-PretrainTest/16"
TINY_ARCH = dict(ARCH_KW, vocab_size=49408, context_length=64)
N_VIDEOS, STORED = 8, 4


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=80)
    return buf.getvalue()


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """One frame store with a VATEX layout (two English captions per video,
    the train list) and an MSR-VTT test split, so the epoch-end eval
    runs; the tiny arch and cross config."""
    pconfig.CLIP_ARCH[TINY_NAME] = TINY_ARCH
    root = tmp_path_factory.mktemp("pretrain_data")
    rng = np.random.default_rng(14)
    vids = [f"video{i}" for i in range(N_VIDEOS)]
    with pfp.FramePackWriter(str(root / "frames.fpk")) as w:
        for v in vids:
            w.add_video(v, [_jpeg(rng.integers(0, 255, (40, 48, 3),
                                               dtype=np.uint8))
                            for _ in range(STORED)])
    vx = root / "vatex"
    vx.mkdir()
    (vx / "train_list.txt").write_text("\n".join(vids))
    (vx / "test_list.txt").write_text("\n".join(vids[:3]))
    (vx / "vatex_data.json").write_text(json.dumps({
        v: {"enCap": [f"a clip about {v}", f"{v} again"],
            "chCap": ["-"]} for v in vids}))
    m = root / "msrvtt"
    m.mkdir()
    (m / "MSRVTT_JSFUSION_test.1k.csv").write_text(
        "video_id,sentence\n" + "".join(f"{v},test sentence {i}\n"
                                        for i, v in enumerate(vids)))
    cross = root / "cross-tiny.json"
    cross.write_text(json.dumps({"pretrained_clip_name": TINY_NAME,
                                 **CROSS_KW}))
    yield str(root), str(cross)
    pconfig.CLIP_ARCH.pop(TINY_NAME, None)


def test_vatex_datasets_equal_jax(layout):
    from hmmc_tpu_torch.data.registry import get_factory
    from hmmc_tpu_torch.tokenization import ClipTokenizer

    from hmmc_tpu.data.registry import DATALOADER_DICT as JAX_DICT
    from hmmc_tpu.tokenization import ClipTokenizer as JaxTokenizer

    data_dir, _ = layout
    task = pconfig.TaskConfig(data_dir=data_dir, max_words=16, max_frames=3,
                              image_resolution=32, batch_size=4)
    jtask = JaxTaskConfig(data_dir=data_dir, max_words=16, max_frames=3,
                          image_resolution=32, batch_size=4)
    for split in ("pretrain", "test"):
        _, ds = get_factory("vatex", split)(task, ClipTokenizer())
        _, jd = JAX_DICT["vatex"][split](jtask, JaxTokenizer())
        jd.source.use_native = False        # its cv2 route (aug mode)
        assert ds.cut_off_points == jd.cut_off_points
        assert ds.samples == jd.samples and len(ds) == len(jd)
        assert ds.source.out_size == jd.source.out_size == (
            36 if split == "pretrain" else 32)
        for i in (0, len(ds) - 1):
            a, b = ds[i], jd[i]
            np.testing.assert_array_equal(a["query_ids"], b["query_ids"])
            vid = ds.samples[i][0]
            blobs = [x for x in a["video_blobs"] if x is not None]
            mode = "aug" if split == "pretrain" else "eval"
            frames = jpeg.decode_frames(blobs, ds.source.out_size, "cpu",
                                        mode)
            np.testing.assert_array_equal(_np(frames),
                                          b["video"][:len(blobs)],
                                          err_msg=f"{split} {vid}")
    # the bundled split lists serve a data dir that lacks them
    bare = pconfig.TaskConfig(data_dir=data_dir + "/none")
    with pytest.raises(FileNotFoundError):
        get_factory("vatex", "test")(bare, ClipTokenizer())


def _pretrain_argv(data_dir, cross, out, extra=()):
    return ["--do_pretrain", "--output_dir", out, "--data_dir", data_dir,
            "--cross_model", cross, "--dataset", "vatex",
            "--language", "english", "--use_temp", "--use_frame_fea",
            "--max_words", "16", "--max_frames", "3", "--batch_size", "4",
            "--gradient_accumulation_steps", "2",
            "--contrast_num_negative", "8", "--batch_size_val", "8",
            "--epochs", "1", "--n_display", "1", "--lr", "1e-4",
            "--compute_dtype", "float32", *extra]


def test_cli_pretrain_checkpoint_loads_in_jax_and_finetune(layout, tmp_path):
    data_dir, cross = layout
    out = str(tmp_path / "pre")
    run = prunner.main(pcli.get_args(argv=_pretrain_argv(data_dir, cross,
                                                         out)), device="cpu")
    # 16 captions at batch 4: 4 steps, ptr 4 x 4 mod 8
    assert [r["step"] for r in run.displayed] == [1, 2, 3, 4]
    assert [r["ptr"] for r in run.displayed] == [4, 0, 4, 0]
    for r in run.displayed:
        assert all(np.isfinite(r[k]) for k in prunner.LOSS_NAMES)
    assert run.epoch_metrics and "R1" in run.epoch_metrics[0]
    saved = os.path.join(out, "pytorch_model.bin.0")
    sd = pckpt.load_torch_state_dict(saved)
    assert {"queue_v_cross_ng", "queue_frame_proj_ng", "queue_ptr",
            "text_encoder_k.ln_final.weight",
            "v_projector_k.linear_hidden.2.running_var",
            "t_projector_k.linear_out.weight", "cls.bias",
            "v_predictor.linear_hidden.2.running_mean"} <= set(sd)
    assert sd["queue_frame_proj_ng"].shape == (32, 8 * 3)
    # the JAX package imports it: the same query model and key towers
    imported = jax_ckpt.import_hmmc_state_dict(
        jax_ckpt.load_torch_state_dict(saved), pretrain=True)
    stats = imported["batch_stats"]
    want = from_jax_pretrain_state(type("S", (), dict(
        params={k: v for k, v in imported["params"].items()
                if not k.endswith("_k")},
        batch_stats=stats,
        params_k={k[:-2]: v for k, v in imported["params"].items()
                  if k.endswith("_k")},
        batch_stats_k={k[:-2]: v for k, v in stats.items()
                       if k.endswith("_k")},
        queues=type("Q", (), {
            **{f: imported["queues"][f"queue_{f}_ng"]
               for f in ("v_cross", "frame_proj", "frame_cross",
                         "title_cross", "tag_cross")},
            "ptr": imported["queues"]["queue_ptr"]}))))
    _assert_state(run.state, want)
    # and it starts a fine-tune in the port (the retrieval towers load;
    # the pretrain's other entries are reported and dropped)
    task = pconfig.TaskConfig(do_train=True, max_frames=3,
                              compute_dtype="float32")
    ft = build_model(task, pconfig.load_cross_config(cross), device="cpu",
                     init_model_path=saved)
    for k, v in ft.state_dict().items():
        assert torch.equal(v, run.state.model.state_dict()[k]), k
    # and a pretrain resumes its towers and queues from it
    again = build_model(task.replace(do_pretrain=True),
                        pconfig.load_cross_config(cross), device="cpu",
                        init_model_path=saved, pretrain=True)
    _assert_state(prunner.pretrain_state(task.replace(
        contrast_num_negative=8), again, 4), want)


def test_pretrain_flags_and_device(layout, monkeypatch, tmp_path):
    data_dir, cross = layout

    def task(*extra):
        return pcli.to_task_config(pcli.get_args(argv=_pretrain_argv(
            data_dir, cross, str(tmp_path), extra)))

    assert task().do_pretrain and task().aug_size == 256
    # train-state checkpoints are ported (ROADMAP Queue A 4)
    assert task("--resume").resume and task("--save_steps", "5").save_steps \
        == 5
    for flag, item in ((["--use_randaugment"], "Queue A 7"),
                       (["--dataset", "bird"], "Queue A 8"),
                       (["--language", "chinese"], "Queue A 8")):
        with pytest.raises(NotImplementedError, match=item):
            task(*flag)
    with pytest.raises(ValueError, match="Queue A 7"):
        task("--fused_ema")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prunner.main(pcli.get_args(argv=_pretrain_argv(
            data_dir, cross, str(tmp_path))))


@pytest.mark.parametrize("async_save", [False, True])
def test_pretrain_resume_after_sigterm_equals_uncut_run(layout, tmp_path,
                                                        async_save):
    """A SIGTERM after step 2 of 4 saves the exact state (model, key
    towers with their BatchNorm statistics, queues, ptr, moments, step);
    --resume trains steps 3 and 4 to the uncut run's losses and state, bit
    for bit (the augmentation and mask streams come from (seed, purpose,
    position), so the resumed run draws what the uncut one drew)."""
    from hmmc_tpu_torch.train import state_io

    data_dir, cross = layout
    extra = ("--async_save",) if async_save else ()
    uncut = prunner.main(pcli.get_args(argv=_pretrain_argv(
        data_dir, cross, str(tmp_path / "uncut"))), device="cpu")
    out = str(tmp_path / "cut")
    make = prunner.make_pretrain_step

    def signalling(*a, **kw):
        fn = make(*a, **kw)

        def step(state, *args, **kwargs):
            state, metrics = fn(state, *args, **kwargs)
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics

        return step

    prunner.make_pretrain_step = signalling
    try:
        cut = prunner.main(pcli.get_args(argv=_pretrain_argv(
            data_dir, cross, out, extra)), device="cpu")
    finally:
        prunner.make_pretrain_step = make
    assert cut.state.step == 2 and [r["step"] for r in cut.displayed] == [1]
    meta = state_io.load_progress_meta(os.path.join(out, "ckpt"), 2)
    assert meta["batch_in_epoch"] == 2 and not meta["fused_ema"]
    resumed = prunner.main(pcli.get_args(argv=_pretrain_argv(
        data_dir, cross, out, ("--resume",) + extra)), device="cpu")
    assert [r["step"] for r in resumed.displayed] == [3, 4]
    for got, want in zip(resumed.displayed, uncut.displayed[2:]):
        for k in prunner.LOSS_NAMES + ("ptr",):
            assert got[k] == want[k], k
    _assert_state(resumed.state, {
        "model": uncut.state.model.state_dict(),
        "towers": uncut.state.towers.state_dict(),
        "queues": {f: getattr(uncut.state.queues, f)
                   for f in MoCoQueues.NAMES},
        "ptr": uncut.state.queues.ptr})
    assert resumed.epoch_metrics == uncut.epoch_metrics
