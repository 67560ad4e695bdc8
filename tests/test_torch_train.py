"""Port fine-tune slice (hmmc_tpu_torch losses, BertAdam, train step,
runner) against the JAX package, on the CPU in fp32.

Weights come from a JAX ``BirdModel`` init at the tiny geometry of
tests/test_torch_model.py, across the weight bridge; gradients, optimizer
moments and parameters from the JAX side are mapped to the port's names
with the same ``from_jax_params`` (it is linear). Inputs are numpy arrays
from a seed. The JAX Pallas kernels run in interpret mode; the port's
``fused_attention`` takes its plain forward and backward on the CPU.

Tolerances, each with its reason:
- losses: atol 1e-5 on values of order 1-10 (fp32, the same formulas,
  reductions in another order);
- BertAdam alone, fed the same gradients: parameters atol 1e-6 (updates of
  order lr = 1e-3 differ in their last fp32 bits); moments rtol 1e-5
  (fp32 state) or 2^-7 (bf16 state: one bf16 ulp where the fp32 value
  rounds the other way, which moves that step's update by up to 2^-7 of
  its size, so parameters atol lr * 2^-7 per step taken);
- the train step: loss atol 1e-4 (the towers' fp32 forward parity,
  tests/test_torch_model.py, times the 100 logit scale's cosine terms);
  each gradient within 1e-3 of its own largest magnitude (sums in another
  order through 2 + 2 layers and two losses); moments after step 1 within
  1e-3 of their largest magnitude (they are 0.1 g and 0.02 g^2);
  parameters after 3 steps within 5% of lr * 2 (step 0's update is
  multiplied by 0, so two updates have moved them; Adam's m/(sqrt(v)+1e-6)
  turns a gradient difference at the fp32 noise floor into a step
  difference of up to that order for gradients near zero, so a bound
  tighter than a share of lr * steps is not one the arithmetic can keep).

The ModifiedResNet fine-tune (the JAX step's BatchNorm branch): the
tiny RN of tests/test_resnet_import.py with running statistics drawn away
from their init, steps with 1 and 2 micro-batches: the tolerances above,
and the running statistics after each step within 1e-5 of JAX's
``batch_stats`` (each micro-batch normalises over its own frames and moves
them in turn). A resumed RN CLI run equals the uncut one, its BatchNorm
buffers included.

The ``gpu`` tests run a tiny fine-tune step on the card against the CPU,
for a ViT and for a ModifiedResNet tower (its forward in both modes too).
"""

import contextlib
import functools
import io
import json
import logging
import os
import signal

import numpy as np
import pytest
import torch

from hmmc_tpu_torch import losses
from hmmc_tpu_torch.config import ClipArch, CrossConfig, TaskConfig
from hmmc_tpu_torch.factory import build_model
from hmmc_tpu_torch.models.retrieval import BirdModel
from hmmc_tpu_torch.ops import image_ops
from hmmc_tpu_torch.ops.fused_attention import (fused_attention,
                                                fused_attention_backward)
from hmmc_tpu_torch.runner import finetune, prepare_finetune_batch
from hmmc_tpu_torch.train import optimization as opt
from hmmc_tpu_torch.train.trainer import (FinetuneState, make_finetune_step,
                                          split_microbatches)
from hmmc_tpu_torch.weights import from_jax_params

try:  # the reference; the card's machine has no JAX and runs the gpu tests
    import jax
    import jax.numpy as jnp
    import optax

    import hmmc_tpu.ops.pallas_attention as pa
    from hmmc_tpu import losses as jax_losses
    from hmmc_tpu.config import ClipArch as JaxClipArch
    from hmmc_tpu.config import CrossConfig as JaxCrossConfig
    from hmmc_tpu.config import TaskConfig as JaxTaskConfig
    from hmmc_tpu.models.retrieval import BirdModel as JaxBirdModel
    from hmmc_tpu.train import optimization as jax_opt
    from hmmc_tpu.train.trainer import FinetuneState as JaxFinetuneState
    from hmmc_tpu.train.trainer import \
        make_finetune_step as jax_make_finetune_step
except ImportError:
    pa = None

# tiny geometry of tests/test_torch_model.py (ViT-B/32 ratios, shrunk)
ARCH_KW = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=16, vocab_size=512,
    transformer_width=64, transformer_heads=2, transformer_layers=2)
CROSS_KW = dict(temporal_hidden_size=32, temporal_attention_heads=2,
                temporal_hidden_layers=2, max_position_embeddings=8)
FRAMES, CTX, B = 3, 16, 4
LOSS_ATOL = 1e-5
STEP_LOSS_ATOL = 1e-4
GRAD_REL = 1e-3
LR, TEXT_LR, COEF_LR = 1e-3, 1e-4, 0.5
OPT_KW = dict(lr=LR, text_lr=TEXT_LR, coef_lr=COEF_LR, weight_decay=0.2,
              warmup_proportion=0.1)


@pytest.fixture(autouse=True)
def interpret_mode(request, monkeypatch):
    if request.node.get_closest_marker("gpu") is None:
        if pa is None:
            pytest.skip("needs jax and hmmc_tpu (the reference)")
        from jax.experimental import pallas as pl

        monkeypatch.setattr(pa.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    yield


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close_rel(got, ref, rel, msg=""):
    """max |got - ref| <= rel * max |ref| (exact when ref is all zero)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() if got.size else 0.0
    bound = rel * np.abs(ref).max() if ref.size else 0.0
    assert err <= bound, f"{msg}: max diff {err:.3g} > {bound:.3g}"


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_cross_en_and_dual_softmax_match_jax():
    sim = _normal(np.random.default_rng(0), 6, 6, scale=5.0)
    for ours, ref in (
            (losses.cross_en, jax_losses.cross_en),
            (losses.get_dual_matrix, jax_losses.get_dual_matrix),
            (losses.dual_cross_en, jax_losses.dual_cross_en)):
        np.testing.assert_allclose(ours(torch.tensor(sim)).numpy(),
                                   np.asarray(ref(jnp.asarray(sim))),
                                   atol=LOSS_ATOL, rtol=1e-6)


@pytest.mark.parametrize("visual_shape", [(5, 32), (5, 3, 32)])
def test_loose_similarity_matches_jax(visual_shape):
    rng = np.random.default_rng(1)
    seq, vis = _normal(rng, 4, 32), _normal(rng, *visual_shape)
    ours = losses.loose_similarity(torch.tensor(seq), torch.tensor(vis),
                                   torch.tensor(100.0))
    ref = jax_losses.loose_similarity(jnp.asarray(seq), jnp.asarray(vis),
                                      jnp.float32(100.0))
    assert ours.shape == ref.shape == (4, *visual_shape[:-1])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=LOSS_ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("with_frames", [True, False])
def test_finetune_retrieval_loss_matches_jax(with_frames):
    rng = np.random.default_rng(2)
    q, v, f = _normal(rng, 6, 32), _normal(rng, 6, 32), _normal(rng, 6, 3, 32)
    ours = losses.finetune_retrieval_loss(
        torch.tensor(q), torch.tensor(v),
        torch.tensor(f) if with_frames else None, torch.tensor(100.0),
        0.85, 0.15)
    ref = jax_losses.finetune_retrieval_loss(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(f) if with_frames else None,
        jnp.float32(100.0), 0.85, 0.15)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                   atol=LOSS_ATOL, rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# schedules, groups, BertAdam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(opt.SCHEDULES))
def test_schedules_match_jax(name):
    for warmup in (0.002, 0.1, 0.3):
        for x in (0.0, 0.001, 0.05, 0.1, 0.2999, 0.5, 0.9, 1.0, 1.3):
            np.testing.assert_allclose(
                opt.SCHEDULES[name](x, warmup),
                float(jax_opt.SCHEDULES[name](jnp.float32(x), warmup)),
                rtol=1e-6, atol=1e-7, err_msg=f"{name} x={x} warmup={warmup}")
    # the JAX schedule takes 1 + cos(pi x) in fp32, which keeps few digits
    # near x = 1: compare multipliers to 1e-7 absolute, as above
    for step in (0, 3, 10, 50, 99):
        assert opt.scheduled_lr(1e-4, step, 100, name, 0.1) == pytest.approx(
            jax_opt.scheduled_lr(1e-4, step, 100, name, 0.1), rel=1e-6,
            abs=1e-4 * 1e-7)
    assert opt.scheduled_lr(1e-4, 5, 0) == 1e-4


@pytest.fixture(scope="module")
def jax_params():
    if pa is None:
        pytest.skip("needs jax and hmmc_tpu (the reference)")
    model = JaxBirdModel(JaxClipArch(**ARCH_KW), JaxCrossConfig(**CROSS_KW))
    params = jax.jit(model.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, CTX), jnp.int32),
        jnp.ones((1, CTX), jnp.int32),
        jnp.zeros((1, FRAMES, 32, 32, 3), jnp.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, use_fused=True) -> BirdModel:
    model = BirdModel(ClipArch(**ARCH_KW), CrossConfig(**CROSS_KW),
                      use_fused=use_fused)
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


def _to_port(tree):
    """Any parameter-shaped JAX tree -> {port name: fp32 tensor}."""
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def test_decay_mask_and_lr_tree_match_jax(jax_params):
    """The port's groups over its state_dict names equal the JAX groups
    over the flax paths, mapped through the bridge."""
    def broadcast(tree):
        return jax.tree_util.tree_map(
            lambda p, x: np.full(np.shape(p), float(x), np.float32),
            jax_params, tree)

    names = list(_port_model(jax_params).state_dict())
    for ours, ref in (
            (opt.decay_mask(names), jax_opt.decay_mask(jax_params)),
            (opt.lr_tree(names, LR, TEXT_LR, COEF_LR),
             jax_opt.lr_tree(jax_params, LR, TEXT_LR, COEF_LR))):
        mapped = _to_port(broadcast(ref))
        assert set(mapped) == set(ours)
        for n, t in mapped.items():
            np.testing.assert_allclose(t.numpy(), float(ours[n]), rtol=1e-7,
                                       err_msg=n)
    decay = opt.decay_mask(names)
    lrs = opt.lr_tree(names, LR, TEXT_LR, COEF_LR)
    assert decay["visual_encoder.visual.ln_pre.weight"]      # CLIP ln decays
    assert decay["text_encoder.logit_scale"]
    assert not decay["text_encoder.transformer.resblocks.0.attn.in_proj_bias"]
    assert lrs["visual_encoder.visual.proj"] == LR * COEF_LR
    assert lrs["visual_encoder.temporal_transformer.resblocks.0.ln_1.bias"] == LR
    assert lrs["visual_encoder.frame_position_embeddings.weight"] == LR
    assert lrs["text_encoder.logit_scale"] == TEXT_LR


@pytest.mark.parametrize("bf16_state", [False, True])
def test_bert_adam_trajectory_matches_jax(jax_params, bf16_state):
    """4 steps of build_optimizer on both sides, fed the same numpy
    gradients: large ones (the global clip engages), then small ones (it
    does not); ``logit_scale`` has no gradient on the port (a zero one in
    JAX) and is still decayed."""
    t_total = 10
    tx = jax_opt.build_optimizer(
        jax_params, t_total=t_total, **OPT_KW,
        state_dtype=jnp.bfloat16 if bf16_state else None)
    jstate = tx.init(jax_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params)
    update = jax.jit(tx.update)
    model = _port_model(jax_params)
    named = dict(model.named_parameters())
    optimizer = opt.build_optimizer(
        model.named_parameters(), t_total=t_total, **OPT_KW,
        state_dtype=torch.bfloat16 if bf16_state else None)
    assert len(optimizer.param_groups) == 6
    rng = np.random.default_rng(9)
    for step, scale in enumerate((1.0, 1.0, 1e-4, 1.0)):
        grads = jax.tree_util.tree_map(
            lambda p: _normal(rng, *np.shape(p), scale=scale), jax_params)
        grads["text_encoder"]["logit_scale"] = np.zeros((), np.float32)
        for n, g in _to_port(grads).items():
            named[n].grad = None if n.endswith("logit_scale") else g
        updates, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        optimizer.step()
        if step == 0:
            state_tol = dict(rtol=2 ** -7 if bf16_state else 1e-5, atol=1e-12)
            for key, tree in (("m", jstate[1].m), ("v", jstate[1].v)):
                for n, ref in _to_port(tree).items():
                    got = optimizer.state[named[n]][key]
                    assert got.dtype == (torch.bfloat16 if bf16_state
                                         else torch.float32)
                    np.testing.assert_allclose(got.float().numpy(),
                                               ref.numpy(), err_msg=n,
                                               **state_tol)
        # bf16 state: where an fp32 moment rounds the other way, that
        # step's update moves by up to 2^-7 of its size (<= lr * |u|)
        atol = LR * 2 ** -7 * (step + 1) if bf16_state else 1e-6
        for n, ref in _to_port(jparams).items():
            np.testing.assert_allclose(named[n].detach().numpy(), ref.numpy(),
                                       atol=atol, rtol=0,
                                       err_msg=f"step {step} {n}")
    assert float(named["text_encoder.logit_scale"]) < np.log(100.0)


# ---------------------------------------------------------------------------
# the train step against make_finetune_step
# ---------------------------------------------------------------------------

def _train_batch(seed=11, nframes=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, size=(B, CTX)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((B, CTX), np.int32)
    for r in range(B):
        ids[r, 5 + r] = ARCH_KW["vocab_size"] - 1      # EOT, the row max
        ids[r, 6 + r:] = 0
        mask[r, 6 + r:] = 0
    batch = {"query_ids": ids, "query_mask": mask,
             "video": _normal(rng, B, FRAMES, 32, 32, 3)}
    if nframes:
        batch["nframes"] = np.array([3, 1, 2, 3], np.int32)
    return batch


def _grab_grads():
    """An optax stage that keeps the latest incoming gradients in its
    state and passes them on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


@pytest.mark.parametrize("n_accum,use_fused,frame_mask", [
    (1, True, False),
    (2, False, True),
    (2, True, True),
])
def test_finetune_step_matches_jax(jax_params, n_accum, use_fused,
                                   frame_mask):
    t_total, steps = 10, 3
    cross = JaxCrossConfig(**CROSS_KW)
    jmodel = JaxBirdModel(JaxClipArch(**ARCH_KW), cross, use_pallas=use_fused)
    tx = optax.chain(_grab_grads(), jax_opt.build_optimizer(
        jax_params, t_total=t_total, **OPT_KW))
    jstep = jax_make_finetune_step(jmodel, tx, cross, use_frame_fea=True,
                                   n_accum=n_accum, use_frame_mask=frame_mask)
    jstate = JaxFinetuneState.create(
        jax.tree_util.tree_map(jnp.asarray, jax_params), tx)

    model = _port_model(jax_params, use_fused=use_fused)
    named = dict(model.named_parameters())
    state = FinetuneState(model, opt.build_optimizer(
        model.named_parameters(), t_total=t_total, **OPT_KW))
    step = make_finetune_step(CrossConfig(**CROSS_KW), use_frame_fea=True,
                              n_accum=n_accum, use_frame_mask=frame_mask)
    host = _train_batch(nframes=frame_mask)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    batch["query_ids"] = batch["query_ids"].long()
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}

    for i in range(steps):
        jstate, jmetrics = jstep(jstate, jbatch)
        state, metrics = step(state, batch)
        for k in ("loss", "sim_loss", "frame_loss"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       atol=STEP_LOSS_ATOL,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=GRAD_REL)
        if i == 0:
            for n, ref in _to_port(jstate.opt_state[0]).items():
                got = named[n].grad
                if n.endswith("logit_scale"):
                    assert got is None and float(ref) == 0.0
                    continue
                _close_rel(got.numpy(), ref.numpy(), GRAD_REL, f"grad {n}")
            adam = jstate.opt_state[1][1]
            for key, tree in (("m", adam.m), ("v", adam.v)):
                for n, ref in _to_port(tree).items():
                    _close_rel(state.optimizer.state[named[n]][key].numpy(),
                               ref.numpy(), GRAD_REL, f"{key} {n}")
    assert state.step == steps
    for n, ref in _to_port(jstate.params).items():
        lr = opt.lr_tree([n], LR, TEXT_LR, COEF_LR)[n]
        np.testing.assert_allclose(named[n].detach().numpy(), ref.numpy(),
                                   atol=0.05 * lr * 2, rtol=0, err_msg=n)
    # logit_scale: no gradient, decayed by BertAdam as in JAX
    assert float(named["text_encoder.logit_scale"]) < np.log(100.0)


# the JAX tests' tiny RN (tests/test_resnet_import.py), at this file's
# text and temporal widths
RN_ARCH_KW = dict(ARCH_KW, vision_layers=(1, 1, 1, 1), vision_width=8,
                  vision_patch_size=0)
STATS_ATOL = 1e-5
ZERO_GRAD_ATOL = 1e-6


@pytest.fixture(scope="module")
def rn_variables():
    """A JAX RN ``BirdModel``'s params and ``batch_stats`` (running means
    N(0, 0.1), variances 1 + 0.5 |N(0, 1)|)."""
    if pa is None:
        pytest.skip("needs jax and hmmc_tpu (the reference)")
    model = JaxBirdModel(JaxClipArch(**RN_ARCH_KW), JaxCrossConfig(**CROSS_KW))
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(6), jnp.zeros((1, CTX), jnp.int32),
        jnp.ones((1, CTX), jnp.int32),
        jnp.zeros((1, FRAMES, 32, 32, 3), jnp.float32))
    rng = np.random.default_rng(6)

    def draw(path, a):
        z = rng.normal(size=np.shape(a)).astype(np.float32)
        return 1.0 + 0.5 * np.abs(z) if path[-1].key == "var" else 0.1 * z

    return (jax.tree_util.tree_map(np.asarray, variables["params"]),
            jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]))


def _running_stats(sd):
    return {k: v.clone() for k, v in sd.items() if "running_" in k}


@pytest.mark.parametrize("n_accum", [1, 2])
def test_resnet_finetune_step_matches_jax(rn_variables, n_accum):
    """Two steps of the fine-tune with a ModifiedResNet tower (fp32)
    against ``make_finetune_step``'s BatchNorm branch computing in fp64
    (fp32 parameters and BertAdam, fp64 activations and statistics): losses,
    grad norm, every gradient and BertAdam's moments after step 1, the
    running statistics after each step (1e-5), the parameters after both
    (within 5% of lr * 1: step 0's update is multiplied by 0). The JAX
    step computes in fp64 because its own fp32 gradients below layer3 are off
    by up to 22% of their largest magnitude from its fp64 ones here
    (train-mode BatchNorm backward over 2-16 values a channel); the
    port's fp32 gradients are within 1e-5 of them. The attention pool's
    key bias has a gradient of 0 in exact arithmetic: held to 1e-6
    absolute (fp32 rounding), its moments not compared."""
    params, stats = rn_variables
    t_total, steps = 10, 2
    with jax.enable_x64(True):
        cross = JaxCrossConfig(**CROSS_KW)
        jmodel = JaxBirdModel(JaxClipArch(**RN_ARCH_KW), cross,
                              dtype=jnp.float64)
        tx = optax.chain(_grab_grads(), jax_opt.build_optimizer(
            params, t_total=t_total, **OPT_KW))
        jstep = jax_make_finetune_step(jmodel, tx, cross, use_frame_fea=True,
                                       n_accum=n_accum)
        jstate = JaxFinetuneState.create(params, tx, jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), stats))

    model = BirdModel(ClipArch(**RN_ARCH_KW), CrossConfig(**CROSS_KW),
                      use_fused=True)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    named = dict(model.named_parameters())
    state = FinetuneState(model, opt.build_optimizer(
        model.named_parameters(), t_total=t_total, **OPT_KW))
    step = make_finetune_step(CrossConfig(**CROSS_KW), use_frame_fea=True,
                              n_accum=n_accum)
    host = _train_batch(seed=13)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    batch["query_ids"] = batch["query_ids"].long()
    start = _running_stats(model.state_dict())
    for i in range(steps):
        with jax.enable_x64(True):
            jbatch = {k: jnp.asarray(v, jnp.float64 if k == "video" else None)
                      for k, v in host.items()}
            jstate, jmetrics = jstep(jstate, jbatch)
            jstate = jax.tree_util.tree_map(np.asarray, jstate)
        state, metrics = step(state, batch)
        for k in ("loss", "sim_loss", "frame_loss"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       atol=STEP_LOSS_ATOL,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=GRAD_REL)
        want = _running_stats(from_jax_params(
            params, jax.tree_util.tree_map(np.asarray, jstate.batch_stats)))
        got = model.state_dict()
        for k, ref in want.items():
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(),
                                       atol=STATS_ATOL, rtol=0,
                                       err_msg=f"step {i} {k}")
            assert not torch.equal(got[k], start[k]), k
        if i == 0:
            for n, ref in _to_port(jstate.opt_state[0]).items():
                if n not in named:
                    continue              # the statistics' init values
                got = named[n].grad
                if n.endswith("logit_scale"):
                    assert got is None and float(ref) == 0.0
                    continue
                if n.endswith("attnpool.k_proj.bias"):
                    # zero: a key bias moves a query's logits all alike
                    assert float(got.abs().max()) <= ZERO_GRAD_ATOL, n
                    continue
                _close_rel(got.numpy(), ref.numpy(), GRAD_REL, f"grad {n}")
            adam = jstate.opt_state[1][1]
            for key, tree in (("m", adam.m), ("v", adam.v)):
                for n, ref in _to_port(tree).items():
                    if n in named and not n.endswith("k_proj.bias"):
                        _close_rel(
                            state.optimizer.state[named[n]][key].numpy(),
                            ref.numpy(), GRAD_REL, f"{key} {n}")
    assert int(model.visual_encoder.visual.bn1.num_batches_tracked) == (
        steps * n_accum)
    for n, ref in _to_port(jstate.params).items():
        if n in named:
            lr = opt.lr_tree([n], LR, TEXT_LR, COEF_LR)[n]
            np.testing.assert_allclose(named[n].detach().numpy(),
                                       ref.numpy(), atol=0.05 * lr, rtol=0,
                                       err_msg=n)


def test_split_microbatches_and_config():
    batch = {"query_ids": torch.arange(8).reshape(4, 2),
             "video": torch.arange(4)}
    parts = split_microbatches(batch, 2)
    assert [p["video"].tolist() for p in parts] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="divisible"):
        split_microbatches(batch, 3)
    task = TaskConfig(batch_size=256, gradient_accumulation_steps=4)
    assert task.micro_batch_size == 64
    with pytest.raises(ValueError, match="gradient_accumulation_steps"):
        TaskConfig(gradient_accumulation_steps=0).validate()
    ref = JaxTaskConfig(do_train=True)
    for field in ("lr", "text_lr", "coef_lr", "weight_decay",
                  "warmup_proportion", "epochs", "batch_size",
                  "gradient_accumulation_steps", "optim_bf16_state",
                  "use_frame_mask", "n_display", "max_words", "max_frames",
                  "seed", "compute_dtype"):
        assert getattr(TaskConfig(), field) == getattr(ref, field), field


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class _Loader:
    """``n`` copies of one host batch (uint8 frames), sized."""

    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter([self.batch] * self.n)


def _u8_batch(n, seed):
    rng = np.random.default_rng(seed)
    b = _train_batch(seed)
    ids = np.concatenate([b["query_ids"]] * (n // B))
    mask = np.concatenate([b["query_mask"]] * (n // B))
    video = rng.integers(0, 256, size=(n, FRAMES, 32, 32, 3), dtype=np.uint8)
    return {"query_ids": ids, "query_mask": mask, "video": video}


def test_prepare_finetune_batch_normalizes_on_device():
    host = _u8_batch(4, 0)
    out = prepare_finetune_batch(host, "cpu")
    assert out["query_ids"].dtype == torch.int64
    ref = image_ops.normalize(torch.from_numpy(host["video"]).float() / 255.0)
    torch.testing.assert_close(out["video"], ref)


def test_run_finetune_on_cpu(caplog):
    task = TaskConfig(compute_dtype="float32", max_frames=FRAMES,
                      max_words=CTX, batch_size=B, epochs=1, n_display=1,
                      gradient_accumulation_steps=2, seed=1)
    train = _Loader(_u8_batch(B, 3), n=2)
    evals = [_u8_batch(B, 4), _u8_batch(B, 5)]
    launches = (fused_attention.launches, fused_attention_backward.launches)
    with caplog.at_level(logging.INFO, logger="hmmc_tpu_torch.runner"):
        run = finetune(task, CrossConfig(**CROSS_KW), train, evals,
                       arch=ClipArch(**ARCH_KW), device="cpu")
    assert run.state.step == 2
    assert [r["step"] for r in run.displayed] == [1, 2]
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all()
               for r in run.displayed)
    # the same batch twice: step 0's update is multiplied by 0, so both
    # losses see the initial weights; step 1's update moves them
    assert run.displayed[1]["loss"] == run.displayed[0]["loss"]
    init = build_model(task, CrossConfig(**CROSS_KW),
                       arch=ClipArch(**ARCH_KW), device="cpu")
    moved = [n for n, p in init.named_parameters()
             if not torch.equal(p, run.state.model.get_parameter(n))]
    assert "visual_encoder.visual.proj" in moved
    assert "text_encoder.logit_scale" in moved
    assert len(run.epoch_metrics) == 1
    assert run.best_metrics == run.epoch_metrics[0]
    assert {"R1", "R5", "R10", "MR"} <= set(run.best_metrics)
    assert "epoch 0 step 2 lr" in caplog.text
    assert (fused_attention.launches,
            fused_attention_backward.launches) == launches   # CPU: no kernel


def test_run_finetune_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune(TaskConfig(), CrossConfig(**CROSS_KW), [], [],
                 arch=ClipArch(**ARCH_KW))


# ---------------------------------------------------------------------------
# train-state checkpoints: a run cut by SIGTERM and resumed
# ---------------------------------------------------------------------------

RESUME_ARCH = "ViT-ResumeTest/16"


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=75)
    return buf.getvalue()


@pytest.fixture(scope="module")
def resume_layout(tmp_path_factory):
    """An MSR-VTT FramePack layout (12 videos of 4 JPEGs, two train
    captions each: 24 samples, 3 steps of 8) at the tiny arch."""
    from hmmc_tpu_torch import config as pconfig
    from hmmc_tpu_torch.data.framepack import FramePackWriter

    pconfig.CLIP_ARCH[RESUME_ARCH] = dict(ARCH_KW, vocab_size=49408,
                                          context_length=64)
    root = tmp_path_factory.mktemp("resume_data")
    rng = np.random.default_rng(0)
    vids = [f"video{i}" for i in range(12)]
    with FramePackWriter(str(root / "frames.fpk")) as w:
        for v in vids:
            w.add_video(v, [_jpeg(rng.integers(0, 255, (40, 40, 3),
                                               dtype=np.uint8))
                            for _ in range(4)])
    m = root / "msrvtt"
    m.mkdir()
    (m / "MSRVTT_JSFUSION_test.1k.csv").write_text(
        "video_id,sentence\n" + "".join(f"{v},test sentence {i}\n"
                                        for i, v in enumerate(vids)))
    (m / "MSRVTT_train.9k.csv").write_text("video_id\n" + "\n".join(vids))
    (m / "MSRVTT_data.json").write_text(json.dumps({
        "sentences": [{"video_id": v, "caption": f"a clip about {v} {j}"}
                      for v in vids for j in range(2)]}))
    cross = root / "cross-tiny.json"
    cross.write_text(json.dumps({"pretrained_clip_name": RESUME_ARCH,
                                 **CROSS_KW}))
    yield str(root), str(cross)
    pconfig.CLIP_ARCH.pop(RESUME_ARCH, None)


def _resume_args(layout, out, *extra):
    from hmmc_tpu_torch import cli

    return cli.get_args(argv=[
        "--do_train", "--output_dir", out, "--data_dir", layout[0],
        "--cross_model", layout[1], "--dataset", "msrvtt",
        "--language", "english", "--use_temp", "--use_frame_fea",
        "--max_words", "16", "--max_frames", str(FRAMES), "--batch_size",
        "8", "--gradient_accumulation_steps", "2", "--batch_size_val", "8",
        "--epochs", "1", "--n_display", "1", "--lr", "1e-3",
        "--compute_dtype", "float32", *extra])


@contextlib.contextmanager
def sigterm_after(runner_module, factory: str, step: int):
    """Wrap ``runner_module.<factory>`` so the step function it makes
    sends this process SIGTERM once the state reaches ``step``."""
    make = getattr(runner_module, factory)

    def wrapped(*a, **kw):
        fn = make(*a, **kw)

        def step_fn(state, *args, **kwargs):
            state, metrics = fn(state, *args, **kwargs)
            if state.step == step:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics

        return step_fn

    setattr(runner_module, factory, wrapped)
    try:
        yield
    finally:
        setattr(runner_module, factory, make)


@pytest.fixture(scope="module")
def uncut_run(resume_layout, tmp_path_factory):
    from hmmc_tpu_torch import runner

    out = str(tmp_path_factory.mktemp("uncut"))
    return runner.main(_resume_args(resume_layout, out), device="cpu")


@pytest.mark.parametrize("async_save", [False, True])
def test_resume_after_sigterm_equals_uncut_run(resume_layout, uncut_run,
                                               tmp_path, async_save):
    """--save_steps 1 and a SIGTERM after step 1, then --resume: the
    resumed run's later losses, its parameters, BertAdam's moments and
    the epoch's eval equal the uncut run's, bit for bit (the same CPU
    arithmetic on the same inputs: the state round-trips exactly, the
    loader skips the batch the cut run trained and the schedule reads the
    restored step). The resumed run also writes a --profile_dir trace."""
    from hmmc_tpu_torch import runner
    from hmmc_tpu_torch.train import state_io

    out = str(tmp_path / "cut")
    extra = ("--async_save",) if async_save else ()
    with sigterm_after(runner, "make_finetune_step", 1):
        cut = runner.main(_resume_args(resume_layout, out, "--save_steps",
                                       "1", *extra), device="cpu")
    assert cut.state.step == 1 and not cut.epoch_metrics
    ckpt = os.path.join(out, "ckpt")
    assert state_io.latest_step(ckpt) == 1
    meta = state_io.load_progress_meta(ckpt, 1)
    assert (meta["epoch"], meta["batch_in_epoch"], meta["epoch_end"]) == (
        0, 1, False)
    profile = str(tmp_path / "profile")
    resumed = runner.main(_resume_args(
        resume_layout, out, "--resume", "--save_steps", "1",
        "--profile_dir", profile, *extra), device="cpu")
    assert os.path.getsize(os.path.join(profile, "trace_rank0.json")) > 0
    assert resumed.state.step == uncut_run.state.step == 3
    assert [r["step"] for r in resumed.displayed] == [2, 3]
    for got, want in zip(resumed.displayed, uncut_run.displayed[1:]):
        assert got["loss"] == want["loss"] and \
            got["grad_norm"] == want["grad_norm"]
    want = dict(uncut_run.state.model.named_parameters())
    for n, p in resumed.state.model.named_parameters():
        assert torch.equal(p, want[n]), n
    moments = uncut_run.state.optimizer.moments()
    for k, tensors in resumed.state.optimizer.moments().items():
        for n, t in tensors.items():
            assert torch.equal(t, moments[k][n]), (k, n)
    assert resumed.epoch_metrics == uncut_run.epoch_metrics
    assert state_io.latest_step(ckpt) == 3      # steps 1-3 kept (max 5)
    assert state_io.load_progress_meta(ckpt, 3)["epoch_end"]


RN_RESUME_ARCH = "RN-ResumeTest"


def test_resnet_resume_after_sigterm_equals_uncut_run(resume_layout,
                                                      tmp_path):
    """The resume check with a ModifiedResNet tower (train-mode BatchNorm):
    an uncut run, and a run cut by SIGTERM after step 1 then --resume'd,
    end with the same parameters, running statistics and
    ``num_batches_tracked``, bit for bit, and the same later losses."""
    from hmmc_tpu_torch import config as pconfig
    from hmmc_tpu_torch import runner

    pconfig.CLIP_ARCH[RN_RESUME_ARCH] = dict(
        RN_ARCH_KW, vocab_size=49408, context_length=64)
    cross = tmp_path / "cross-rn.json"
    cross.write_text(json.dumps({"pretrained_clip_name": RN_RESUME_ARCH,
                                 **CROSS_KW}))
    layout = (resume_layout[0], str(cross))
    try:
        uncut = runner.main(_resume_args(layout, str(tmp_path / "uncut")),
                            device="cpu")
        out = str(tmp_path / "cut")
        with sigterm_after(runner, "make_finetune_step", 1):
            runner.main(_resume_args(layout, out, "--save_steps", "1"),
                        device="cpu")
        resumed = runner.main(_resume_args(layout, out, "--resume"),
                              device="cpu")
    finally:
        pconfig.CLIP_ARCH.pop(RN_RESUME_ARCH, None)
    assert resumed.state.model.arch.is_resnet
    assert resumed.state.step == uncut.state.step == 3
    assert [r["loss"] for r in resumed.displayed] == [
        r["loss"] for r in uncut.displayed[1:]]
    want = uncut.state.model.state_dict()
    got = resumed.state.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # 3 steps of 2 micro-batches moved every BatchNorm's statistics
    assert int(got["visual_encoder.visual.bn1.num_batches_tracked"]) == 6
    assert resumed.epoch_metrics == uncut.epoch_metrics


def test_parallel_flags(tmp_path):
    """--tp_size / --sp_size > 1 raise naming their ROADMAP item; one
    process refuses --dp_size 2 and --multihost (no torchrun world)."""
    from hmmc_tpu_torch import cli
    from hmmc_tpu_torch.parallel import distributed

    def args(*extra):
        return cli.get_args(argv=["--do_train", "--output_dir",
                                  str(tmp_path), "--language", "english",
                                  *extra])

    for flag in ("--tp_size", "--sp_size"):
        with pytest.raises(ValueError, match="Queue A 13"):
            cli.to_task_config(args(flag, "2"))
        with pytest.raises(ValueError, match="Queue A 13"):
            distributed.init_distributed(args(flag, "2"), "cpu")
    with pytest.raises(ValueError, match="world size 1"):
        distributed.init_distributed(args("--dp_size", "2"), "cpu")
    with pytest.raises(ValueError, match="torchrun"):
        distributed.init_distributed(args("--multihost"), "cpu")
    device, created = distributed.init_distributed(
        args("--dp_size", "1", "--zero_opt"), "cpu")
    assert device == "cpu" and not created


# ---------------------------------------------------------------------------
# on the card: a tiny fine-tune step against the CPU
# ---------------------------------------------------------------------------

# head_dim 64 everywhere, as the kernels require
GPU_ARCH_KW = dict(ARCH_KW, embed_dim=128, vision_width=128,
                   transformer_width=128)
GPU_CROSS_KW = dict(CROSS_KW, temporal_hidden_size=128)
# a ModifiedResNet at 64 px: its attention pool 512 wide in 8 heads
GPU_RN_ARCH_KW = dict(GPU_ARCH_KW, image_resolution=64,
                      vision_layers=(1, 1, 1, 1), vision_width=16,
                      vision_patch_size=0)


@pytest.mark.gpu
def test_resnet_tower_and_step_on_card_match_cpu():
    """fp32, TF32 off: the ModifiedResNet tower's forward in eval and in
    train mode (output atol 1e-4, running statistics after it 1e-5), then
    one fine-tune step of 2 micro-batches (loss 1e-4, gradients within 1e-3
    of their largest magnitude, running statistics 1e-5), cuDNN's
    convolutions and the kernels on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, cross = ClipArch(**GPU_RN_ARCH_KW), CrossConfig(**GPU_CROSS_KW)
    host = _u8_batch(B, 7)
    host["video"] = np.random.default_rng(7).integers(
        0, 256, size=(B, FRAMES, 64, 64, 3), dtype=np.uint8)
    runs = {}
    for name, dev, switch in (("card", "cuda", "on"), ("cpu", "cpu", "off")):
        task = TaskConfig(compute_dtype="float32", max_frames=FRAMES,
                          use_fused_attention=switch, seed=4)
        model = build_model(task, cross, arch=arch, device=dev)
        batch = prepare_finetune_batch(host, dev)
        frames = batch["video"].flatten(0, 1)
        with torch.no_grad():
            towers = [model.visual_encoder.visual(frames, t).cpu()
                      for t in (False, True)]
        state = FinetuneState(model, opt.build_optimizer(
            model.named_parameters(), t_total=10, **OPT_KW))
        _, metrics = make_finetune_step(cross, n_accum=2)(state, batch)
        runs[name] = dict(
            towers=towers, loss=float(metrics["loss"]),
            grads={n: p.grad.cpu() for n, p in model.named_parameters()
                   if p.grad is not None},
            stats={k: v.cpu() for k, v in model.state_dict().items()
                   if "running_" in k})
    for got, want in zip(runs["card"]["towers"], runs["cpu"]["towers"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert abs(runs["card"]["loss"] - runs["cpu"]["loss"]) <= STEP_LOSS_ATOL
    assert set(runs["card"]["grads"]) == set(runs["cpu"]["grads"])
    for n, ref in runs["cpu"]["grads"].items():
        if n.endswith("attnpool.k_proj.bias"):
            continue                      # 0 in exact arithmetic
        _close_rel(runs["card"]["grads"][n].numpy(), ref.numpy(), GRAD_REL,
                   f"grad {n}")
    for k, ref in runs["cpu"]["stats"].items():
        torch.testing.assert_close(runs["card"]["stats"][k], ref, rtol=0,
                                   atol=STATS_ATOL, msg=k)


@pytest.mark.gpu
def test_finetune_step_on_card_matches_cpu():
    """fp32, TF32 off: two steps with the kernels on the card against the
    plain attention on the CPU, same weights and batch. Loss atol 1e-4,
    gradients within 1e-3 of their largest magnitude, parameters after the
    second step within 5% of lr (sums in another order, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, cross = ClipArch(**GPU_ARCH_KW), CrossConfig(**GPU_CROSS_KW)
    host = _u8_batch(B, 6)
    runs = {}
    for name, dev, switch in (("card", "cuda", "on"), ("cpu", "cpu", "off")):
        task = TaskConfig(compute_dtype="float32", max_frames=FRAMES,
                          use_fused_attention=switch, seed=2)
        model = build_model(task, cross, arch=arch, device=dev)
        state = FinetuneState(model, opt.build_optimizer(
            model.named_parameters(), t_total=10, **OPT_KW))
        step = make_finetune_step(cross, n_accum=2)
        batch = prepare_finetune_batch(host, dev)
        before = (fused_attention.launches, fused_attention_backward.launches)
        state, metrics = step(state, batch)
        after = (fused_attention.launches, fused_attention_backward.launches)
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        state, _ = step(state, batch)
        runs[name] = dict(loss=float(metrics["loss"]), grads=grads,
                          launches=[a - b for a, b in zip(after, before)],
                          params={n: p.detach().cpu() for n, p in
                                  model.named_parameters()})
    per_step = (arch.vision_layers + arch.transformer_layers
                + cross.temporal_hidden_layers) * 2
    assert runs["card"]["launches"] == [per_step, per_step]
    assert runs["cpu"]["launches"] == [0, 0]
    assert abs(runs["card"]["loss"] - runs["cpu"]["loss"]) <= STEP_LOSS_ATOL
    assert set(runs["card"]["grads"]) == set(runs["cpu"]["grads"])
    for n, ref in runs["cpu"]["grads"].items():
        _close_rel(runs["card"]["grads"][n].numpy(), ref.numpy(), GRAD_REL,
                   f"grad {n}")
    for n, ref in runs["cpu"]["params"].items():
        lr = opt.lr_tree([n], LR, TEXT_LR, COEF_LR)[n]
        np.testing.assert_allclose(runs["card"]["params"][n].numpy(),
                                   ref.numpy(), atol=0.05 * lr, rtol=0,
                                   err_msg=n)
