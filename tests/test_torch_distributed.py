"""Data parallelism of the port over two ranks, on the CPU in fp32: gloo,
one process per rank, against one rank (no process group) and against the
JAX package's single-process step on the same global batch and weights.

What is held:
- (a) a fine-tune step with ``n_accum=2``: losses, ``grad_norm`` and the
  parameters after 2 steps; the same with a ModifiedResNet tower (train-
  mode BatchNorm over the global micro-batch), its running statistics
  too, against one rank;
- (b) a pretrain step with ``n_accum=2``: the four losses, ``grad_norm``,
  the queues, ``ptr``, the BatchNorm running statistics and the
  parameters and key towers after 2 steps;
- (c) ``--zero_opt`` (ZeRO-1 by whole parameters) against no ZeRO, and its
  moments gathered by name;
- (d) the sharded eval (blocks dealt out over the ranks, a partial last
  block, one rank without text blocks) and ``--do_extract``'s
  ``features.npz`` (written by rank 0 alone) against one rank;
- (e) the rank shard of ``BatchLoader`` against the JAX micro-batch
  composition (numpy only, no spawn), the final partial batch included;
- (f) a ZeRO fine-tune through ``runner.main`` where rank 1 alone receives
  SIGTERM after step 1: both ranks save the same state and stop, and one
  rank without ZeRO resumes it to the uncut run's result.

Each scenario set spawns one 2-rank group (:class:`Group`): a free port,
this file run as a script per rank, every rank killed when the set fails
or outlives its timeout (at most 120 s). Tolerances: world 2 against
world 1 1e-5 max abs (an all-reduce sums two partial gradients where one
rank sums every row, and the BatchNorm sums go over ranks, so the last
fp32 bits differ); against JAX 1e-4 max abs, the parity tolerance of
tests/test_torch_train.py and tests/test_torch_pretrain.py for the same
quantities (an Adam step turns a gradient difference at the noise floor
into a step difference of up to lr, and 0.05 * 2 * lr = 1e-4 at lr 1e-3),
losses 1e-5 relative to JAX as there.
"""

import argparse
import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:            # run as a script: a rank of a group
    sys.path.insert(0, REPO)

from hmmc_tpu_torch import cli as pcli  # noqa: E402
from hmmc_tpu_torch import config as pconfig  # noqa: E402
from hmmc_tpu_torch import runner as prunner  # noqa: E402
from hmmc_tpu_torch.config import ClipArch, CrossConfig  # noqa: E402
from hmmc_tpu_torch.data.loader import BatchLoader, rank_rows  # noqa: E402
from hmmc_tpu_torch.evaluation import Evaluator  # noqa: E402
from hmmc_tpu_torch.factory import build_model  # noqa: E402
from hmmc_tpu_torch.models.pretrain import (  # noqa: E402
    BirdPretrainModel, MaskDecisions, MoCoQueues, init_key_params)
from hmmc_tpu_torch.models.retrieval import BirdModel  # noqa: E402
from hmmc_tpu_torch.parallel import distributed  # noqa: E402
from hmmc_tpu_torch.tokenization import ClipTokenizer  # noqa: E402
from hmmc_tpu_torch.train import optimization as opt  # noqa: E402
from hmmc_tpu_torch.train import state_io  # noqa: E402
from hmmc_tpu_torch.train.trainer import (  # noqa: E402
    FinetuneState, PretrainState, make_finetune_step, make_pretrain_step)

# tiny geometry of tests/test_torch_train.py and test_torch_pretrain.py
ARCH_KW = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=16, vocab_size=512,
    transformer_width=64, transformer_heads=2, transformer_layers=2)
CROSS_KW = dict(temporal_hidden_size=32, temporal_attention_heads=2,
                temporal_hidden_layers=2, max_position_embeddings=8)
FRAMES, CTX, B, N_ACCUM, K, STEPS, WORLD = 3, 16, 8, 2, 16, 2, 2
MASK_ID, PAD_ID, CLS_ID = 500, 511, 510
FT_OPT = dict(lr=1e-3, text_lr=1e-4, coef_lr=0.5, weight_decay=0.2,
              warmup_proportion=0.1)
PRE_OPT = dict(lr=1e-4, text_lr=1e-5, coef_lr=1.0, weight_decay=0.2,
               warmup_proportion=0.1)
MOMENTUM, TEMP = 0.9, 0.07
WORLD_ATOL = 1e-5
JAX_ATOL = 1e-4
JAX_LOSS_RTOL = 1e-5
SPAWN_TIMEOUT_S = 120
# the CLI scenarios' tiny arch (a CLIP vocabulary: the CLI's tokenizer)
TINY_NAME = "ViT-DistTest/16"
TINY_ARCH = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=64, vocab_size=49408,
    transformer_width=32, transformer_heads=2, transformer_layers=2)
N_VIDEOS, STORED = 12, 4
EVAL_BLOCK = 5                       # 12 clips: blocks of 5, 5, 2


# ---------------------------------------------------------------------------
# the runs, the same code at one rank (here) and at two (the children)
# ---------------------------------------------------------------------------

def _local(batch, rank=0, world=1):
    rows = rank_rows(B, N_ACCUM, rank, world)
    return {k: v[rows] for k, v in batch.items()}


def finetune_run(inputs, zero=False):
    model = BirdModel(ClipArch(**inputs.get("arch", ARCH_KW)),
                      CrossConfig(**CROSS_KW), use_fused=True)
    model.load_state_dict(inputs["weights"], strict=True)
    state = FinetuneState(model, opt.build_optimizer(
        model.named_parameters(), t_total=10, zero=zero, **FT_OPT))
    step = make_finetune_step(CrossConfig(**CROSS_KW), use_frame_fea=True,
                              n_accum=N_ACCUM)
    batch = _local(inputs["batch"], distributed.rank(),
                   distributed.world_size())
    out = {"loss": [], "sim_loss": [], "frame_loss": [], "grad_norm": []}
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        for k in out:
            out[k].append(float(metrics[k]))
    out["params"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    out["buffers"] = {n: b.clone() for n, b in model.named_buffers()}
    out["moments"] = state.optimizer.moments()
    return out


def pretrain_run(inputs):
    start = inputs["start"]
    arch, cross = ClipArch(**ARCH_KW), CrossConfig(**CROSS_KW)
    model = BirdPretrainModel(arch, cross, vocab_size=512, use_fused=True)
    model.load_state_dict(start["model"], strict=True)
    towers = init_key_params(model)
    towers.load_state_dict(start["towers"], strict=True)
    queues = MoCoQueues(**{f: v.clone() for f, v in start["queues"].items()},
                        ptr=start["ptr"])
    state = PretrainState(model, towers, queues, opt.build_optimizer(
        model.named_parameters(), t_total=10, **PRE_OPT))
    step = make_pretrain_step(cross, MASK_ID, PAD_ID, CLS_ID,
                              temperature=TEMP, momentum=MOMENTUM,
                              n_accum=N_ACCUM)
    batch = _local(inputs["batch"], distributed.rank(),
                   distributed.world_size())
    names = ("loss", "loss_FAM", "loss_VTM", "loss_FTM", "loss_MLM",
             "grad_norm")
    out = {k: [] for k in names}
    for s in range(STEPS):
        decisions = [{name: MaskDecisions(**d) for name, d in mb.items()}
                     for mb in inputs["decisions"][s]]
        state, metrics = step(state, batch, decisions=decisions)
        for k in names:
            out[k].append(float(metrics[k]))
    out["model"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["towers"] = {k: v.clone() for k, v in towers.state_dict().items()}
    out["queues"] = {f: getattr(queues, f).clone() for f in queues.NAMES}
    out["ptr"] = queues.ptr
    return out


def _register_tiny():
    pconfig.CLIP_ARCH[TINY_NAME] = TINY_ARCH


def cli_argv(layout, out, *extra):
    data_dir, cross = layout
    return ["--output_dir", out, "--data_dir", data_dir,
            "--cross_model", cross, "--dataset", "msrvtt",
            "--language", "english", "--use_temp", "--use_frame_fea",
            "--max_words", "16", "--max_frames", "4", "--batch_size", "8",
            "--gradient_accumulation_steps", "2", "--batch_size_val", "8",
            "--epochs", "1", "--num_thread_reader", "1", "--n_display", "1",
            "--lr", "1e-3", "--compute_dtype", "float32", *extra]


def eval_run(layout):
    """Evaluator.cache_features and run at blocks of 5 over the 12 test
    clips."""
    _register_tiny()
    args = pcli.get_args(argv=cli_argv(layout, layout[0] + "/unused",
                                       "--do_eval"))
    task, cross = prunner._task_with_resolution(args)
    loader, dataset = pconfig_factory(task)
    model = build_model(task, cross, device="cpu")
    ev = Evaluator(model, task, query_block=EVAL_BLOCK,
                   text_block=EVAL_BLOCK, video_block=EVAL_BLOCK,
                   device="cpu")
    q, v, f, _, _ = ev.cache_features(loader, dataset)
    return {"q": q, "v": v, "f": f, "metrics": ev.run(loader, dataset)}


def pconfig_factory(task):
    from hmmc_tpu_torch.data.registry import get_factory

    return get_factory("msrvtt", "test")(task, ClipTokenizer())


def extract_run(layout, out):
    _register_tiny()
    return prunner.main(pcli.get_args(argv=cli_argv(layout, out,
                                                    "--do_extract")),
                        device="cpu")


def preempted_zero_run(layout, out):
    """--do_train --zero_opt; rank 1 alone receives SIGTERM after its
    first step."""
    _register_tiny()
    make = prunner.make_finetune_step

    def make_signalling(*a, **kw):
        step = make(*a, **kw)

        def signalling(state, batch):
            state, metrics = step(state, batch)
            if distributed.rank() == 1 and state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics

        return signalling

    prunner.make_finetune_step = make_signalling
    try:
        run = prunner.main(pcli.get_args(argv=cli_argv(
            layout, out, "--do_train", "--zero_opt", "--dp_size", "2")),
            device="cpu")
    finally:
        prunner.make_finetune_step = make
    return {"step": run.state.step,
            "losses": [r["loss"] for r in run.displayed],
            "files": sorted(os.listdir(os.path.join(out, "ckpt")))}


SCENARIOS = {"finetune": lambda s, i: finetune_run(i["finetune"]),
             "finetune_rn": lambda s, i: finetune_run(i["finetune_rn"]),
             "finetune_zero": lambda s, i: finetune_run(i["finetune"], True),
             "pretrain": lambda s, i: pretrain_run(i["pretrain"]),
             "eval": lambda s, i: eval_run(s["layout"]),
             "extract": lambda s, i: extract_run(s["layout"], s["extract"]),
             "preempted_zero": lambda s, i: preempted_zero_run(
                 s["layout"], s["preempt"])}


def child_main(spec_path: str) -> None:
    """One rank: join the group from the environment, run the spec's
    scenarios, save what they return."""
    torch.set_num_threads(2)
    with open(spec_path) as f:
        spec = json.load(f)
    ns = argparse.Namespace(tp_size=1, sp_size=1, dp_size=WORLD,
                            dcn_dp_size=WORLD, multihost=False)
    _, created = distributed.init_distributed(ns, "cpu")
    assert created and distributed.world_size() == WORLD
    inputs = (torch.load(spec["inputs"], weights_only=True)
              if spec.get("inputs") else {})
    out = {name: SCENARIOS[name](spec, inputs) for name in spec["scenarios"]}
    torch.save(out, spec["out"] % distributed.rank())
    distributed.shutdown()


# ---------------------------------------------------------------------------
# spawning a group
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Group:
    """A 2-rank gloo group running this file's ``child_main`` on a spec,
    started at construction; :meth:`results` waits (at most
    ``SPAWN_TIMEOUT_S`` from the start) and kills every rank on failure or
    timeout."""

    def __init__(self, tmp, name, scenarios, **spec):
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S
        self.out = str(tmp / f"{name}_out_%d.pt")
        spec_path = str(tmp / f"{name}_spec.json")
        with open(spec_path, "w") as f:
            json.dump(dict(spec, scenarios=scenarios, out=self.out), f)
        port = _free_port()
        self.logs, self.procs = [], []
        for r in range(WORLD):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="2")
            env.pop("LOCAL_WORLD_SIZE", None)
            log = open(str(tmp / f"{name}_rank{r}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec_path],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=10)

    def results(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self._kill()
            pytest.fail(f"a rank outlived {SPAWN_TIMEOUT_S} s:\n"
                        + self._tails())
        finally:
            self._kill()
        if any(p.returncode for p in self.procs):
            pytest.fail("a rank failed:\n" + self._tails())
        return [torch.load(self.out % r, weights_only=False)
                for r in range(WORLD)]

    def _tails(self):
        out = []
        for r, log in enumerate(self.logs):
            log.seek(0)
            out.append(f"--- rank {r} ---\n" + log.read()[-3000:])
        return "\n".join(out)


# ---------------------------------------------------------------------------
# the JAX references and the inputs
# ---------------------------------------------------------------------------

def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _ids(rng, n):
    ids = rng.integers(1, 400, size=(n, CTX)).astype(np.int32)
    ids[:, 0] = CLS_ID
    for r in range(n):
        ids[r, 5 + r % 8] = PAD_ID       # EOT (the row's maximum), pad id
        ids[r, 6 + r % 8:] = 0
    return ids


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from hmmc_tpu.config import ClipArch as JaxClipArch
    from hmmc_tpu.config import CrossConfig as JaxCrossConfig
    from hmmc_tpu.models import pretrain as jax_pretrain
    from hmmc_tpu.models.retrieval import BirdModel as JaxBirdModel
    from hmmc_tpu.train import optimization as jax_opt
    from hmmc_tpu.train import trainer as jax_trainer
    return dict(jax=jax, jnp=jnp, JaxClipArch=JaxClipArch,
                JaxCrossConfig=JaxCrossConfig, jax_pretrain=jax_pretrain,
                JaxBirdModel=JaxBirdModel, jax_opt=jax_opt,
                jax_trainer=jax_trainer)


def _jax_finetune(j):
    """(the inputs of the port's runs, a function that runs the JAX steps
    and returns their metrics and final parameters)."""
    jax, jnp = j["jax"], j["jnp"]
    from hmmc_tpu_torch.weights import from_jax_params

    cross = j["JaxCrossConfig"](**CROSS_KW)
    model = j["JaxBirdModel"](j["JaxClipArch"](**ARCH_KW), cross,
                              use_pallas=False)
    rng = np.random.default_rng(11)
    ids = _ids(rng, B)
    batch = {"query_ids": ids, "query_mask": (ids > 0).astype(np.int32),
             "video": _normal(rng, B, FRAMES, 32, 32, 3)}
    params = jax.jit(model.init)(
        jax.random.PRNGKey(5), jnp.asarray(ids[:1]),
        jnp.asarray(batch["query_mask"][:1]),
        jnp.asarray(batch["video"][:1]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tx = j["jax_opt"].build_optimizer(params, t_total=10, **FT_OPT)
    step = j["jax_trainer"].make_finetune_step(model, tx, cross,
                                               use_frame_fea=True,
                                               n_accum=N_ACCUM)

    def run():
        state = j["jax_trainer"].FinetuneState.create(
            jax.tree_util.tree_map(jnp.asarray, params), tx)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, from_jax_params(
            jax.tree_util.tree_map(np.asarray, state.params))

    inputs = {"weights": from_jax_params(params),
              "batch": {"query_ids": torch.from_numpy(ids).long(),
                        "video": torch.from_numpy(batch["video"])}}
    return inputs, run


def _jax_decisions(jax, key, shape):
    r_sel, r_rep, r_rand, r_words = jax.random.split(key, 4)
    return {"select": torch.tensor(np.asarray(
                jax.random.bernoulli(r_sel, 0.15, shape))),
            "replace": torch.tensor(np.asarray(
                jax.random.bernoulli(r_rep, 0.8, shape))),
            "randomize": torch.tensor(np.asarray(
                jax.random.bernoulli(r_rand, 0.5, shape))),
            "words": torch.tensor(np.asarray(jax.random.randint(
                r_words, shape, 0, 512))).long()}


def _jax_pretrain(j):
    jax, jnp = j["jax"], j["jnp"]
    from hmmc_tpu.config import TaskConfig as JaxTaskConfig

    from hmmc_tpu_torch.weights import from_jax_pretrain_state

    arch, cross = j["JaxClipArch"](**ARCH_KW), j["JaxCrossConfig"](**CROSS_KW)
    model = j["jax_pretrain"].BirdPretrainModel(arch, cross, vocab_size=512)
    rng = np.random.default_rng(7)
    ids = _ids(rng, B)
    video = _normal(rng, B, FRAMES, 32, 32, 3)
    mask = (ids > 0).astype(np.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), ids[:1],
                                    mask[:1], video[:1])
    tx = j["jax_opt"].build_optimizer(variables["params"], t_total=10,
                                      **PRE_OPT)

    def create(v, key):
        queues = j["jax_pretrain"].MoCoQueues.create(
            key, ARCH_KW["embed_dim"], K, FRAMES)
        return j["jax_trainer"].PretrainState.create(v, tx, queues)

    start = jax.tree_util.tree_map(np.asarray, jax.jit(create)(
        variables, jax.random.PRNGKey(1)))
    task = JaxTaskConfig(do_pretrain=True, dataset="vatex",
                         contrast_num_negative=K, max_frames=FRAMES,
                         contrast_temperature=TEMP,
                         contrast_momentum=MOMENTUM)
    step = j["jax_trainer"].make_pretrain_step(
        model, tx, cross, task, mask_token_id=MASK_ID, pad_token_id=PAD_ID,
        cls_token_id=CLS_ID, n_accum=N_ACCUM)
    jb = {"title_ids": jnp.asarray(ids), "title_mask": jnp.asarray(mask),
          "video": jnp.asarray(video)}
    keys = [jax.random.PRNGKey(100 + s) for s in range(STEPS)]
    # make_pretrain_step's draws: one key a micro-batch, titles first
    decisions = [[{"title": _jax_decisions(
        jax, jax.random.split(k)[0], (B // N_ACCUM, CTX))}
        for k in jax.random.split(key, N_ACCUM)] for key in keys]

    def run():
        state = jax.tree_util.tree_map(jnp.asarray, start)
        metrics = []
        for key in keys:
            state, m = step(state, jb, key)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, from_jax_pretrain_state(
            jax.tree_util.tree_map(np.asarray, state))

    inputs = {"start": from_jax_pretrain_state(start),
              "batch": {"title_ids": torch.from_numpy(ids).long(),
                        "video": torch.from_numpy(video)},
              "decisions": decisions}
    return inputs, run


# the JAX tests' tiny RN (tests/test_resnet_import.py) at ARCH_KW's text
RN_ARCH_KW = dict(ARCH_KW, vision_layers=[1, 1, 1, 1], vision_width=8,
                  vision_patch_size=0)


def _resnet_finetune_inputs(batch):
    """A ModifiedResNet model's seeded weights (running statistics drawn
    away from their init) and the fine-tune batch."""
    model = BirdModel(ClipArch(**RN_ARCH_KW), CrossConfig(**CROSS_KW))
    g = torch.Generator().manual_seed(8)
    model.reset_parameters(g)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.normal_(0.0, 0.1, generator=g)
        elif k.endswith("running_var"):
            v.uniform_(1.0, 1.5, generator=g)
    return {"arch": RN_ARCH_KW, "weights": sd, "batch": batch}


@pytest.fixture(scope="module")
def runs(jax_ref, layout, tmp_path_factory):
    """Both 2-rank groups, started as soon as their inputs exist (the JAX
    inits' weights and draws, the FramePack layout); while they run, this
    process takes the JAX steps and the one-rank runs."""
    tmp = tmp_path_factory.mktemp("dist")
    ft_inputs, ft_jax_run = _jax_finetune(jax_ref)
    pre_inputs, pre_jax_run = _jax_pretrain(jax_ref)
    rn_inputs = _resnet_finetune_inputs(ft_inputs["batch"])
    path = str(tmp / "inputs.pt")
    torch.save({"finetune": ft_inputs, "pretrain": pre_inputs,
                "finetune_rn": rn_inputs}, path)
    spec = dict(layout=list(layout), extract=str(tmp / "extract2"),
                preempt=str(tmp / "preempt2"))
    groups = (Group(tmp, "steps", ["finetune", "finetune_zero", "pretrain",
                                   "finetune_rn"], inputs=path),
              Group(tmp, "cli", ["eval", "extract", "preempted_zero"],
                    **spec))
    out = dict(spec=spec)
    out["ft_jax"], out["ft_jax_params"] = ft_jax_run()
    out["pre_jax"], out["pre_jax_final"] = pre_jax_run()
    out["one"] = {
        "finetune": finetune_run(ft_inputs),
        "finetune_rn": finetune_run(rn_inputs),
        "pretrain": pretrain_run(pre_inputs),
        "eval": eval_run(layout),
        "extract": extract_run(layout, str(tmp / "extract1")),
        "uncut": prunner.main(pcli.get_args(argv=cli_argv(
            layout, str(tmp / "uncut"), "--do_train")), device="cpu")}
    two = [g.results() for g in groups]
    out["two"] = [dict(a, **b) for a, b in zip(*two)]
    return out


@pytest.fixture
def steps(runs):
    return runs


def _max_diff(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def _assert_close_dicts(got, want, atol, what):
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        d = _max_diff(got[name], ref)
        assert d <= atol, f"{what} {name}: {d} > {atol}"


def test_finetune_two_ranks_equal_one_and_jax(steps):
    one, two = steps["one"]["finetune"], steps["two"]
    for r in range(WORLD):
        got = two[r]["finetune"]
        for k in ("loss", "sim_loss", "frame_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], one[k], atol=WORLD_ATOL,
                                       rtol=0, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(
                got[k], [m[k] for m in steps["ft_jax"]], rtol=JAX_LOSS_RTOL
                if k != "grad_norm" else 1e-3, err_msg=f"jax {k}")
        _assert_close_dicts(got["params"], one["params"], WORLD_ATOL,
                            f"rank {r} vs one rank")
        _assert_close_dicts(got["params"], steps["ft_jax_params"], JAX_ATOL,
                            f"rank {r} vs jax")
    # the ranks hold the same parameters, bit for bit
    _assert_close_dicts(two[1]["finetune"]["params"],
                        two[0]["finetune"]["params"], 0.0, "rank 1 vs 0")


def test_resnet_finetune_two_ranks_equal_one(steps):
    """A ModifiedResNet tower's fine-tune over two ranks: its train-mode
    BatchNorm takes the global micro-batch's statistics (sums over the
    ranks, and its backward's two sums too), so the parameters and
    running statistics equal one rank's within 1e-5 and every rank holds
    the same, bit for bit; the losses (about 30 here: fp32 steps of 4e-6)
    and grad norm within 1e-5 relative."""
    one, two = steps["one"]["finetune_rn"], steps["two"]
    assert any(k.endswith("running_var") for k in one["buffers"])
    for r in range(WORLD):
        got = two[r]["finetune_rn"]
        for k in ("loss", "sim_loss", "frame_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], one[k], rtol=WORLD_ATOL,
                                       atol=0, err_msg=f"rank {r} {k}")
        _assert_close_dicts(got["params"], one["params"], WORLD_ATOL,
                            f"rank {r} vs one rank")
        _assert_close_dicts(got["buffers"], one["buffers"], WORLD_ATOL,
                            f"rank {r} statistics vs one rank")
        for k, v in got["buffers"].items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == int(one["buffers"][k]) == STEPS * N_ACCUM
    for kind in ("params", "buffers"):
        _assert_close_dicts(two[1]["finetune_rn"][kind],
                            two[0]["finetune_rn"][kind], 0.0, "rank 1 vs 0")


def test_zero_opt_equals_no_zero(steps):
    for r in range(WORLD):
        zero, plain = steps["two"][r]["finetune_zero"], \
            steps["two"][r]["finetune"]
        assert zero["loss"] == plain["loss"]
        assert zero["grad_norm"] == plain["grad_norm"]
        _assert_close_dicts(zero["params"], plain["params"], 0.0,
                            f"rank {r} zero")
        for k in ("m", "v"):      # gathered from their owners, by name
            assert set(zero["moments"][k]) == set(plain["moments"][k])
            _assert_close_dicts(zero["moments"][k], plain["moments"][k],
                                0.0, f"rank {r} zero {k}")
    owners = opt.zero_owners([p.numel() for p in
                              steps["two"][0]["finetune"]["params"].values()],
                             WORLD)
    assert set(owners) == {0, 1}


def test_pretrain_two_ranks_equal_one_and_jax(steps):
    one, two = steps["one"]["pretrain"], steps["two"]
    final = steps["pre_jax_final"]
    names = ("loss", "loss_FAM", "loss_VTM", "loss_FTM", "loss_MLM")
    for r in range(WORLD):
        got = two[r]["pretrain"]
        for k in names + ("grad_norm",):
            np.testing.assert_allclose(got[k], one[k], atol=WORLD_ATOL,
                                       rtol=0, err_msg=f"rank {r} {k}")
        for k in names:
            np.testing.assert_allclose(
                got[k], [m[k] for m in steps["pre_jax"]],
                rtol=JAX_LOSS_RTOL, err_msg=f"jax {k}")
        assert got["ptr"] == one["ptr"] == final["ptr"]
        for part, want in (("model", final["model"]),
                           ("towers", final["towers"]),
                           ("queues", final["queues"])):
            _assert_close_dicts(got[part], one[part], WORLD_ATOL,
                                f"rank {r} {part} vs one rank")
            _assert_close_dicts(got[part], want, JAX_ATOL,
                                f"rank {r} {part} vs jax")
    for part in ("model", "towers", "queues"):
        _assert_close_dicts(two[1]["pretrain"][part],
                            two[0]["pretrain"][part], 0.0, f"{part} 1 vs 0")
    bn = "v_projector.linear_hidden.2.running_var"
    assert _max_diff(two[0]["pretrain"]["towers"][bn],
                     steps["one"]["pretrain"]["towers"][bn]) <= WORLD_ATOL


# ---------------------------------------------------------------------------
# the rank shard of BatchLoader
# ---------------------------------------------------------------------------

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int32(i)}


@pytest.mark.parametrize("n,drop_last", [(40, True), (37, False)])
def test_rank_shard_holds_the_jax_micro_batches(n, drop_last):
    """Rank r's local micro-batch i is its contiguous half of the global
    micro-batch i that the JAX step takes (``reshape(n_accum,
    B / n_accum)`` of the single-process batch); a final partial batch is
    wrap-padded to a multiple of n_accum x world first."""
    from hmmc_tpu.data import loader as jloader

    batch, n_accum, world = 8, 2, 2
    ref = jloader.BatchLoader(_Indexed(n), batch_size=batch, shuffle=True,
                              drop_last=drop_last, num_workers=2, seed=3)
    ref.set_epoch(1)
    want = [b["idx"] for b in ref]
    shards = []
    for r in range(world):
        ld = BatchLoader(_Indexed(n), batch_size=batch, shuffle=True,
                         drop_last=drop_last, num_workers=2, seed=3,
                         process_index=r, process_count=world,
                         n_accum=n_accum)
        ld.set_epoch(1)
        shards.append([b["idx"] for b in ld])
        assert len(ld) == len(ref)
        np.testing.assert_array_equal(ld.global_rows(),
                                      rank_rows(batch, n_accum, r, world))
    assert len(shards[0]) == len(want)
    for g, full in enumerate(want):
        unit = n_accum * world
        padded = np.resize(full, -(-len(full) // unit) * unit)
        m = len(padded) // n_accum
        for i in range(n_accum):
            gathered = np.concatenate(
                [s[g].reshape(n_accum, -1)[i] for s in shards])
            np.testing.assert_array_equal(gathered, padded[i * m:(i + 1) * m])
        np.testing.assert_array_equal(padded[:len(full)], full)
    # skip_batches stays exact: the same shards from the second batch on
    ld = BatchLoader(_Indexed(n), batch_size=batch, shuffle=True,
                     drop_last=drop_last, seed=3, process_index=1,
                     process_count=world, n_accum=n_accum)
    ld.set_epoch(1)
    ld.skip_batches(1)
    assert [b["idx"].tolist() for b in ld] == [s.tolist()
                                               for s in shards[1][1:]]
    with pytest.raises(ValueError, match="divide"):
        BatchLoader(_Indexed(n), batch_size=6, process_count=world,
                    n_accum=n_accum)


# ---------------------------------------------------------------------------
# the sharded eval and extract; a ZeRO run cut on one rank and resumed
# ---------------------------------------------------------------------------

def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=75)
    return buf.getvalue()


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    from hmmc_tpu_torch.data.framepack import FramePackWriter

    root = tmp_path_factory.mktemp("dist_data")
    rng = np.random.default_rng(0)
    vids = [f"video{i}" for i in range(N_VIDEOS)]
    with FramePackWriter(str(root / "frames.fpk")) as w:
        for v in vids:
            w.add_video(v, [_jpeg(rng.integers(0, 255, (40, 40, 3),
                                               dtype=np.uint8))
                            for _ in range(STORED)])
    m = root / "msrvtt"
    m.mkdir()
    (m / "MSRVTT_JSFUSION_test.1k.csv").write_text(
        "video_id,sentence\n" + "".join(
            f"{v},test sentence {i}\n" for i, v in enumerate(vids)))
    (m / "MSRVTT_train.9k.csv").write_text("video_id\n" + "\n".join(vids))
    (m / "MSRVTT_data.json").write_text(json.dumps({
        "sentences": [{"video_id": v, "caption": f"a clip about {v} "
                       f"number {j}"} for v in vids for j in range(2)]}))
    cross = root / "cross-tiny.json"
    cross.write_text(json.dumps({"pretrained_clip_name": TINY_NAME,
                                 **CROSS_KW}))
    _register_tiny()
    yield str(root), str(cross)
    pconfig.CLIP_ARCH.pop(TINY_NAME, None)


@pytest.fixture
def cli_group(runs):
    return runs


def test_sharded_eval_and_extract_equal_one_rank(cli_group):
    one, two = cli_group["one"], cli_group["two"]
    for r in range(WORLD):
        got = two[r]["eval"]
        for k in ("q", "v", "f"):       # the same blocks, the same rows
            np.testing.assert_array_equal(got[k], one["eval"][k], err_msg=k)
        assert got["metrics"] == one["eval"]["metrics"]
    a = np.load(one["extract"])
    b = np.load(os.path.join(cli_group["spec"]["extract"], "features.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_signal_on_one_rank_saves_zero_state_that_resumes_without_zero(
        cli_group, layout):
    two, uncut = cli_group["two"], cli_group["one"]["uncut"]
    out = cli_group["spec"]["preempt"]
    for r in range(WORLD):             # both ranks stopped at step 1
        assert two[r]["preempted_zero"]["step"] == 1
    assert two[0]["preempted_zero"]["files"] == ["progress_meta",
                                                 "state_1.pt"]
    meta = state_io.load_progress_meta(os.path.join(out, "ckpt"), 1)
    assert meta["batch_in_epoch"] == 1 and not meta["epoch_end"]
    assert meta["zero_opt"] and meta["world_size"] == WORLD
    # the stop comes before step 1's log line, as in the JAX runner
    assert two[0]["preempted_zero"]["losses"] == []
    resumed = prunner.main(pcli.get_args(argv=cli_argv(
        layout, out, "--do_train", "--resume")), device="cpu")
    assert resumed.state.step == uncut.state.step == 3
    assert [r["step"] for r in resumed.displayed] == [2, 3]
    np.testing.assert_allclose(
        [r["loss"] for r in resumed.displayed],
        [r["loss"] for r in uncut.displayed[1:]], atol=WORLD_ATOL, rtol=0)
    _assert_close_dicts(dict(resumed.state.model.named_parameters()),
                        dict(uncut.state.model.named_parameters()),
                        WORLD_ATOL, "resumed vs uncut")


if __name__ == "__main__":
    child_main(sys.argv[1])
