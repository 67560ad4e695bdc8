"""The weight bridge: ``hmmc_tpu`` parameters -> the port's ``state_dict``.

:func:`from_jax_params` maps a JAX ``BirdModel`` parameter tree (as numpy)
to the reference checkpoint's key names, which the port's modules use, so
``BirdModel.load_state_dict(from_jax_params(params), strict=True)`` loads
it. The mapping unstacks the scan-stacked ``[layers, ...]`` leaves,
transposes ``[in, out]`` kernels to ``[out, in]`` (``in_proj_kernel``
[D, 3D] -> ``in_proj_weight`` [3D, D]), turns the HWIO patch convolution
into OIHW (the 3d tube's ``conv2``, [kt, kh, kw, I, O], into [O, I, kt, kh,
kw]), and renames LayerNorm ``scale``/``bias`` to ``weight``/``bias``.
A ModifiedResNet tower (``visual`` holding ``attnpool``) maps as the JAX
package's ``export_clip_resnet`` does (``hmmc_tpu/train/checkpoint.py:
257-297``): ``layer{s}_{b}`` -> ``layer{s}.{b}``, ``downsample_conv`` /
``downsample_bn`` -> ``downsample.0`` / ``downsample.1``, HWIO -> OIHW,
BatchNorm ``scale`` -> ``weight`` and, from ``batch_stats["visual_encoder"]
["visual"]``, ``mean`` / ``var`` -> ``running_mean`` / ``running_var`` with
``num_batches_tracked`` 0 (flax keeps no counter; without statistics they
come out at their init, 0 and 1). Covers the English ``BirdModel`` this
port builds, and with
:func:`from_jax_pretrain_state` a JAX ``PretrainState``: the
``BirdPretrainModel``'s projectors and predictor (``hidden_j`` / ``bn_j`` /
``out`` -> the reference ``nn.Sequential``'s ``linear_hidden.{1+3j}`` /
``{2+3j}`` / ``linear_out``, BatchNorm ``scale`` -> ``weight`` and its
``mean`` / ``var`` statistics -> ``running_mean`` / ``running_var``), the
MLM head (``transform_dense``, ``transform_ln``, ``decoder`` -> ``cls.
transform.dense``, ``cls.transform.LayerNorm``, ``cls.decoder.weight`` and
``cls.bias``), the key towers and the queues.

The mapping only moves, transposes and renames elements, so it is linear:
any tree shaped like the parameters maps the same way. A JAX gradient tree,
or BertAdam's m and v trees, become per-name tensors to hold against the
port's ``.grad`` and optimizer state (tests/test_torch_train.py does so).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from hmmc_tpu_torch.models.pretrain import MoCoQueues

StateDict = Dict[str, torch.Tensor]


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _kernel(a: Any) -> torch.Tensor:
    """[in, out] -> [out, in]."""
    return _t(np.asarray(a).T)


def _layer_norm(p: Dict, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _resblocks(tree: Dict, prefix: str, out: StateDict) -> None:
    block = tree["resblocks"]["block"]
    for i in range(np.shape(block["attn"]["in_proj_kernel"])[0]):
        b = f"{prefix}.resblocks.{i}"
        attn = block["attn"]
        out[f"{b}.attn.in_proj_weight"] = _kernel(attn["in_proj_kernel"][i])
        out[f"{b}.attn.in_proj_bias"] = _t(attn["in_proj_bias"][i])
        out[f"{b}.attn.out_proj.weight"] = _kernel(attn["out_kernel"][i])
        out[f"{b}.attn.out_proj.bias"] = _t(attn["out_bias"][i])
        for ln in ("ln_1", "ln_2"):
            out[f"{b}.{ln}.weight"] = _t(block[ln]["scale"][i])
            out[f"{b}.{ln}.bias"] = _t(block[ln]["bias"][i])
        for fc in ("c_fc", "c_proj"):
            out[f"{b}.mlp.{fc}.weight"] = _kernel(block[fc]["kernel"][i])
            out[f"{b}.mlp.{fc}.bias"] = _t(block[fc]["bias"][i])


def _text(te: Dict, prefix: str, out: StateDict) -> None:
    p = te["clip_text"]
    out[f"{prefix}logit_scale"] = _t(te["logit_scale"]).reshape(())
    out[f"{prefix}token_embedding.weight"] = _t(p["token_embedding"])
    out[f"{prefix}positional_embedding"] = _t(p["positional_embedding"])
    out[f"{prefix}text_projection"] = _t(p["text_projection"])
    _layer_norm(p["ln_final"], f"{prefix}ln_final", out)
    _resblocks(p["transformer"], f"{prefix}transformer", out)


def _conv(p: Dict, name: str, out: StateDict) -> None:
    """HWIO -> OIHW."""
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _batch_norm(p: Dict, stats: Dict, name: str, out: StateDict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])
    width = np.shape(p["scale"])
    out[f"{name}.running_mean"] = _t(stats.get("mean", np.zeros(width)))
    out[f"{name}.running_var"] = _t(stats.get("var", np.ones(width)))
    out[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _resnet(p: Dict, stats: Dict, v: str, out: StateDict) -> None:
    for i in (1, 2, 3):
        _conv(p[f"conv{i}"], f"{v}conv{i}", out)
        _batch_norm(p[f"bn{i}"], stats.get(f"bn{i}", {}), f"{v}bn{i}", out)
    for f in sorted(k for k in p if k.startswith("layer")):
        stage, block = f[len("layer"):].split("_")
        t, bp, bs = f"{v}layer{stage}.{block}", p[f], stats.get(f, {})
        for i in (1, 2, 3):
            _conv(bp[f"conv{i}"], f"{t}.conv{i}", out)
            _batch_norm(bp[f"bn{i}"], bs.get(f"bn{i}", {}), f"{t}.bn{i}", out)
        if "downsample_conv" in bp:
            _conv(bp["downsample_conv"], f"{t}.downsample.0", out)
            _batch_norm(bp["downsample_bn"], bs.get("downsample_bn", {}),
                        f"{t}.downsample.1", out)
    ap = p["attnpool"]
    out[f"{v}attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        out[f"{v}attnpool.{proj}.weight"] = _kernel(ap[proj]["kernel"])
        out[f"{v}attnpool.{proj}.bias"] = _t(ap[proj]["bias"])


def _vit(p: Dict, v: str, out: StateDict) -> None:
    if "conv2" in p:   # the 3d tube: [kt, kh, kw, I, O] -> [O, I, kt, kh, kw]
        out[f"{v}conv2.weight"] = _t(
            np.asarray(p["conv2"]["kernel"]).transpose(4, 3, 0, 1, 2))
    else:
        _conv(p["conv1"], f"{v}conv1", out)
    out[f"{v}class_embedding"] = _t(p["class_embedding"])
    out[f"{v}positional_embedding"] = _t(p["positional_embedding"])
    out[f"{v}proj"] = _t(p["proj"])
    _layer_norm(p["ln_pre"], f"{v}ln_pre", out)
    _layer_norm(p["ln_post"], f"{v}ln_post", out)
    _resblocks(p["transformer"], f"{v}transformer", out)


def _visual(ve: Dict, prefix: str, out: StateDict,
            stats: Dict = None) -> None:
    p = ve["visual"]
    if "attnpool" in p:
        _resnet(p, stats or {}, f"{prefix}visual.", out)
    else:
        _vit(p, f"{prefix}visual.", out)
    if "frame_position_embeddings" in ve:
        out[f"{prefix}frame_position_embeddings.weight"] = _t(
            ve["frame_position_embeddings"])
        _resblocks(ve["temporal_transformer"],
                   f"{prefix}temporal_transformer", out)


def from_jax_params(params: Dict, batch_stats: Dict = None) -> StateDict:
    """``hmmc_tpu`` ``BirdModel`` params (nested dict of arrays), or any
    tree of the same structure (gradients, optimizer moments) -> the port's
    ``BirdModel`` state_dict names (fp32 CPU tensors). ``batch_stats``: the
    JAX ``batch_stats`` collection, whose ``["visual_encoder"]["visual"]``
    a ModifiedResNet tower's running statistics come from."""
    out: StateDict = {}
    _text(params["text_encoder"], "text_encoder.", out)
    _visual(params["visual_encoder"], "visual_encoder.", out,
            (batch_stats or {}).get("visual_encoder", {}).get("visual"))
    return out


def _mlp(p: Dict, stats: Dict, prefix: str, out: StateDict) -> None:
    j = 0
    while f"hidden_{j}" in p:
        li, bi = 1 + 3 * j, 2 + 3 * j
        out[f"{prefix}linear_hidden.{li}.weight"] = _kernel(
            p[f"hidden_{j}"]["kernel"])
        out[f"{prefix}linear_hidden.{li}.bias"] = _t(p[f"hidden_{j}"]["bias"])
        _batch_norm(p[f"bn_{j}"], (stats or {}).get(f"bn_{j}", {}),
                    f"{prefix}linear_hidden.{bi}", out)
        j += 1
    out[f"{prefix}linear_out.weight"] = _kernel(p["out"]["kernel"])
    out[f"{prefix}linear_out.bias"] = _t(p["out"]["bias"])


def _mlm_head(p: Dict, prefix: str, out: StateDict) -> None:
    out[f"{prefix}transform.dense.weight"] = _kernel(
        p["transform_dense"]["kernel"])
    out[f"{prefix}transform.dense.bias"] = _t(p["transform_dense"]["bias"])
    _layer_norm(p["transform_ln"], f"{prefix}transform.LayerNorm", out)
    out[f"{prefix}decoder.weight"] = _kernel(p["decoder"]["kernel"])
    out[f"{prefix}bias"] = _t(p["decoder"]["bias"])


def from_jax_pretrain_params(params: Dict, batch_stats: Dict = None
                             ) -> StateDict:
    """``hmmc_tpu`` ``BirdPretrainModel`` params (and the projectors'
    ``batch_stats``) -> the port's ``BirdPretrainModel`` state_dict.
    Linear like :func:`from_jax_params` in ``params``: a gradient tree maps
    too (its statistics then come out at their init)."""
    out = from_jax_params(params, batch_stats)
    stats = batch_stats or {}
    for tower in ("t_projector", "v_projector", "v_predictor"):
        _mlp(params[tower], stats.get(tower), f"{tower}.", out)
    _mlm_head(params["cls"], "cls.", out)
    return out


def from_jax_key_params(params_k: Dict, batch_stats_k: Dict = None,
                        batch_stats: Dict = None) -> StateDict:
    """The JAX ``params_k`` (and ``batch_stats_k``) -> the port's
    ``MomentumTowers`` state_dict. A ModifiedResNet key tower's running
    statistics are the query side's ``batch_stats`` (the JAX step reads the
    one frozen copy for both, ``hmmc_tpu/train/trainer.py:360-364``)."""
    out = from_jax_params(params_k, batch_stats)
    stats = batch_stats_k or {}
    for tower in ("t_projector", "v_projector"):
        _mlp(params_k[tower], stats.get(tower), f"{tower}.", out)
    return out


def from_jax_pretrain_state(state) -> Dict[str, Any]:
    """A JAX ``PretrainState`` (its arrays as numpy, or anything with its
    ``params``, ``params_k``, ``batch_stats``, ``batch_stats_k`` and
    ``queues`` attributes) -> ``{"model": state_dict, "towers":
    state_dict, "queues": {field: tensor}, "ptr": int}``, to load strictly
    into ``BirdPretrainModel``, ``MomentumTowers`` and ``MoCoQueues``."""
    q = state.queues
    return {
        "model": from_jax_pretrain_params(state.params, state.batch_stats),
        "towers": from_jax_key_params(state.params_k, state.batch_stats_k,
                                      state.batch_stats),
        "queues": {f: _t(getattr(q, f)) for f in MoCoQueues.NAMES},
        "ptr": int(np.asarray(q.ptr)),
    }
