"""Carries the JAX package's parameters into the port.

The JAX package keeps params as nested dicts (flax) with ``Dense`` kernels
[in, out], ``LayerNorm`` scales and a fused ``in_proj_kernel`` [D, 3D];
this module turns them, given as nested dicts of arrays, into the port's
``state_dict`` (torch ``Linear`` weights [out, in], ``in_proj_weight``
[3D, D], LayerNorm ``weight``, learned PEs [max_len, 1, D]).  The result
loads with ``load_state_dict(strict=True)``, so both packages compute from
the same weights.

    system_state_dict({"vae": ..., "denoiser": ...})  -> LADiffSystem
                                                         (LA-VAE or
                                                         ActorVae)
    actor_vae_state_dict(tree, prefix)                -> ActorVae, also a
                                                         gradient tree
    clip_state_dict(tower_params)                     -> CLIPTextTower
    evaluator_state_dict(evaluator_params)            -> the three T2M
                                                         evaluator encoders
    gru_classifier_state_dict(params)                 -> MotionDiscriminator
    stgcn_state_dict(params)                          -> STGCN
    flax_state_dict(tree, prefix)                     -> any subtree, also
                                                         a gradient tree

A gradient tree of the JAX package (``jax.grad`` with respect to
``params["vae"]``, say) has its params' nesting, so ``flax_state_dict(tree,
"vae.")`` gives it the same renames and transposes, and gradients (or
updated parameters after an optimizer step) compare with the port's name by
name.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["system_state_dict", "clip_state_dict", "flax_state_dict",
           "evaluator_state_dict", "actor_vae_state_dict",
           "gru_classifier_state_dict", "stgcn_state_dict"]

# flax submodule names "input_blocks_0" / "emb_layers_1" -> torch "input_blocks.0"
_INDEXED = re.compile(
    r"^(input_blocks|output_blocks|linear_blocks|emb_layers|out_layers|"
    r"emb_proj)_(\d+)$")


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def flax_state_dict(tree: Mapping[str, Any], prefix: str = "",
                    out=None) -> Dict[str, torch.Tensor]:
    """Any flax param tree of the JAX package -> torch state dict entries
    under ``prefix`` (submodule names and leaves renamed as above)."""
    out = {} if out is None else out
    for name, v in tree.items():
        if isinstance(v, Mapping):
            m = _INDEXED.match(name)
            key = f"{m.group(1)}.{m.group(2)}" if m else name
            flax_state_dict(v, f"{prefix}{key}.", out)
        elif name == "kernel":
            out[prefix + "weight"] = _t(v, transpose=True)
        elif name == "scale":
            out[prefix + "weight"] = _t(v)
        elif name == "in_proj_kernel":
            out[prefix + "in_proj_weight"] = _t(v, transpose=True)
        elif name == "pe":
            out[prefix + "pe"] = _t(v)[:, None, :]
        else:
            out[prefix + name] = _t(v)
    return out


def actor_vae_state_dict(tree: Mapping[str, Any], prefix: str = "vae.",
                         out=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ActorVae`` tree (``skel_embedding``,
    ``mu_token``, ``logvar_token``, ``enc_{i}``, ``dec_{i}``,
    ``final_layer``), or a gradient tree of it, -> the port's reference
    names under ``prefix``."""
    out = {} if out is None else out
    names = {"skel_embedding": "encoder.skel_embedding",
             "mu_token": "encoder.mu_token",
             "logvar_token": "encoder.logvar_token",
             "final_layer": "decoder.final_layer"}
    for name, v in tree.items():
        if name in names:
            key = prefix + names[name]
            if isinstance(v, Mapping):
                flax_state_dict(v, key + ".", out)
            else:
                out[key] = _t(v)
        else:
            side, i = name.split("_")
            stack = ("encoder.seqTransEncoder" if side == "enc"
                     else "decoder.seqTransDecoder")
            flax_state_dict(v, f"{prefix}{stack}.layers.{i}.", out)
    return out


def system_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``ladiff_tpu`` ``LADiffSystem.init_params`` output ({"vae",
    "denoiser"}) -> ``ladiff_torch`` ``LADiffSystem`` state dict.  An empty
    (or absent) ``vae`` tree, feature-space diffusion's, gives no ``vae.*``
    entry; an ActorVae tree (it has ``mu_token``) takes
    ``actor_vae_state_dict``'s names."""
    out: Dict[str, torch.Tensor] = {}
    vae = params.get("vae") or {}
    if "mu_token" in vae:
        actor_vae_state_dict(vae, "vae.", out)
    else:
        flax_state_dict(vae, "vae.", out)
    flax_state_dict(params["denoiser"], "denoiser.", out)
    return out


def gru_classifier_state_dict(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MotionDiscriminator`` params (``gru{l}_w_ih``
    ..., ``linear1``, ``linear2``) -> the port's (reference) names."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in params.items():
        if name.startswith("gru"):
            layer, leaf = name[3:].split("_", 1)
            kind = "weight" if leaf[0] == "w" else "bias"
            out[f"recurrent.{kind}_{leaf[2:]}_l{layer}"] = _t(v)
        else:
            flax_state_dict(v, name + ".", out)
    return out


def stgcn_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``STGCN`` params -> the port's (reference) names:
    frozen BNs to ``weight`` / ``bias`` / ``running_mean`` / ``running_var``,
    flax convolutions [kh, kw, in, out] to ``Conv2d`` [out, in, kh, kw], the
    dense ``fcn`` to a 1x1 convolution, and the graph ``A``."""
    from ladiff_torch.models.classifiers import smpl_graph_adjacency
    out: Dict[str, torch.Tensor] = {
        "A": torch.from_numpy(smpl_graph_adjacency(24))}

    def bn(p, key):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"),
                             ("var", "running_var")):
            out[f"{key}.{theirs}"] = _t(p[ours])
        out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    def conv(p, key):
        k = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
        out[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
        out[f"{key}.bias"] = _t(p["bias"])

    bn(params["data_bn"], "data_bn")
    parts = {"gcn_conv": (conv, "gcn.conv"), "bn1": (bn, "tcn.0"),
             "tcn_conv": (conv, "tcn.2"), "bn2": (bn, "tcn.3"),
             "res_conv": (conv, "residual.0"), "res_bn": (bn, "residual.1")}
    i = 0
    while f"st_gcn_{i}" in params:
        for name, p in params[f"st_gcn_{i}"].items():
            fn, key = parts[name]
            fn(p, f"st_gcn_networks.{i}.{key}")
        out[f"edge_importance.{i}"] = _t(params[f"edge_importance_{i}"])
        i += 1
    k = np.asarray(params["fcn"]["kernel"], np.float32).T
    out["fcn.weight"] = torch.from_numpy(np.ascontiguousarray(k))[
        :, :, None, None]
    out["fcn.bias"] = _t(params["fcn"]["bias"])
    return out


def clip_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``ladiff_tpu`` ``CLIPTextTower`` params -> the port's (HF-named)
    ``CLIPTextTower`` state dict."""
    pre = "text_model."
    out = {
        pre + "embeddings.token_embedding.weight":
            _t(params["token_embedding"]["embedding"]),
        pre + "embeddings.position_embedding.weight":
            _t(params["positional_embedding"]),
        pre + "final_layer_norm.weight": _t(params["ln_final"]["scale"]),
        pre + "final_layer_norm.bias": _t(params["ln_final"]["bias"]),
        "text_projection.weight": _t(params["text_projection"],
                                     transpose=True),
    }
    hf = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
          "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
          "fc1": "mlp.fc1", "fc2": "mlp.fc2", "ln_1": "layer_norm1",
          "ln_2": "layer_norm2"}
    i = 0
    while f"layers_{i}" in params:
        layer = params[f"layers_{i}"]
        for ours, theirs in hf.items():
            flax_state_dict(layer[ours], f"{pre}encoder.layers.{i}.{theirs}.", out)
        i += 1
    return out


def evaluator_state_dict(params: Mapping[str, Any]
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``ladiff_tpu`` ``T2MEvaluator.params`` ({"text", "movement",
    "motion"}) -> the state dicts of the port's ``TextEncoderBiGRUCo``,
    ``MovementConvEncoder`` and ``MotionEncoderBiGRUCo``, under the same
    keys (the inverse of ``ladiff_tpu/models/evaluators.py``
    ``load_t2m_checkpoint``: flax conv kernels [K, in, out] become
    ``Conv1d`` weights [out, in, K], the GRU's direction leaves
    ``gru_fwd_*`` / ``gru_bwd_*`` become ``gru.*_l0`` / ``gru.*_l0_reverse``).
    """
    def bigru(p):
        out = {"hidden": _t(p["hidden"])}
        for name in ("input_emb", "pos_emb", "output_net_0", "output_net_1",
                     "output_net_3"):
            if name in p:
                flax_state_dict(p[name], name.replace("output_net_",
                                                      "output_net.") + ".",
                                out)
        for ours, theirs in (("gru_fwd", "l0"), ("gru_bwd", "l0_reverse")):
            for leaf in ("w_ih", "w_hh", "b_ih", "b_hh"):
                kind = "weight" if leaf[0] == "w" else "bias"
                out[f"gru.{kind}_{leaf[2:]}_{theirs}"] = _t(
                    p[f"{ours}_{leaf}"])
        return out

    def conv(p):
        k = np.asarray(p["kernel"], np.float32).transpose(2, 1, 0)
        return torch.from_numpy(np.ascontiguousarray(k)), _t(p["bias"])

    move = params["movement"]
    movement = {}
    for ours, theirs in (("conv1", "main.0"), ("conv2", "main.3")):
        movement[theirs + ".weight"], movement[theirs + ".bias"] = conv(
            move[ours])
    flax_state_dict(move["out_net"], "out_net.", movement)
    return {"text": bigru(params["text"]), "movement": movement,
            "motion": bigru(params["motion"])}
