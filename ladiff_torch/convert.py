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
    body_model_from_jax(jax_model)                    -> SMPLModel (SMPL,
                                                         SMPL-H / X, MANO,
                                                         FLAME)
    gmm_prior_from_jax(prior)                         -> MaxMixturePrior

The alternate models, each from its JAX params (the reference torch names
where the JAX package has a torch converter for the model, the JAX
module's names in torch form otherwise):

    motionclip_state_dict(params)                     -> MotionClip (or
                                                         either tower)
    motion_transformer_state_dict(params)             -> MotionTransformer
    distilbert_state_dict(tower_params)               -> DistilBertTower
    vq_state_dict(params)                             -> VQVae, HumanVQDiff
    mld_vae_t2m_state_dict(params)                    -> MldVaeT2m
    vposert_state_dict(params, batch_stats)           -> VPosert
    vit_state_dict(params)                            -> VisionTransformer
    extras_state_dict(params, batch_stats)            -> LinearBlock,
                                                         ConvBlock, MLP

A flax 1-D conv kernel [k, in, out] reversed is ``Conv1d``'s [out, in, k],
so ``flax_state_dict``'s transpose serves it; the ViT's patch conv goes
from HWIO to OIHW.

The LA-VAE's ablation variants need no rule of their own: ``dist_layer``
(``MLP_DIST``), a ``global_motion_token`` of ``2 * n_lat`` or
``latent_dim[0]`` rows, pre-norm stacks and the all-encoder decoder (a
skip encoder under ``decoder``) carry the port's names in the flax tree,
and the sine positional embeddings have no parameter on either side.

A gradient tree of the JAX package (``jax.grad`` with respect to
``params["vae"]``, say) has its params' nesting, so ``flax_state_dict(tree,
"vae.")`` gives it the same renames and transposes, and gradients (or
updated parameters after an optimizer step) compare with the port's name by
name.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["system_state_dict", "clip_state_dict", "flax_state_dict",
           "evaluator_state_dict", "actor_vae_state_dict",
           "gru_classifier_state_dict", "stgcn_state_dict",
           "body_model_from_jax", "gmm_prior_from_jax",
           "motionclip_state_dict", "motion_transformer_state_dict",
           "distilbert_state_dict", "vq_state_dict", "mld_vae_t2m_state_dict",
           "vposert_state_dict", "vit_state_dict", "extras_state_dict"]

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


def body_model_from_jax(jax_model):
    """A JAX ``SMPLModel`` (any model type) -> the port's ``SMPLModel`` on
    the CPU: every array as numpy, the optional ones (SMPL-H's
    ``hands_mean``, MANO's ``hand_components`` and ``hand_mean``, FLAME's
    ``expr_dirs``) where the JAX model has them."""
    from ladiff_torch.smpl.body_model import SMPLModel

    def arr(name):
        v = getattr(jax_model, name)
        return None if v is None else np.asarray(v, np.float32)

    return SMPLModel(
        arr("v_template"), arr("shapedirs"), arr("posedirs"),
        arr("J_regressor"), arr("weights"),
        np.asarray(jax_model.parents, np.int64),
        hands_mean=arr("hands_mean"), hand_components=arr("hand_components"),
        hand_mean=arr("hand_mean"), expr_dirs=arr("expr_dirs"))


def gmm_prior_from_jax(prior):
    """A JAX ``MaxMixturePrior`` -> the port's: its means, precisions and
    log weights, as they are."""
    from ladiff_torch.smpl.prior import MaxMixturePrior
    return MaxMixturePrior(np.asarray(prior.means),
                           np.asarray(prior.precisions),
                           np.asarray(prior.log_nll_weights))


# -- the alternate models ----------------------------------------------------

def _grouped(tree: Mapping[str, Any], renames: Mapping[str, str]
             ) -> Dict[str, Any]:
    """``tree`` with each key ``name_{i}`` of ``renames`` moved to
    ``renames[name]`` (a dotted path) under index ``i``, other keys as
    they are, for ``flax_state_dict``."""
    out: Dict[str, Any] = {}
    for key, v in tree.items():
        name, _, i = key.rpartition("_")
        if name in renames and i.isdigit():
            node = out
            for part in renames[name].split("."):
                node = node.setdefault(part, {})
            node[i] = v
        else:
            out[key] = v
    return out


def motionclip_state_dict(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """The JAX ``MotionClip`` params ({"encoder", "decoder"}), or one
    tower's (``MotionClipMotionEncoder`` / ``Decoder``) -> the port's
    state dict: ``layers_{i}`` become ``layers.{i}``."""
    towers = ({k: params[k] for k in ("encoder", "decoder")}
              if "encoder" in params else {"": params})
    out: Dict[str, torch.Tensor] = {}
    for name, tree in towers.items():
        flax_state_dict(_grouped(tree, {"layers": "layers"}),
                        f"{name}." if name else "", out)
    return out


def motion_transformer_state_dict(params: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``MotionTransformer`` params -> the reference torch
    MotionTransformer's names (the inverse of the JAX package's
    ``convert_torch_motion_transformer``)."""
    tree = _grouped(params, {"text_enc": "textTransEncoder.layers",
                             "block": "temporal_decoder_blocks"})
    tree["text_proj"] = {"0": tree["text_proj"]}
    tree["time_embed"] = {"0": tree.pop("time_embed_1"),
                          "2": tree.pop("time_embed_2")}
    return flax_state_dict(tree)


def distilbert_state_dict(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """The JAX ``DistilBertTower`` params -> HF ``DistilBertModel``'s names
    (the inverse of ``load_torch_distilbert_state``)."""
    tree = {"embeddings": {
        "word_embeddings": {"weight": params["word_embeddings"]["embedding"]},
        "position_embeddings": {
            "weight": params["position_embeddings"]["embedding"]},
        "LayerNorm": params["emb_layer_norm"]}}
    layers = tree.setdefault("transformer", {}).setdefault("layer", {})
    i = 0
    while f"layer_{i}" in params:
        p = params[f"layer_{i}"]
        layers[str(i)] = {
            "attention": {k: p[k] for k in ("q_lin", "k_lin", "v_lin",
                                            "out_lin")},
            "sa_layer_norm": p["sa_layer_norm"],
            "ffn": {"lin1": p["lin1"], "lin2": p["lin2"]},
            "output_layer_norm": p["output_layer_norm"]}
        i += 1
    return flax_state_dict(tree)


def _encdec_tree(tree: Mapping[str, Any], kind: str) -> Dict[str, Any]:
    """A JAX ``Encoder1D`` / ``Decoder1D`` tree in the reference's
    ``nn.Sequential`` slots."""
    n = sum(1 for k in tree if k.startswith("res_"))

    def res(i):  # Resnet1D: block_{j} -> model.{j}
        return {"model": {k.split("_")[1]: v
                          for k, v in tree[f"res_{i}"].items()}}

    slots = {"0": tree["in_conv"]}
    for i in range(n):
        slots[str(2 + i)] = ({"0": tree[f"down_{i}"], "1": res(i)}
                             if kind == "encoder" else
                             {"0": res(i), "2": tree[f"up_{i}"]})
    if kind == "encoder":
        slots[str(2 + n)] = tree["out_conv"]
    else:
        slots[str(2 + n)] = tree["mid_conv"]
        slots[str(4 + n)] = tree["out_conv"]
    return {"model": slots}


def vq_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``VQVae`` params (or ``HumanVQDiff``'s, under ``vqvae``) ->
    the port's state dict: the conv stacks in the reference's slots, the
    learned ``codebook`` of the ``orig`` quantizer as it is."""
    if "vqvae" in params:
        return {f"vqvae.{k}": v
                for k, v in vq_state_dict(params["vqvae"]).items()}
    out = mld_vae_t2m_state_dict(params)
    if "codebook" in params:
        out["codebook"] = _t(params["codebook"])
    return out


def mld_vae_t2m_state_dict(params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The JAX ``MldVaeT2m`` params -> the reference MldVae's names (the
    inverse of ``convert_torch_mld_vae_t2m``)."""
    return flax_state_dict({k: _encdec_tree(params[k], k)
                            for k in ("encoder", "decoder")})


def _batch_norm(p: Mapping[str, Any], stats: Mapping[str, Any]):
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(stats["mean"]),
            "running_var": _t(stats["var"]),
            "num_batches_tracked": torch.zeros((), dtype=torch.long)}


def vposert_state_dict(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """The JAX ``VPosert`` params and ``batch_stats`` -> the reference's
    ``encoder_net`` / ``decoder_net`` slots (the inverse of
    ``convert_torch_vposert``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, slot in (("enc_bn_in", "encoder_net.1"),
                       ("enc_bn_mid", "encoder_net.4")):
        for k, v in _batch_norm(params[name], batch_stats[name]).items():
            out[f"{slot}.{k}"] = v
    for name, slot in (("enc_fc1", "encoder_net.2"),
                       ("enc_fc2", "encoder_net.6"),
                       ("enc_fc3", "encoder_net.7"),
                       ("mu", "encoder_net.8.mu"),
                       ("logvar", "encoder_net.8.logvar"),
                       ("dec_fc1", "decoder_net.0"),
                       ("dec_fc2", "decoder_net.3"),
                       ("dec_out", "decoder_net.5")):
        flax_state_dict(params[name], slot + ".", out)
    return out


def vit_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``VisionTransformer`` params -> timm's names (the inverse of
    ``convert_torch_vit``): HWIO convolutions to OIHW; a hybrid stage's
    ``patch_embed.proj`` likewise.  A hybrid backbone's params
    (``hybrid_backbone``, the caller's module) are the caller's to carry
    to ``patch_embed.backbone``."""
    tree = _grouped({k: v for k, v in params.items()
                     if k not in ("patch_embed", "hybrid_backbone")},
                    {"blocks": "blocks"})
    if "pre_logits_fc" in tree:
        tree["pre_logits"] = {"fc": tree.pop("pre_logits_fc")}
    out = flax_state_dict(tree)
    proj = params["patch_embed"]["proj"]
    k = np.asarray(proj["kernel"], np.float32).transpose(3, 2, 0, 1)
    out["patch_embed.proj.weight"] = torch.from_numpy(np.ascontiguousarray(k))
    out["patch_embed.proj.bias"] = _t(proj["bias"])
    return out


def extras_state_dict(params: Mapping[str, Any],
                      batch_stats: Optional[Mapping[str, Any]] = None,
                      prefix: str = "", out=None) -> Dict[str, torch.Tensor]:
    """The JAX ``LinearBlock`` / ``ConvBlock`` / ``MLP`` params (and the
    BatchNorms' ``batch_stats``) -> the port's names: an MLP's ``block_{i}``
    become ``block.{i}``, a BatchNorm its weight, bias and running
    statistics."""
    out = {} if out is None else out
    batch_stats = batch_stats or {}
    for name, v in params.items():
        block, _, i = name.rpartition("_")
        if name == "out" or (block == "block" and i.isdigit()):
            sub = "out." if name == "out" else f"block.{i}."
            extras_state_dict(v, batch_stats.get(name), prefix + sub, out)
        elif name in batch_stats:
            for k, t in _batch_norm(v, batch_stats[name]).items():
                out[f"{prefix}{name}.{k}"] = t
        elif isinstance(v, Mapping):
            flax_state_dict(v, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = _t(v)
    return out
