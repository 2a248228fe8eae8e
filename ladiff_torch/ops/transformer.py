"""Post-norm (default) or pre-norm transformer blocks with U-Net skip
connections (counterpart of ``ladiff_tpu/ops/transformer.py``), inference
and training paths.

Parameter names follow the reference torch LADiff (``self_attn``,
``multihead_attn``, ``linear1/2``, ``norm1/2/3``; skip stacks with
``input_blocks.i``, ``middle_block``, ``output_blocks.i``,
``linear_blocks.i``, ``norm``).  ``dropout`` adds no parameter or buffer.

Which kernel a layer runs through (each wrapper takes its plain version on
a CPU tensor):

  encoder layer, inference   ``masked_attention`` (kernel 10 from 64
                             tokens on) -> ``fused_postnorm_ffn``
  encoder layer, training    ``train_encoder_layer`` (kernel 12) where the
                             layer is ``whole_layer`` and
                             ``train_encoder_layer_supported``; otherwise
                             ``train_self_attention`` ->
                             ``train_postnorm_ffn(norm1, norm2)``
  decoder layer, inference   ``fused_decoder_layer`` (kernel K2) where
                             ``decoder_layer_supported``; otherwise (e.g. a
                             head width above 128, or where the caller
                             asks for the cross-attention weights) per
                             block:
                             ``masked_attention`` -> norm1 -> plain
                             cross-attention -> ``fused_postnorm_ffn``
  decoder layer, training    ``train_decoder_layer`` (kernel 13) where the
                             layer is ``whole_layer`` and
                             ``train_decoder_layer_supported``; otherwise
                             ``train_self_attention`` -> norm1 -> plain
                             cross-attention into the few memory rows ->
                             ``train_postnorm_ffn(norm2, norm3)``

Each route is chosen from shapes and the compute type before any launch,
the type per kernel (``kernel_route``): the inference kernels K2, 5 and 10
and the training kernels 8, 9, 12 and 13 take float32 as well as bf16
(their float32 chains, ``ops/f32_layer.py`` and ``ops/f32_train.py``), so
float32 compute on the card (the published configurations'
``TRAIN.MIXED_PRECISION: false``) takes every route above through the same
kernels as bf16, under the same shape gates.  Every kernel computes the
post-norm layer: a layer built with ``normalize_before`` (pre-norm, which
no published configuration asks for) runs its plain parts on every device
and in every mode, decided from the module before any launch
(``_forward_prenorm``).  ``train_self_attention`` takes what
``train_attention_supported`` admits (at least ``MIN_TOKENS`` tokens, head
widths 16 to 64); other streams and ``extra_kv`` keep the plain
attention module in training.  The FFN tail kernels (5 and 9) take what
``postnorm_ffn_supported`` admits; a wider tail (D 512, F 2048) runs as plain
``layer_norm`` / ``linear`` ops with dropout from the generator.  The
whole-layer kernels are off unless the skip stack is built with
``whole_layer=True`` (``LADiffSystem(train_whole_layer=...)``, the JAX
package's ``LADIFF_TRAIN_WHOLE_LAYER``).

A layer takes its training route when ``module.training``, and also in eval
mode whenever autograd is recording and an input or one of its parameters
requires a gradient (the joint stage's decode of generated latents): the
inference kernels have no backward, while the training kernels at rate 0
draw no masks and compute the eval-mode math with one.  Dropout masks and
kernel seeds come from the ``generator`` passed to ``forward``, in training
mode only.  Under sequence parallelism (``ops/sp_hook.py``) a skip stack
runs on this rank's block of the tokens and each self-attention gathers its
keys and values; under tensor parallelism ``linear`` hands a shard to its
own forward (``parallel/tp.py``).  Parameters may be float32 while the
activations are bf16 (explicit casts at each product; the training kernels
cast on the way in and return float32 gradients).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.attention import MultiHeadAttention
from ladiff_torch.ops.cuda_common import dropout_mask, kernel_route
from ladiff_torch.ops.decoder_layer import (decoder_layer_supported,
                                            fused_decoder_layer)
from ladiff_torch.ops.postnorm_ffn import (fused_postnorm_ffn,
                                           postnorm_ffn_supported)
from ladiff_torch.ops.sp_hook import gather_tokens, shard_tokens
from ladiff_torch.ops.train_attention import (train_attention_supported,
                                              train_self_attention)
from ladiff_torch.ops.train_decoder_layer import (
    train_decoder_layer, train_decoder_layer_supported)
from ladiff_torch.ops.train_ffn import train_postnorm_ffn
from ladiff_torch.ops.train_layer import (train_encoder_layer,
                                          train_encoder_layer_supported)

__all__ = [
    "get_activation",
    "linear",
    "layer_norm",
    "TransformerEncoderLayer",
    "TransformerDecoderLayer",
    "SkipTransformerEncoder",
    "SkipTransformerDecoder",
]


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu  # exact (erf) GELU
    raise ValueError(f"activation should be relu/gelu, not {name}")


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` computed in x's type whatever type the parameters have; a
    tensor-parallel shard (``parallel/tp.py``) runs its own forward, with
    its collectives."""
    if getattr(mod, "tensor_parallel", False):
        return mod(x)
    return F.linear(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` computed in x's type whatever type the parameters have."""
    return F.layer_norm(x, mod.normalized_shape, mod.weight.to(x.dtype),
                        mod.bias.to(x.dtype), mod.eps)


def _drop(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    return x if rate == 0.0 else x * dropout_mask(x.shape, rate, x, generator)


def _ffn_params(layer, ln_a: nn.LayerNorm, ln_b: nn.LayerNorm) -> dict:
    """A layer's FFN tail by the names the FFN-tail kernels take."""
    return {"ln1_w": ln_a.weight, "ln1_b": ln_a.bias,
            "w1": layer.linear1.weight, "b1": layer.linear1.bias,
            "w2": layer.linear2.weight, "b2": layer.linear2.bias,
            "ln2_w": ln_b.weight, "ln2_b": ln_b.bias}


def _cast(params: dict, dtype: torch.dtype) -> dict:
    return {k: v.to(dtype) for k, v in params.items()}


def _needs_grad(module: nn.Module, *tensors) -> bool:
    """Whether autograd is recording and an input or a parameter of
    ``module`` requires a gradient."""
    return torch.is_grad_enabled() and (
        any(t is not None and t.requires_grad for t in tensors)
        or any(p.requires_grad for p in module.parameters()))


def _train_self_attention(attn: MultiHeadAttention, x: torch.Tensor,
                          key_valid: Optional[torch.Tensor], rate: float,
                          generator):
    """``x + drop(self_attn(x))`` through kernel 8."""
    B, S, D = x.shape
    out = train_self_attention(
        x.reshape(B * S, D).contiguous(), _key_valid(key_valid, x),
        attn.kernel_params(), H=attn.num_heads, S=S, rate=rate,
        generator=generator)
    return out.reshape(B, S, D)


def _self_attention_block(attn: MultiHeadAttention, x: torch.Tensor,
                          key_valid: Optional[torch.Tensor], train_route: bool,
                          rate: float, generator) -> torch.Tensor:
    """``x + drop(self_attn(x))``: kernel 8 on the training route where it
    takes the shape, else the attention module."""
    if train_route and kernel_route(
            x, "train_self_attention") and train_attention_supported(
            x.shape[1], attn.d_model, attn.num_heads):
        return _train_self_attention(attn, x, key_valid, rate, generator)
    kv = gather_tokens(x)
    x2 = attn(x, kv, kv, key_valid, generator=generator)
    return x + _drop(x2, rate, generator)


def _key_valid(key_valid: Optional[torch.Tensor], x: torch.Tensor):
    """[B*S] float32 key validity for the training kernels."""
    B, S, _ = x.shape
    if key_valid is None:
        return torch.ones(B * S, dtype=torch.float32, device=x.device)
    return key_valid.reshape(B * S).float().contiguous()


def _plain_ffn(layer, h: torch.Tensor, rate: float,
               generator) -> torch.Tensor:
    """``linear2(drop(act(linear1(h))))`` in plain ops."""
    act = get_activation(layer.activation)
    return linear(layer.linear2, _drop(act(linear(layer.linear1, h)), rate,
                                       generator))


def _ffn_tail(layer, resid: torch.Tensor, ln_a: nn.LayerNorm,
              ln_b: nn.LayerNorm, train_route: bool, rate: float,
              generator) -> torch.Tensor:
    """``ln_b(h + FFN(h))`` with ``h = ln_a(resid)``: kernel 9 on the
    training route, kernel 5 at inference, plain ops for a shape or a
    compute type they do not take."""
    B, S, D = resid.shape
    kernel = "train_postnorm_ffn" if train_route else "fused_postnorm_ffn"
    if not (kernel_route(resid, kernel) and postnorm_ffn_supported(
            D, layer.linear1.out_features, layer.activation)):
        h = layer_norm(ln_a, resid)
        return layer_norm(ln_b, h + _drop(_plain_ffn(layer, h, rate,
                                                     generator),
                                          rate, generator))
    x = resid.reshape(B * S, D).contiguous()
    p = _ffn_params(layer, ln_a, ln_b)
    if train_route:
        out = train_postnorm_ffn(x, p, activation=layer.activation,
                                 rate=rate, generator=generator)
    else:
        out = fused_postnorm_ffn(x, _cast(p, x.dtype),
                                 activation=layer.activation)
    return out.reshape(B, S, D)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer; ``extra_kv`` tokens are attended to but
    produce no outputs (same as running on ``cat([src, extra_kv])`` and
    keeping the first S rows)."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int = 2048,
                 activation: str = "relu", dropout: float = 0.0,
                 whole_layer: bool = False, normalize_before: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.activation = activation
        self.dropout = dropout
        self.whole_layer = whole_layer
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def kernel_params(self) -> dict:
        """The layer's tensors by the names ``train_encoder_layer`` takes."""
        return {**self.self_attn.kernel_params(),
                **_ffn_params(self, self.norm1, self.norm2)}

    def takes_whole_training_layer(self, S: int) -> bool:
        """Whether the layer's training route over S tokens is kernel 12."""
        return (self.whole_layer and not self.normalize_before
                and train_encoder_layer_supported(
            S, self.linear1.in_features, self.num_heads,
            self.linear1.out_features, self.activation))

    def _forward_prenorm(self, src, key_valid, rate, generator):
        """``src + drop(attn(norm1(src)))``, then ``x + drop(FFN(norm2(x)))``
        in plain parts (the JAX layer's ``normalize_before`` branch)."""
        x2 = layer_norm(self.norm1, src)
        kv = gather_tokens(x2)
        x2 = self.self_attn(x2, kv, kv, key_valid, generator=generator,
                            plain=True)
        src = src + _drop(x2, rate, generator)
        return src + _drop(_plain_ffn(self, layer_norm(self.norm2, src),
                                      rate, generator), rate, generator)

    def forward(self, src: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                extra_kv: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        train_route = self.training or _needs_grad(self, src, extra_kv)
        rate = self.dropout if self.training else 0.0
        if self.normalize_before:
            if extra_kv is not None:
                raise ValueError("extra_kv: the post-norm layer only, as in "
                                 "the JAX package")
            return self._forward_prenorm(src, key_valid, rate, generator)
        B, S, D = src.shape
        if (train_route and extra_kv is None
                and kernel_route(src, "train_encoder_layer")
                and self.takes_whole_training_layer(S)):
            out = train_encoder_layer(
                src.reshape(B * S, D).contiguous(), _key_valid(key_valid, src),
                self.kernel_params(), H=self.num_heads, S=S,
                activation=self.activation, rate=rate, generator=generator)
            return out.reshape(B, S, D)
        if extra_kv is None:
            resid = _self_attention_block(self.self_attn, src, key_valid,
                                          train_route, rate, generator)
        else:
            kv = torch.cat([src, extra_kv.to(src.dtype)], dim=1)
            x2 = self.self_attn(src, kv, kv, key_valid, generator=generator)
            resid = src + _drop(x2, rate, generator)
        return _ffn_tail(self, resid, self.norm1, self.norm2, train_route,
                         rate, generator)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention over the queries,
    cross-attention into the memory, FFN."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int = 2048,
                 activation: str = "relu", dropout: float = 0.0,
                 whole_layer: bool = False, normalize_before: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.activation = activation
        self.dropout = dropout
        self.whole_layer = whole_layer
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def kernel_params(self) -> dict:
        """The layer's tensors by the names ``fused_decoder_layer`` and
        ``train_decoder_layer`` take."""
        sa, ca = self.self_attn, self.multihead_attn
        return {
            "sa_in_w": sa.in_proj_weight, "sa_in_b": sa.in_proj_bias,
            "sa_out_w": sa.out_proj.weight, "sa_out_b": sa.out_proj.bias,
            "ln1_w": self.norm1.weight, "ln1_b": self.norm1.bias,
            "ca_in_w": ca.in_proj_weight, "ca_in_b": ca.in_proj_bias,
            "ca_out_w": ca.out_proj.weight, "ca_out_b": ca.out_proj.bias,
            "ln2_w": self.norm2.weight, "ln2_b": self.norm2.bias,
            "w1": self.linear1.weight, "b1": self.linear1.bias,
            "w2": self.linear2.weight, "b2": self.linear2.bias,
            "ln3_w": self.norm3.weight, "ln3_b": self.norm3.bias,
        }

    def takes_whole_layer(self, L: int) -> bool:
        """Whether the layer runs as K2 at inference over L memory rows per
        sample: a post-norm layer of a shape K2 takes."""
        return not self.normalize_before and decoder_layer_supported(
            self.linear1.in_features, self.num_heads,
            self.linear1.out_features, self.activation, L)

    def takes_whole_training_layer(self, T: int, L: int) -> bool:
        """Whether the layer's training route over T frames and L memory
        rows is kernel 13."""
        return (self.whole_layer and not self.normalize_before
                and train_decoder_layer_supported(
                    T, L, self.linear1.in_features, self.num_heads,
                    self.linear1.out_features, self.activation))

    def _forward_prenorm(self, tgt, memory, tgt_key_valid, memory_key_valid,
                         rate, generator, return_cross_weights):
        """Self-attention, cross-attention and FFN, each on the normed
        stream and added to it, in plain parts (the JAX layer's
        ``normalize_before`` branch)."""
        x2 = layer_norm(self.norm1, tgt)
        kv = gather_tokens(x2)
        x2 = self.self_attn(x2, kv, kv, tgt_key_valid, generator=generator,
                            plain=True)
        tgt = tgt + _drop(x2, rate, generator)
        x2 = self.multihead_attn(layer_norm(self.norm2, tgt), memory, memory,
                                 memory_key_valid, generator=generator,
                                 return_weights=return_cross_weights,
                                 plain=True)
        if return_cross_weights:
            x2, weights = x2
        tgt = tgt + _drop(x2, rate, generator)
        out = tgt + _drop(_plain_ffn(self, layer_norm(self.norm3, tgt), rate,
                                     generator), rate, generator)
        return (out, weights) if return_cross_weights else out

    def _forward_blocks(self, tgt, memory, tgt_key_valid, memory_key_valid,
                        train_route, rate, generator, return_cross_weights):
        """The layer block by block: the training route (kernels 8 and 9)
        or, at inference, ``masked_attention`` and kernel 5; the plain
        cross-attention gives its head-averaged weights where asked."""
        resid = _self_attention_block(self.self_attn, tgt, tgt_key_valid,
                                      train_route, rate, generator)
        tgt = layer_norm(self.norm1, resid)
        x2 = self.multihead_attn(tgt, memory, memory, memory_key_valid,
                                 generator=generator,
                                 return_weights=return_cross_weights)
        if return_cross_weights:
            x2, weights = x2
        resid = tgt + _drop(x2, rate, generator)
        out = _ffn_tail(self, resid, self.norm2, self.norm3, train_route,
                        rate, generator)
        return (out, weights) if return_cross_weights else out

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_key_valid: Optional[torch.Tensor] = None,
                memory_key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_cross_weights: bool = False):
        """[B, T, D] -> [B, T, D]; with ``return_cross_weights`` also the
        cross-attention's head-averaged weights [B, T, L], which only the
        per-block route gives (K2 and kernel 13 return none)."""
        if self.normalize_before:
            return self._forward_prenorm(
                tgt, memory, tgt_key_valid, memory_key_valid,
                self.dropout if self.training else 0.0, generator,
                return_cross_weights)
        train_route = self.training or _needs_grad(self, tgt, memory)
        B, T, D = tgt.shape
        L = memory.shape[1]
        if (train_route and not return_cross_weights
                and kernel_route(tgt, "train_decoder_layer")
                and self.takes_whole_training_layer(T, L)):
            mv = (memory_key_valid if memory_key_valid is not None
                  else torch.ones(B, L, dtype=torch.bool, device=tgt.device))
            out = train_decoder_layer(
                tgt.reshape(B * T, D).contiguous(),
                _key_valid(tgt_key_valid, tgt), memory.contiguous(),
                mv.float().contiguous(), self.kernel_params(),
                H=self.num_heads, S=T, activation=self.activation,
                rate=self.dropout if self.training else 0.0,
                generator=generator)
            return out.reshape(B, T, D)
        if train_route or return_cross_weights or not (
                kernel_route(tgt, "fused_decoder_layer")
                and self.takes_whole_layer(L)):
            return self._forward_blocks(
                tgt, memory, tgt_key_valid, memory_key_valid, train_route,
                self.dropout if self.training else 0.0, generator,
                return_cross_weights)
        kv = (tgt_key_valid if tgt_key_valid is not None
              else torch.ones(B, T, dtype=torch.bool, device=tgt.device))
        mv = (memory_key_valid if memory_key_valid is not None
              else torch.ones(B, L, dtype=torch.bool, device=tgt.device))
        out = fused_decoder_layer(
            tgt.reshape(B * T, D).contiguous(),
            kv.reshape(B * T).float().contiguous(),
            memory.to(tgt.dtype).contiguous(), mv.float().contiguous(),
            _cast(self.kernel_params(), tgt.dtype), T=T, H=self.num_heads,
            activation=self.activation)
        return out.reshape(B, T, D)


class _SkipStack(nn.Module):
    """U-Net wiring: (L-1)/2 input blocks, a middle block, (L-1)/2 output
    blocks fed through Linear(2D -> D) skip fusion, final LayerNorm."""

    def __init__(self, make_layer, d_model: int, num_layers: int):
        super().__init__()
        assert num_layers % 2 == 1, "skip stack needs an odd layer count"
        nb = (num_layers - 1) // 2
        self.input_blocks = nn.ModuleList([make_layer() for _ in range(nb)])
        self.middle_block = make_layer()
        self.output_blocks = nn.ModuleList([make_layer() for _ in range(nb)])
        self.linear_blocks = nn.ModuleList(
            [nn.Linear(2 * d_model, d_model) for _ in range(nb)])
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def ordered_blocks(self):
        """The layers in execution order."""
        return [*self.input_blocks, self.middle_block, *self.output_blocks]

    def run(self, x: torch.Tensor, block_fn) -> torch.Tensor:
        """``block_fn(i, block, x)`` runs the i-th layer in execution
        order."""
        nb = len(self.input_blocks)
        xs = []
        for i, block in enumerate(self.ordered_blocks()):
            if i > nb:
                x = linear(self.linear_blocks[i - nb - 1],
                           torch.cat([x, xs.pop()], dim=-1))
            x = block_fn(i, block, x)
            if i < nb:
                xs.append(x)
        return layer_norm(self.norm, x)


class SkipTransformerEncoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu",
                 dropout: float = 0.0, whole_layer: bool = False,
                 normalize_before: bool = False):
        super().__init__(
            lambda: TransformerEncoderLayer(d_model, num_heads, ff_size,
                                            activation, dropout, whole_layer,
                                            normalize_before),
            d_model, num_layers)

    def forward(self, src: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        src, key_valid, unshard = shard_tokens(src, key_valid)
        return unshard(self.run(src, lambda i, block, x: block(
            x, key_valid, generator=generator)))


class SkipTransformerDecoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu",
                 dropout: float = 0.0, whole_layer: bool = False,
                 normalize_before: bool = False):
        super().__init__(
            lambda: TransformerDecoderLayer(d_model, num_heads, ff_size,
                                            activation, dropout, whole_layer,
                                            normalize_before),
            d_model, num_layers)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_key_valid: Optional[torch.Tensor] = None,
                memory_key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_cross_weights: bool = False):
        """[B, T, D] -> [B, T, D]; with ``return_cross_weights`` also each
        layer's cross-attention weights [B, T, L], in execution order."""
        weights = []

        def block_fn(i, block, x):
            out = block(x, memory, tgt_key_valid, memory_key_valid,
                        generator=generator,
                        return_cross_weights=return_cross_weights)
            if return_cross_weights:
                out, w = out
                weights.append(w)
            return out

        tgt, tgt_key_valid, unshard = shard_tokens(tgt, tgt_key_valid)
        out = unshard(self.run(tgt, block_fn))
        return (out, weights) if return_cross_weights else out
