"""MotionDiffuse-style stylization layers, the ``MD_TRANS`` denoiser path
(counterpart of ``ladiff_tpu/ops/stylization.py``).

Parameter names follow the reference torch LADiff (``sa_block``,
``ca_block.{norm,text_norm,query,key,value,proj_out}``,
``ffn.{linear1,linear2,proj_out}``, ``proj_out.emb_layers.1`` /
``.norm`` / ``.out_layers.2``).  Each kernel wrapper takes its plain version
on a CPU tensor.  Routes of an ``MDTransformerLayer``, chosen from shapes
before any launch (as the JAX package's gate); the compute type is gated
per kernel (``kernel_route``): K1 and kernels 5, 6, 7, 9 and 11 take
float32 as well as bf16 (as the JAX package runs them in float32), so
float32 on the card runs each of them where bf16 runs it:

  eval, one text token, a shape K1 takes (``md_layer_supported``; every
      published configuration)      the whole layer as ``fused_md_layer``
                                    (kernel K1)
  eval, otherwise (full-context text, or e.g. a head width above 128)
                                    per block: ``sa_block`` with the text and
                                    time rows as ``extra_kv`` (its tail is
                                    kernel 5), ``ca_block`` (kernel 7 with one
                                    token, the plain linear attention with
                                    more), ``ffn`` (kernel 6); a shape kernel
                                    7 or 6 does not take
                                    (``broadcast_stylize_supported``,
                                    ``stylized_ffn_supported``) runs that
                                    block as plain ops
  training                          the same blocks with their training
                                    routes, which have a backward (the
                                    sa_block tail is kernel 9), with dropout
                                    after each SiLU of a ``StylizationBlock``
                                    and after the GELU of ``StylizedFFN``

``MDSkipTransformerEncoder`` also runs the whole stack as one launch of
``fused_md_stack`` (kernel 11) when given a stack prep (``stacked_params``,
``stack_prep``), and hands its forward to the GPipe schedule of
``parallel/pp.py`` inside a ``pp_encoder_override`` scope. As the encoder
and decoder layers do, ``ca_block`` and ``ffn`` take their training route in
eval mode too while autograd records a gradient. ``dropout`` adds no
parameter or buffer; masks come from the ``generator`` passed to
``forward``. Parameters may be float32 while the activations are bf16: every
product casts its weight to the input's type.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.cuda_common import kernel_route
from ladiff_torch.ops.md_layer import fused_md_layer, md_layer_supported
from ladiff_torch.ops.md_stack import (fused_md_stack, md_stack_plain,
                                      stack_md_params)
from ladiff_torch.ops.pp_hook import pp_override_get
from ladiff_torch.ops.stylize import (broadcast_stylize_supported,
                                     fused_broadcast_stylize)
from ladiff_torch.ops.stylized_ffn import (fused_stylized_ffn,
                                           stylized_ffn_supported)
from ladiff_torch.ops.transformer import (TransformerEncoderLayer,
                                          _cast, _drop, _needs_grad,
                                          _SkipStack, layer_norm, linear)

__all__ = [
    "StylizationBlock",
    "LinearTemporalCrossAttention",
    "StylizedFFN",
    "MDTransformerLayer",
    "MDSkipTransformerEncoder",
]


class StylizationBlock(nn.Module):
    """h <- linear(drop(silu(norm(h) * (1 + scale) + shift))) with (scale,
    shift) from ``emb_layers(emb)``; the last linear starts at zero.
    ``out_layers`` keeps the reference's indices (SiLU, dropout, linear);
    the dropout at index 1 is applied by ``forward`` in training mode, from
    the caller's generator."""

    def __init__(self, latent_dim: int, emb_dim: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        D = latent_dim
        self.dropout = dropout
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_dim or D, 2 * D))
        self.norm = nn.LayerNorm(D, eps=1e-5)
        self.out_layers = nn.Sequential(nn.SiLU(), nn.Identity(),
                                        nn.Linear(D, D))
        nn.init.zeros_(self.out_layers[2].weight)
        nn.init.zeros_(self.out_layers[2].bias)

    def ss_rows(self, emb: torch.Tensor) -> torch.Tensor:
        """[..., 2D] AdaLN (scale, shift) rows of the embeddings."""
        return linear(self.emb_layers[1], F.silu(emb))

    def scale_shift(self, emb: torch.Tensor):
        return self.ss_rows(emb).chunk(2, dim=-1)

    def forward(self, h: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        scale, shift = self.scale_shift(emb)
        h = (layer_norm(self.norm, h) * (1 + scale[:, None, :])
             + shift[:, None, :])
        h = _drop(F.silu(h), self.dropout if self.training else 0.0,
                  generator)
        return linear(self.out_layers[2], h)


class LinearTemporalCrossAttention(nn.Module):
    """Softmax-linear attention latents <- text with latent-row masking; at
    inference with one text token the collapsed block is kernel 7."""

    def __init__(self, latent_dim: int, text_latent_dim: int,
                 num_heads: int, emb_dim: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(D, eps=1e-5)
        self.text_norm = nn.LayerNorm(text_latent_dim, eps=1e-5)
        self.query = nn.Linear(D, D)
        self.key = nn.Linear(text_latent_dim, D)
        self.value = nn.Linear(text_latent_dim, D)
        self.proj_out = StylizationBlock(D, emb_dim, dropout)

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                latent_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        tn = layer_norm(self.text_norm, xf)
        value = linear(self.value, tn)
        if (N == 1 and kernel_route(x, "fused_broadcast_stylize")
                and broadcast_stylize_supported(B * T, T, D)
                and not (self.training or _needs_grad(self, x, xf, emb))):
            p = self.proj_out
            mask = (latent_valid.reshape(B * T).float() if latent_valid
                    is not None else torch.ones(B * T, device=x.device))
            out = fused_broadcast_stylize(
                x.reshape(B * T, D).contiguous(), value[:, 0].contiguous(),
                mask.contiguous(), p.ss_rows(emb).contiguous(),
                *_cast({"ln_w": p.norm.weight, "ln_b": p.norm.bias,
                        "w": p.out_layers[2].weight,
                        "b": p.out_layers[2].bias}, x.dtype).values(), T=T)
            return out.reshape(B, T, D)
        if N == 1:
            # exact collapse for one text token: softmax over one key is 1
            # and the query softmax sums to 1, so every valid row gets v
            y = value.expand(B, T, D)
        else:
            query = torch.softmax(linear(
                self.query, layer_norm(self.norm, x)).reshape(B, T, H, -1),
                dim=-1)
            key = torch.softmax(linear(self.key, tn).reshape(B, N, H, -1),
                                dim=1)
            att = torch.einsum("bnhd,bnhl->bhdl", key,
                               value.reshape(B, N, H, -1))
            y = torch.einsum("bnhd,bhdl->bnhl", query, att).reshape(B, T, D)
        if latent_valid is not None:
            y = y * latent_valid[:, :, None].to(y.dtype)
        return x + self.proj_out(y, emb, generator)


class StylizedFFN(nn.Module):
    """GELU FFN (dropout after the GELU in training mode) with a zero-init
    second linear and stylized output; kernel 6 at inference."""

    def __init__(self, latent_dim: int, ffn_dim: int,
                 emb_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, latent_dim)
        nn.init.zeros_(self.linear2.weight)
        nn.init.zeros_(self.linear2.bias)
        self.proj_out = StylizationBlock(latent_dim, emb_dim, dropout)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        if (kernel_route(x, "fused_stylized_ffn") and stylized_ffn_supported(
                B * T, T, D, self.linear1.out_features)
                and not (self.training or _needs_grad(self, x, emb))):
            p = self.proj_out
            w = _cast({"w1": self.linear1.weight, "b1": self.linear1.bias,
                       "w2": self.linear2.weight, "b2": self.linear2.bias,
                       "ln_w": p.norm.weight, "ln_b": p.norm.bias,
                       "w3": p.out_layers[2].weight,
                       "b3": p.out_layers[2].bias}, x.dtype)
            out = fused_stylized_ffn(x.reshape(B * T, D).contiguous(),
                                     p.ss_rows(emb).contiguous(),
                                     *w.values(), T=T)
            return out.reshape(B, T, D)
        y = _drop(F.gelu(linear(self.linear1, x)),
                  self.dropout if self.training else 0.0, generator)
        return x + self.proj_out(linear(self.linear2, y), emb, generator)


class MDTransformerLayer(nn.Module):
    """Self-attention over [latents; text; time] (text and time as keys and
    values only), then the linear cross-attention and the stylized FFN."""

    def __init__(self, d_model: int, text_latent_dim: int, ffn_dim: int,
                 num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        # the reference hard-codes ff 1024 + ReLU for this inner block
        self.sa_block = TransformerEncoderLayer(d_model, num_heads, 1024,
                                                "relu", dropout)
        self.ca_block = LinearTemporalCrossAttention(
            d_model, text_latent_dim, num_heads, dropout=dropout)
        self.ffn = StylizedFFN(d_model, ffn_dim, dropout=dropout)

    def kernel_params(self) -> dict:
        """The layer's tensors by the names ``fused_md_layer`` takes."""
        sa, cp, f = self.sa_block, self.ca_block.proj_out, self.ffn
        return {
            "sa_in_w": sa.self_attn.in_proj_weight,
            "sa_in_b": sa.self_attn.in_proj_bias,
            "sa_out_w": sa.self_attn.out_proj.weight,
            "sa_out_b": sa.self_attn.out_proj.bias,
            "ln1_w": sa.norm1.weight, "ln1_b": sa.norm1.bias,
            "w1": sa.linear1.weight, "b1": sa.linear1.bias,
            "w2": sa.linear2.weight, "b2": sa.linear2.bias,
            "ln2_w": sa.norm2.weight, "ln2_b": sa.norm2.bias,
            "ca_ln_w": cp.norm.weight, "ca_ln_b": cp.norm.bias,
            "ca_w": cp.out_layers[2].weight, "ca_b": cp.out_layers[2].bias,
            "fw1": f.linear1.weight, "fb1": f.linear1.bias,
            "fw2": f.linear2.weight, "fb2": f.linear2.bias,
            "f_ln_w": f.proj_out.norm.weight, "f_ln_b": f.proj_out.norm.bias,
            "fp_w": f.proj_out.out_layers[2].weight,
            "fp_b": f.proj_out.out_layers[2].bias,
        }

    def takes_whole_layer(self, x: torch.Tensor, xf: torch.Tensor) -> bool:
        """Whether the layer runs as K1 (``fused_md_layer``): eval mode, one
        text token, a compute type K1 takes (``kernel_route``: bf16 or
        float32) and a shape K1 takes."""
        B, T, D = x.shape
        return (not self.training and xf.shape[1] == 1
                and kernel_route(x, "fused_md_layer")
                and md_layer_supported(B, T, 2, D, self.num_heads,
                                       self.sa_block.linear1.out_features,
                                       self.ffn.linear1.out_features))

    def compute_prep(self, xf: torch.Tensor, embs: torch.Tensor,
                     with_params: bool = True) -> dict:
        """Step-invariant pieces of the fused paths, computed once before a
        sampling loop: the collapsed text value per sample and both AdaLN
        (scale, shift) tables, one row per time embedding.

        xf [B, 1, D] projected text; embs [S, D] time embeddings.  Returns
        {"value": [B, D], "ca_ss": [S, 2D], "ffn_ss": [S, 2D]} and, with
        ``with_params``, "params": K1's parameters in xf's type."""
        ca = self.ca_block
        tn = F.layer_norm(xf[:, 0].float(), (xf.shape[-1],),
                          ca.text_norm.weight.float(),
                          ca.text_norm.bias.float(), 1e-5).to(xf.dtype)
        prep = {"value": linear(ca.value, tn),
                "ca_ss": ca.proj_out.ss_rows(embs),
                "ffn_ss": self.ffn.proj_out.ss_rows(embs)}
        if with_params:
            prep["params"] = _cast(self.kernel_params(), xf.dtype)
        return prep

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                latent_valid: Optional[torch.Tensor] = None,
                prep: Optional[dict] = None,
                extra_rows: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, D]; xf [B, N, D]; emb [B, D].  ``prep``: one step's
        slice of ``compute_prep`` ("value" [B, D], "ca_ss"/"ffn_ss" [2D],
        shared by all samples, optionally "params"), read by the K1 route
        only; ``extra_rows``: [B*2, D] text and time rows shared by the
        layers of a stack.  ``generator`` drives the dropout of training
        mode."""
        B, T, D = x.shape
        if not self.takes_whole_layer(x, xf):
            tokens_valid = None
            if latent_valid is not None:
                tokens_valid = torch.cat([latent_valid, torch.ones(
                    B, xf.shape[1] + 1, dtype=torch.bool,
                    device=x.device)], dim=1)
            extra = torch.cat([xf, emb[:, None, :]], dim=1)
            x = self.sa_block(x, tokens_valid, extra_kv=extra,
                              generator=generator)
            x = self.ca_block(x, xf, emb, latent_valid, generator)
            return self.ffn(x, emb, generator)
        if prep is None:
            prep = self.compute_prep(xf, emb)
            value, ca_ss, ffn_ss = prep["value"], prep["ca_ss"], prep["ffn_ss"]
        else:
            value = prep["value"]
            ca_ss = prep["ca_ss"].reshape(1, -1)
            ffn_ss = prep["ffn_ss"].reshape(1, -1)
        params = prep.get("params")
        if params is None:
            params = _cast(self.kernel_params(), x.dtype)
        if extra_rows is None:
            extra_rows = torch.cat([xf, emb[:, None, :]], dim=1).reshape(
                B * 2, D)
        if latent_valid is not None:
            kvalid = latent_valid.reshape(B * T).float()
        else:
            kvalid = torch.ones(B * T, dtype=torch.float32, device=x.device)
        out = fused_md_layer(
            x.reshape(B * T, D).contiguous(), extra_rows.contiguous(),
            kvalid.contiguous(), value.contiguous(), ca_ss.contiguous(),
            ffn_ss.contiguous(), params, T=T, E=2, H=self.num_heads)
        return out.reshape(B, T, D)


class MDSkipTransformerEncoder(_SkipStack):
    """Skip (U-Net) encoder over MD layers; with a stack prep the whole
    stack is one launch of kernel 11."""

    def __init__(self, d_model: int, text_latent_dim: int, num_heads: int,
                 num_layers: int, ffn_dim: int = 1024, dropout: float = 0.0):
        super().__init__(
            lambda: MDTransformerLayer(d_model, text_latent_dim, ffn_dim,
                                       num_heads, dropout),
            d_model, num_layers)

    def precompute_prep(self, xf: torch.Tensor, embs: torch.Tensor,
                        with_params: bool = True) -> List[dict]:
        """``compute_prep`` of every layer, in execution order."""
        return [block.compute_prep(xf, embs, with_params)
                for block in self.ordered_blocks()]

    def stacked_params(self, dtype: torch.dtype) -> dict:
        """The stack's tensors for ``fused_md_stack`` in ``dtype``
        (``stack_md_params``), built once before a sampling loop."""
        return stack_md_params(
            [block.kernel_params() for block in self.ordered_blocks()],
            self.linear_blocks, self.norm, dtype)

    def stack_prep(self, prep_all: List[dict]):
        """``precompute_prep(..., with_params=False)`` laid out for kernel
        11: values [L, B, D] (step-invariant) and the AdaLN tables [S, L,
        2D] (one [L, 2D] slice per step)."""
        values = torch.stack([p["value"] for p in prep_all])
        ca_ss = torch.stack([p["ca_ss"] for p in prep_all], dim=1)
        ffn_ss = torch.stack([p["ffn_ss"] for p in prep_all], dim=1)
        return values, ca_ss, ffn_ss

    def _stack_forward(self, x, xf, emb, latent_valid, stack: dict):
        """The whole stack (layers, skips, final LN) as kernel 11 (its
        plain version inside a ``plain_routes()`` scope)."""
        B, T, D = x.shape
        if self.training or xf.shape[1] != 1:
            raise ValueError("the whole-stack route takes one text token in "
                             f"eval mode, got {xf.shape[1]} tokens, "
                             f"training={self.training}")
        extra = torch.cat([xf, emb[:, None, :]], dim=1).reshape(B * 2, D)
        kvalid = (latent_valid.reshape(B * T).float()
                  if latent_valid is not None
                  else torch.ones(B * T, device=x.device))
        # a plain_routes() scope takes the stack's plain version
        run = (fused_md_stack if kernel_route(x, "fused_md_stack")
               else md_stack_plain)
        out = run(
            x.reshape(B * T, D).contiguous(), extra.contiguous(),
            kvalid.contiguous(), stack["values"],
            stack["ca_ss"].contiguous(), stack["ffn_ss"].contiguous(),
            stack["params"], T=T, E=2, H=self.middle_block.num_heads)
        return out.reshape(B, T, D)

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                latent_valid: Optional[torch.Tensor] = None,
                prep: Optional[Union[List[dict], dict]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prep: one step's slice of ``precompute_prep`` (a list in
        execution order; the text and time rows are then shared by all
        layers), or {"stack": {"params": ``stacked_params``, "values" [L,
        B, D], "ca_ss" / "ffn_ss" [L, 2D]}} for the whole-stack kernel."""
        override = pp_override_get()
        if override is not None:
            # pipeline-parallel scope (parallel/pp.py): the GPipe schedule
            # replaces the layer loop
            return override(self, x, xf, emb, latent_valid)
        if isinstance(prep, dict):
            return self._stack_forward(x, xf, emb, latent_valid,
                                       prep["stack"])
        B, _, D = x.shape
        extra_rows = None
        if prep is not None:
            extra_rows = torch.cat([xf, emb[:, None, :]], dim=1).reshape(
                B * 2, D)
        return self.run(x, lambda i, block, h: block(
            h, xf, emb, latent_valid,
            prep=None if prep is None else prep[i], extra_rows=extra_rows,
            generator=generator))
