"""MotionDiffuse-style stylization layers, the ``MD_TRANS`` denoiser path
(counterpart of ``ladiff_tpu/ops/stylization.py``).

Parameter names follow the reference torch LADiff (``sa_block``,
``ca_block.{norm,text_norm,query,key,value,proj_out}``,
``ffn.{linear1,linear2,proj_out}``, ``proj_out.emb_layers.1`` /
``.norm`` / ``.out_layers.2``).  With one pooled text token (the released
configs) a whole ``MDTransformerLayer`` runs as one call of
``fused_md_layer`` (kernel K1 on a CUDA tensor, its plain version on a CPU
tensor).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ladiff_torch.ops.md_layer import fused_md_layer
from ladiff_torch.ops.transformer import TransformerEncoderLayer, _SkipStack

__all__ = [
    "StylizationBlock",
    "LinearTemporalCrossAttention",
    "StylizedFFN",
    "MDTransformerLayer",
    "MDSkipTransformerEncoder",
]


class StylizationBlock(nn.Module):
    """h <- out_layers(norm(h) * (1 + scale) + shift) with (scale, shift)
    from ``emb_layers(emb)``; the last linear starts at zero."""

    def __init__(self, latent_dim: int, emb_dim: Optional[int] = None):
        super().__init__()
        D = latent_dim
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_dim or D, 2 * D))
        self.norm = nn.LayerNorm(D, eps=1e-5)
        self.out_layers = nn.Sequential(nn.SiLU(), nn.Dropout(0.0),
                                        nn.Linear(D, D))
        nn.init.zeros_(self.out_layers[2].weight)
        nn.init.zeros_(self.out_layers[2].bias)

    def scale_shift(self, emb: torch.Tensor):
        return self.emb_layers(emb).chunk(2, dim=-1)

    def forward(self, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.scale_shift(emb)
        h = self.norm(h) * (1 + scale[:, None, :]) + shift[:, None, :]
        return self.out_layers(h)


class LinearTemporalCrossAttention(nn.Module):
    """Softmax-linear attention latents <- text with latent-row masking."""

    def __init__(self, latent_dim: int, text_latent_dim: int,
                 num_heads: int, emb_dim: Optional[int] = None):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.norm = nn.LayerNorm(D, eps=1e-5)
        self.text_norm = nn.LayerNorm(text_latent_dim, eps=1e-5)
        self.query = nn.Linear(D, D)
        self.key = nn.Linear(text_latent_dim, D)
        self.value = nn.Linear(text_latent_dim, D)
        self.proj_out = StylizationBlock(D, emb_dim)

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                latent_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        tn = self.text_norm(xf)
        value = self.value(tn)
        if N == 1:
            # exact collapse for one text token: softmax over one key is 1
            # and the query softmax sums to 1, so every valid row gets v
            y = value.expand(B, T, D)
        else:
            query = torch.softmax(self.query(self.norm(x)).reshape(
                B, T, H, -1), dim=-1)
            key = torch.softmax(self.key(tn).reshape(B, N, H, -1), dim=1)
            att = torch.einsum("bnhd,bnhl->bhdl", key,
                               value.reshape(B, N, H, -1))
            y = torch.einsum("bnhd,bhdl->bnhl", query, att).reshape(B, T, D)
        if latent_valid is not None:
            y = y * latent_valid[:, :, None].to(y.dtype)
        return x + self.proj_out(y, emb)


class StylizedFFN(nn.Module):
    """GELU FFN with a zero-init second linear and stylized output."""

    def __init__(self, latent_dim: int, ffn_dim: int,
                 emb_dim: Optional[int] = None):
        super().__init__()
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, latent_dim)
        nn.init.zeros_(self.linear2.weight)
        nn.init.zeros_(self.linear2.bias)
        self.proj_out = StylizationBlock(latent_dim, emb_dim)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        y = self.linear2(F.gelu(self.linear1(x)))
        return x + self.proj_out(y, emb)


class MDTransformerLayer(nn.Module):
    """Self-attention over [latents; text; time] (text and time as keys and
    values only), then the linear cross-attention and the stylized FFN."""

    def __init__(self, d_model: int, text_latent_dim: int, ffn_dim: int,
                 num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        # the reference hard-codes ff 1024 + ReLU for this inner block
        self.sa_block = TransformerEncoderLayer(d_model, num_heads, 1024,
                                                "relu")
        self.ca_block = LinearTemporalCrossAttention(d_model, text_latent_dim,
                                                     num_heads)
        self.ffn = StylizedFFN(d_model, ffn_dim)

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

    def compute_prep(self, xf: torch.Tensor, embs: torch.Tensor) -> dict:
        """Step-invariant pieces of the fused path, computed once before a
        sampling loop: the collapsed text value per sample and both AdaLN
        (scale, shift) tables, one row per time embedding.

        xf [B, 1, D] projected text; embs [S, D] time embeddings.  Returns
        {"value": [B, D], "ca_ss": [S, 2D], "ffn_ss": [S, 2D]}."""
        ca = self.ca_block
        tn = F.layer_norm(xf[:, 0].float(), (xf.shape[-1],),
                          ca.text_norm.weight.float(),
                          ca.text_norm.bias.float(), 1e-5).to(xf.dtype)
        sembs = F.silu(embs)
        return {"value": ca.value(tn),
                "ca_ss": ca.proj_out.emb_layers[1](sembs),
                "ffn_ss": self.ffn.proj_out.emb_layers[1](sembs)}

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                latent_valid: Optional[torch.Tensor] = None,
                prep: Optional[dict] = None,
                extra_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, D]; xf [B, N, D]; emb [B, D].  ``prep``: one step's
        slice of ``compute_prep`` ("value" [B, D], "ca_ss"/"ffn_ss" [2D],
        shared by all samples); ``extra_rows``: [B*2, D] text and time rows
        shared by the layers of a stack."""
        B, T, D = x.shape
        if xf.shape[1] != 1:
            tokens_valid = None
            if latent_valid is not None:
                tokens_valid = torch.cat([latent_valid, torch.ones(
                    B, xf.shape[1] + 1, dtype=torch.bool,
                    device=x.device)], dim=1)
            extra = torch.cat([xf, emb[:, None, :]], dim=1)
            x = self.sa_block(x, tokens_valid, extra_kv=extra)
            x = self.ca_block(x, xf, emb, latent_valid)
            return self.ffn(x, emb)
        if prep is None:
            p = self.compute_prep(xf, emb)
            value, ca_ss, ffn_ss = p["value"], p["ca_ss"], p["ffn_ss"]
        else:
            value = prep["value"]
            ca_ss = prep["ca_ss"].reshape(1, -1)
            ffn_ss = prep["ffn_ss"].reshape(1, -1)
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
            ffn_ss.contiguous(), self.kernel_params(), T=T, E=2,
            H=self.num_heads)
        return out.reshape(B, T, D)


class MDSkipTransformerEncoder(_SkipStack):
    """Skip (U-Net) encoder over MD layers."""

    def __init__(self, d_model: int, text_latent_dim: int, num_heads: int,
                 num_layers: int, ffn_dim: int = 1024):
        super().__init__(
            lambda: MDTransformerLayer(d_model, text_latent_dim, ffn_dim,
                                       num_heads),
            d_model, num_layers)

    def precompute_prep(self, xf: torch.Tensor,
                        embs: torch.Tensor) -> List[dict]:
        """``compute_prep`` of every layer, in execution order."""
        return [block.compute_prep(xf, embs)
                for block in self.ordered_blocks()]

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                latent_valid: Optional[torch.Tensor] = None,
                prep: Optional[List[dict]] = None) -> torch.Tensor:
        """prep: one step's slice of ``precompute_prep`` (a list in
        execution order); the text and time rows are then shared by all
        layers."""
        B, _, D = x.shape
        extra_rows = None
        if prep is not None:
            extra_rows = torch.cat([xf, emb[:, None, :]], dim=1).reshape(
                B * 2, D)
        return self.run(x, lambda i, block, h: block(
            h, xf, emb, latent_valid,
            prep=None if prep is None else prep[i], extra_rows=extra_rows))
