"""Kernel K1: one whole MD-trans denoiser layer.  Replaces
``ladiff_tpu/ops/pallas_md_layer.py`` ``fused_md_layer`` (:198,
``pl.pallas_call`` at :313).

    sa:  each sample's T latent rows attend over [its latents ; its E extra
         rows] (text and time, keys/values only, always valid; latent keys
         masked by the latent mask; keys never cross samples), H heads
         -> out-proj + residual -> LN -> ReLU FFN -> + residual -> LN
    ca:  single-text-token collapse: value row x latent mask -> LN ->
         AdaLN(scale, shift) -> SiLU -> proj + residual (a masked row is a
         zero row, whose LN is the LN bias; kept as it is)
    ffn: GELU FFN -> LN -> AdaLN -> SiLU -> proj + residual

What bounds it on the H100: at the sampling shape (2B = 512 samples x 5
rows, D 256, F 1024) one launch is ~7.8 GFLOP against ~2.4 MB of weights
and ~1.3 MB of activations, so the tensor cores bound it in principle, but
it runs 450 times per batch and each launch is short: launch latency and
filling the card matter as much.  The design (``csrc/md_layer.cu``): one
block per group of whole samples (32 latent rows, e.g. 6 samples of 5
rows), the whole layer in one launch with every intermediate in shared
memory; products are WMMA bf16 tiles with f32 accumulation, weights are
read straight from global memory (L2-resident across blocks), the 7-key
attention is a warp-per-(row, head) online softmax, LayerNorms are
warp-per-row in f32.  The layer body (``csrc/md_layer_body.cuh``) is
shared with kernel 11, which runs the whole skip stack in one launch.
CUDA graphs for the 450 launches are a later step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.attention_kernel import masked_attention_plain
from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)

__all__ = ["fused_md_layer", "md_layer_plain", "md_layer_supported"]

_PARAM_ORDER = ("sa_in_w", "sa_in_b", "sa_out_w", "sa_out_b", "ln1_w",
                "ln1_b", "w1", "b1", "w2", "b2", "ln2_w", "ln2_b",
                "ca_ln_w", "ca_ln_b", "ca_w", "ca_b", "fw1", "fb1", "fw2",
                "fb2", "f_ln_w", "f_ln_b", "fp_w", "fp_b")


def md_layer_supported(B: int, T: int, E: int, D: int, H: int, F1: int,
                       F2: int) -> bool:
    """Whether K1 (and kernel 11, which runs K1's layer body) takes a layer
    of this shape: B samples of T latent rows and E extra rows, width D, H
    heads, FFN widths F1 (the ReLU block) and F2 (the stylized one).  Whole
    samples of at most 32 rows of each kind in a block, D a multiple of 32
    up to 256, head width up to 128 (a warp's four values per lane)."""
    return (B >= 1 and 1 <= T <= 32 and 1 <= E <= 32 and D % 32 == 0
            and D <= 256 and D % H == 0 and D // H <= 128 and F1 % 32 == 0
            and F2 % 32 == 0)


def md_layer_plain(x, extra, kvalid, value, ca_ss, ffn_ss, p, *, T: int,
                   E: int, H: int) -> torch.Tensor:
    """Plain PyTorch version.  x [B*T, D] latent rows; extra [B*E, D] text
    and time rows; kvalid [B*T] float latent validity; value [B, D] the
    collapsed text value; ca_ss / ffn_ss [1 or B, 2D] AdaLN (scale, shift)
    rows, one row shared by all samples or one per sample."""
    BT, D = x.shape
    B = BT // T
    dt = x.dtype
    w = {k: v.to(dt) for k, v in p.items()}

    def ln(a, name):
        return F.layer_norm(a, (D,), w[name + "_w"], w[name + "_b"], 1e-5)

    xb = x.reshape(B, T, D)
    kv_in = torch.cat([xb, extra.to(dt).reshape(B, E, D)], dim=1)
    q = F.linear(xb, w["sa_in_w"][:D], w["sa_in_b"][:D])
    k, v = F.linear(kv_in, w["sa_in_w"][D:], w["sa_in_b"][D:]).split(D, -1)
    lat_valid = kvalid.reshape(B, T) > 0.5
    valid = torch.cat([lat_valid, torch.ones(B, E, dtype=torch.bool,
                                             device=x.device)], dim=1)
    att = masked_attention_plain(q, k, v, valid, num_heads=H)
    h1 = ln(xb + F.linear(att, w["sa_out_w"], w["sa_out_b"]), "ln1")
    y = F.linear(F.relu(F.linear(h1, w["w1"], w["b1"])), w["w2"], w["b2"])
    x2 = ln(h1 + y, "ln2")

    ca_scale, ca_shift = ca_ss.to(dt).reshape(-1, 1, 2 * D).split(D, -1)
    f_scale, f_shift = ffn_ss.to(dt).reshape(-1, 1, 2 * D).split(D, -1)
    yv = value.to(dt).reshape(B, 1, D) * kvalid.to(dt).reshape(B, T, 1)
    h2 = F.silu(ln(yv, "ca_ln") * (1 + ca_scale) + ca_shift)
    x3 = x2 + F.linear(h2, w["ca_w"], w["ca_b"])
    y2 = F.linear(F.gelu(F.linear(x3, w["fw1"], w["fb1"])),
                  w["fw2"], w["fb2"])
    h3 = F.silu(ln(y2, "f_ln") * (1 + f_scale) + f_shift)
    return (x3 + F.linear(h3, w["fp_w"], w["fp_b"])).reshape(BT, D)


@register_kernel("fused_md_layer")
def fused_md_layer(x, extra, kvalid, value, ca_ss, ffn_ss, p, *, T: int,
                   E: int, H: int) -> torch.Tensor:
    """Kernel K1 on CUDA tensors (bf16), its plain version on CPU tensors.
    The kernel has no backward: on CUDA tensors it raises while a gradient
    is required (a training-mode MD layer takes its unfused route)."""
    if not x.is_cuda:
        return md_layer_plain(x, extra, kvalid, value, ca_ss, ffn_ss, p,
                              T=T, E=E, H=H)
    require_no_grad("fused_md_layer",
                    [x, extra, value, ca_ss, ffn_ss,
                     *[p[k] for k in _PARAM_ORDER]])
    BT, D = x.shape
    B = BT // T
    F1, F2 = p["w1"].shape[0], p["fw1"].shape[0]
    rows = ca_ss.shape[0], ffn_ss.shape[0]
    if (BT != B * T or extra.shape != (B * E, D) or value.shape != (B, D)
            or not md_layer_supported(B, T, E, D, H, F1, F2)
            or any(r not in (1, B) for r in rows)):
        raise ValueError(f"fused_md_layer: unsupported shape B={B} T={T} "
                         f"E={E} D={D} H={H} F={F1},{F2} ss rows={rows}")
    check_cuda_args("fused_md_layer",
                    {"x": x, "extra": extra, "kvalid": kvalid,
                     "value": value, "ca_ss": ca_ss, "ffn_ss": ffn_ss,
                     **{k: p[k] for k in _PARAM_ORDER}}, f32=("kvalid",))
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), extra.data_ptr(), kvalid.data_ptr(),
            value.data_ptr(), ca_ss.data_ptr(), ffn_ss.data_ptr(),
            *[p[k].data_ptr() for k in _PARAM_ORDER], out.data_ptr()]
    launch("md_layer", "md_layer_forward", x.device, ptrs,
           [B, T, E, D, H, F1, F2, 0 if rows[0] == 1 else 2 * D,
            0 if rows[1] == 1 else 2 * D])
    fused_md_layer.launches += 1
    return out
