"""Kernel K2: one whole post-norm transformer decoder layer, the VAE decode
hot path.  Replaces ``ladiff_tpu/ops/pallas_decoder_layer.py``
``fused_decoder_layer`` (:234, ``pl.pallas_call`` at :364).

    t1  = LN1(x + out(self_attn(x, keys = the sample's valid frames)))
    h   = LN2(t1 + out(cross_attn(t1, keys = the sample's valid latents)))
    out = LN3(h + W2 act(W1 h + b1) + b2)

What bounds it on the H100: at batch 256 x 196 frames it is ~100 GFLOP of
bf16 products against ~26 MB of activations and 1.4 MB of weights, far
above the 295 FLOP/byte ridge, so the tensor cores bound it, and with them
the weight bytes each row block streams from L2.  The TPU kernel kept a
[196, 196] score block per head in VMEM; on Hopper that is 154 KB of f32 per
head, so the CUDA version (``csrc/decoder_layer.cu``) is a fixed sequence of
four launches behind this one wrapper:

  1. the q/k/v projection of the frame rows and 2. the k/v projection of
     the latent memory rows (``linear64_kernel`` of ``csrc/tail64.cuh``:
     64-row blocks of 16 warps, ``mma.sync`` bf16 with f32 register
     accumulators, the weight through a three-stage ``cp.async`` ring);
  3. the self-attention as register-resident 64-query flash tiles
     (``csrc/attn_tile.cuh``: one block per sample, head and query tile,
     scores and probabilities in registers, key tiles without a valid key
     skipped); padded frames are masked keys and never reach a valid
     query, their own query rows are computed and later zeroed by
     ``LAVae.decode``;
  4. the rest of the layer per 64-row block (``csrc/dec_tail64.cuh``, the
     body kernel 13 runs too): out-projection + residual + LN1, the
     cross-attention into the sample's <= 8 latent rows (one warp per row
     and head, the scores in lane quads, softmax by shuffles), its
     out-projection + LN2, the FFN in 128-column hidden chunks, LN3; the
     residuals stay in f32 registers, only bf16 operands go through
     shared memory, and each byte of weight serves 64 rows.

In float32 (the published configurations' type) the wrapper runs K2's
float32 route, ``f32_layer.decoder_layer_f32``: 8 launches of the
three-term TF32 tensor-core kernels of ``csrc/f32_train_layer.cu`` (kernel
13's forward at rate 0, nothing saved: qkv, the self-attention, out-proj +
residual + LN1, the cross q with the memory's k / v, the cross-attention,
cross out-proj + residual + LN2, W1 + act, W2 + residual + LN3), at the
shapes ``decoder_layer_supported`` takes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ladiff_torch.ops.attention_kernel import masked_attention_plain
from ladiff_torch.ops.cuda_common import (check_cuda_args, launch,
                                          register_kernel, require_no_grad)
from ladiff_torch.ops.f32_layer import decoder_layer_f32

__all__ = ["fused_decoder_layer", "decoder_layer_plain",
           "decoder_layer_supported", "MAX_MEMORY"]

_ACT = {"relu": 0, "gelu": 1}
MAX_MEMORY = 8  # memory rows per sample: the lane quads of a warp (K2, 13)
_PARAM_ORDER = ("sa_in_w", "sa_in_b", "sa_out_w", "sa_out_b", "ln1_w",
                "ln1_b", "ca_in_w", "ca_in_b", "ca_out_w", "ca_out_b",
                "ln2_w", "ln2_b", "w1", "b1", "w2", "b2", "ln3_w", "ln3_b")


def decoder_layer_supported(D: int, H: int, F: int, activation: str,
                            L: int = 1) -> bool:
    """Whether K2 takes a layer of width D, H heads, FFN width F over L
    latent memory rows per sample: D a multiple of 64 up to 256 (the tail's
    instantiations), a head width that is a multiple of 16 up to 128 (the
    attention tile's), F a multiple of 128 (the FFN's hidden chunks), 1 to
    ``MAX_MEMORY`` memory rows, ReLU or GELU."""
    return (D % 64 == 0 and 0 < D <= 256 and D % H == 0
            and (D // H) % 16 == 0 and D // H <= 128 and F % 128 == 0
            and F > 0 and 1 <= L <= MAX_MEMORY and activation in _ACT)


def decoder_layer_plain(x, kvalid, mem, mvalid, p, *, T: int, H: int,
                        activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch version.  x [B*T, D] frame rows; kvalid [B*T] float
    frame validity; mem [B, L, D] latent memory; mvalid [B, L] float."""
    BT, D = x.shape
    B = BT // T
    dt = x.dtype
    w = {k: v.to(dt) for k, v in p.items()}
    xb = x.reshape(B, T, D)

    def ln(a, name):
        return F.layer_norm(a, (D,), w[name + "_w"], w[name + "_b"], 1e-5)

    q, k, v = F.linear(xb, w["sa_in_w"], w["sa_in_b"]).split(D, dim=-1)
    att = masked_attention_plain(q, k, v, kvalid.reshape(B, T) > 0.5,
                                 num_heads=H)
    t1 = ln(xb + F.linear(att, w["sa_out_w"], w["sa_out_b"]), "ln1")
    wq, wk, wv = w["ca_in_w"].split(D)
    bq, bk, bv = w["ca_in_b"].split(D)
    mem = mem.to(dt)
    att2 = masked_attention_plain(
        F.linear(t1, wq, bq), F.linear(mem, wk, bk), F.linear(mem, wv, bv),
        mvalid > 0.5, num_heads=H)
    h = ln(t1 + F.linear(att2, w["ca_out_w"], w["ca_out_b"]), "ln2")
    act = F.relu if activation == "relu" else F.gelu
    y = F.linear(act(F.linear(h, w["w1"], w["b1"])), w["w2"], w["b2"])
    return ln(h + y, "ln3").reshape(BT, D)


@register_kernel("fused_decoder_layer")
def fused_decoder_layer(x, kvalid, mem, mvalid, p, *, T: int, H: int,
                        activation: str = "gelu") -> torch.Tensor:
    """Kernel K2 on CUDA tensors (bf16, or float32 through its float32
    chain), its plain version on CPU tensors.
    The kernel has no backward: on CUDA tensors it raises while a gradient
    is required (training layers take the training kernels instead)."""
    if not x.is_cuda:
        return decoder_layer_plain(x, kvalid, mem, mvalid, p, T=T, H=H,
                                   activation=activation)
    require_no_grad("fused_decoder_layer",
                    [x, mem, *[p[k] for k in _PARAM_ORDER]])
    BT, D = x.shape
    B, L = mem.shape[0], mem.shape[1]
    Fd = p["w1"].shape[0]
    if BT != B * T or not decoder_layer_supported(D, H, Fd, activation, L):
        raise ValueError(f"fused_decoder_layer: unsupported shape B={B} T={T}"
                         f" L={L} D={D} H={H} F={Fd} activation="
                         f"{activation}")
    check_cuda_args("fused_decoder_layer",
                    {"x": x, "kvalid": kvalid, "mem": mem, "mvalid": mvalid,
                     **{k: p[k] for k in _PARAM_ORDER}},
                    f32=("kvalid", "mvalid"))
    if x.dtype == torch.float32:
        out = decoder_layer_f32(x, kvalid, mem, mvalid, p, T=T, H=H,
                                activation=activation)
        fused_decoder_layer.launches += 1
        return out
    qkv = torch.empty(BT, 3 * D, dtype=x.dtype, device=x.device)
    kv2 = torch.empty(B * L, 2 * D, dtype=x.dtype, device=x.device)
    ctx = torch.empty(BT, D, dtype=x.dtype, device=x.device)
    out = torch.empty(BT, D, dtype=x.dtype, device=x.device)
    ptrs = [x.data_ptr(), kvalid.data_ptr(), mem.data_ptr(),
            mvalid.data_ptr(), *[p[k].data_ptr() for k in _PARAM_ORDER],
            qkv.data_ptr(), kv2.data_ptr(), ctx.data_ptr(), out.data_ptr()]
    launch("decoder_layer", "decoder_layer_forward", x.device, ptrs,
           [B, T, L, D, H, Fd, _ACT[activation]])
    fused_decoder_layer.launches += 1
    return out
