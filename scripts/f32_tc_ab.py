"""Times the float32 K2 and kernel 10 of the PyTorch port (the three-term
TF32 tensor-core kernels of ``ladiff_torch/csrc/f32_train_layer.cu``) at
their path shapes on one NVIDIA GPU, for A/B runs of two checkouts in one
call (run each checkout's copy in turns: A, B, B, A):

    python scripts/f32_tc_ab.py --label A [--tiles]

It imports ``ladiff_torch`` and ``chip_smoke``'s timers from the checkout
that holds it, builds that checkout's kernels at first use and prints one
JSON line per measurement, each with the label and the card's name and
power limit (``nvidia-smi``):

  kernel10        128 x 206 tokens, D 256, H 4, the encoder stream's mask
                  (the stage-2 frozen encode), beside SDPA
  kernel10_novae  64 x 198 tokens, D 512, H 4 (head width 128), no mask,
                  beside SDPA
  k2              32 x 196 frames over 5 memory rows (the test.py eval
                  batch's decode), beside ``nn.TransformerDecoderLayer``,
                  and its launches one by one with TFLOP/s
  k2_tiles        (``--tiles``) K2 with each product tile (128 or 64 rows)
                  and row block (64 or 32 rows) forced: 64 and 32 are the
                  inference tiles, which add each 8-deep step in float32

Device ms are the profiler's (``chip_smoke.interleaved_ms``: medians of
windows of 20 calls, in turn with the yardstick); every result is held to
its float32 plain version within 5e-5 first.  TF32 is off.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(ROOT))
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from ladiff_torch.ops import f32_layer
    from ladiff_torch.ops.attention_kernel import (fused_masked_attention,
                                                   masked_attention_plain)
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    from ladiff_torch.utils.masks import latent_valid_mask, lengths_to_mask

    if not torch.cuda.is_available():
        sys.exit("f32_tc_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, f32 = torch.device("cuda", 0), torch.float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    gpu = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    g = torch.Generator().manual_seed(25)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, f32)

    def out(what, **rec):
        print(json.dumps({"label": args.label, "gpu": gpu, "what": what,
                          **rec}), flush=True)

    def held(got, want):
        err = cs.relerr(got, want)
        if not err <= cs.F32_KERNEL_TOL:
            sys.exit(f"f32_tc_ab: rel err {err}")
        return err

    def heads(t, n, S, H):
        return t.reshape(n, S, H, -1).transpose(1, 2)

    with torch.no_grad():
        # kernel 10 at the frozen encode's tokens, under the encoder mask
        n, S, D, H = 128, 206, 256, 4
        lens = cs.mixed_lengths(n, seed=9)
        lat = latent_valid_mask(lens, 48, 5)
        valid = torch.cat([lat, lat, lengths_to_mask(lens, 196)], 1).to(dev)
        q, k, v = (rnd(n, S, D) for _ in range(3))
        err = held(fused_masked_attention(q, k, v, valid, num_heads=H),
                   masked_attention_plain(q, k, v, valid, num_heads=H))
        (ms, sdpa), _ = cs.interleaved_ms([
            lambda: fused_masked_attention(q, k, v, valid, num_heads=H),
            lambda: F.scaled_dot_product_attention(
                heads(q, n, S, H), heads(k, n, S, H), heads(v, n, S, H),
                attn_mask=valid[:, None, None, :])], rounds=3)
        out("kernel10", shape="128 x 206, head width 64, encoder mask",
            rel_err=err, ms=ms, sdpa_ms=sdpa)
        # kernel 10 at novae's float32 shape
        n, S, D, H = 64, 198, 512, 4
        q, k, v = (rnd(n, S, D) for _ in range(3))
        err = held(fused_masked_attention(q, k, v, None, num_heads=H),
                   masked_attention_plain(q, k, v, None, num_heads=H))
        (ms, sdpa), _ = cs.interleaved_ms([
            lambda: fused_masked_attention(q, k, v, None, num_heads=H),
            lambda: F.scaled_dot_product_attention(
                heads(q, n, S, H), heads(k, n, S, H), heads(v, n, S, H))],
            rounds=3)
        out("kernel10_novae", shape="64 x 198, head width 128, no mask",
            rel_err=err, ms=ms, sdpa_ms=sdpa)
        del q, k, v
        # K2 at the test.py eval batch's decode
        n, T, L, D, H, Fd = 32, 196, 5, 256, 4, 1024
        layer = cs.randomize_(TransformerDecoderLayer(D, H, Fd, "gelu"),
                              32).to(dev, f32)
        p = layer.kernel_params()
        lens = cs.mixed_lengths(n, lo=16, hi=T, seed=8)
        fv = lengths_to_mask(lens, T).to(dev)
        mv = latent_valid_mask(lens, 48, L).to(dev)
        x, mem = rnd(n * T, D), rnd(n, L, D)
        a2 = (x, fv.reshape(-1).float(), mem, mv.float())
        lib = torch.nn.TransformerDecoderLayer(
            D, H, Fd, dropout=0.0, activation="gelu", batch_first=True,
            norm_first=False).to(dev, f32).eval()
        lib.load_state_dict(layer.state_dict())
        err = held(fused_decoder_layer(*a2, p, T=T, H=H),
                   decoder_layer_plain(*a2, p, T=T, H=H))
        (ms, lib_ms), _ = cs.interleaved_ms([
            lambda: fused_decoder_layer(*a2, p, T=T, H=H),
            lambda: lib(x.reshape(n, T, D), mem, tgt_key_padding_mask=~fv,
                        memory_key_padding_mask=~mv)], rounds=3)
        keys, mkeys = fv.sum(1), mv.sum(1)
        pairs = T * int(torch.where(keys > 0, keys, T).sum())
        cpairs = T * int(torch.where(mkeys > 0, mkeys, L).sum())
        per = cs.launch_rates(
            lambda: fused_decoder_layer(*a2, p, T=T, H=H),
            cs.tc_launch_flops("fwd", n * T, D, Fd, pairs, (n * L, cpairs)))
        out("k2", shape="32 x 196 frames, L 5", rel_err=err, ms=ms,
            library_ms=lib_ms, per_launch=per)
        if args.tiles:
            picks = f32_layer.TC_PRODUCT_ROWS, f32_layer.TC_ROW_BLOCK
            combos = [(gen, rows) for gen in (128, 64) for rows in (64, 32)]
            fns = []
            for gen, rows in combos:
                def run(gen=gen, rows=rows):
                    f32_layer.TC_PRODUCT_ROWS = gen
                    f32_layer.TC_ROW_BLOCK = rows
                    try:
                        return fused_decoder_layer(*a2, p, T=T, H=H)
                    finally:
                        (f32_layer.TC_PRODUCT_ROWS,
                         f32_layer.TC_ROW_BLOCK) = picks
                held(run(), decoder_layer_plain(*a2, p, T=T, H=H))
                fns.append(run)
            meds, _ = cs.interleaved_ms(fns, rounds=3)
            out("k2_tiles", shape="32 x 196 frames, L 5",
                ms={f"products {gen}, row blocks {rows}": m
                    for (gen, rows), m in zip(combos, meds)})


if __name__ == "__main__":
    main()
