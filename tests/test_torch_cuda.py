"""The port's CUDA kernels (K1..K4, the inference FFN tail and masked
attention, the training attention and FFN-tail kernels with their
backwards, the whole MD stack, the stylized FFN and the one-token
stylize, the whole-layer training kernels 12 and 13) against their plain
PyTorch versions, on an NVIDIA GPU (marked ``cuda``; skipped where there is
none).  Imports no JAX, so it runs on a machine that has only PyTorch and
the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda [--noconftest]

(``--noconftest`` where JAX is not installed: tests/conftest.py sets JAX up.)

Inputs are bf16 with mixed lengths; the plain version runs in float32 on
the same inputs.  Tolerance 2e-2 norm-wise: bf16 operands (2^-9 rounding)
through a layer's ~6 chained products, LayerNorms and softmaxes.  The
training kernels' gradients are held to the plain backward the same way,
each gradient on its own; with dropout the plain version gets the masks
the kernel drew (``*_masks``).
"""
import math

import numpy as np
import pytest
import torch

TOL = 2e-2
# Gradients through ReLU: its derivative is a step, and the kernel decides
# a > 0 from a product of bf16-rounded h while the float32 plain version
# does not round h, so pre-activations within ~2^-9 of zero (a few in a
# thousand) flip and each flip changes da by the whole upstream value:
# a norm-wise error of sqrt(flipped share), measured 3.2e-2.
TOL_RELU_GRAD = 8e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                r = r / math.sqrt(p.shape[-1])
            elif "norm" in name and name.endswith("weight"):
                r = 1.0 + 0.1 * r
            else:
                r = 0.05 * r
            p.copy_(r)
    return module


def _relerr(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _mask(lengths, n, dev):
    lengths = torch.as_tensor(lengths)
    return (torch.arange(n)[None] < lengths[:, None]).float().to(dev)


def _f32(p):
    return {k: v.float() for k, v in p.items()}


def _md_valid(B, T, dev, seed=3):
    """Mixed latent lengths for B samples of T rows; the first of several
    samples has no valid latent (it attends over its extra rows only)."""
    lengths = np.random.RandomState(seed).randint(1, T + 1, B)
    if B > 1:
        lengths[0] = 0
    return _mask(lengths, T, dev).reshape(-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B,spg", [(1, 0), (13, 0), (13, 4), (512, 0)])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("shared_rows", [True, False])
@torch.no_grad()
def test_md_layer_kernel(dev, shared_rows, T, B, spg):
    """K1 against its float32 plain version: the geometry the wrapper picks
    and (spg 4) row groups of 4 samples, the last one partial; row tiles
    partly filled at T 1 and 5."""
    from ladiff_torch.ops import md_layer
    from ladiff_torch.ops.md_layer import md_layer_plain
    from ladiff_torch.ops.stylization import MDTransformerLayer
    D, H, E = 256, 4, 2
    layer = _randomize(MDTransformerLayer(D, D, 1024, H), 1).to(dev,
                                                                torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    bf = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    rows = 1 if shared_rows else B
    args = (bf(B * T, D), bf(B * E, D), _md_valid(B, T, dev),
            bf(B, D), 0.3 * bf(rows, 2 * D), 0.3 * bf(rows, 2 * D))
    p = layer.kernel_params()
    got = (md_layer._launch(*args, p, T=T, E=E, H=H, spg=spg) if spg else
           md_layer.fused_md_layer(*args, p, T=T, E=E, H=H))
    want = md_layer_plain(*[a.float() for a in args], _f32(p), T=T, E=E, H=H)
    assert _relerr(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("T,lengths", [(196, (196, 16, 100, 47, 150)),
                                       (40, (40, 23, 7))])
@pytest.mark.parametrize("D,H", [(64, 2), (128, 2), (192, 4), (256, 4)])
@torch.no_grad()
def test_decoder_layer_kernel(dev, D, H, T, lengths):
    """K2 at each width its 64-row tail takes, FFN 4 D; 5 x 196 frames
    (the last row block partial) and 3 x 40 (a block holds rows of two
    samples, the second block partial, one sample sees one latent)."""
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    L = 5
    lengths = np.array(lengths)
    B = len(lengths)
    layer = _randomize(TransformerDecoderLayer(D, H, 4 * D, "gelu"), 4).to(
        dev, torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    bf = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    args = (bf(B * T, D), _mask(lengths, T, dev).reshape(-1).contiguous(),
            bf(B, L, D), _mask(-(-lengths // 48) if T == 196
                               else np.array([5, 3, 1]), L, dev))
    p = layer.kernel_params()
    got = fused_decoder_layer(*args, p, T=T, H=H)
    want = decoder_layer_plain(*[a.float() for a in args], _f32(p), T=T, H=H)
    assert _relerr(got, want) <= TOL


# One launch of K3's and K4's chains against its plain piece on the same
# bf16 inputs: the piece computes in float32, the launch rounds its output
# once to bf16 (2^-9 at most, ~1e-3 norm-wise; h stays f32) and sums in
# another order.
TOL_PIECE = 4e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,seq,W", [(5, 16, 768), (5, 32, 768),
                                     (5, 77, 768), (1, 16, 768),
                                     (3, 16, 768), (3, 77, 768),
                                     (256, 32, 768), (3, 16, 128),
                                     (3, 16, 160)])
@torch.no_grad()
def test_clip_layer_kernels(dev, B, seq, W):
    """K3 and K4 against their float32 plain versions, and each launch of
    their chains (the LayerNorm pass, the GEMMs with their epilogues)
    against its plain piece: 16, 48, 80, 160, 231, 385 and 8192 rows at
    CLIP's width 768; widths 128 and 160 take the LayerNorm pass's
    one-element loads (D not a multiple of 256, or of 128 for f32 h) and
    partial column tiles."""
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops import clip_layer as cl
    layer = _randomize(CLIPTextLayer(W, 12), 6).to(dev, torch.bfloat16)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B * seq, W, generator=g).to(dev, torch.bfloat16)
    att = torch.randn(B * seq, W, generator=g).to(dev, torch.bfloat16)
    pq, pm = layer.qkv_params(), layer.mlp_params()
    f = lambda *ts: [t.float() for t in ts]
    for got, want in zip(cl.fused_ln_qkv(x, pq, scale=0.125),
                         cl.ln_qkv_plain(x.float(), _f32(pq), scale=0.125)):
        assert _relerr(got, want) <= TOL
    assert _relerr(cl.fused_proj_mlp(att, x, pm),
                   cl.proj_mlp_plain(att.float(), x.float(), _f32(pm))) <= TOL
    # K3's launches
    y = cl._ln_rows(x, pq["ln_w"], pq["ln_b"])
    assert _relerr(y, cl.clip_ln_plain(*f(x, pq["ln_w"], pq["ln_b"]),
                                       torch.float32)) <= TOL_PIECE
    qkv = [torch.empty_like(x) for _ in range(3)]
    cl._gemm(y, [pq["wq"], pq["wk"], pq["wv"]], [pq["bq"], pq["bk"],
                                                 pq["bv"]],
             qkv, epilogue="bias", scale=0.125)
    for n, got in zip("qkv", qkv):
        want = cl.clip_gemm_plain(*f(y, pq["w" + n], pq["b" + n]),
                                  epilogue="bias",
                                  scale=0.125 if n == "q" else 1.0)
        assert _relerr(got, want) <= TOL_PIECE, n
    # K4's launches, each on the previous launch's output
    M = B * seq
    h = torch.empty(M, W, dtype=torch.float32, device=dev)
    cl._gemm(att, [pm["wo"]], [pm["bo"]], [h], epilogue="resid_f32", resid=x)
    assert _relerr(h, cl.clip_gemm_plain(*f(att, pm["wo"], pm["bo"]),
                                         epilogue="resid_f32",
                                         resid=x.float())) <= TOL_PIECE
    y2 = cl._ln_rows(h, pm["ln_w"], pm["ln_b"])
    assert _relerr(y2, cl.clip_ln_plain(h, *f(pm["ln_w"], pm["ln_b"]),
                                        torch.float32)) <= TOL_PIECE
    hid = torch.empty(M, 4 * W, dtype=torch.bfloat16, device=dev)
    cl._gemm(y2, [pm["w1"]], [pm["b1"]], [hid], epilogue="gelu")
    assert _relerr(hid, cl.clip_gemm_plain(*f(y2, pm["w1"], pm["b1"]),
                                           epilogue="gelu")) <= TOL_PIECE
    out = torch.empty_like(x)
    cl._gemm(hid, [pm["w2"]], [pm["b2"]], [out], epilogue="resid_bf16",
             resid=h)
    assert _relerr(out, cl.clip_gemm_plain(*f(hid, pm["w2"], pm["b2"]),
                                           epilogue="resid_bf16",
                                           resid=h)) <= TOL_PIECE


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 192, 256])
@pytest.mark.parametrize("M,N,K", [(48, 768, 768), (300, 3072, 768),
                                   (385, 768, 3072), (1000, 320, 96)])
@torch.no_grad()
def test_clip_gemm_tile_widths(dev, bn, M, N, K):
    """The GEMM block at each tile width against its plain piece: ragged
    rows (48, 300, 385, 1000; an odd count of row tiles leaves a cluster's
    second CTA past M), columns that leave a partial tile (320), k shorter
    than a stage (96), one cluster per tile pair and persistent
    clusters."""
    from ladiff_torch.ops import clip_layer as cl
    from ladiff_torch.ops.cuda_common import launch
    a, w = _bf(dev, M, K, seed=21), _bf(dev, N, K, seed=22,
                                        scale=K ** -0.5)
    b, r = _bf(dev, N, seed=23, scale=0.05), _bf(dev, M, N, seed=24)
    out = torch.empty(M, N, dtype=torch.float32, device=dev)
    # the geometry's clusters, then 3 and 1 clusters walking every pair
    for ctas in (None, 6, 2):
        geo = cl.clip_gemm_geometry(M, N, K, bn=bn)
        if ctas:
            launch("clip_layer", "clip_gemm", dev,
                   [a.data_ptr(), w.data_ptr(), 0, 0, b.data_ptr(), 0, 0,
                    out.data_ptr(), 0, 0, r.data_ptr()],
                   [M, N, K, 1, cl.EPILOGUES["resid_f32"], bn, ctas], [1.0])
        else:
            cl._gemm(a, [w], [b], [out], epilogue="resid_f32", resid=r,
                     bn=bn)
        want = cl.clip_gemm_plain(a.float(), w.float(), b.float(),
                                  epilogue="resid_f32", resid=r.float())
        assert _relerr(out, want) <= TOL_PIECE, (geo, ctas)
        out.fill_(float("nan"))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 192, 256])
@torch.no_grad()
def test_clip_gemm_probe_sums_the_products(dev, bn):
    """The probe epilogue (it times the GEMM block's products alone) adds
    up every product of A W^T, three weights in one launch, on 300 rows
    (an odd count of row tiles: the cluster's second CTA past M adds
    nothing)."""
    from ladiff_torch.ops import clip_layer as cl
    M, N, K = 300, 768, 768
    a = _bf(dev, M, K, seed=25)
    ws = [_bf(dev, N, K, seed=26 + i, scale=K ** -0.5) for i in range(3)]
    b = torch.zeros(N, dtype=torch.bfloat16, device=dev)
    total = torch.zeros(1, dtype=torch.float32, device=dev)
    cl._gemm(a, ws, [b] * 3, [total] * 3, epilogue="probe", bn=bn)
    want = sum(float((a.float() @ w.float().T).double().sum()) for w in ws)
    scale = sum(float((a.float() @ w.float().T).abs().double().sum())
                for w in ws)
    # f32 sums of ~690k products in another order: ~1e-6 of their size
    assert abs(float(total) - want) <= 1e-5 * scale


@pytest.mark.cuda
@torch.no_grad()
def test_kernels_refuse_float32(dev):
    """A CUDA tensor of another type raises; it never takes the plain
    path."""
    from ladiff_torch.ops.clip_layer import fused_proj_mlp
    from ladiff_torch.models.clip_text import CLIPTextLayer
    layer = CLIPTextLayer(128, 2).to(dev)
    x = torch.randn(8, 128, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_proj_mlp(x, x, layer.mlp_params())


@pytest.mark.cuda
def test_default_system_generates_on_the_gpu(dev):
    """The entry point's defaults (device "cuda", bfloat16) run together:
    generation goes through K1 and K2 and gives finite features with the
    padded frames zero."""
    from ladiff_torch.models.ladiff import LADiffSystem
    from ladiff_torch.ops import cuda_common as cc
    system = LADiffSystem(nfeats=263, njoints=22)
    assert system.device.type == "cuda"
    assert system.vae.final_layer.weight.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(8)
    text = torch.randn(2, 1, 768, generator=g)
    cc.reset_launch_counts()
    feats, z = system.generate(
        text, torch.zeros_like(text), torch.tensor([40, 196]),
        generator=torch.Generator(device=dev).manual_seed(0),
        num_inference_timesteps=3)
    counts = cc.launch_counts()
    assert counts["fused_md_layer"] == 3 * 9
    assert counts["fused_decoder_layer"] == 9
    assert feats.shape == (2, 196, 263) and z.shape == (2, 5, 256)
    assert bool(torch.isfinite(feats).all())
    assert not bool(feats[0, 40:].any())
    assert system.feats2joints(feats).shape == (2, 196, 22, 3)


# -- the inference FFN tail and the training kernels -------------------------

def _ffn_params(dev, D=256, Fd=1024, seed=9):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    p = {"ln1_w": 1 + 0.1 * r(D), "ln1_b": 0.05 * r(D),
         "w1": r(Fd, D) / math.sqrt(D), "b1": 0.05 * r(Fd),
         "w2": r(D, Fd) / math.sqrt(Fd), "b2": 0.05 * r(D),
         "ln2_w": 1 + 0.1 * r(D), "ln2_b": 0.05 * r(D)}
    return {k: v.to(dev, torch.bfloat16) for k, v in p.items()}


def _attn_params(dev, D=256, seed=10):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    p = {"in_w": r(3 * D, D) / math.sqrt(D), "in_b": 0.05 * r(3 * D),
         "out_w": r(D, D) / math.sqrt(D), "out_b": 0.05 * r(D)}
    return {k: v.to(dev, torch.bfloat16) for k, v in p.items()}


def _bf(dev, *shape, seed=11, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@torch.no_grad()
def test_postnorm_ffn_kernel(dev, activation):
    from ladiff_torch.ops.postnorm_ffn import (fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    p = _ffn_params(dev)
    x = _bf(dev, 5 * 206 + 3, 256)  # a partial last row block
    got = fused_postnorm_ffn(x, p, activation=activation)
    want = postnorm_ffn_plain(x.float(), _f32(p), activation=activation)
    assert _relerr(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("S", [206, 64, 100])
@torch.no_grad()
def test_masked_attention_kernel(dev, S, masked):
    """Kernel 10 at the encoder stream's 206 tokens (a partial last tile),
    at one whole tile and at 100; masked keys, a sample with one valid key,
    and no mask at all."""
    from ladiff_torch.ops.attention import masked_attention
    from ladiff_torch.ops.attention_kernel import (fused_masked_attention,
                                                   masked_attention_plain)
    D, H = 256, 4
    lengths = [S, 16, S // 2, 1, S - 3]
    B = len(lengths)
    q, k, v = (_bf(dev, B, S, D, seed=20 + i) for i in range(3))
    valid = _mask(lengths, S, dev) > 0.5 if masked else None
    got = fused_masked_attention(q, k, v, valid, num_heads=H)
    want = masked_attention_plain(q.float(), k.float(), v.float(), valid,
                                  num_heads=H)
    assert _relerr(got, want) <= TOL
    # the dispatch sends this shape to the kernel
    assert torch.equal(masked_attention(q, k, v, valid, num_heads=H), got)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_masked_attention(q.float(), k.float(), v.float(), valid,
                               num_heads=H)
    with pytest.raises(ValueError, match="unsupported"):
        fused_masked_attention(q, k[:, :-1], v[:, :-1], valid, num_heads=H)


def _stream_mask(B, S, dev):
    """Key validity with wholly masked 64-key tiles and keys that are not a
    prefix: sample 0 has no valid key (it attends uniformly), sample 1 the
    encoder stream's layout (2 + 2 of 10 distribution tokens, then 11
    frames), sample 2 one key in the last tile only, the rest all valid."""
    v = torch.ones(B, S)
    v[0] = 0
    v[1] = 0
    v[1, [0, 1, 5, 6]] = 1
    v[1, 10:21] = 1
    v[2] = 0
    v[2, S - 1] = 1
    return v.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [16, 48, 64, 112, 128])
@torch.no_grad()
def test_masked_attention_kernel_skips_masked_tiles(dev, Dh):
    """Kernel 10 at every head width class it takes: whole masked key tiles
    skipped, a sample with no valid key attending uniformly, each sample
    held to the plain version on its own."""
    from ladiff_torch.ops.attention_kernel import (fused_masked_attention,
                                                   masked_attention_plain)
    B, S, H = 4, 206, 2
    D = H * Dh
    q, k, v = (_bf(dev, B, S, D, seed=40 + i) for i in range(3))
    valid = _stream_mask(B, S, dev) > 0.5
    got = fused_masked_attention(q, k, v, valid, num_heads=H)
    want = masked_attention_plain(q.float(), k.float(), v.float(), valid,
                                  num_heads=H)
    for b in range(B):
        assert _relerr(got[b], want[b]) <= TOL, b
    # sample 0: every row is the mean of its values
    mean = v[0].float().mean(0, keepdim=True).expand(S, D)
    assert _relerr(got[0], mean) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,H", [(256, 16), (256, 8), (192, 4), (256, 4),
                                 (128, 4), (64, 4)])
@torch.no_grad()
def test_train_attention_kernels_skip_masked_tiles(dev, rate, D, H):
    """Kernel 8's flash tiles at head widths 16, 32, 48 and 64 with wholly
    masked key tiles and a sample with no valid key, forward and every
    gradient."""
    from ladiff_torch.ops.train_attention import (
        ATTN_PARAM_ORDER, train_self_attention_bwd,
        train_self_attention_bwd_plain, train_self_attention_fwd,
        train_self_attention_masks, train_self_attention_plain)
    B, S, seed = 4, 150, 97531
    M = B * S
    p = _attn_params(dev, D)
    x, dout = _bf(dev, M, D, seed=44), _bf(dev, M, D, seed=45, scale=0.1)
    kvalid = _stream_mask(B, S, dev).reshape(-1).contiguous()
    masks = (train_self_attention_masks(B, S, D, H, rate, seed, dev)
             if rate else None)
    kw = dict(H=H, S=S, rate=rate, seed=seed)
    got, saved = train_self_attention_fwd(x, kvalid, p, return_saved=True,
                                          **kw)
    assert _relerr(got, train_self_attention_plain(
        x.float(), kvalid, _f32(p), masks, H=H, S=S)) <= TOL
    dx, grads = train_self_attention_bwd(x, kvalid, dout, p, saved, **kw)
    wdx, wgrads = train_self_attention_bwd_plain(
        x.float(), kvalid, dout.float(), _f32(p), masks, H=H, S=S)
    assert _relerr(dx, wdx) <= TOL
    for k in ATTN_PARAM_ORDER:
        assert _relerr(grads[k], wgrads[k]) <= TOL, k


@pytest.mark.cuda
def test_inference_kernels_refuse_a_required_gradient(dev):
    """The inference kernels have no backward: with autograd recording and a
    weight or input that requires a gradient every one of them raises.  An
    eval-mode layer in that situation takes its training route instead."""
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops.attention_kernel import fused_masked_attention
    from ladiff_torch.ops.clip_layer import fused_ln_qkv, fused_proj_mlp
    from ladiff_torch.ops.decoder_layer import fused_decoder_layer
    from ladiff_torch.ops.md_layer import fused_md_layer
    from ladiff_torch.ops.postnorm_ffn import fused_postnorm_ffn
    from ladiff_torch.ops.stylization import MDTransformerLayer
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    bf = torch.bfloat16
    p = _ffn_params(dev)
    x = _bf(dev, 64, 256)
    p["w1"].requires_grad_()
    layer = TransformerDecoderLayer(256, 4, 1024, "gelu").to(dev, bf).eval()
    tgt, mem = _bf(dev, 2, 40, 256), _bf(dev, 2, 5, 256)
    md = MDTransformerLayer(256, 256, 1024, 4).to(dev, bf).eval()
    lat, xf, emb = _bf(dev, 2, 5, 256), _bf(dev, 2, 1, 256), _bf(dev, 2, 256)
    cl = CLIPTextLayer(768, 12).to(dev, bf)
    xc = _bf(dev, 32, 768)
    q = _bf(dev, 2, 64, 256).requires_grad_()
    calls = {
        "fused_postnorm_ffn": lambda: fused_postnorm_ffn(x, p),
        "fused_decoder_layer": lambda: fused_decoder_layer(
            tgt.reshape(80, 256), torch.ones(80, device=dev), mem,
            torch.ones(2, 5, device=dev), layer.kernel_params(), T=40, H=4),
        "fused_md_layer": lambda: md(lat, xf, emb),
        "fused_ln_qkv": lambda: fused_ln_qkv(xc, cl.qkv_params(),
                                             scale=0.125),
        "fused_proj_mlp": lambda: fused_proj_mlp(xc, xc, cl.mlp_params()),
        "fused_masked_attention": lambda: fused_masked_attention(
            q, q, q, num_heads=4),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} is an inference"):
            call()
        with torch.no_grad():
            call()
    out = layer(tgt, mem)  # eval mode, parameters require a gradient
    out.float().sum().backward()
    assert layer.linear1.weight.grad is not None
    with torch.no_grad():
        assert _relerr(layer(tgt, mem), out.detach()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@torch.no_grad()
def test_train_ffn_kernels(dev, rate, activation):
    from ladiff_torch.ops.postnorm_ffn import FFN_PARAM_ORDER
    from ladiff_torch.ops.train_ffn import (
        train_postnorm_ffn_bwd, train_postnorm_ffn_bwd_plain,
        train_postnorm_ffn_fwd, train_postnorm_ffn_masks,
        train_postnorm_ffn_plain)
    M, D, Fd, seed = 12 * 206 + 5, 256, 1024, 1234567890123
    p = _ffn_params(dev)
    x, dout = _bf(dev, M, D, seed=12), _bf(dev, M, D, seed=13, scale=0.1)
    masks = (train_postnorm_ffn_masks(M, D, Fd, rate, seed, dev)
             if rate else None)
    kw = dict(activation=activation, rate=rate, seed=seed)
    got = train_postnorm_ffn_fwd(x, p, **kw)
    want = train_postnorm_ffn_plain(x.float(), _f32(p), masks,
                                    activation=activation)
    assert _relerr(got, want) <= TOL
    dx, grads = train_postnorm_ffn_bwd(x, dout, p, **kw)
    wdx, wgrads = train_postnorm_ffn_bwd_plain(
        x.float(), dout.float(), _f32(p), masks, activation=activation)
    tol = TOL if activation == "gelu" else TOL_RELU_GRAD
    assert _relerr(dx, wdx) <= tol
    for k in FFN_PARAM_ORDER:
        assert grads[k].dtype == torch.float32
        assert _relerr(grads[k], wgrads[k]) <= tol, k


# the FFN tail's path shapes: the MD layers' 2560 rows (kernel 5) and 640
# rows (kernel 9 in stage 2), the small slice's 20, and a row count that is
# not a multiple of the 64-row block
FFN_PATH_ROWS = [2560, 640, 20, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("rows", FFN_PATH_ROWS)
@torch.no_grad()
def test_ffn_tail_forward_on_a_cluster(dev, rows, cluster, rate):
    """Kernel 5 (at rate 0) and kernel 9's forward with ReLU, each 64-row
    block on C CTAs that split the hidden width (C 1: one CTA a block),
    against the plain version; the default geometry's result equals the
    forced one of the same C."""
    from ladiff_torch.ops.postnorm_ffn import (ffn_launch_geometry,
                                               fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn_fwd,
                                            train_postnorm_ffn_masks,
                                            train_postnorm_ffn_plain)
    D, Fd, seed = 256, 1024, 424242
    p = _ffn_params(dev)
    x = _bf(dev, rows, D, seed=rows)
    kw = dict(activation="relu", rate=rate, seed=seed)
    masks = (train_postnorm_ffn_masks(rows, D, Fd, rate, seed, dev)
             if rate else None)
    got = train_postnorm_ffn_fwd(x, p, cluster=cluster, **kw)
    want = train_postnorm_ffn_plain(x.float(), _f32(p), masks,
                                    activation="relu")
    assert _relerr(got, want) <= TOL
    if rate == 0.0:
        got5 = fused_postnorm_ffn(x, p, activation="relu", cluster=cluster)
        assert _relerr(got5, postnorm_ffn_plain(
            x.float(), _f32(p), activation="relu")) <= TOL
        assert torch.equal(got5, got)  # kernel 9 at rate 0 is kernel 5
    g = ffn_launch_geometry("train_ffn", dev, rows, D, Fd)
    if g["cluster"] == cluster:
        assert torch.equal(train_postnorm_ffn_fwd(x, p, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", FFN_PATH_ROWS)
@torch.no_grad()
def test_train_ffn_backward_at_path_rows(dev, rows, rate):
    """Kernel 9's backward with ReLU at the path's row counts: the
    gradients downstream of the ReLU's derivative (dx, ln1, w1, b1) within
    its tolerance, the others within the common one; the bias gradients
    come from the row-block launch's partials."""
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn_bwd,
                                            train_postnorm_ffn_bwd_plain,
                                            train_postnorm_ffn_masks)
    D, Fd, seed = 256, 1024, 2718281828
    p = _ffn_params(dev)
    x = _bf(dev, rows, D, seed=rows + 1)
    dout = _bf(dev, rows, D, seed=rows + 2, scale=0.1)
    masks = (train_postnorm_ffn_masks(rows, D, Fd, rate, seed, dev)
             if rate else None)
    dx, grads = train_postnorm_ffn_bwd(x, dout, p, activation="relu",
                                       rate=rate, seed=seed)
    wdx, wgrads = train_postnorm_ffn_bwd_plain(
        x.float(), dout.float(), _f32(p), masks, activation="relu")
    assert _relerr(dx, wdx) <= TOL_RELU_GRAD
    for k in ("ln1_w", "ln1_b", "w1", "b1"):
        assert _relerr(grads[k], wgrads[k]) <= TOL_RELU_GRAD, k
    for k in ("w2", "b2", "ln2_w", "ln2_b"):
        assert _relerr(grads[k], wgrads[k]) <= TOL, k


@pytest.mark.cuda
@torch.no_grad()
def test_train_ffn_backward_bits_equal_twice(dev):
    """Every sum over rows (the LayerNorm and bias partials, the split-K
    weight gradients) runs in a fixed order: two runs give the same bits."""
    from ladiff_torch.ops.train_ffn import train_postnorm_ffn_bwd
    p = _ffn_params(dev)
    x, dout = _bf(dev, 3000, 256, seed=21), _bf(dev, 3000, 256, seed=22)
    runs = [train_postnorm_ffn_bwd(x, dout, p, rate=0.1, seed=9)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for k, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [206, 196, 37])
@torch.no_grad()
def test_train_attention_kernels(dev, rate, S):
    from ladiff_torch.ops.train_attention import (
        ATTN_PARAM_ORDER, train_self_attention_bwd,
        train_self_attention_bwd_plain, train_self_attention_fwd,
        train_self_attention_masks, train_self_attention_plain)
    D, H, seed = 256, 4, -987654321012
    lengths = np.array([S, 16, S // 2, 1, S - 3])
    B = len(lengths)
    M = B * S
    p = _attn_params(dev)
    x, dout = _bf(dev, M, D, seed=14), _bf(dev, M, D, seed=15, scale=0.1)
    kvalid = _mask(lengths, S, dev).reshape(-1).contiguous()
    masks = (train_self_attention_masks(B, S, D, H, rate, seed, dev)
             if rate else None)
    kw = dict(H=H, S=S, rate=rate, seed=seed)
    got, saved = train_self_attention_fwd(x, kvalid, p, return_saved=True,
                                          **kw)
    want = train_self_attention_plain(x.float(), kvalid, _f32(p), masks,
                                      H=H, S=S)
    assert _relerr(got, want) <= TOL
    dx, grads = train_self_attention_bwd(x, kvalid, dout, p, saved, **kw)
    wdx, wgrads = train_self_attention_bwd_plain(
        x.float(), kvalid, dout.float(), _f32(p), masks, H=H, S=S)
    assert _relerr(dx, wdx) <= TOL
    for k in ATTN_PARAM_ORDER:
        assert grads[k].dtype == torch.float32
        assert _relerr(grads[k], wgrads[k]) <= TOL, k


def _gemm_inputs(dev, name, M, D, H, rate=0.1, seed=40):
    """One product of kernel 8 at M rows of width D (head width D / H): the
    operands a, w and the epilogue's tensors, as ``train_gemm_launch``
    takes them, and the plain version's extra arguments."""
    from ladiff_torch.ops.train_attention import train_self_attention_masks
    w_out, w_in = (_bf(dev, D, D, seed=seed + 1, scale=D ** -0.5),
                   _bf(dev, 3 * D, D, seed=seed + 2, scale=D ** -0.5))
    a = _bf(dev, M, 3 * D if name in ("dx", "wgrad") else D, seed=seed)
    resid = _bf(dev, M, D, seed=seed + 3)
    bias = _bf(dev, 3 * D if name == "qkv" else D, seed=seed + 4, scale=0.05)
    if name == "qkv":
        return a, w_in, {"bias": bias}, {}
    if name in ("out", "out_drop"):
        kw = {"bias": bias, "resid": resid}
        if name == "out":
            return a, w_out, kw, {}
        rm = train_self_attention_masks(M, 1, D, H, rate, seed, dev)[1]
        return a, w_out, {**kw, "rate": rate, "seed": seed}, {"rm": rm}
    if name == "dctx":
        return a, w_out, {"resid": resid, "H": H}, {}
    if name == "dx":
        return a, w_in, {"resid": resid}, {}
    return a, _bf(dev, M, D, seed=seed + 5), {}, {}  # wgrad: dqkv^T x


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qkv", "out", "out_drop", "dctx", "dx",
                                  "wgrad"])
@torch.no_grad()
def test_train_gemm_products(dev, name):
    """Each product of kernels 8 and 12 alone on the GEMM block (the
    MN-major operands, the residual, dropout, delta and split-K epilogues)
    against its float32 product, at every tile width it may take, at 618
    and 26,368 rows (ragged tiles and K ranges) and D 64, 128, 192, 256
    (head widths 16, 32, 48, 64)."""
    from ladiff_torch.ops.train_attention import (dctx_widths,
                                                  train_gemm_launch,
                                                  train_gemm_plain)
    for D, H in ((64, 4), (128, 4), (192, 4), (256, 4)):
        bns = {"qkv": (256, 192, 128), "out": (256, 128),
               "out_drop": (256, 128), "dx": (256, 128),
               "dctx": dctx_widths(D, H)}.get(name, (0,))
        for M in (618, 26368):
            a, w, kw, plain_kw = _gemm_inputs(dev, name, M, D, H)
            for bn in bns:
                got, geo = train_gemm_launch(name, a, w, bn=bn, **kw)
                want = train_gemm_plain(
                    name, a, w, ranges=geo.get("ranges"), **plain_kw,
                    **{k: v for k, v in kw.items() if k in (
                        "bias", "resid", "H")})
                if name == "dctx":
                    assert _relerr(got[1], want[1]) <= TOL, (D, M)
                    got, want = got[0], want[0]
                assert _relerr(got, want) <= TOL, (D, M, bn)


@pytest.mark.cuda
@torch.no_grad()
def test_dropout_masks_rate_and_seeds(dev):
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn_fwd,
                                            train_postnorm_ffn_masks)
    M, D, Fd = 4096, 256, 1024
    m1, m2 = train_postnorm_ffn_masks(M, D, Fd, 0.1, 7, dev)
    for m in (m1, m2):
        assert abs(float((m > 0).float().mean()) - 0.9) <= 0.005
        assert set(torch.unique(m).tolist()) == {0.0, float(
            torch.tensor(1 / 0.9, dtype=torch.float32))}
    p, x = _ffn_params(dev), _bf(dev, M, D)
    a = train_postnorm_ffn_fwd(x, p, rate=0.1, seed=7)
    b = train_postnorm_ffn_fwd(x, p, rate=0.1, seed=7)
    c = train_postnorm_ffn_fwd(x, p, rate=0.1, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.cuda
def test_seed_draws_from_a_cuda_generator_on_the_host(dev):
    """A CUDA generator gives each kernel call its own seed, the same
    sequence for the same generator seed, and moves on for torch's own
    draws; a CPU generator is refused for CUDA tensors."""
    from ladiff_torch.ops.cuda_common import draw_seed, dropout_mask

    def draws(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        first = draw_seed(g)
        between = torch.rand(8, generator=g, device=dev)
        return first, draw_seed(g), draw_seed(g), between

    a, b = draws(3), draws(3)
    assert a[:3] == b[:3] and torch.equal(a[3], b[3])
    assert len({*a[:3], *draws(4)[:3]}) == 6
    assert all(0 <= v < 2 ** 64 for v in a[:3])
    g = torch.Generator(device=dev).manual_seed(3)
    assert not torch.equal(torch.rand(8, generator=g, device=dev), a[3])
    like = torch.zeros(1, device=dev)
    with pytest.raises(RuntimeError):
        dropout_mask((4, 4), 0.1, like, torch.Generator().manual_seed(0))


@pytest.mark.cuda
def test_training_functions_backpropagate_float32_gradients(dev):
    """The autograd.Functions take float32 parameters with bf16
    activations and return float32 parameter gradients, equal to the
    backward wrapper's."""
    from ladiff_torch.ops.postnorm_ffn import FFN_PARAM_ORDER
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn,
                                            train_postnorm_ffn_bwd)
    p32 = {k: v.float().requires_grad_() for k, v in _ffn_params(dev).items()}
    x = _bf(dev, 300, 256).requires_grad_()
    dout = _bf(dev, 300, 256, seed=16)
    out = train_postnorm_ffn(x, p32, rate=0.1, seed=5)
    out.backward(dout)
    pbf = {k: v.detach().to(torch.bfloat16) for k, v in p32.items()}
    with torch.no_grad():
        dx, grads = train_postnorm_ffn_bwd(x.detach(), dout, pbf, rate=0.1,
                                           seed=5)
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, dx)
    for k in FFN_PARAM_ORDER:
        assert p32[k].grad.dtype == torch.float32
        assert torch.equal(p32[k].grad, grads[k]), k


@pytest.mark.cuda
def test_default_system_takes_a_training_step_on_the_gpu(dev):
    """The trainer's defaults (float32 parameters, bf16 compute, dropout
    0.1) run together: one AdamW step through the training kernels, then a
    validation pass through the inference kernels."""
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.trainer import vae_train_step
    system, opt = train_bench.build()
    assert system.device.type == "cuda"
    assert system.vae.final_layer.weight.dtype == torch.float32
    batch = train_bench.make_batch(4, device=system.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = system.vae.final_layer.weight.detach().clone()
    cc.reset_launch_counts()
    logs = vae_train_step(system, opt, batch, gen)
    counts = cc.launch_counts()
    for name in ("train_self_attention", "train_self_attention_bwd",
                 "train_postnorm_ffn", "train_postnorm_ffn_bwd"):
        assert counts[name] == 18, name
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    assert float(logs["grad_norm"]) > 0
    assert not torch.equal(system.vae.final_layer.weight, before)
    cc.reset_launch_counts()
    with torch.no_grad():
        total, _ = system.vae_forward(batch, train=False, generator=gen)
    counts = cc.launch_counts()
    assert counts["fused_masked_attention"] == 9
    assert counts["fused_postnorm_ffn"] == 9
    assert counts["fused_decoder_layer"] == 9
    assert bool(torch.isfinite(total))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["diffusion_train", "vae_diffusion_train"])
def test_default_system_takes_a_denoiser_step_on_the_gpu(dev, stage):
    """One AdamW step of stage 2 and of the joint stage at the trainer's
    defaults (float32 parameters, bf16 compute, dropout 0.1): the frozen
    encode through kernels 10 and 5, the MD layers through kernel 9, the
    joint stage's sampling through K1 and its decodes through kernels 8 and
    9; the frozen VAE gets no gradient in stage 2."""
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    system, opt = train_bench.build(stage=stage)
    batch = train_bench.make_batch(4, device=system.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = train_bench.make_step(system, opt, batch, stage)
    before = system.denoiser.emb_proj[1].weight.detach().clone()
    cc.reset_launch_counts()
    logs = step(gen)
    counts = cc.launch_counts()
    joint = stage == "vae_diffusion_train"
    want = {"fused_masked_attention": 9, "fused_postnorm_ffn": 9,
            "train_postnorm_ffn": 36 if joint else 9,
            "train_postnorm_ffn_bwd": 36 if joint else 9,
            "train_self_attention": 27 if joint else 0,
            "train_self_attention_bwd": 27 if joint else 0,
            "fused_md_layer": 90 if joint else 0, "fused_decoder_layer": 0}
    for name, n in want.items():
        assert counts[name] == n, name
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    assert float(logs["grad_norm"]) > 0
    assert not torch.equal(system.denoiser.emb_proj[1].weight, before)
    if not joint:
        assert all(p.grad is None for p in system.vae.parameters())
        cc.reset_launch_counts()
        with torch.no_grad():
            total, _ = system.diffusion_forward(
                batch, torch.zeros(1, 1, 768, device=dev), train=False,
                generator=gen)
        assert cc.launch_counts()["fused_md_layer"] == 9
        assert bool(torch.isfinite(total))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["last", "full"])
@torch.no_grad()
def test_ar_generate_on_the_gpu(dev, mode):
    """Autoregressive generation at batch 4 (lengths 16 / 60 / 123 / 196,
    3 DDIM steps) in bf16 against the float32 plain run on the card, from
    the same weights and the same token noise: K1 at T = 2 ("last") or 6
    ("full") stream rows, 5 tokens x 3 steps x 9 layers, then K2 x 9; the
    rows past each sample's tokens exactly zero."""
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    kw = dict(ardiff=True, motion_conditioning=mode, dropout=0.0)
    ref = _randomize(train_bench.build(dev, dtype=torch.float32, **kw)[0],
                     7)
    system = train_bench.build(dev, **kw)[0]
    system.load_state_dict(ref.state_dict(), strict=True)
    g = torch.Generator().manual_seed(8)
    cond = torch.randn(4, 1, 768, generator=g).to(dev)
    uncond = 0.1 * torch.randn(4, 1, 768, generator=g).to(dev)
    lengths = torch.tensor([16, 60, 123, 196], device=dev)
    run = lambda s: s.generate(
        cond, uncond, lengths, num_inference_timesteps=3,
        generator=torch.Generator(dev).manual_seed(9))
    want_f, want_z = run(ref)
    cc.reset_launch_counts()
    feats, z = run(system)
    counts = cc.launch_counts()
    assert counts["fused_md_layer"] == 5 * 3 * 9
    assert counts["fused_decoder_layer"] == 9
    assert _relerr(z.float(), want_z) <= 1e-1
    assert _relerr(feats.float(), want_f) <= 1e-1
    assert not z[0, 1:].any() and not z[1, 2:].any()


@pytest.mark.cuda
def test_distill_step_on_the_gpu(dev):
    """One ``distill_train_step`` at batch 4 at the trainer's defaults
    (float32 parameters, bf16 compute, dropout 0.1), grid 25: the frozen
    encode through kernels 10 and 5, the teacher's two guided calls through
    K1, the student through kernel 9; the student moves, the teacher and
    the VAE stay."""
    import copy

    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.trainer import distill_train_step
    system, opt = train_bench.build(stage="diffusion_train")
    teacher = copy.deepcopy(system.denoiser).requires_grad_(False)
    batch = train_bench.make_batch(4, device=system.device)
    before = {k: v.clone() for k, v in system.state_dict().items()}
    cc.reset_launch_counts()
    logs = distill_train_step(system, teacher, opt, batch,
                              torch.zeros(1, 1, 768, device=dev), 25,
                              torch.Generator(device=dev).manual_seed(0))
    counts = cc.launch_counts()
    want = {"fused_masked_attention": 9, "fused_postnorm_ffn": 9,
            "fused_md_layer": 18, "train_postnorm_ffn": 9,
            "train_postnorm_ffn_bwd": 9, "train_self_attention": 0}
    for name, n in want.items():
        assert counts[name] == n, name
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    after = system.state_dict()
    assert any(not torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("denoiser."))
    assert all(torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("vae."))
    assert all(torch.equal(v, before["denoiser." + k])
               for k, v in teacher.state_dict().items())


# -- no kernel reads outside its inputs --------------------------------------

def _at_end(t):
    """A copy of ``t`` that ends exactly where its own large device
    allocation ends, so that a read past the tensor's end faults instead of
    landing in a neighbour."""
    nbytes = t.numel() * t.element_size()
    assert nbytes % 32 == 0  # keeps the copy 32-byte aligned
    arena = torch.empty(64 << 20, dtype=torch.uint8, device=t.device)
    view = arena[arena.numel() - nbytes:].view(t.dtype).reshape(t.shape)
    view.copy_(t)
    return view


def _guarded_calls(fn, tensors, params=None):
    """Calls ``fn(tensors, params)`` once per input, that input moved to the
    end of an allocation; a fault surfaces at the synchronize."""
    for i in range(len(tensors)):
        moved = list(tensors)
        moved[i] = _at_end(tensors[i])
        fn(moved, params)
        torch.cuda.synchronize()
    for k in (params or {}):
        moved = dict(params)
        moved[k] = _at_end(params[k])
        fn(list(tensors), moved)
        torch.cuda.synchronize()


@pytest.mark.cuda
@torch.no_grad()
def test_kernels_read_inside_their_inputs(dev):
    """Row counts that leave a partial last block, D 128 and 256 (the
    LayerNorm helpers unroll past D / 32), every input and parameter in turn
    at the end of its allocation, the memory rows of kernel 13 too."""
    from ladiff_torch.models.clip_text import CLIPTextLayer
    from ladiff_torch.ops.attention_kernel import fused_masked_attention
    from ladiff_torch.ops.clip_layer import fused_ln_qkv, fused_proj_mlp
    from ladiff_torch.ops.decoder_layer import fused_decoder_layer
    from ladiff_torch.ops.md_layer import fused_md_layer
    from ladiff_torch.ops.postnorm_ffn import fused_postnorm_ffn
    from ladiff_torch.ops.stylization import MDTransformerLayer
    from ladiff_torch.ops.train_attention import (train_self_attention_bwd,
                                                  train_self_attention_fwd)
    from ladiff_torch.ops.train_decoder_layer import (
        train_decoder_layer_bwd, train_decoder_layer_fwd)
    from ladiff_torch.ops.train_ffn import (train_postnorm_ffn_bwd,
                                            train_postnorm_ffn_fwd)
    from ladiff_torch.ops.train_layer import (train_encoder_layer_bwd,
                                              train_encoder_layer_fwd)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    bf = torch.bfloat16
    for D, H in ((256, 4), (128, 2)):
        B, S, Fd = 3, 48, 512
        M = B * S  # 144 rows: 4 whole row blocks and 16 rows
        pf, pa = _ffn_params(dev, D, Fd), _attn_params(dev, D)
        x, dout = _bf(dev, M, D), _bf(dev, M, D, seed=17)
        kvalid = _mask([S, 20, 1], S, dev).reshape(-1).contiguous()
        for C in (1, 2, 4):  # one CTA a block, and clusters
            _guarded_calls(lambda t, p: fused_postnorm_ffn(
                t[0], p, cluster=C), [x], pf)
            _guarded_calls(lambda t, p: train_postnorm_ffn_fwd(
                t[0], p, rate=0.1, seed=3, cluster=C), [x], pf)
        _guarded_calls(lambda t, p: train_postnorm_ffn_bwd(
            t[0], t[1], p, rate=0.1, seed=3), [x, dout], pf)
        _guarded_calls(lambda t, p: train_self_attention_fwd(
            t[0], t[1], p, H=H, S=S, rate=0.1, seed=3), [x, kvalid], pa)
        _, saved = train_self_attention_fwd(x, kvalid, pa, H=H, S=S,
                                            rate=0.1, seed=3,
                                            return_saved=True)
        _guarded_calls(lambda t, p: train_self_attention_bwd(
            t[0], t[1], t[2], p, tuple(t[3:]), H=H, S=S, rate=0.1, seed=3),
            [x, kvalid, dout, *saved], pa)
        # kernel 12; kernel 13 at 8 x 37 rows (a partial last row block,
        # and a 32-byte multiple for mvalid) with 5 memory rows per sample
        pe = {**pa, **pf}
        _guarded_calls(lambda t, p: train_encoder_layer_fwd(
            t[0], t[1], p, H=H, S=S, rate=0.1, seed=3), [x, kvalid], pe)
        _, saved = train_encoder_layer_fwd(x, kvalid, pe, H=H, S=S, rate=0.1,
                                           seed=3, return_saved=True)
        _guarded_calls(lambda t, p: train_encoder_layer_bwd(
            t[0], t[1], t[2], p, tuple(t[3:]), H=H, S=S, rate=0.1, seed=3),
            [x, kvalid, dout, *saved], pe)
        pdl = _randomize(TransformerDecoderLayer(D, H, Fd, "gelu"), 5).to(
            dev, bf)
        pd = {k: v.detach() for k, v in pdl.kernel_params().items()}
        Bd, Sd = 8, 37
        xd, doutd = _bf(dev, Bd * Sd, D), _bf(dev, Bd * Sd, D, seed=17)
        kvd = _mask([Sd, 20, 1, 36, 5, Sd, 9, 30], Sd, dev).reshape(-1)
        mem = _bf(dev, Bd, 5, D, seed=19)
        mvalid = _mask([5, 2, 1, 3, 4, 5, 1, 2], 5, dev).contiguous()
        _guarded_calls(lambda t, p: train_decoder_layer_fwd(
            *t, p, H=H, S=Sd, rate=0.1, seed=3),
            [xd, kvd.contiguous(), mem, mvalid], pd)
        _, saved = train_decoder_layer_fwd(xd, kvd.contiguous(), mem, mvalid,
                                           pd, H=H, S=Sd, rate=0.1, seed=3,
                                           return_saved=True)
        _guarded_calls(lambda t, p: train_decoder_layer_bwd(
            *t[:5], p, tuple(t[5:]), H=H, S=Sd, rate=0.1, seed=3),
            [xd, kvd.contiguous(), mem, mvalid, doutd, *saved], pd)
        # kernel 13 at 3 x 40 rows: a 64-row block holds three samples, the
        # second block is partial; 8 memory rows
        xd, doutd = _bf(dev, 3 * 40, D), _bf(dev, 3 * 40, D, seed=17)
        kvd = _mask([40, 23, 7], 40, dev).reshape(-1).contiguous()
        mem = _bf(dev, 3, 8, D, seed=19)
        mvalid = _mask([1, 8, 5], 8, dev).contiguous()
        _guarded_calls(lambda t, p: train_decoder_layer_fwd(
            *t, p, H=H, S=40, rate=0.1, seed=3), [xd, kvd, mem, mvalid], pd)
        _, saved = train_decoder_layer_fwd(xd, kvd, mem, mvalid, pd, H=H,
                                           S=40, rate=0.1, seed=3,
                                           return_saved=True)
        _guarded_calls(lambda t, p: train_decoder_layer_bwd(
            *t[:5], p, tuple(t[5:]), H=H, S=40, rate=0.1, seed=3),
            [xd, kvd, mem, mvalid, doutd, *saved], pd)
        # kernel 10: 70 tokens, so the last 64-row tile holds 6 rows
        S10 = 70
        qkv = [_bf(dev, B, S10, D, seed=30 + i) for i in range(3)]
        kv10 = _mask([S10, 20, 1], S10, dev) > 0.5  # the wrapper copies it
        _guarded_calls(lambda t, p: fused_masked_attention(
            *t, kv10, num_heads=H), qkv)
        # the flash tiles' masked-tile and no-valid-key paths: kernels 10,
        # 8 and 12 at 152 tokens (the 64-row tails' partial last block;
        # kvalid's bytes a multiple of 32, as _at_end needs)
        S2 = 152
        kv2 = _stream_mask(B, S2, dev).reshape(-1).contiguous()
        x2, dout2 = _bf(dev, B * S2, D), _bf(dev, B * S2, D, seed=17)
        qkv = [_bf(dev, B, S2, D, seed=33 + i) for i in range(3)]
        _guarded_calls(lambda t, p: fused_masked_attention(
            *t, kv2.reshape(B, S2) > 0.5, num_heads=H), qkv)
        _, saved = train_self_attention_fwd(x2, kv2, pa, H=H, S=S2,
                                            rate=0.1, seed=3,
                                            return_saved=True)
        _guarded_calls(lambda t, p: train_self_attention_bwd(
            t[0], t[1], t[2], p, tuple(t[3:]), H=H, S=S2, rate=0.1, seed=3),
            [x2, kv2, dout2, *saved], pa)
        _guarded_calls(lambda t, p: train_encoder_layer_fwd(
            t[0], t[1], p, H=H, S=S2, rate=0.1, seed=3), [x2, kv2], pe)
        _, saved = train_encoder_layer_fwd(x2, kv2, pe, H=H, S=S2, rate=0.1,
                                           seed=3, return_saved=True)
        _guarded_calls(lambda t, p: train_encoder_layer_bwd(
            t[0], t[1], t[2], p, tuple(t[3:]), H=H, S=S2, rate=0.1, seed=3),
            [x2, kv2, dout2, *saved], pe)
    # kernel 8 at D 192 and 64 (head widths 48 and 16): 3 x 40 rows, a
    # partial 128-row tile of each product and K range
    for D, H in ((192, 4), (64, 4)):
        B, S = 3, 40
        pa = _attn_params(dev, D)
        x, dout = _bf(dev, B * S, D), _bf(dev, B * S, D, seed=17)
        kvalid = _mask([S, 20, 1], S, dev).reshape(-1).contiguous()
        _guarded_calls(lambda t, p: train_self_attention_fwd(
            t[0], t[1], p, H=H, S=S, rate=0.1, seed=3), [x, kvalid], pa)
        _, saved = train_self_attention_fwd(x, kvalid, pa, H=H, S=S,
                                            rate=0.1, seed=3,
                                            return_saved=True)
        _guarded_calls(lambda t, p: train_self_attention_bwd(
            t[0], t[1], t[2], p, tuple(t[3:]), H=H, S=S, rate=0.1, seed=3),
            [x, kvalid, dout, *saved], pa)
    # K2 at 7 x 40 rows (its 64-row blocks: the last one partial) and 8
    # memory rows; K1..K4 share the LayerNorm helper
    D, H, T, L = 256, 4, 40, 8
    dl = _randomize(TransformerDecoderLayer(D, H, 1024, "gelu"), 4).to(dev, bf)
    lens = [T, 9, 1, 33, T, 17, 25]
    args = [_bf(dev, 7 * T, D), _mask(lens, T, dev).reshape(-1).contiguous(),
            _bf(dev, 7, L, D),
            _mask([5, 1, 8, 4, 5, 2, 3], L, dev).contiguous()]
    _guarded_calls(lambda t, p: fused_decoder_layer(*t, p, T=T, H=H), args,
                   {k: v.detach() for k, v in dl.kernel_params().items()})
    md = _randomize(MDTransformerLayer(D, D, 1024, H), 1).to(dev, bf)
    Bm, Tm, E = 8, 5, 2
    args = [_bf(dev, Bm * Tm, D), _bf(dev, Bm * E, D),
            torch.ones(Bm * Tm, device=dev), _bf(dev, Bm, D),
            0.3 * _bf(dev, 1, 2 * D), 0.3 * _bf(dev, 1, 2 * D)]
    _guarded_calls(lambda t, p: fused_md_layer(*t, p, T=Tm, E=E, H=H), args,
                   {k: v.detach() for k, v in md.kernel_params().items()})
    cl = _randomize(CLIPTextLayer(768, 12), 6).to(dev, bf)
    xc, ac = _bf(dev, 48, 768), _bf(dev, 48, 768, seed=18)
    _guarded_calls(lambda t, p: fused_ln_qkv(t[0], p, scale=0.125), [xc],
                   {k: v.detach() for k, v in cl.qkv_params().items()})
    _guarded_calls(lambda t, p: fused_proj_mlp(t[0], t[1], p), [ac, xc],
                   {k: v.detach() for k, v in cl.mlp_params().items()})


# -- the whole-layer training kernels 12 and 13 -----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B", [5, 1])
@torch.no_grad()
def test_whole_layer_kernels(dev, rate, B):
    """Kernels 12 (206 encoder rows per sample) and 13 (196 frames, 5
    memory rows of which 1 to 5 are valid) against their plain versions,
    forward and every gradient, the memory's too; B 1 leaves a partial row
    block."""
    from ladiff_torch.ops.train_decoder_layer import (
        DEC_PARAM_ORDER, train_decoder_layer_bwd,
        train_decoder_layer_bwd_plain, train_decoder_layer_fwd,
        train_decoder_layer_masks, train_decoder_layer_plain)
    from ladiff_torch.ops.train_layer import (
        ENC_PARAM_ORDER, train_encoder_layer_bwd,
        train_encoder_layer_bwd_plain, train_encoder_layer_fwd,
        train_encoder_layer_masks, train_encoder_layer_plain)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    D, H, Fd, L, seed = 256, 4, 1024, 5, 24681357
    lengths = np.array([196, 16, 99, 1, 193])[:B]
    pe = {**_attn_params(dev), **_ffn_params(dev)}
    pd = {k: v.detach() for k, v in _randomize(TransformerDecoderLayer(
        D, H, Fd, "gelu"), 7).to(dev, torch.bfloat16).kernel_params().items()}
    for S in (206, 196):
        M = B * S
        x, dout = _bf(dev, M, D, seed=20), _bf(dev, M, D, seed=21, scale=0.1)
        kvalid = _mask(np.minimum(lengths + (S - 196), S), S,
                       dev).reshape(-1).contiguous()
        kw = dict(H=H, S=S, rate=rate, seed=seed)
        if S == 206:
            masks = (train_encoder_layer_masks(B, S, D, H, Fd, rate, seed,
                                               dev) if rate else None)
            got, saved = train_encoder_layer_fwd(x, kvalid, pe,
                                                 return_saved=True, **kw)
            want = train_encoder_layer_plain(x.float(), kvalid, _f32(pe),
                                             masks, H=H, S=S)
            dx, grads = train_encoder_layer_bwd(x, kvalid, dout, pe, saved,
                                                **kw)
            wdx, wgrads = train_encoder_layer_bwd_plain(
                x.float(), kvalid, dout.float(), _f32(pe), masks, H=H, S=S)
            names = ENC_PARAM_ORDER
        else:
            mem = _bf(dev, B, L, D, seed=22)
            mvalid = _mask(np.array([5, 1, 3, 2, 4])[:B], L, dev).contiguous()
            masks = (train_decoder_layer_masks(B, S, L, D, H, Fd, rate, seed,
                                               dev) if rate else None)
            got, saved = train_decoder_layer_fwd(x, kvalid, mem, mvalid, pd,
                                                 return_saved=True, **kw)
            want = train_decoder_layer_plain(x.float(), kvalid, mem.float(),
                                             mvalid, _f32(pd), masks, H=H,
                                             S=S)
            dx, dmem, grads = train_decoder_layer_bwd(
                x, kvalid, mem, mvalid, dout, pd, saved, **kw)
            wdx, wdmem, wgrads = train_decoder_layer_bwd_plain(
                x.float(), kvalid, mem.float(), mvalid, dout.float(),
                _f32(pd), masks, H=H, S=S)
            assert _relerr(dmem, wdmem) <= TOL
            names = DEC_PARAM_ORDER
        assert _relerr(got, want) <= TOL, S
        assert _relerr(dx, wdx) <= TOL, S
        for k in names:
            assert grads[k].dtype == torch.float32
            assert _relerr(grads[k], wgrads[k]) <= TOL, (S, k)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,H", [(64, 2), (128, 2), (192, 4)])
@torch.no_grad()
def test_whole_layer_encoder_kernel_widths(dev, rate, D, H):
    """Kernel 12's 64-row tails at the widths below 256 it takes (each its
    own instantiation), 150 tokens with masked key tiles and a sample with
    no valid key, 600 rows (a partial last block), forward and every
    gradient."""
    from ladiff_torch.ops.train_layer import (
        ENC_PARAM_ORDER, train_encoder_layer_bwd,
        train_encoder_layer_bwd_plain, train_encoder_layer_fwd,
        train_encoder_layer_masks, train_encoder_layer_plain)
    B, S, Fd, seed = 4, 150, 256, 1357
    M = B * S
    pe = {**_attn_params(dev, D), **_ffn_params(dev, D, Fd)}
    x, dout = _bf(dev, M, D, seed=46), _bf(dev, M, D, seed=47, scale=0.1)
    kvalid = _stream_mask(B, S, dev).reshape(-1).contiguous()
    masks = (train_encoder_layer_masks(B, S, D, H, Fd, rate, seed, dev)
             if rate else None)
    kw = dict(H=H, S=S, rate=rate, seed=seed)
    got, saved = train_encoder_layer_fwd(x, kvalid, pe, return_saved=True,
                                         **kw)
    assert _relerr(got, train_encoder_layer_plain(
        x.float(), kvalid, _f32(pe), masks, H=H, S=S)) <= TOL
    dx, grads = train_encoder_layer_bwd(x, kvalid, dout, pe, saved, **kw)
    wdx, wgrads = train_encoder_layer_bwd_plain(
        x.float(), kvalid, dout.float(), _f32(pe), masks, H=H, S=S)
    assert _relerr(dx, wdx) <= TOL
    for k in ENC_PARAM_ORDER:
        assert _relerr(grads[k], wgrads[k]) <= TOL, k


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,H", [(64, 2), (128, 2), (192, 4)])
@torch.no_grad()
def test_whole_layer_decoder_kernel_widths(dev, rate, D, H):
    """Kernel 13's 64-row tails and projections at the widths below 256 it
    takes (each its own instantiation), 3 x 40 frames (a row block holds
    three samples, the last block partial), 5 memory rows of which one
    sample sees 1, forward and every gradient, the memory's too."""
    from ladiff_torch.ops.train_decoder_layer import (
        DEC_PARAM_ORDER, train_decoder_layer_bwd,
        train_decoder_layer_bwd_plain, train_decoder_layer_fwd,
        train_decoder_layer_masks, train_decoder_layer_plain)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    B, T, L, Fd, seed = 3, 40, 5, 256, 2468
    pd = {k: v.detach() for k, v in _randomize(TransformerDecoderLayer(
        D, H, Fd, "gelu"), 8).to(dev, torch.bfloat16).kernel_params().items()}
    x, dout = _bf(dev, B * T, D, seed=48), _bf(dev, B * T, D, seed=49,
                                               scale=0.1)
    mem = _bf(dev, B, L, D, seed=50)
    kvalid = _mask([40, 23, 7], T, dev).reshape(-1).contiguous()
    mvalid = _mask([5, 1, 3], L, dev).contiguous()
    masks = (train_decoder_layer_masks(B, T, L, D, H, Fd, rate, seed, dev)
             if rate else None)
    kw = dict(H=H, S=T, rate=rate, seed=seed)
    got, saved = train_decoder_layer_fwd(x, kvalid, mem, mvalid, pd,
                                         return_saved=True, **kw)
    assert _relerr(got, train_decoder_layer_plain(
        x.float(), kvalid, mem.float(), mvalid, _f32(pd), masks, H=H,
        S=T)) <= TOL
    dx, dmem, grads = train_decoder_layer_bwd(x, kvalid, mem, mvalid, dout,
                                              pd, saved, **kw)
    wdx, wdmem, wgrads = train_decoder_layer_bwd_plain(
        x.float(), kvalid, mem.float(), mvalid, dout.float(), _f32(pd), masks,
        H=H, S=T)
    assert _relerr(dx, wdx) <= TOL
    assert _relerr(dmem, wdmem) <= TOL
    for k in DEC_PARAM_ORDER:
        assert _relerr(grads[k], wgrads[k]) <= TOL, k


@pytest.mark.cuda
def test_published_config_trains_in_float32_on_the_gpu(dev):
    """``configs/config_vae_humanml3d.yaml`` as shipped (float32 compute):
    a training step on the card through the plain routes, no kernel
    launched, its loss on one batch within 1e-3 of the CPU's on the same
    weights and latent noise."""
    import os
    import types

    from ladiff_torch import train_bench
    from ladiff_torch.config import assemble_config
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.loop import build_system
    from ladiff_torch.training.trainer import make_optimizer, vae_train_step
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = assemble_config(
        os.path.join(repo, "configs", "config_vae_humanml3d.yaml"),
        os.path.join(repo, "configs", "assets.yaml"))
    assert not cfg.TRAIN.MIXED_PRECISION
    dm = types.SimpleNamespace(nfeats=263, njoints=22,
                               mean=np.zeros(263, np.float32),
                               std=np.ones(263, np.float32))
    gpu = build_system(cfg, dm, device=dev)
    cpu = build_system(cfg, dm, device="cpu")
    assert gpu.dtype == torch.float32
    batch = train_bench.make_batch(4)
    eps = torch.randn(4, gpu.max_it, gpu.latent_dim[-1],
                      generator=torch.Generator().manual_seed(3))
    cc.reset_launch_counts()
    with torch.no_grad():
        got, _ = gpu.vae_forward({k: v.to(dev) for k, v in batch.items()},
                                 train=False, eps=eps.to(dev))
        want, _ = cpu.vae_forward(batch, train=False, eps=eps)
    assert abs(float(got) - float(want)) <= 1e-3 * abs(float(want))
    logs = vae_train_step(gpu, make_optimizer(gpu.vae.parameters()),
                          {k: v.to(dev) for k, v in batch.items()})
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    assert not any(cc.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["1", "enc", "dec"])
def test_whole_layer_route_launches_on_the_gpu(dev, route):
    """One AdamW step of the published VAE at batch 4 on the whole-layer
    route: kernel 12 in each encoder layer, kernel 13 in each decoder
    layer where the option names their stack, kernels 8 and 9 in the
    others; the parameters move and the logs are finite."""
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.trainer import vae_train_step
    system, opt = train_bench.build(train_whole_layer=route)
    batch = train_bench.make_batch(4, device=system.device)
    before = system.vae.final_layer.weight.detach().clone()
    cc.reset_launch_counts()
    logs = vae_train_step(system, opt, batch,
                          torch.Generator(device=dev).manual_seed(0))
    counts = cc.launch_counts()
    enc, dec = route in ("1", "enc"), route in ("1", "dec")
    split = 9 * ((not enc) + (not dec))
    for name, n in (("train_encoder_layer", 9 * enc),
                    ("train_encoder_layer_bwd", 9 * enc),
                    ("train_decoder_layer", 9 * dec),
                    ("train_decoder_layer_bwd", 9 * dec),
                    ("train_self_attention", split),
                    ("train_self_attention_bwd", split),
                    ("train_postnorm_ffn", split),
                    ("train_postnorm_ffn_bwd", split)):
        assert counts[name] == n, name
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    assert not torch.equal(system.vae.final_layer.weight, before)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("case", ["head_width_128", "d512_ff2048"])
def test_gated_vae_steps_without_the_refused_kernels(dev, case, dropout):
    """A VAE whose training shapes kernel 8 (head width 128), or kernels 8
    and 9 (d 512, ff 2048), do not take runs a step through the plain
    parts: no launch of those kernels, nor of 12 and 13 on the whole-layer
    route, nor of kernel 10 (no backward) for the plain attention at
    dropout 0."""
    from ladiff_torch import train_bench
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.trainer import vae_train_step
    kw = ({"num_heads": 2} if case == "head_width_128" else
          {"latent_dim": (7, 512), "ff_size": 2048, "num_heads": 8})
    system, opt = train_bench.build(train_whole_layer="1", dropout=dropout,
                                    **kw)
    batch = train_bench.make_batch(4, device=system.device)
    cc.reset_launch_counts()
    logs = vae_train_step(system, opt, batch,
                          torch.Generator(device=dev).manual_seed(0))
    counts = cc.launch_counts()
    tail = 18 if case == "head_width_128" else 0
    assert counts["train_self_attention"] == 0
    assert counts["train_postnorm_ffn"] == counts["train_postnorm_ffn_bwd"] \
        == tail
    assert counts["train_encoder_layer"] == counts["train_decoder_layer"] == 0
    assert counts["fused_masked_attention"] == 0
    assert all(bool(torch.isfinite(v)) for v in logs.values())


# -- generation's other routes: kernels 11, 6 and 7 --------------------------

def _route_setup(dev, D=256, H=4, L=5, B=37, T=5, seed=21):
    """A randomized MD layer and skip stack, bf16, and their inputs: B
    samples (a partial last sample block) with mixed lengths."""
    from ladiff_torch.ops.stylization import (MDSkipTransformerEncoder,
                                              MDTransformerLayer)
    bf = torch.bfloat16
    enc = _randomize(MDSkipTransformerEncoder(D, D, H, L, 1024), seed).to(
        dev, bf)
    layer = _randomize(MDTransformerLayer(D, D, 1024, H), seed + 1).to(
        dev, bf)
    kvalid = _mask(np.random.RandomState(seed).randint(1, T + 1, B), T,
                   dev).reshape(-1).contiguous()
    f, cp = layer.ffn, layer.ca_block.proj_out
    w6 = [t.detach() for t in (f.linear1.weight, f.linear1.bias,
                               f.linear2.weight, f.linear2.bias,
                               f.proj_out.norm.weight, f.proj_out.norm.bias,
                               f.proj_out.out_layers[2].weight,
                               f.proj_out.out_layers[2].bias)]
    w7 = [t.detach() for t in (cp.norm.weight, cp.norm.bias,
                               cp.out_layers[2].weight,
                               cp.out_layers[2].bias)]
    return enc, layer, kvalid, w6, w7


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 13, 512])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("masked", [True, False])
@torch.no_grad()
def test_md_stack_kernel(dev, masked, T, B):
    """Kernel 11 over a 5-layer stack (two skips) against its float32
    plain version, at sample counts that leave partial row groups and row
    tiles (one sample without a valid latent where masked); the same inputs
    give the same bits."""
    from ladiff_torch.ops.md_stack import fused_md_stack, md_stack_plain
    D, H, L, E = 256, 4, 5, 2
    enc, _, _, _, _ = _route_setup(dev, D, H, L, B, T)
    kvalid = (_md_valid(B, T, dev) if masked else
              torch.ones(B * T, device=dev))
    st = enc.stacked_params(torch.bfloat16)
    args = (_bf(dev, B * T, D), _bf(dev, B * E, D, seed=12), kvalid,
            _bf(dev, L, B, D, seed=13), _bf(dev, L, 2 * D, seed=14, scale=0.3),
            _bf(dev, L, 2 * D, seed=15, scale=0.3))
    got = fused_md_stack(*args, st, T=T, E=E, H=H)
    want = md_stack_plain(*[a.float() for a in args], _f32(st), T=T, E=E,
                          H=H)
    assert _relerr(got, want) <= TOL
    assert torch.equal(got, fused_md_stack(*args, st, T=T, E=E, H=H))


@pytest.mark.cuda
@pytest.mark.parametrize("shared_rows", [True, False])
@torch.no_grad()
def test_stylize_kernels(dev, shared_rows):
    """Kernels 6 and 7 against their float32 plain versions, with one AdaLN
    row per sample and one shared row; 185 rows leave a partial block."""
    from ladiff_torch.ops.stylize import (broadcast_stylize_plain,
                                          fused_broadcast_stylize)
    from ladiff_torch.ops.stylized_ffn import (fused_stylized_ffn,
                                               stylized_ffn_plain)
    D, B, T = 256, 37, 5
    _, _, kvalid, w6, w7 = _route_setup(dev, D, B=B, T=T)
    x, value = _bf(dev, B * T, D), _bf(dev, B, D, seed=12)
    ss = _bf(dev, 1 if shared_rows else B, 2 * D, seed=13, scale=0.3)
    up = lambda ts: [t.float() for t in ts]
    assert _relerr(fused_stylized_ffn(x, ss, *w6, T=T),
                   stylized_ffn_plain(x.float(), ss.float(), *up(w6), T=T)
                   ) <= TOL
    assert _relerr(fused_broadcast_stylize(x, value, kvalid, ss, *w7, T=T),
                   broadcast_stylize_plain(x.float(), value.float(), kvalid,
                                           ss.float(), *up(w7), T=T)) <= TOL


@pytest.mark.cuda
@torch.no_grad()
def test_route_kernels_read_inside_their_inputs(dev):
    """Kernels 11, 6 and 7 with every input and parameter in turn at the end
    of its allocation; 8 samples of 5 rows leave a partial sample block and
    a partial row group; D 128 and 256; 6 and 7 with an AdaLN row per
    sample and with one shared row; kernel 7 again at D 64 and 192 on 24 x
    7 rows (row groups that split samples, a partial last group; the mask
    a whole number of 32-byte words, as ``_at_end`` needs)."""
    from ladiff_torch.ops.md_stack import fused_md_stack
    from ladiff_torch.ops.postnorm_ffn import fused_postnorm_ffn
    from ladiff_torch.ops.stylize import fused_broadcast_stylize
    from ladiff_torch.ops.stylized_ffn import fused_stylized_ffn
    B, T, E, L = 8, 5, 2, 3
    for D, H in ((256, 4), (128, 2)):
        enc, _, kvalid, w6, w7 = _route_setup(dev, D, H, L, B, T)
        st = enc.stacked_params(torch.bfloat16)
        args = [_bf(dev, B * T, D), _bf(dev, B * E, D, seed=12), kvalid,
                _bf(dev, L, B, D, seed=13),
                _bf(dev, L, 2 * D, seed=14, scale=0.3),
                _bf(dev, L, 2 * D, seed=15, scale=0.3)]
        _guarded_calls(lambda t, p: fused_md_stack(*t, p, T=T, E=E, H=H),
                       args, st)
        x = _bf(dev, B * T, D)
        for rows in (B, 1):  # an AdaLN row per sample, one shared row
            ss = _bf(dev, rows, 2 * D, seed=16, scale=0.3)
            _guarded_calls(lambda t, p: fused_stylized_ffn(
                t[0], t[1], *t[2:], T=T), [x, ss, *w6])
            _guarded_calls(lambda t, p: fused_broadcast_stylize(
                *t[:4], *t[4:], T=T),
                [x, _bf(dev, B, D, seed=17), kvalid, ss, *w7])
        # kernel 5 as the MD sa_block's tail: 40 rows, ReLU, on the
        # cluster the geometry picks
        _guarded_calls(lambda t, p: fused_postnorm_ffn(
            t[0], p, activation="relu"), [x], _ffn_params(dev, D, 1024))
    B, T = 24, 7
    for D in (64, 192):
        x, value = _bf(dev, B * T, D), _bf(dev, B, D, seed=17)
        kvalid = _md_valid(B, T, dev)
        for rows in (B, 1):
            ss = _bf(dev, rows, 2 * D, seed=16, scale=0.3)
            _guarded_calls(lambda t, p: fused_broadcast_stylize(
                *t[:4], *t[4:], T=T),
                [x, value, kvalid, ss, *_w7(dev, D)])


def _w6(dev, D, Fd, seed=23):
    """Kernel 6's eight tensors at width D, hidden width Fd (bf16)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    w = [r(Fd, D) / math.sqrt(D), 0.05 * r(Fd), r(D, Fd) / math.sqrt(Fd),
         0.05 * r(D), 1 + 0.1 * r(D), 0.05 * r(D), r(D, D) / math.sqrt(D),
         0.05 * r(D)]
    return [t.to(dev, torch.bfloat16) for t in w]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("B,T", [(37, 7), (3, 5), (512, 5)])
@torch.no_grad()
def test_stylized_ffn_kernel_widths(dev, D, B, T):
    """Kernel 6 on the cluster body at every width it takes (clusters of 1
    to 4 CTAs, F = 4 D), in row groups that split samples and a partial
    last group, with an AdaLN row per sample and one shared row."""
    from ladiff_torch.ops.stylized_ffn import (fused_stylized_ffn,
                                               stylized_ffn_plain)
    w6 = _w6(dev, D, 4 * D)
    x = _bf(dev, B * T, D)
    for rows in (B, 1):
        ss = _bf(dev, rows, 2 * D, seed=13, scale=0.3)
        assert _relerr(fused_stylized_ffn(x, ss, *w6, T=T),
                       stylized_ffn_plain(x.float(), ss.float(),
                                          *[t.float() for t in w6], T=T)
                       ) <= TOL, (D, B, T, rows)


def _w7(dev, D, seed=24):
    """Kernel 7's four tensors at width D (bf16): the LayerNorm's weight
    and bias, the projection's weight and bias."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    w = [1 + 0.1 * r(D), 0.05 * r(D), r(D, D) / math.sqrt(D), 0.05 * r(D)]
    return [t.to(dev, torch.bfloat16) for t in w]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("B,T", [(37, 7), (3, 5), (512, 5), (200, 1)])
@torch.no_grad()
def test_broadcast_stylize_kernel_widths(dev, D, B, T):
    """Kernel 7 on the cluster body at every width it takes (clusters of 1
    to 4 CTAs), in row groups that split samples and a partial last group,
    with masks of fractional values (the first sample wholly masked) and
    all-zero masks, an AdaLN row per sample and one shared row."""
    from ladiff_torch.ops.stylize import (broadcast_stylize_plain,
                                          fused_broadcast_stylize)
    w7 = _w7(dev, D)
    x, value = _bf(dev, B * T, D), _bf(dev, B, D, seed=12)
    frac = torch.rand(B * T, generator=torch.Generator().manual_seed(5))
    frac[:T] = 0.0
    for name, mask in (("fractional", frac), ("zero", torch.zeros(B * T))):
        mask = mask.to(dev)
        for rows in (B, 1):
            ss = _bf(dev, rows, 2 * D, seed=13, scale=0.3)
            got = fused_broadcast_stylize(x, value, mask, ss, *w7, T=T)
            want = broadcast_stylize_plain(
                x.float(), value.float(), mask, ss.float(),
                *[t.float() for t in w7], T=T)
            assert _relerr(got, want) <= TOL, (D, B, T, name, rows)


@pytest.mark.cuda
@torch.no_grad()
def test_stylized_ffn_reads_inside_its_inputs(dev):
    """Kernel 6 at D 64 and 192 on 37 x 7 rows (a partial last row group),
    every input in turn at the end of its allocation."""
    from ladiff_torch.ops.stylized_ffn import fused_stylized_ffn
    B, T = 37, 7
    for D in (64, 192):
        x = _bf(dev, B * T, D)
        for rows in (B, 1):
            ss = _bf(dev, rows, 2 * D, seed=16, scale=0.3)
            _guarded_calls(lambda t, p: fused_stylized_ffn(
                t[0], t[1], *t[2:], T=T), [x, ss, *_w6(dev, D, 4 * D)])


@pytest.mark.cuda
def test_route_kernels_refuse_a_required_gradient(dev):
    """Kernels 11, 6 and 7 raise while autograd records a gradient; the
    eval-mode stylization blocks then take their training route, and the
    gradient reaches their parameters."""
    from ladiff_torch.ops.md_stack import fused_md_stack
    from ladiff_torch.ops.stylize import fused_broadcast_stylize
    from ladiff_torch.ops.stylized_ffn import fused_stylized_ffn
    D, H, L, B, T, E = 256, 4, 3, 4, 5, 2
    enc, layer, kvalid, w6, w7 = _route_setup(dev, D, H, L, B, T)
    st = enc.stacked_params(torch.bfloat16)
    x = _bf(dev, B * T, D).requires_grad_()
    ss = _bf(dev, B, 2 * D, seed=13, scale=0.3)
    value = _bf(dev, B, D, seed=12)
    calls = {
        "fused_md_stack": lambda: fused_md_stack(
            x, _bf(dev, B * E, D), kvalid, _bf(dev, L, B, D),
            _bf(dev, L, 2 * D), _bf(dev, L, 2 * D), st, T=T, E=E, H=H),
        "fused_stylized_ffn": lambda: fused_stylized_ffn(x, ss, *w6, T=T),
        "fused_broadcast_stylize": lambda: fused_broadcast_stylize(
            x, value, kvalid, ss, *w7, T=T),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} is an inference"):
            call()
        with torch.no_grad():
            call()
    layer.eval()
    lat, emb = _bf(dev, B, T, D), _bf(dev, B, D, seed=18)
    xf = _bf(dev, B, 1, D, seed=19)
    out = layer.ffn(lat, emb) + layer.ca_block(lat, xf, emb)
    out.float().sum().backward()
    assert layer.ffn.linear1.weight.grad is not None
    assert layer.ca_block.proj_out.out_layers[2].weight.grad is not None


# the evaluation step at batch 4 in bf16: the kernels of its stage, each
# the number of times the stage's layers call it, and no other
EVAL_STEP_LAUNCHES = {
    "diffusion": {"fused_md_layer": 450, "fused_decoder_layer": 9},
    "vae": {"fused_masked_attention": 9, "fused_postnorm_ffn": 9,
            "fused_decoder_layer": 9}}


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["diffusion", "vae"])
def test_eval_step_on_the_gpu(dev, stage):
    """``evaluation.t2m_eval.eval_step`` at the published width (d 256,
    9 + 9 layers, CFG 7.5 DDIM-50) at batch 4 with mixed lengths and the
    same random weights, evaluators and noise on each run: in bf16 it
    launches ``EVAL_STEP_LAUNCHES[stage]``; in float32 (the published
    compute) no kernel, and every output within 1e-3 norm-wise of the
    CPU's (the same function, sums in another order)."""
    import os
    import types

    from ladiff_torch.config import assemble_config
    from ladiff_torch.evaluation.t2m_eval import T2MEvaluator, eval_step
    from ladiff_torch.ops import cuda_common as cc
    from ladiff_torch.training.loop import build_system
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = ("config_vae_humanml3d.yaml" if stage == "vae"
            else "config_ladiff_humanml3d.yaml")
    rng = np.random.RandomState(0)
    dm = types.SimpleNamespace(
        nfeats=263, njoints=22,
        mean=(0.1 * rng.randn(263)).astype(np.float32),
        std=(0.5 + rng.rand(263)).astype(np.float32))
    stats = {"mean_eval": (0.1 * rng.randn(263)).astype(np.float32),
             "std_eval": (0.5 + rng.rand(263)).astype(np.float32)}
    lengths = [40, 196, 97, 64]
    motion = rng.randn(4, 196, 263).astype(np.float32)
    for i, n in enumerate(lengths):
        motion[i, n:] = 0.0
    g = torch.Generator().manual_seed(1)
    batch = {"motion": torch.from_numpy(motion),
             "length": torch.tensor(lengths),
             "word_embs": torch.randn(4, 22, 300, generator=g),
             "pos_ohot": torch.rand(4, 22, 15, generator=g),
             "text_len": torch.tensor([5, 22, 9, 12])}
    cond = torch.randn(4, 1, 768, generator=g)
    uncond = 0.1 * torch.randn(4, 1, 768, generator=g)
    noise = torch.randn(4, 5, 256, generator=g)
    outs = {}
    for mixed, device in ((True, dev), (False, dev), (False, "cpu")):
        cfg = assemble_config(
            os.path.join(repo, "configs", name),
            os.path.join(repo, "configs", "assets.yaml"),
            overrides={"TRAIN": {"MIXED_PRECISION": mixed}})
        system = _randomize(build_system(cfg, dm, device=device), 3)
        ev = T2MEvaluator.random_init(263, torch.Generator().manual_seed(0),
                                      device)
        cc.reset_launch_counts()
        out = eval_step(system, ev, batch, cond, uncond, stage, **stats,
                        **{"init_latents" if stage == "diffusion" else "eps":
                           noise})
        torch.cuda.synchronize()
        launches = {k: v for k, v in cc.launch_counts().items() if v}
        outs[mixed, str(device)] = ({k: v.float().cpu()
                                     for k, v in out.items()}, launches)
    bf16, launches = outs[True, str(dev)]
    assert launches == EVAL_STEP_LAUNCHES[stage]
    assert all(bool(torch.isfinite(v).all()) for v in bf16.values())
    card, launches = outs[False, str(dev)]
    cpu, _ = outs[False, "cpu"]
    assert not launches
    errs = {k: _relerr(card[k], cpu[k]) for k in cpu}
    assert max(errs.values()) <= 1e-3, errs


# -- the action family's shapes ---------------------------------------------
# The ActorVae (d 256, 4 heads, ff 1024, GELU): its encoder runs over 2
# distribution tokens (always valid) and 60 frames, its decoder over 60
# frames against ONE memory row (the latent); the 15-layer action denoiser
# runs 3-token samples [latent; time; action].

ACTION_LENGTHS = (60, 16, 33, 1, 47)


def _action_valid(lengths, S, dev):
    """[B*S] key validity: with S 62 the two distribution tokens (valid)
    ahead of the frames."""
    lengths = np.asarray(lengths)
    frames = _mask(lengths, 60, dev)
    if S == 62:
        frames = torch.cat([torch.ones(len(lengths), 2, device=dev), frames],
                           1)
    return frames.reshape(-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 5, 1])
@torch.no_grad()
def test_action_decoder_layer_kernel(dev, B):
    """K2 at the ActorVae's decode: 60 frames against one memory row (the
    cross-attention's softmax over one key is 1), a 64-row block holding
    rows of two samples; 32 samples (an evaluation batch), 5 with one
    1-frame sample, and 1 (a single partial block)."""
    from ladiff_torch.ops.decoder_layer import (decoder_layer_plain,
                                                fused_decoder_layer)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    D, H, T, L = 256, 4, 60, 1
    lengths = np.resize(np.array(ACTION_LENGTHS), B)
    layer = _randomize(TransformerDecoderLayer(D, H, 4 * D, "gelu"), 31).to(
        dev, torch.bfloat16)
    g = torch.Generator().manual_seed(32)
    bf = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    args = (bf(B * T, D), _mask(lengths, T, dev).reshape(-1).contiguous(),
            bf(B, L, D), torch.ones(B, L, device=dev))
    p = layer.kernel_params()
    got = fused_decoder_layer(*args, p, T=T, H=H)
    want = decoder_layer_plain(*[a.float() for a in args], _f32(p), T=T, H=H)
    assert torch.isfinite(got).all()
    assert _relerr(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [62, 60])
@torch.no_grad()
def test_action_train_attention_kernel(dev, S, rate):
    """Kernel 8 at the ActorVae's training streams: the encoder's 62 tokens
    (two always-valid distribution tokens, then padded frames) and the
    decoder's 60 frames; forward and every gradient."""
    from ladiff_torch.ops.train_attention import (
        ATTN_PARAM_ORDER, train_self_attention_bwd,
        train_self_attention_bwd_plain, train_self_attention_fwd,
        train_self_attention_masks, train_self_attention_plain)
    D, H, seed = 256, 4, 8642097531
    B = len(ACTION_LENGTHS)
    p = _attn_params(dev)
    x = _bf(dev, B * S, D, seed=33)
    dout = _bf(dev, B * S, D, seed=34, scale=0.1)
    kvalid = _action_valid(ACTION_LENGTHS, S, dev)
    masks = (train_self_attention_masks(B, S, D, H, rate, seed, dev)
             if rate else None)
    kw = dict(H=H, S=S, rate=rate, seed=seed)
    got, saved = train_self_attention_fwd(x, kvalid, p, return_saved=True,
                                          **kw)
    want = train_self_attention_plain(x.float(), kvalid, _f32(p), masks,
                                      H=H, S=S)
    assert _relerr(got, want) <= TOL
    dx, grads = train_self_attention_bwd(x, kvalid, dout, p, saved, **kw)
    wdx, wgrads = train_self_attention_bwd_plain(
        x.float(), kvalid, dout.float(), _f32(p), masks, H=H, S=S)
    assert _relerr(dx, wdx) <= TOL
    for k in ATTN_PARAM_ORDER:
        assert _relerr(grads[k], wgrads[k]) <= TOL, k


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@torch.no_grad()
def test_action_whole_layer_kernels(dev, rate):
    """Kernel 12 over the ActorVae encoder's 62 tokens and kernel 13 over
    its decoder's 60 frames with ONE memory row (L 1), forward and every
    gradient, the memory's too."""
    from ladiff_torch.ops.train_decoder_layer import (
        DEC_PARAM_ORDER, train_decoder_layer_bwd,
        train_decoder_layer_bwd_plain, train_decoder_layer_fwd,
        train_decoder_layer_masks, train_decoder_layer_plain)
    from ladiff_torch.ops.train_layer import (
        ENC_PARAM_ORDER, train_encoder_layer_bwd,
        train_encoder_layer_bwd_plain, train_encoder_layer_fwd,
        train_encoder_layer_masks, train_encoder_layer_plain)
    from ladiff_torch.ops.transformer import TransformerDecoderLayer
    D, H, Fd, L, seed = 256, 4, 1024, 1, 1357924680
    B = len(ACTION_LENGTHS)
    pe = {**_attn_params(dev), **_ffn_params(dev)}
    pd = {k: v.detach() for k, v in _randomize(TransformerDecoderLayer(
        D, H, Fd, "gelu"), 35).to(dev, torch.bfloat16).kernel_params().items()}
    for S in (62, 60):
        x, dout = _bf(dev, B * S, D, seed=36), _bf(dev, B * S, D, seed=37,
                                                   scale=0.1)
        kvalid = _action_valid(ACTION_LENGTHS, S, dev)
        kw = dict(H=H, S=S, rate=rate, seed=seed)
        if S == 62:
            masks = (train_encoder_layer_masks(B, S, D, H, Fd, rate, seed,
                                               dev) if rate else None)
            got, saved = train_encoder_layer_fwd(x, kvalid, pe,
                                                 return_saved=True, **kw)
            want = train_encoder_layer_plain(x.float(), kvalid, _f32(pe),
                                             masks, H=H, S=S)
            dx, grads = train_encoder_layer_bwd(x, kvalid, dout, pe, saved,
                                                **kw)
            wdx, wgrads = train_encoder_layer_bwd_plain(
                x.float(), kvalid, dout.float(), _f32(pe), masks, H=H, S=S)
            names = ENC_PARAM_ORDER
        else:
            mem = _bf(dev, B, L, D, seed=38)
            mvalid = torch.ones(B, L, device=dev)
            masks = (train_decoder_layer_masks(B, S, L, D, H, Fd, rate, seed,
                                               dev) if rate else None)
            got, saved = train_decoder_layer_fwd(x, kvalid, mem, mvalid, pd,
                                                 return_saved=True, **kw)
            want = train_decoder_layer_plain(x.float(), kvalid, mem.float(),
                                             mvalid, _f32(pd), masks, H=H,
                                             S=S)
            dx, dmem, grads = train_decoder_layer_bwd(
                x, kvalid, mem, mvalid, dout, pd, saved, **kw)
            wdx, wdmem, wgrads = train_decoder_layer_bwd_plain(
                x.float(), kvalid, mem.float(), mvalid, dout.float(),
                _f32(pd), masks, H=H, S=S)
            assert _relerr(dmem, wdmem) <= TOL
            names = DEC_PARAM_ORDER
        assert _relerr(got, want) <= TOL, S
        assert _relerr(dx, wdx) <= TOL, S
        for k in names:
            assert _relerr(grads[k], wgrads[k]) <= TOL, (S, k)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", [192, 64 * 62, 128 * 62, 128 * 60])
@torch.no_grad()
def test_action_ffn_tail_rows(dev, rows, rate):
    """Kernels 5 and 9 (GELU) at the action path's row counts: 192 (the
    denoiser's 3-token samples, 64 a CFG evaluation launch or a stage-2
    step), 64 x 62 (the frozen encode), 128 x 62 and 128 x 60 (stage 1):
    kernel 5 at rate 0, kernel 9 forward and backward."""
    from ladiff_torch.ops.postnorm_ffn import (fused_postnorm_ffn,
                                               postnorm_ffn_plain)
    from ladiff_torch.ops.train_ffn import (
        train_postnorm_ffn_bwd, train_postnorm_ffn_bwd_plain,
        train_postnorm_ffn_fwd, train_postnorm_ffn_masks,
        train_postnorm_ffn_plain)
    D, Fd, seed = 256, 1024, 97531
    p = _ffn_params(dev)
    x = _bf(dev, rows, D, seed=rows + 3)
    dout = _bf(dev, rows, D, seed=rows + 4, scale=0.1)
    if rate == 0.0:
        assert _relerr(fused_postnorm_ffn(x, p), postnorm_ffn_plain(
            x.float(), _f32(p))) <= TOL
    masks = (train_postnorm_ffn_masks(rows, D, Fd, rate, seed, dev)
             if rate else None)
    kw = dict(activation="gelu", rate=rate, seed=seed)
    got = train_postnorm_ffn_fwd(x, p, **kw)
    assert _relerr(got, train_postnorm_ffn_plain(
        x.float(), _f32(p), masks, activation="gelu")) <= TOL
    dx, grads = train_postnorm_ffn_bwd(x, dout, p, **kw)
    wdx, wgrads = train_postnorm_ffn_bwd_plain(
        x.float(), dout.float(), _f32(p), masks, activation="gelu")
    assert _relerr(dx, wdx) <= TOL
    for k, w in wgrads.items():
        assert _relerr(grads[k], w) <= TOL, k
