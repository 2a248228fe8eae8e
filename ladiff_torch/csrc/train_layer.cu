// Kernel 12: one whole post-norm transformer encoder layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_layer.py
// train_encoder_layer).  See ladiff_torch/ops/train_layer.py for the math,
// the dropout contract, what is saved and the weight-gradient scheme.
//
// Forward, a fixed sequence of launches:
//   linear_kernel        qkv = x Wqkv^T + bqkv                   (kernel 8's)
//   attn_fwd_kernel      tiled online-softmax attention, probability
//                        dropout (mask 0); ctx, log-sum-exp       (kernel 8's)
//   enc_tail_fwd_kernel  per 32-row block, from ctx to the layer's output:
//                        out-projection, residual dropout (mask 1), LN1, the
//                        FFN (masks 2, 3), LN2 (ffn_tail.cuh); the residual
//                        r and h stay in shared memory
// Backward:
//   enc_tail_bwd_kernel  per 32-row block, from dout to dctx: r and h again,
//                        the tail's backward (ffn_bwd.cuh), LN1's backward,
//                        the residual dropout and the out-projection's
//                        backward: writes dr (the residual path's dx), dattn,
//                        dctx, delta = dctx . ctx, and the scratch rows the
//                        weight gradients need
//   reduce_kernel        LayerNorm gradients over the blocks
//   attn_bwd_kernel x2   dq; dk, dv                               (kernel 8's)
//   linear_nn_kernel     dx = dr + dqkv Wqkv                      (kernel 8's)
//   wgrad / colsum       dWqkv, dbqkv, dWout, dbout, dW1, db1, dW2, db2
#include "ffn_bwd.cuh"
#include "train_attn.cuh"

namespace {

constexpr uint32_t kMaskRes = 1u, kMaskHid = 2u, kMaskOut = 3u;

struct EncTail {
  const bf16 *x, *ctx;
  const bf16 *out_w, *out_b, *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w,
      *ln2_b;
  const bf16* dout;
  bf16* out;
  // backward scratch: r (f32), h, gd, da, dy, dr, dattn, dctx (bf16),
  // delta [M, H] and the LayerNorm partials [blocks, 4 D] (f32)
  float* r;
  bf16 *h, *gd, *da, *dy, *dr, *dattn, *dctx;
  float *delta, *lnpart;
  int M, D, H, F, act;
  Dropout drop;
};

FfnArgs tail_args(const EncTail& a) {
  FfnArgs f;
  f.x = nullptr;
  f.ln1_w = a.ln1_w; f.ln1_b = a.ln1_b; f.w1 = a.w1; f.b1 = a.b1;
  f.w2 = a.w2; f.b2 = a.b2; f.ln2_w = a.ln2_w; f.ln2_b = a.ln2_b;
  f.out = a.out;
  f.M = a.M; f.D = a.D; f.F = a.F; f.act = a.act;
  f.drop = a.drop;
  return f;
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
enc_tail_fwd_kernel(EncTail a, FfnArgs f, FfnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(a.M - row0));
  out_proj_rows<kDrop>(a.ctx, a.x, a.out_w, a.out_b, a.drop, kMaskRes, a.D,
                       reinterpret_cast<bf16*>(smem + L.xb),
                       reinterpret_cast<float*>(smem + L.cf),
                       reinterpret_cast<float*>(smem + L.r),
                       reinterpret_cast<bf16*>(smem + L.ws), row0, nrow);
  ffn_tail_rows<kDrop>(f, L, smem, row0, nrow, kMaskHid, kMaskOut);
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
enc_tail_bwd_kernel(EncTail a, FfnBwdLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  bf16* dyb = reinterpret_cast<bf16*>(smem + L.dyb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* r = reinterpret_cast<float*>(smem + L.r);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(a.M - row0));
  float* lnpart = a.lnpart + (size_t)blockIdx.x * 4 * D;

  // r = x + drop(ctx Wout^T + bout), kept (f32) for LN1's backward
  out_proj_rows<kDrop>(a.ctx, a.x, a.out_w, a.out_b, a.drop, kMaskRes, D, xb,
                       cf, r, ws, row0, nrow);
  for (int i = tid; i < nrow * D; i += blockDim.x) a.r[row0 * D + i] = r[i];
  __syncthreads();
  // h = LN1(r): f32 in r, bf16 in xb and in scratch (dW1 = da^T h)
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln1_w, a.ln1_b);
  __syncthreads();
  for (int i = tid; i < nrow * D; i += blockDim.x)
    a.h[row0 * D + i] = xb[(i / D) * ld + i % D];
  __syncthreads();

  // the FFN tail's backward: r <- dh
  FfnBwdArgs fb;
  fb.dout = a.dout;
  fb.w1 = a.w1; fb.b1 = a.b1; fb.w2 = a.w2; fb.b2 = a.b2; fb.lnb_w = a.ln2_w;
  fb.gd = a.gd; fb.da = a.da; fb.dy = a.dy;
  fb.M = a.M; fb.D = D; fb.F = a.F; fb.act = a.act;
  fb.mask_hid = kMaskHid; fb.mask_out = kMaskOut;
  fb.drop = a.drop;
  ffn_tail_backward_rows<kDrop>(fb, L, smem, row0, nrow, lnpart + 2 * D);

  // LN1's backward from the kept r: r <- dr
  block_ln_bwd_rows(a.r, row0, nrow, r, D, a.ln1_w, cf, lnpart);
  // the residual dropout and the out-projection's backward
  dattn_rows<kDrop>(r, xb, a.dr, a.dattn, D, a.drop, kMaskRes, row0, nrow);
  dctx_rows(xb, dyb, cf, ws, a.out_w, a.ctx, a.dctx, a.delta, D, a.H, row0,
            nrow);
}

inline bool layer_shape_ok(int B, int S, int D, int H, int F) {
  return shape_ok(B, S, D, H) && F % kBC == 0 && F >= kBC && F <= 1024;
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D] bf16, kvalid [M] f32, the 12 parameters (bf16, in the
// order in_w [3D, D], in_b, out_w [D, D], out_b, ln1_w, ln1_b, w1 [F, D],
// b1, w2 [D, F], b2, ln2_w, ln2_b), then what the backward reuses: qkv
// [M, 3D], ctx [M, D] (bf16), lse [M, H] (f32); out [M, D] (bf16).  ints: B,
// S, D, H, F, act, seed lo, seed hi.  floats: rate.
extern "C" int train_layer_forward(const void** p, const int* n,
                                   const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int B = n[0], S = n[1], D = n[2], H = n[3], F = n[4];
  if (!layer_shape_ok(B, S, D, H, F)) return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[6], n[7], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = reinterpret_cast<const float*>(p[1]);
  const bf16** q = w + 2;
  bf16* qkv = const_cast<bf16*>(w[14]);
  bf16* ctx = const_cast<bf16*>(w[15]);
  float* lse = reinterpret_cast<float*>(const_cast<void*>(p[16]));
  EncTail a = {};
  a.x = x; a.ctx = ctx;
  a.out_w = q[2]; a.out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.w1 = q[6]; a.b1 = q[7]; a.w2 = q[8]; a.b2 = q[9];
  a.ln2_w = q[10]; a.ln2_b = q[11];
  a.out = const_cast<bf16*>(w[17]);
  a.M = M; a.D = D; a.H = H; a.F = F; a.act = n[5];
  a.drop = drop;
  const FfnArgs fa = tail_args(a);

  const size_t rb = row_gemm_bytes(D);
  const AttnLayout La = attn_layout(D / H);
  const FfnLayout Lt = ffn_layout(D, F);
  static SmemGrant g_lin, g_att0, g_att1, g_t0, g_t1;
  if (!allow_smem(linear_kernel, rb, g_lin) ||
      !allow_smem(attn_fwd_kernel<false>, La.total, g_att0) ||
      !allow_smem(attn_fwd_kernel<true>, La.total, g_att1) ||
      !allow_smem(enc_tail_fwd_kernel<false>, Lt.total, g_t0) ||
      !allow_smem(enc_tail_fwd_kernel<true>, Lt.total, g_t1))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  linear_kernel<<<dim3(blocks, (3 * D + kChunk - 1) / kChunk), kThreads, rb,
                  stream>>>(x, M, D, q[0], q[1], 3 * D, qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 agrid((S + kTile - 1) / kTile, H, B);
  if (on)
    attn_fwd_kernel<true><<<agrid, kAttnThreads, La.total, stream>>>(
        qkv, kvalid, ctx, lse, S, D, H, drop, La);
  else
    attn_fwd_kernel<false><<<agrid, kAttnThreads, La.total, stream>>>(
        qkv, kvalid, ctx, lse, S, D, H, drop, La);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (on)
    enc_tail_fwd_kernel<true><<<blocks, kThreads, Lt.total, stream>>>(a, fa,
                                                                      Lt);
  else
    enc_tail_fwd_kernel<false><<<blocks, kThreads, Lt.total, stream>>>(a, fa,
                                                                       Lt);
  return cudaGetLastError();
}

// ptrs: x [M, D] bf16, kvalid [M] f32, dout [M, D] bf16; the 12 parameters
// (bf16, the forward's order); the forward's qkv, ctx (bf16), lse (f32);
// scratch r [M, D] (f32), h [M, D], gd [M, F], da [M, F], dy [M, D], dr
// [M, D], dattn [M, D], dctx [M, D] (bf16), delta [M, H], dqkv [M, 3D]
// (bf16), lnpart [blocks, 4 D], wpart [split, max(3 D D, F D)] (f32); dx
// [M, D] (bf16); the 12 parameter gradients (f32, the forward's order).
// ints: B, S, D, H, F, act, seed lo, seed hi, split.  floats: rate.
extern "C" int train_layer_backward(const void** p, const int* n,
                                    const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  auto fptr = [&](int i) {
    return reinterpret_cast<float*>(const_cast<void*>(p[i]));
  };
  auto bptr = [&](int i) { return const_cast<bf16*>(w[i]); };
  const int B = n[0], S = n[1], D = n[2], H = n[3], F = n[4], split = n[8];
  if (!layer_shape_ok(B, S, D, H, F) || split < 1)
    return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[6], n[7], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = fptr(1);
  const bf16** q = w + 3;
  const bf16 *qkv = w[15], *ctx = w[16];
  const float* lse = fptr(17);
  EncTail a = {};
  a.x = x; a.ctx = ctx; a.dout = w[2];
  a.out_w = q[2]; a.out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.w1 = q[6]; a.b1 = q[7]; a.w2 = q[8]; a.b2 = q[9];
  a.ln2_w = q[10]; a.ln2_b = q[11];
  a.r = fptr(18);
  a.h = bptr(19); a.gd = bptr(20); a.da = bptr(21); a.dy = bptr(22);
  a.dr = bptr(23); a.dattn = bptr(24); a.dctx = bptr(25);
  a.delta = fptr(26);
  bf16* dqkv = bptr(27);
  a.lnpart = fptr(28);
  float* wpart = fptr(29);
  bf16* dx = bptr(30);
  float* g[12];
  for (int i = 0; i < 12; ++i) g[i] = fptr(31 + i);
  a.M = M; a.D = D; a.H = H; a.F = F; a.act = n[5];
  a.drop = drop;

  const size_t rb3 = row_gemm_bytes(3 * D);
  const BwdLayout Lb = bwd_layout(D / H);
  const FfnBwdLayout Lt = ffn_bwd_layout(D, F);
  static SmemGrant g_t0, g_t1, g_q0, g_q1, g_k0, g_k1, g_dx;
  if (!allow_smem(enc_tail_bwd_kernel<false>, Lt.total, g_t0) ||
      !allow_smem(enc_tail_bwd_kernel<true>, Lt.total, g_t1) ||
      !allow_smem(attn_bwd_kernel<false, false>, Lb.total, g_q0) ||
      !allow_smem(attn_bwd_kernel<false, true>, Lb.total, g_q1) ||
      !allow_smem(attn_bwd_kernel<true, false>, Lb.total, g_k0) ||
      !allow_smem(attn_bwd_kernel<true, true>, Lb.total, g_k1) ||
      !allow_smem(linear_nn_kernel, rb3, g_dx))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  if (on)
    enc_tail_bwd_kernel<true><<<blocks, kThreads, Lt.total, stream>>>(a, Lt);
  else
    enc_tail_bwd_kernel<false><<<blocks, kThreads, Lt.total, stream>>>(a, Lt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // LayerNorm gradients: ln1_w, ln1_b, ln2_w, ln2_b = g[4], g[5], g[10], g[11]
  float* ln_out[4] = {g[4], g[5], g[10], g[11]};
  for (int k = 0; k < 4; ++k)
    if ((err = reduce_partials(a.lnpart + k * D, blocks, (size_t)4 * D, D,
                               ln_out[k], stream)) != cudaSuccess)
      return err;
  const dim3 agrid((S + kTile - 1) / kTile, H, B);
  if (on) {
    attn_bwd_kernel<false, true><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, a.dctx, kvalid, lse, a.delta, dqkv, S, D, H, drop, Lb);
    attn_bwd_kernel<true, true><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, a.dctx, kvalid, lse, a.delta, dqkv, S, D, H, drop, Lb);
  } else {
    attn_bwd_kernel<false, false><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, a.dctx, kvalid, lse, a.delta, dqkv, S, D, H, drop, Lb);
    attn_bwd_kernel<true, false><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, a.dctx, kvalid, lse, a.delta, dqkv, S, D, H, drop, Lb);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  linear_nn_kernel<<<blocks, kThreads, rb3, stream>>>(dqkv, M, 3 * D, q[0], D,
                                                      a.dr, dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = weight_grad(dqkv, 3 * D, 3 * D, x, D, D, M, split, wpart, g[0],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(dqkv, 3 * D, 3 * D, M, split, wpart, g[1],
                       stream)) != cudaSuccess) return err;
  if ((err = weight_grad(a.dattn, D, D, ctx, D, D, M, split, wpart, g[2],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(a.dattn, D, D, M, split, wpart, g[3], stream)) !=
      cudaSuccess) return err;
  if ((err = weight_grad(a.da, F, F, a.h, D, D, M, split, wpart, g[6],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(a.da, F, F, M, split, wpart, g[7], stream)) !=
      cudaSuccess) return err;
  if ((err = weight_grad(a.dy, D, D, a.gd, F, F, M, split, wpart, g[8],
                         stream)) != cudaSuccess) return err;
  return bias_grad(a.dy, D, D, M, split, wpart, g[9], stream);
}

// ptrs: pm [B, H, S, S], rm [M, D], m1 [M, F], m2 [M, D] (f32): the four
// keep-masks of a seed (probabilities, residual, FFN hidden, FFN output).
// ints: B, S, D, H, F, seed lo, seed hi.  floats: rate.
extern "C" int train_layer_masks(const void** p, const int* n, const float* f,
                                 void* stream_ptr) {
  const unsigned long long B = n[0], S = n[1], D = n[2], H = n[3], F = n[4];
  const Dropout d = make_dropout(n[5], n[6], f[0]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned long long sizes[4] = {B * H * S * S, B * S * D, B * S * F,
                                       B * S * D};
  for (uint32_t k = 0; k < 4; ++k) {
    cudaError_t err = fill_mask(
        reinterpret_cast<float*>(const_cast<void*>(p[k])), sizes[k], d, k,
        stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
