// Kernel 12: one whole post-norm transformer encoder layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_layer.py
// train_encoder_layer).  See ladiff_torch/ops/train_layer.py for the math,
// the dropout contract, what is saved and the weight-gradient scheme.
//
// Forward, a fixed sequence of launches:
//   qkv product          qkv = x Wqkv^T + bqkv   (kernel 8's, train_gemm.cuh)
//   attn_fwd_kernel      register-resident flash tile, probability dropout
//                        (mask 0); ctx, log-sum-exp   (flash_tile.cuh, 8's)
//   enc_tail_fwd_kernel  per 64-row block, from ctx to the layer's output:
//                        out-projection, residual dropout (mask 1), LN1, the
//                        FFN in 128-column hidden chunks (masks 2, 3), LN2;
//                        r, h and the hidden rows never leave the block
// Backward:
//   enc_tail_bwd_kernel  per 64-row block, from dout to dctx: r and h again,
//                        the FFN's backward chunk by chunk (dh accumulating
//                        in registers), both LayerNorms' backward, the
//                        residual dropout and the out-projection's backward:
//                        writes dr (the residual path's dx), dattn, dctx,
//                        delta = dctx . ctx, and the scratch rows the weight
//                        gradients need
//   reduce_kernel        LayerNorm gradients over the blocks
//   attn_bwd_kernel x2   dq; dk, dv, wholly masked key tiles skipped
//                                                  (flash_tile.cuh, 8's)
//   dx product           dx = dr + dqkv Wqkv     (kernel 8's, train_gemm.cuh)
//   wgrad / colsum       dWqkv, dbqkv, dWout, dbout, dW1, db1, dW2, db2
//
// What bounds the tails on the H100: ~75 MFLOP forward and ~185 MFLOP
// backward per 64 rows against ~1.2 MB of weights: the tensor cores, and
// the weight bytes each block streams from L2 (on the 32-row blocks, 486
// MB per forward tail at 64 x 206 rows).  The tails (tail64.cuh) run
// 64-row blocks of 16 warps with mma.sync register accumulators and a
// three-stage cp.async weight ring, so each byte of weight serves 64 rows;
// the LayerNorms reduce over the accumulator registers.
#include "tail64.cuh"
#include "train_attn.cuh"
#include "train_gemm.cuh"

namespace {

constexpr uint32_t kMaskRes = 1u, kMaskHid = 2u, kMaskOut = 3u;

struct EncTail {
  const bf16 *x, *ctx;
  const bf16 *out_w, *out_b, *ln1_w, *ln1_b;
  FfnSeg ffn;  // w1, b1, w2, b2, ln2 (and the backward's dout, gd, da, dy)
  bf16* out;
  // backward scratch: r (f32), h, dr, dattn, dctx (bf16), delta [M, H] and
  // the LayerNorm partials [blocks, 4 D] (f32)
  float* r;
  bf16 *h, *dr, *dattn, *dctx;
  float *delta, *lnpart;
  int M, D, H;
  Dropout drop;
};

// Per 64-row block, from ctx to the layer's output: out-projection,
// residual dropout (mask 1), LN1, the FFN in 128-column hidden chunks
// (masks 2, 3; the hidden rows never leave the block), LN2.
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
enc_tail_fwd_kernel(EncTail a) {
  constexpr int D = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem m = tail_smem(smem, D, false);
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(a.M - row0));
  float mean[kTMT][2], rstd[kTMT][2];

  load_rows64<D>(a.ctx, row0, nrow, m.xa);
  float h[kTMT][NT][4];
  tail_zero(h);
  tail_gemm<NT, false>(h, m.xa, D + 8, a.out_w, D, D, m.ring);
  residual_sum<NT, kDrop>(h, a.x, a.out_b, a.drop, kMaskRes, row0, nrow);
  tail_normalize(h, D, m.red, mean, rstd);
  tail_affine(h, a.ln1_w, a.ln1_b);
  store_rows(h, m.xa, D + 8, nullptr, row0, nrow);
  ffn_seg_forward<NT, kDrop>(h, a.ffn, a.drop, kMaskOut, m, row0, nrow,
                             a.out);
}

// Per 64-row block, from dout to dctx: the forward tail again (r to the
// scratch for LN1's backward, h and gd to the scratch for the weight
// gradients), LN2's backward (dy), the FFN's backward in 128-column hidden
// chunks (da, dh = ds + da W1 accumulating in registers), LN1's backward,
// the residual dropout (dr, dattn) and dctx = dattn Wout with
// delta = dctx . ctx per row and head; LayerNorm gradient partials per
// block to lnpart [blocks, 4 D].
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
enc_tail_bwd_kernel(EncTail a) {
  constexpr int D = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem m = tail_smem(smem, D, true);
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(a.M - row0));
  float* lnpart = a.lnpart + (size_t)blockIdx.x * 4 * D;
  float mean1[kTMT][2], rstd1[kTMT][2];

  // r = x + drop(ctx Wout^T + bout): kept (f32) for LN1's backward
  load_rows64<D>(a.ctx, row0, nrow, m.xa);
  float h[kTMT][NT][4];
  tail_zero(h);
  tail_gemm<NT, false>(h, m.xa, D + 8, a.out_w, D, D, m.ring);
  residual_sum<NT, kDrop>(h, a.x, a.out_b, a.drop, kMaskRes, row0, nrow);
  store_rows_f32(h, a.r, row0, nrow);
  // h = LN1(r): bf16 in xa and the scratch (dW1 = da^T h)
  tail_normalize(h, D, m.red, mean1, rstd1);
  tail_affine(h, a.ln1_w, a.ln1_b);
  store_rows(h, m.xa, D + 8, a.h, row0, nrow);
  // the FFN and LN2 again, their backward: h <- the gradient of LN1's output
  ffn_ln_bwd<NT, kDrop>(h, a.ffn, a.drop, m, row0, nrow, lnpart + 2 * D);
  // LN1's backward from the kept r: h <- dr
  float y[kTMT][NT][4];
  load_rows_f32(y, a.r, row0, nrow);
  tail_ln_bwd_rows(y, h, mean1, rstd1, a.ln1_w, m, lnpart);
  // dr, dattn, dctx and delta
  attn_out_bwd<NT, kDrop>(h, a.ctx, a.out_w, a.drop, kMaskRes, a.dr, a.dattn,
                          a.dctx, a.delta, a.H, m, row0, nrow);
}

template <int NT>
static inline cudaError_t tail_fwd_d(const EncTail& a, bool on,
                                     cudaStream_t stream) {
  static SmemGrant g0, g1;
  const size_t bytes = tail_smem_bytes(32 * NT, false, false);
  const int blocks = (a.M + kTRows - 1) / kTRows;
  if (on) {
    if (!allow_smem(enc_tail_fwd_kernel<NT, true>, bytes, g1))
      return cudaErrorInvalidValue;
    enc_tail_fwd_kernel<NT, true><<<blocks, kTThreads, bytes, stream>>>(a);
  } else {
    if (!allow_smem(enc_tail_fwd_kernel<NT, false>, bytes, g0))
      return cudaErrorInvalidValue;
    enc_tail_fwd_kernel<NT, false><<<blocks, kTThreads, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int NT>
static inline cudaError_t tail_bwd_d(const EncTail& a, bool on,
                                     cudaStream_t stream) {
  static SmemGrant g0, g1;
  const size_t bytes = tail_smem_bytes(32 * NT, true, true);
  const int blocks = (a.M + kTRows - 1) / kTRows;
  if (on) {
    if (!allow_smem(enc_tail_bwd_kernel<NT, true>, bytes, g1))
      return cudaErrorInvalidValue;
    enc_tail_bwd_kernel<NT, true><<<blocks, kTThreads, bytes, stream>>>(a);
  } else {
    if (!allow_smem(enc_tail_bwd_kernel<NT, false>, bytes, g0))
      return cudaErrorInvalidValue;
    enc_tail_bwd_kernel<NT, false><<<blocks, kTThreads, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

// The tail launches at width D (64, 128, 192 or 256).
static inline cudaError_t launch_tail(const EncTail& a, bool bwd, bool on,
                                      cudaStream_t stream) {
  switch (a.D) {
    case 64: return bwd ? tail_bwd_d<2>(a, on, stream) : tail_fwd_d<2>(a, on, stream);
    case 128: return bwd ? tail_bwd_d<4>(a, on, stream) : tail_fwd_d<4>(a, on, stream);
    case 192: return bwd ? tail_bwd_d<6>(a, on, stream) : tail_fwd_d<6>(a, on, stream);
    case 256: return bwd ? tail_bwd_d<8>(a, on, stream) : tail_fwd_d<8>(a, on, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The 12 parameters (the host's order) into a.
void fill_params(EncTail& a, const bf16** q, int F, int act) {
  a.out_w = q[2]; a.out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.ffn.w1 = q[6]; a.ffn.b1 = q[7]; a.ffn.w2 = q[8]; a.ffn.b2 = q[9];
  a.ffn.ln_w = q[10]; a.ffn.ln_b = q[11];
  a.ffn.F = F; a.ffn.act = act;
  a.ffn.mask_hid = kMaskHid; a.ffn.mask_out = kMaskOut;
}

inline bool layer_shape_ok(int B, int S, int D, int H, int F) {
  return shape_ok(B, S, D, H) && F % kTFC == 0 && F >= kTFC && F <= 1024;
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D] bf16, kvalid [M] f32, the 12 parameters (bf16, in the
// order in_w [3D, D], in_b, out_w [D, D], out_b, ln1_w, ln1_b, w1 [F, D],
// b1, w2 [D, F], b2, ln2_w, ln2_b), then what the backward reuses: qkv
// [M, 3D], ctx [M, D] (bf16), lse [M, H] (f32); out [M, D] (bf16).  ints: B,
// S, D, H, F, act, seed lo, seed hi, the qkv product's geometry (BN, CTAs).
// floats: rate.
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
  fill_params(a, q, F, n[5]);
  a.out = const_cast<bf16*>(w[17]);
  a.M = M; a.D = D; a.H = H;
  a.drop = drop;

  cudaError_t err;
  if ((err = qkv_product(gemm_geo(n + 8), x, q[0], q[1], qkv, M, D,
                         stream)) != cudaSuccess)
    return err;
  if ((err = launch_attn_fwd(qkv, kvalid, ctx, lse, B, S, D, H, drop, on,
                             stream)) != cudaSuccess)
    return err;
  return launch_tail(a, false, on, stream);
}

// ptrs: x [M, D] bf16, kvalid [M] f32, dout [M, D] bf16; the 12 parameters
// (bf16, the forward's order); the forward's qkv, ctx (bf16), lse (f32);
// scratch r [M, D] (f32), h [M, D], gd [M, F], da [M, F], dy [M, D], dr
// [M, D], dattn [M, D], dctx [M, D] (bf16), delta [M, H], dqkv [M, 3D]
// (bf16), lnpart [blocks, 4 D], wpart [split, max(3 D D, F D)] (f32); dx
// [M, D] (bf16); the 12 parameter gradients (f32, the forward's order).
// ints: B, S, D, H, F, act, seed lo, seed hi, split, the dx product's
// geometry (BN, CTAs).  floats: rate.
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
  a.x = x; a.ctx = ctx;
  fill_params(a, q, F, n[5]);
  a.ffn.dout = w[2];
  a.r = fptr(18);
  a.h = bptr(19); a.ffn.gd = bptr(20); a.ffn.da = bptr(21);
  a.ffn.dy = bptr(22);
  a.dr = bptr(23); a.dattn = bptr(24); a.dctx = bptr(25);
  a.delta = fptr(26);
  bf16* dqkv = bptr(27);
  a.lnpart = fptr(28);
  float* wpart = fptr(29);
  bf16* dx = bptr(30);
  float* g[12];
  for (int i = 0; i < 12; ++i) g[i] = fptr(31 + i);
  a.M = M; a.D = D; a.H = H;
  a.drop = drop;

  const int tail_blocks = (M + kTRows - 1) / kTRows;
  cudaError_t err;
  if ((err = launch_tail(a, true, on, stream)) != cudaSuccess) return err;
  // LayerNorm gradients: ln1_w, ln1_b, ln2_w, ln2_b = g[4], g[5], g[10], g[11]
  float* ln_out[4] = {g[4], g[5], g[10], g[11]};
  for (int k = 0; k < 4; ++k)
    if ((err = reduce_partials(a.lnpart + k * D, tail_blocks, (size_t)4 * D,
                               D, ln_out[k], stream)) != cudaSuccess)
      return err;
  if ((err = launch_attn_bwd(qkv, a.dctx, kvalid, lse, a.delta, dqkv, B, S, D,
                             H, drop, on, stream)) != cudaSuccess)
    return err;
  if ((err = dx_product(gemm_geo(n + 9), dqkv, q[0], a.dr, dx, M, D,
                        stream)) != cudaSuccess)
    return err;
  if ((err = weight_grad(dqkv, 3 * D, 3 * D, x, D, D, M, split, wpart, g[0],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(dqkv, 3 * D, 3 * D, M, split, wpart, g[1],
                       stream)) != cudaSuccess) return err;
  if ((err = weight_grad(a.dattn, D, D, ctx, D, D, M, split, wpart, g[2],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(a.dattn, D, D, M, split, wpart, g[3], stream)) !=
      cudaSuccess) return err;
  if ((err = weight_grad(a.ffn.da, F, F, a.h, D, D, M, split, wpart, g[6],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(a.ffn.da, F, F, M, split, wpart, g[7], stream)) !=
      cudaSuccess) return err;
  if ((err = weight_grad(a.ffn.dy, D, D, a.ffn.gd, F, F, M, split, wpart, g[8],
                         stream)) != cudaSuccess) return err;
  return bias_grad(a.ffn.dy, D, D, M, split, wpart, g[9], stream);
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
