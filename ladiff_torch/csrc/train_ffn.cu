// Kernel 9: the post-norm FFN tail of a transformer layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_ffn.py
// train_postnorm_ffn).  See ladiff_torch/ops/train_ffn.py for the math, the
// dropout contract, what is saved and the weight-gradient scheme.
//
// Forward: ffn_tail.cuh's body with dropout, one block per 32 rows.
// Backward, a fixed sequence of launches:
//   train_ffn_bwd_kernel   per 32-row block: recomputes h, gd, y and both
//                          LayerNorms from x, then ds, dy, da, dh and dx;
//                          writes h, gd, da, dy (bf16) to scratch and the
//                          block's LayerNorm-gradient partials
//   reduce_kernel          LayerNorm gradients over the blocks
//   wgrad / colsum + reduce   dW1 = da^T h, db1, dW2 = dy^T gd, db2
#include "ffn_bwd.cuh"

using namespace ladiff;

namespace {

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
train_ffn_fwd_kernel(FfnArgs a, FfnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  ffn_tail_forward<kDrop>(a, L, smem);
}

struct BwdArgs {
  const bf16* x;
  const bf16* dout;
  const bf16 *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
  bf16* dx;
  bf16 *h, *gd, *da, *dy;  // scratch [M, D], [M, F], [M, F], [M, D]
  float* lnpart;           // [blocks, 4 D]: dln1_w, dln1_b, dln2_w, dln2_b
  int M, D, F, act;
  Dropout drop;
};

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
train_ffn_bwd_kernel(BwdArgs a, FfnBwdLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* r = reinterpret_cast<float*>(smem + L.r);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5, per = D / 32;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(a.M - row0));
  float* lnpart = a.lnpart + (size_t)blockIdx.x * 4 * D;

  // 1. h = LN1(x): f32 in r, bf16 in xb and in scratch
  for (int i = tid; i < kRows * D; i += blockDim.x)
    r[i] = i / D < nrow ? ldgf(a.x + row0 * D + i) : 0.f;
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln1_w, a.ln1_b);
  __syncthreads();
  for (int i = tid; i < nrow * D; i += blockDim.x)
    a.h[row0 * D + i] = xb[(i / D) * ld + i % D];

  // 2.-4. the tail's backward down to dh = ds + da W1 in r (ffn_bwd.cuh)
  FfnBwdArgs fb;
  fb.dout = a.dout;
  fb.w1 = a.w1; fb.b1 = a.b1; fb.w2 = a.w2; fb.b2 = a.b2; fb.lnb_w = a.ln2_w;
  fb.gd = a.gd; fb.da = a.da; fb.dy = a.dy;
  fb.M = a.M; fb.D = D; fb.F = a.F; fb.act = a.act;
  fb.mask_hid = 0u; fb.mask_out = 1u;
  fb.drop = a.drop;
  ffn_tail_backward_rows<kDrop>(fb, L, smem, row0, nrow, lnpart + 2 * D);

  // 5. LN1 backward -> dx
  float gw[kPer], gb[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) gw[i] = gb[i] = 0.f;
  for (int row = warp; row < kRows; row += nwarps) {
    float v[kPer], d[kPer];
    const size_t grow = row0 + min(row, nrow - 1);  // a row that exists
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = min(lane + 32 * i, D - 1);
      if (i < per) {
        v[i] = row < nrow ? ldgf(a.x + grow * D + c) : 0.f;
        d[i] = r[row * D + c];
      }
    }
    const float rstd = warp_normalize(v, per, D);
    warp_ln_bwd(v, d, a.ln1_w, per, D, rstd, gw, gb);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (i < per && row < nrow)
        a.dx[(row0 + row) * D + lane + 32 * i] = tob(d[i]);
  }
  block_partials(gw, gb, per, D, cf, lnpart);  // cf: dh's product is consumed
}

inline bool shape_ok(int M, int D, int F) {
  return M >= 1 && D % 64 == 0 && D <= kChunk && F % kBC == 0 && F <= 1024;
}

void fill_ffn_args(FfnArgs& a, const bf16** w, const int* n, float rate) {
  a.x = w[0];
  a.ln1_w = w[1]; a.ln1_b = w[2]; a.w1 = w[3]; a.b1 = w[4];
  a.w2 = w[5]; a.b2 = w[6]; a.ln2_w = w[7]; a.ln2_b = w[8];
  a.M = n[0]; a.D = n[1]; a.F = n[2]; a.act = n[3];
  a.drop = make_dropout(n[4], n[5], rate);
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D], ln1_w, ln1_b, w1 [F, D], b1, w2 [D, F], b2, ln2_w, ln2_b,
// out [M, D] (all bf16).  ints: M, D, F, act, seed lo, seed hi.  floats:
// rate.
extern "C" int train_ffn_forward(const void** p, const int* n, const float* f,
                                 void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  FfnArgs a;
  fill_ffn_args(a, w, n, f[0]);
  a.out = const_cast<bf16*>(w[9]);
  if (!shape_ok(a.M, a.D, a.F)) return cudaErrorInvalidValue;
  const FfnLayout L = ffn_layout(a.D, a.F);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (a.M + kRows - 1) / kRows;
  static SmemGrant g_plain, g_drop;
  if (f[0] > 0.f) {
    if (!allow_smem(train_ffn_fwd_kernel<true>, L.total, g_drop))
      return cudaErrorInvalidValue;
    train_ffn_fwd_kernel<true><<<blocks, kThreads, L.total, stream>>>(a, L);
  } else {
    if (!allow_smem(train_ffn_fwd_kernel<false>, L.total, g_plain))
      return cudaErrorInvalidValue;
    train_ffn_fwd_kernel<false><<<blocks, kThreads, L.total, stream>>>(a, L);
  }
  return cudaGetLastError();
}

// ptrs: x, dout [M, D]; the 8 parameters (bf16, forward's order); dx [M, D];
// scratch h [M, D], gd [M, F], da [M, F], dy [M, D] (bf16); lnpart
// [blocks, 4 D], wpart [split, F D] (f32); then the 8 parameter gradients
// (f32, forward's order).  ints: M, D, F, act, seed lo, seed hi, split.
// floats: rate.
extern "C" int train_ffn_backward(const void** p, const int* n,
                                  const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  BwdArgs a;
  a.x = w[0]; a.dout = w[1];
  a.ln1_w = w[2]; a.ln1_b = w[3]; a.w1 = w[4]; a.b1 = w[5];
  a.w2 = w[6]; a.b2 = w[7]; a.ln2_w = w[8]; a.ln2_b = w[9];
  a.dx = const_cast<bf16*>(w[10]);
  a.h = const_cast<bf16*>(w[11]); a.gd = const_cast<bf16*>(w[12]);
  a.da = const_cast<bf16*>(w[13]); a.dy = const_cast<bf16*>(w[14]);
  a.lnpart = reinterpret_cast<float*>(const_cast<void*>(p[15]));
  float* wpart = reinterpret_cast<float*>(const_cast<void*>(p[16]));
  float* g[8];
  for (int i = 0; i < 8; ++i)
    g[i] = reinterpret_cast<float*>(const_cast<void*>(p[17 + i]));
  a.M = n[0]; a.D = n[1]; a.F = n[2]; a.act = n[3];
  a.drop = make_dropout(n[4], n[5], f[0]);
  const int M = a.M, D = a.D, F = a.F, split = n[6];
  if (!shape_ok(M, D, F) || split < 1) return cudaErrorInvalidValue;
  const FfnBwdLayout L = ffn_bwd_layout(D, F);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (M + kRows - 1) / kRows;
  static SmemGrant g_plain, g_drop;
  if (f[0] > 0.f) {
    if (!allow_smem(train_ffn_bwd_kernel<true>, L.total, g_drop))
      return cudaErrorInvalidValue;
    train_ffn_bwd_kernel<true><<<blocks, kThreads, L.total, stream>>>(a, L);
  } else {
    if (!allow_smem(train_ffn_bwd_kernel<false>, L.total, g_plain))
      return cudaErrorInvalidValue;
    train_ffn_bwd_kernel<false><<<blocks, kThreads, L.total, stream>>>(a, L);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // LayerNorm gradients: ln1_w, ln1_b, ln2_w, ln2_b = g[0], g[1], g[6], g[7]
  float* ln_out[4] = {g[0], g[1], g[6], g[7]};
  for (int k = 0; k < 4; ++k) {
    err = reduce_partials(a.lnpart + k * D, blocks, (size_t)4 * D, D,
                          ln_out[k], stream);
    if (err != cudaSuccess) return err;
  }
  if ((err = weight_grad(a.da, F, F, a.h, D, D, M, split, wpart, g[2],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(a.da, F, F, M, split, wpart, g[3], stream)) !=
      cudaSuccess) return err;
  if ((err = weight_grad(a.dy, D, D, a.gd, F, F, M, split, wpart, g[4],
                         stream)) != cudaSuccess) return err;
  return bias_grad(a.dy, D, D, M, split, wpart, g[5], stream);
}

// ptrs: m1 [M, F], m2 [M, D] (f32): the keep-masks of a seed.  ints: M, D,
// F, seed lo, seed hi.  floats: rate.
extern "C" int train_ffn_masks(const void** p, const int* n, const float* f,
                               void* stream_ptr) {
  float* m1 = reinterpret_cast<float*>(const_cast<void*>(p[0]));
  float* m2 = reinterpret_cast<float*>(const_cast<void*>(p[1]));
  const unsigned long long M = n[0], D = n[1], F = n[2];
  const Dropout d = make_dropout(n[3], n[4], f[0]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = fill_mask(m1, M * F, d, 0u, stream);
  if (err != cudaSuccess) return err;
  return fill_mask(m2, M * D, d, 1u, stream);
}
