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
#include "ffn_tail.cuh"
#include "train_common.cuh"

using namespace ladiff;

namespace {

constexpr int kPer = 8;   // D <= 256: values of a row per lane
constexpr int kBC = 128;  // FFN columns per step of the backward's da pass

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

struct BwdLayout {
  size_t xb, dyb, cf, cf2, r, hid, ws, total;
};

inline BwdLayout bwd_layout(int D, int F) {
  BwdLayout L;
  L.xb = 0;
  L.dyb = align128(L.xb + kRows * (D + 8) * sizeof(bf16));
  L.cf = align128(L.dyb + kRows * (D + 8) * sizeof(bf16));
  L.cf2 = align128(L.cf + kRows * (kChunk + 4) * sizeof(float));
  L.r = align128(L.cf2 + kRows * (kBC + 4) * sizeof(float));
  L.hid = align128(L.r + kRows * D * sizeof(float));
  L.ws = align128(L.hid + kRows * (F + 8) * sizeof(bf16));
  L.total = align128(L.ws + kWStageBytes);
  return L;
}

// v[i] (element lane + 32 i of a row of length D) <- (v - mean) * rstd;
// returns rstd.
__device__ __forceinline__ float warp_normalize(float* v, int per, int D) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (i < per) s += v[i];
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (i < per) q += (v[i] - mean) * (v[i] - mean);
  const float rstd = rsqrtf(warp_sum(q) / D + kLnEps);
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (i < per) v[i] = (v[i] - mean) * rstd;
  return rstd;
}

// LayerNorm VJP of one row held by a warp: d (upstream) <- the gradient of
// the LayerNorm's input; gw += d * xhat, gb += d (weight and bias gradient
// contributions of this row).
__device__ __forceinline__ void warp_ln_bwd(const float* xhat, float* d,
                                            const bf16* w, int per, int D,
                                            float rstd, float* gw,
                                            float* gb) {
  const int lane = threadIdx.x & 31;
  float sg = 0.f, sgx = 0.f;
  // columns are clamped before the guard: the read-only loads of the
  // unrolled iterations i >= per may be issued speculatively
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = min(lane + 32 * i, D - 1);
    if (i < per) {
      gw[i] += d[i] * xhat[i];
      gb[i] += d[i];
      const float g = d[i] * ldgf(w + c);
      d[i] = g;
      sg += g;
      sgx += g * xhat[i];
    }
  }
  sg = warp_sum(sg) / D;
  sgx = warp_sum(sgx) / D;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (i < per) d[i] = rstd * (d[i] - sg - xhat[i] * sgx);
}

// out[0:D] = sum over the block's warps of gw, out[D:2D] of gb, through
// scratch (nwarps * 2 D floats).  All threads call it.
__device__ __forceinline__ void block_partials(const float* gw,
                                               const float* gb, int per,
                                               int D, float* scratch,
                                               float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (i < per) {
      scratch[warp * 2 * D + lane + 32 * i] = gw[i];
      scratch[warp * 2 * D + D + lane + 32 * i] = gb[i];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += scratch[w * 2 * D + c];
    out[c] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float act_grad(float a, int act) {
  if (!act) return a > 0.f ? 1.f : 0.f;
  const float cdf = 0.5f * (1.f + erff(a * 0.70710678118654752f));
  const float pdf = 0.39894228040143268f * expf(-0.5f * a * a);
  return cdf + a * pdf;
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
train_ffn_bwd_kernel(BwdArgs a, BwdLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, F = a.F;
  const int ld = D + 8, ldc = kChunk + 4, ldc2 = kBC + 4, ldh = F + 8;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  bf16* dyb = reinterpret_cast<bf16*>(smem + L.dyb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* cf2 = reinterpret_cast<float*>(smem + L.cf2);
  float* r = reinterpret_cast<float*>(smem + L.r);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
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

  // 2. the forward again: gd (to scratch), y, s = h + (y + b2) * m2 in r
  ffn_hidden<kDrop>(xb, ld, D, a.w1, a.b1, F, a.act, row0, a.drop, hid, ldh,
                    cf, ldc, ws);
  for (int i = tid; i < nrow * F; i += blockDim.x)
    a.gd[row0 * F + i] = hid[(i / F) * ldh + i % F];
  block_gemm(hid, ldh, a.w2, F, F, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float y = cf[row * ldc + c] + ldgf(a.b2 + c);
    if (kDrop) y *= keep_scale(a.drop, 1u, (row0 + row) * D + c);
    r[i] += y;
  }
  __syncthreads();

  // 3. LN2 backward per row: r <- ds, dy = ds * m2 (bf16) in dyb and scratch
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
        v[i] = r[row * D + c];
        d[i] = row < nrow ? ldgf(a.dout + grow * D + c) : 0.f;
      }
    }
    const float rstd = warp_normalize(v, per, D);
    warp_ln_bwd(v, d, a.ln2_w, per, D, rstd, gw, gb);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        r[row * D + c] = d[i];
        float dyv = d[i];
        if (kDrop) dyv *= keep_scale(a.drop, 1u, (row0 + row) * D + c);
        const bf16 b = tob(dyv);
        dyb[row * ld + c] = b;
        if (row < nrow) a.dy[(row0 + row) * D + c] = b;
      }
  }
  block_partials(gw, gb, per, D, cf, lnpart + 2 * D);  // cf: y is consumed

  // 4. da = (dy W2) * m1 * act'(a), a recomputed per 128-column step; da
  //    (bf16) replaces gd in hid and goes to scratch
  for (int n0 = 0; n0 < F; n0 += kBC) {
    block_gemm(xb, ld, a.w1 + (size_t)n0 * D, D, D, kBC, cf, ldc, false, ws);
    block_gemm_nn(dyb, ld, a.w2 + n0, F, D, kBC, cf2, ldc2, false, ws);
    for (int i = tid; i < kRows * kBC; i += blockDim.x) {
      const int row = i / kBC, c = i % kBC;
      const float av = cf[row * ldc + c] + ldgf(a.b1 + n0 + c);
      float dav = cf2[row * ldc2 + c] * act_grad(av, a.act);
      if (kDrop) dav *= keep_scale(a.drop, 0u, (row0 + row) * F + n0 + c);
      const bf16 b = tob(dav);
      hid[row * ldh + n0 + c] = b;
      if (row < nrow) a.da[(row0 + row) * F + n0 + c] = b;
    }
    __syncthreads();
  }

  // 5. dh = ds + da W1; LN1 backward -> dx
  block_gemm_nn(hid, ldh, a.w1, D, F, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x)
    r[i] += cf[(i / D) * ldc + i % D];
  __syncthreads();
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
  const BwdLayout L = bwd_layout(D, F);
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
