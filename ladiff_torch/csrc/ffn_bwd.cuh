// The backward of the post-norm FFN tail for one 32-row block, kernel 9's
// (train_ffn.cu), with the LayerNorm VJP pieces it uses.  The forward is
// ffn_tail.cuh's:
//   h = LN_a(x);  gd = act(h W1^T + b1) * m_hid;
//   out = LN_b(h + (gd W2^T + b2) * m_out)
// Rounding points as in the TPU kernels: h, gd, da and dy are rounded to
// bf16 before their products, everything else is float32.
#pragma once

#include "ffn_tail.cuh"
#include "train_common.cuh"

namespace ladiff {

constexpr int kPer = 8;   // D <= 256: values of a row per lane
constexpr int kBC = 128;  // FFN columns per step of the backward's da pass

struct FfnBwdLayout {
  size_t xb, dyb, cf, cf2, r, hid, ws, total;
};

inline FfnBwdLayout ffn_bwd_layout(int D, int F) {
  FfnBwdLayout L;
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

struct FfnBwdArgs {
  const bf16* dout;                        // gradient of LN_b's output
  const bf16 *w1, *b1, *w2, *b2, *lnb_w;   // lnb_w: LN_b's weight
  bf16 *gd, *da, *dy;  // scratch [M, F], [M, F], [M, D] for the wgrads
  int M, D, F, act;
  uint32_t mask_hid, mask_out;
  Dropout drop;
};

// The FFN tail's backward for the block's rows, from h = LN_a(input): on
// entry xb holds bf16(h) and r holds h (f32), rows >= nrow zero.  Recomputes
// gd and s = h + y * m_out, runs LN_b's backward with dout, da, and returns
// with r = dh = ds + da W1 (the gradient of h) and xb unchanged; writes gd,
// dy and da (bf16) to scratch for rows < nrow and LN_b's weight and bias
// gradient sums of the block to lnb_part[0:2D].  Ends synchronized.
template <bool kDrop>
__device__ __forceinline__ void ffn_tail_backward_rows(
    const FfnBwdArgs& a, const FfnBwdLayout& L, unsigned char* smem,
    size_t row0, int nrow, float* lnb_part) {
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

  // the forward again: gd (to scratch), y, s = h + (y + b2) * m_out in r
  ffn_hidden<kDrop>(xb, ld, D, a.w1, a.b1, F, a.act, row0, a.drop, hid, ldh,
                    cf, ldc, ws, a.mask_hid);
  for (int i = tid; i < nrow * F; i += blockDim.x)
    a.gd[row0 * F + i] = hid[(i / F) * ldh + i % F];
  block_gemm(hid, ldh, a.w2, F, F, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float y = cf[row * ldc + c] + ldgf(a.b2 + c);
    if (kDrop) y *= keep_scale(a.drop, a.mask_out, (row0 + row) * D + c);
    r[i] += y;
  }
  __syncthreads();

  // LN_b backward per row: r <- ds, dy = ds * m_out (bf16) in dyb and scratch
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
    warp_ln_bwd(v, d, a.lnb_w, per, D, rstd, gw, gb);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        r[row * D + c] = d[i];
        float dyv = d[i];
        if (kDrop) dyv *= keep_scale(a.drop, a.mask_out, (row0 + row) * D + c);
        const bf16 b = tob(dyv);
        dyb[row * ld + c] = b;
        if (row < nrow) a.dy[(row0 + row) * D + c] = b;
      }
  }
  block_partials(gw, gb, per, D, cf, lnb_part);  // cf: y is consumed

  // da = (dy W2) * m_hid * act'(a), a recomputed per 128-column step; da
  // (bf16) replaces gd in hid and goes to scratch
  for (int n0 = 0; n0 < F; n0 += kBC) {
    block_gemm(xb, ld, a.w1 + (size_t)n0 * D, D, D, kBC, cf, ldc, false, ws);
    block_gemm_nn(dyb, ld, a.w2 + n0, F, D, kBC, cf2, ldc2, false, ws);
    for (int i = tid; i < kRows * kBC; i += blockDim.x) {
      const int row = i / kBC, c = i % kBC;
      const float av = cf[row * ldc + c] + ldgf(a.b1 + n0 + c);
      float dav = cf2[row * ldc2 + c] * act_grad(av, a.act);
      if (kDrop)
        dav *= keep_scale(a.drop, a.mask_hid, (row0 + row) * F + n0 + c);
      const bf16 b = tob(dav);
      hid[row * ldh + n0 + c] = b;
      if (row < nrow) a.da[(row0 + row) * F + n0 + c] = b;
    }
    __syncthreads();
  }

  // dh = ds + da W1
  block_gemm_nn(hid, ldh, a.w1, D, F, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x)
    r[i] += cf[(i / D) * ldc + i % D];
  __syncthreads();
}

}  // namespace ladiff
