// The post-norm FFN tail of a transformer layer for one 32-row block, shared
// by kernel 5 (postnorm_ffn.cu, inference), kernel 9's forward
// (train_ffn.cu, with dropout) and kernel 6 (stylized_ffn.cu, its layout):
//   h = LN1(x);  gd = act(h W1^T + b1) * m1;  out = LN2(h + (gd W2^T + b2) * m2)
// Rounding points as in the TPU kernels: h and gd are rounded to bf16 before
// their products, everything else (LayerNorms, bias, activation, residual)
// is float32.
#pragma once

#include "common.cuh"

namespace ladiff {

struct FfnArgs {
  const bf16* x;
  const bf16 *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
  bf16* out;
  int M, D, F, act;
  Dropout drop;
};

struct FfnLayout {
  size_t xb, cf, r, hid, ws, total;
};

inline FfnLayout ffn_layout(int D, int F) {
  FfnLayout L;
  L.xb = 0;
  L.cf = align128(L.xb + kRows * (D + 8) * sizeof(bf16));
  L.r = align128(L.cf + kRows * (kChunk + 4) * sizeof(float));
  L.hid = align128(L.r + kRows * D * sizeof(float));
  L.ws = align128(L.hid + kRows * (F + 8) * sizeof(bf16));
  L.total = align128(L.ws + kWStageBytes);
  return L;
}

// hid[32 x F] = bf16(act(xb W1^T + b1) * mask mask_id) in 256-column chunks
// (act: 0 relu, 1 erf GELU), for rows row0 .. of the batch.  Ends
// synchronized.
template <bool kDrop>
__device__ __forceinline__ void ffn_hidden(const bf16* xb, int ld, int D,
                                           const bf16* w1, const bf16* b1,
                                           int F, int act, size_t row0,
                                           const Dropout& drop, bf16* hid,
                                           int ldh, float* cf, int ldc,
                                           bf16* ws, uint32_t mask_id = 0u) {
  for (int n0 = 0; n0 < F; n0 += kChunk) {
    const int nc = F - n0 < kChunk ? F - n0 : kChunk;
    block_gemm(xb, ld, w1 + (size_t)n0 * D, D, D, nc, cf, ldc, false, ws);
    for (int i = threadIdx.x; i < kRows * nc; i += blockDim.x) {
      const int row = i / nc, c = i % nc;
      const float v = cf[row * ldc + c] + ldgf(b1 + n0 + c);
      float g = act ? gelu_erf(v) : fmaxf(v, 0.f);
      if (kDrop) g *= keep_scale(drop, mask_id, (row0 + row) * F + n0 + c);
      hid[row * ldh + n0 + c] = tob(g);
    }
    __syncthreads();
  }
}

// The tail of the block's 32 rows whose input (the residual sum, f32, zero
// rows past the end) the caller has put in the layout's r buffer: h = LN1(r),
// the FFN with dropout masks mask_hid / mask_out, LN2, out rows < nrow.
template <bool kDrop>
__device__ __forceinline__ void ffn_tail_rows(const FfnArgs& a,
                                              const FfnLayout& L,
                                              unsigned char* smem,
                                              size_t row0, int nrow,
                                              uint32_t mask_hid,
                                              uint32_t mask_out) {
  const int D = a.D, ld = D + 8, ldc = kChunk + 4, ldh = a.F + 8;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* r = reinterpret_cast<float*>(smem + L.r);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int tid = threadIdx.x;
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln1_w, a.ln1_b);
  __syncthreads();
  ffn_hidden<kDrop>(xb, ld, D, a.w1, a.b1, a.F, a.act, row0, a.drop, hid, ldh,
                    cf, ldc, ws, mask_hid);
  block_gemm(hid, ldh, a.w2, a.F, a.F, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float y = cf[row * ldc + c] + ldgf(a.b2 + c);
    if (kDrop) y *= keep_scale(a.drop, mask_out, (row0 + row) * D + c);
    r[i] += y;
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln2_w, a.ln2_b);
  __syncthreads();
  for (int i = tid; i < nrow * D; i += blockDim.x)
    a.out[row0 * D + i] = tob(r[i]);
}

template <bool kDrop>
__device__ __forceinline__ void ffn_tail_forward(const FfnArgs& a,
                                                 const FfnLayout& L,
                                                 unsigned char* smem) {
  float* r = reinterpret_cast<float*>(smem + L.r);
  const int D = a.D;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(a.M - row0));
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int row = i / D;
    r[i] = row < nrow ? ldgf(a.x + row0 * D + i) : 0.f;
  }
  __syncthreads();
  ffn_tail_rows<kDrop>(a, L, smem, row0, nrow, 0u, 1u);
}

}  // namespace ladiff
