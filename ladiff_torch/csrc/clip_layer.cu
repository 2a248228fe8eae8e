// Kernels K3 and K4: the two halves of a CLIP text layer around its causal
// attention core (replace ladiff_tpu/ops/pallas_clip_layer.py fused_ln_qkv
// and fused_proj_mlp).  See ladiff_torch/ops/clip_layer.py for the math, the
// bound and the design.
#include "common.cuh"

using namespace ladiff;

namespace {

// K3: one block per (32-row block, output matrix q | k | v).  LN1 in f32,
// kept in shared memory as the bf16 A operand; out = (y W^T + b) * scale.
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const bf16* x, const bf16* wq, const bf16* bq, const bf16* wk,
              const bf16* bk, const bf16* wv, const bf16* bv,
              const bf16* ln_w, const bf16* ln_b, bf16* q, bf16* k, bf16* v,
              int M, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = D + 8, ldc = kChunk + 4;
  bf16* xb = reinterpret_cast<bf16*>(smem);
  float* cf = reinterpret_cast<float*>(smem + align128(kRows * ld * sizeof(bf16)));
  bf16* ws = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(cf) + kRows * ldc * sizeof(float));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));
  const int per = D / 32;
  for (int row = warp; row < kRows; row += blockDim.x >> 5) {
    float vals[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per)
        vals[i] = row < nrow ? ldgf(x + (row0 + row) * D + lane + 32 * i) : 0.f;
    warp_layernorm(vals, D, ln_w, ln_b);
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per) xb[row * ld + lane + 32 * i] = tob(vals[i]);
  }
  __syncthreads();
  const int which = blockIdx.y;
  const bf16* W = which == 0 ? wq : (which == 1 ? wk : wv);
  const bf16* bias = which == 0 ? bq : (which == 1 ? bk : bv);
  bf16* out = which == 0 ? q : (which == 1 ? k : v);
  const float sc = which == 0 ? scale : 1.f;
  for (int n0 = 0; n0 < D; n0 += kChunk) {
    const int nc = min(kChunk, D - n0);
    block_gemm(xb, ld, W + (size_t)n0 * D, D, D, nc, cf, ldc, false, ws);
    for (int i = threadIdx.x; i < nrow * nc; i += blockDim.x) {
      const int row = i / nc, c = i % nc;
      out[(row0 + row) * D + n0 + c] =
          tob((cf[row * ldc + c] + ldgf(bias + n0 + c)) * sc);
    }
    __syncthreads();
  }
}

struct MlpLayout {
  size_t xb, acc, cf, hid, ws, total;
};

inline MlpLayout mlp_layout(int D) {
  MlpLayout L;
  L.xb = 0;
  L.acc = align128(kRows * (D + 8) * sizeof(bf16));
  L.cf = align128(L.acc + kRows * (D + 4) * sizeof(float));
  L.hid = align128(L.cf + kRows * (kChunk + 4) * sizeof(float));
  L.ws = align128(L.hid + kRows * (kChunk + 8) * sizeof(bf16));
  L.total = align128(L.ws + kWStageBytes);
  return L;
}

// K4: one block per 32 rows.  acc (f32, shared memory) holds
// h = x + att Wo^T + bo and then accumulates fc2 over 256-wide chunks of
// the MLP width: chunk = quick_gelu(LN2(h) W1[c]^T + b1[c]) (bf16),
// acc += chunk W2[:, c]^T.
__global__ void __launch_bounds__(kThreads)
proj_mlp_kernel(const bf16* att, const bf16* x, const bf16* wo,
                const bf16* bo, const bf16* w1, const bf16* b1,
                const bf16* w2, const bf16* b2, const bf16* ln_w,
                const bf16* ln_b, bf16* out, int M, int D, int F,
                MlpLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = D + 8, lda = D + 4, ldc = kChunk + 4, ldh = kChunk + 8;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));

  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    xb[row * ld + c] = row < nrow ? ldg(att + (row0 + row) * D + c) : tob(0.f);
  }
  __syncthreads();
  block_gemm(xb, ld, wo, D, D, D, acc, lda, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const float xv = row < nrow ? ldgf(x + (row0 + row) * D + c) : 0.f;
    acc[row * lda + c] += ldgf(bo + c) + xv;
  }
  __syncthreads();
  block_layernorm_rows(acc, lda, nullptr, 0, xb, ld, D, ln_w, ln_b);
  __syncthreads();
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int fc = min(kChunk, F - f0);
    block_gemm(xb, ld, w1 + (size_t)f0 * D, D, D, fc, cf, ldc, false, ws);
    for (int i = tid; i < kRows * fc; i += blockDim.x) {
      const int row = i / fc, c = i % fc;
      hid[row * ldh + c] = tob(quick_gelu(cf[row * ldc + c] + ldgf(b1 + f0 + c)));
    }
    __syncthreads();
    block_gemm(hid, ldh, w2 + f0, F, fc, D, acc, lda, true, ws);
  }
  for (int i = tid; i < nrow * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    out[(row0 + row) * D + c] = tob(acc[row * lda + c] + ldgf(b2 + c));
  }
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x, wq, bq, wk, bk, wv, bv, ln_w, ln_b, q, k, v.  ints: M, D.
// floats: scale (folded into q).
extern "C" int ln_qkv_forward(const void** p, const int* n, const float* f,
                              void* stream) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int M = n[0], D = n[1];
  if (D % 32 || D > 32 * kMaxPer) return cudaErrorInvalidValue;
  const size_t bytes = align128(kRows * (D + 8) * sizeof(bf16)) +
                       kRows * (kChunk + 4) * sizeof(float) + kWStageBytes;
  static SmemGrant grant;
  if (!allow_smem(ln_qkv_kernel, bytes, grant)) return cudaErrorInvalidValue;
  ln_qkv_kernel<<<dim3((M + kRows - 1) / kRows, 3), kThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8],
      const_cast<bf16*>(w[9]), const_cast<bf16*>(w[10]),
      const_cast<bf16*>(w[11]), M, D, f[0]);
  return cudaGetLastError();
}

// ptrs: att, x, wo, bo, w1, b1, w2, b2, ln_w, ln_b, out.  ints: M, D, F.
extern "C" int proj_mlp_forward(const void** p, const int* n, const float*,
                                void* stream) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int M = n[0], D = n[1], F = n[2];
  if (D % 32 || D > 32 * kMaxPer || F % kKT) return cudaErrorInvalidValue;
  const MlpLayout L = mlp_layout(D);
  static SmemGrant grant;
  if (!allow_smem(proj_mlp_kernel, L.total, grant)) return cudaErrorInvalidValue;
  proj_mlp_kernel<<<(M + kRows - 1) / kRows, kThreads, L.total,
                    static_cast<cudaStream_t>(stream)>>>(
      w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9],
      const_cast<bf16*>(w[10]), M, D, F, L);
  return cudaGetLastError();
}
