// Kernel 6: the MD layer's stylized FFN at inference (replaces
// ladiff_tpu/ops/pallas_fused_ffn.py fused_stylized_ffn).  See
// ladiff_torch/ops/stylized_ffn.py for the math, the bound and the design.
//
// One block per 32 rows: x rows into shared memory (bf16 A operand and f32
// residual), the GELU FFN in 256-column chunks of the hidden width (the
// hidden row block stays in shared memory), then per row by one warp: + b2
// -> LayerNorm -> AdaLN (scale, shift of the row's sample) -> SiLU, and the
// out-projection + residual.  The row segment is md_rows.cuh
// stylize_rows.
#include "common.cuh"
#include "md_rows.cuh"

using namespace ladiff;

namespace {

// Shared memory of a 32-row block: x rows (bf16), a product chunk (f32),
// the f32 residual rows, the hidden row block (bf16) and the weight stage.
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

struct SFArgs {
  const bf16 *x, *ss, *w1, *b1, *w2, *b2, *ln_w, *ln_b, *w3, *b3;
  bf16* out;
  int M, D, F, T, ss_stride;
};

__global__ void __launch_bounds__(kThreads)
stylized_ffn_kernel(SFArgs a, FfnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8, ldc = kChunk + 4, ldh = a.F + 8;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* r = reinterpret_cast<float*>(smem + L.r);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrow = min(kRows, a.M - row0);
  const size_t base = (size_t)row0 * D;

  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const bf16 xv = row < nrow ? ldg(a.x + base + i) : tob(0.f);
    xb[row * ld + c] = xv;
    r[i] = tof(xv);
  }
  __syncthreads();
  block_ffn(xb, ld, D, a.w1, a.b1, a.w2, a.F, 1, hid, ldh, cf, ldc, ws);
  stylize_rows(cf, ldc, a.b2, xb, ld, D, a.T, row0, a.M / a.T - 1, a.ss,
               a.ss_stride, a.ln_w, a.ln_b);
  __syncthreads();
  block_gemm(xb, ld, a.w3, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < nrow * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    a.out[base + i] = tob(r[i] + cf[row * ldc + c] + ldgf(a.b3 + c));
  }
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D], ss [1 or M / T, 2D], w1 [F, D], b1, w2 [D, F], b2, ln_w,
// ln_b, w3 [D, D], b3, out [M, D] (all bf16).  ints: M, D, F, T, ss_stride.
extern "C" int stylized_ffn_forward(const void** p, const int* n,
                                    const float*, void* stream) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  SFArgs a;
  a.x = w[0]; a.ss = w[1]; a.w1 = w[2]; a.b1 = w[3]; a.w2 = w[4];
  a.b2 = w[5]; a.ln_w = w[6]; a.ln_b = w[7]; a.w3 = w[8]; a.b3 = w[9];
  a.out = const_cast<bf16*>(w[10]);
  a.M = n[0]; a.D = n[1]; a.F = n[2]; a.T = n[3]; a.ss_stride = n[4];
  if (a.M < 1 || a.T < 1 || a.M % a.T || a.D % 32 || a.D > kChunk ||
      a.F % kKT)
    return cudaErrorInvalidValue;
  const FfnLayout L = ffn_layout(a.D, a.F);
  static SmemGrant grant;
  if (!allow_smem(stylized_ffn_kernel, L.total, grant))
    return cudaErrorInvalidValue;
  stylized_ffn_kernel<<<(a.M + kRows - 1) / kRows, kThreads, L.total,
                        static_cast<cudaStream_t>(stream)>>>(a, L);
  return cudaGetLastError();
}
