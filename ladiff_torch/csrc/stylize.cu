// Kernel 7: the MD layer's one-token cross-attention block at inference
// (replaces ladiff_tpu/ops/pallas_stylize.py fused_broadcast_stylize).  See
// ladiff_torch/ops/stylize.py for the math, the bound and the design.
//
// One block per 32 rows.  Per row by one warp: the row's sample value row x
// the row's mask -> LayerNorm -> AdaLN (scale, shift of the row's sample)
// -> SiLU into a bf16 row block in shared memory; then the projection, and
// out = x + proj + b with x read once from global memory.  The row segment
// is md_rows.cuh ca_rows.
#include "md_rows.cuh"

using namespace ladiff;

namespace {

struct StylizeArgs {
  const bf16 *x, *value;
  const float* mask;
  const bf16 *ss, *ln_w, *ln_b, *w, *b;
  bf16* out;
  int M, D, T, ss_stride;
};

struct StylizeLayout {
  size_t xb, cf, ws, total;
};

inline StylizeLayout stylize_layout(int D) {
  StylizeLayout L;
  L.xb = 0;
  L.cf = align128(L.xb + kRows * (D + 8) * sizeof(bf16));
  L.ws = align128(L.cf + kRows * (kChunk + 4) * sizeof(float));
  L.total = align128(L.ws + kWStageBytes);
  return L;
}

__global__ void __launch_bounds__(kThreads)
stylize_kernel(StylizeArgs a, StylizeLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8, ldc = kChunk + 4;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int row0 = blockIdx.x * kRows;
  const int nrow = min(kRows, a.M - row0);
  ca_rows(xb, ld, D, a.T, row0, nrow, a.M / a.T - 1, a.mask + row0, a.value,
          a.ss, a.ss_stride, a.ln_w, a.ln_b);
  block_gemm(xb, ld, a.w, D, D, D, cf, ldc, false, ws);
  const size_t base = (size_t)row0 * D;
  for (int i = threadIdx.x; i < nrow * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    a.out[base + i] =
        tob(ldgf(a.x + base + i) + cf[row * ldc + c] + ldgf(a.b + c));
  }
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D], value [M / T, D], mask [M] (f32), ss [1 or M / T, 2D],
// ln_w, ln_b, w [D, D], b, out [M, D] (bf16 unless noted).  ints: M, D, T,
// ss_stride.
extern "C" int stylize_forward(const void** p, const int* n, const float*,
                               void* stream) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  StylizeArgs a;
  a.x = w[0]; a.value = w[1];
  a.mask = reinterpret_cast<const float*>(p[2]);
  a.ss = w[3]; a.ln_w = w[4]; a.ln_b = w[5]; a.w = w[6]; a.b = w[7];
  a.out = const_cast<bf16*>(w[8]);
  a.M = n[0]; a.D = n[1]; a.T = n[2]; a.ss_stride = n[3];
  if (a.M < 1 || a.T < 1 || a.M % a.T || a.D % 32 || a.D > kChunk)
    return cudaErrorInvalidValue;
  const StylizeLayout L = stylize_layout(a.D);
  static SmemGrant grant;
  if (!allow_smem(stylize_kernel, L.total, grant))
    return cudaErrorInvalidValue;
  stylize_kernel<<<(a.M + kRows - 1) / kRows, kThreads, L.total,
                   static_cast<cudaStream_t>(stream)>>>(a, L);
  return cudaGetLastError();
}
