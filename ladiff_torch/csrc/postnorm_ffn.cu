// Kernel 5: the post-norm FFN tail of a transformer layer at inference
// (replaces ladiff_tpu/ops/pallas_postnorm_ffn.py fused_postnorm_ffn).  See
// ladiff_torch/ops/postnorm_ffn.py for the math and the bound; the body is
// ffn_tail.cuh's, without dropout.  One block per 32 rows.
#include "ffn_tail.cuh"

using namespace ladiff;

namespace {

__global__ void __launch_bounds__(kThreads)
postnorm_ffn_kernel(FfnArgs a, FfnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  ffn_tail_forward<false>(a, L, smem);
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D], ln1_w, ln1_b, w1 [F, D], b1, w2 [D, F], b2, ln2_w, ln2_b,
// out [M, D] (all bf16).  ints: M, D, F, act (0 relu, 1 gelu).
extern "C" int postnorm_ffn_forward(const void** p, const int* n,
                                    const float*, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  FfnArgs a;
  a.x = w[0];
  a.ln1_w = w[1]; a.ln1_b = w[2]; a.w1 = w[3]; a.b1 = w[4];
  a.w2 = w[5]; a.b2 = w[6]; a.ln2_w = w[7]; a.ln2_b = w[8];
  a.out = const_cast<bf16*>(w[9]);
  a.M = n[0]; a.D = n[1]; a.F = n[2]; a.act = n[3];
  a.drop = make_dropout(0, 0, 0.f);
  if (a.M < 1 || a.D % 32 || a.D > kChunk || a.F % kKT)
    return cudaErrorInvalidValue;
  const FfnLayout L = ffn_layout(a.D, a.F);
  static SmemGrant grant;
  if (!allow_smem(postnorm_ffn_kernel, L.total, grant))
    return cudaErrorInvalidValue;
  postnorm_ffn_kernel<<<(a.M + kRows - 1) / kRows, kThreads, L.total,
                        static_cast<cudaStream_t>(stream_ptr)>>>(a, L);
  return cudaGetLastError();
}
