// Kernel K1: one whole MD-trans denoiser layer per launch (replaces
// ladiff_tpu/ops/pallas_md_layer.py fused_md_layer).  See
// ladiff_torch/ops/md_layer.py for the math, the bound and the design; the
// layer body is md_layer_body.cuh's, shared with kernel 11 (md_stack.cu).
#include "md_layer_body.cuh"

using namespace ladiff;

namespace {

struct MDArgs {
  const bf16* x;
  const bf16* extra;
  const float* kvalid;
  const bf16* value;
  const bf16* ca_ss;
  const bf16* ffn_ss;
  const bf16* w[kMDParams];
  bf16* out;
  int B, T, E, D, H, F1, F2, ca_stride, ffn_stride, spb;
};

__global__ void __launch_bounds__(kThreads) md_layer_kernel(MDArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D;
  const MDSmem m = md_smem(smem, D, a.F1, a.F2);
  const int s0 = blockIdx.x * a.spb;
  const int ns = min(a.spb, a.B - s0);
  const int nrow = ns * a.T;
  const size_t row0 = (size_t)s0 * a.T;
  md_load_rows(m, a.x + row0 * D, a.extra + (size_t)s0 * a.E * D, D, nrow,
               ns * a.E);
  bf16* out = a.out + row0 * D;
  md_layer_body(md_weights(a.w, 0, D, a.F1, a.F2), m, D, a.T, a.E, a.H,
                a.F1, a.F2, ns, a.kvalid + row0, a.value + (size_t)s0 * D,
                a.ca_ss + (size_t)s0 * a.ca_stride, a.ca_stride,
                a.ffn_ss + (size_t)s0 * a.ffn_stride, a.ffn_stride,
                [&](int i, float v) {
                  if (i < nrow * D) out[i] = tob(v);
                });
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x, extra, kvalid, value, ca_ss, ffn_ss, 24 weights (see
// ops/md_layer.py _PARAM_ORDER), out.  ints: B, T, E, D, H, F1, F2,
// ca_stride, ffn_stride.
extern "C" int md_layer_forward(const void** p, const int* n, const float*,
                                void* stream) {
  MDArgs a;
  const bf16** w = reinterpret_cast<const bf16**>(p);
  a.x = w[0];
  a.extra = w[1];
  a.kvalid = reinterpret_cast<const float*>(p[2]);
  a.value = w[3];
  a.ca_ss = w[4];
  a.ffn_ss = w[5];
  for (int k = 0; k < kMDParams; ++k) a.w[k] = w[6 + k];
  a.out = const_cast<bf16*>(w[6 + kMDParams]);
  a.B = n[0]; a.T = n[1]; a.E = n[2]; a.D = n[3]; a.H = n[4]; a.F1 = n[5];
  a.F2 = n[6]; a.ca_stride = n[7]; a.ffn_stride = n[8];
  if (a.T < 1 || a.E < 1 || a.T > kRows || a.E > kRows || a.D > kChunk ||
      a.D % 32 || a.F1 % kKT || a.F2 % kKT)
    return cudaErrorInvalidValue;
  a.spb = md_samples_per_block(a.T, a.E);
  const size_t bytes = md_layout(a.D, a.F1, a.F2).total;
  static SmemGrant grant;
  if (!allow_smem(md_layer_kernel, bytes, grant)) return cudaErrorInvalidValue;
  const int grid = (a.B + a.spb - 1) / a.spb;
  md_layer_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
