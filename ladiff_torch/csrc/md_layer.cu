// Kernel K1: one whole MD-trans denoiser layer per launch (replaces
// ladiff_tpu/ops/pallas_md_layer.py fused_md_layer).  See
// ladiff_torch/ops/md_layer.py for the math, the bound and the design; the
// layer body is md_body_cluster.cuh's, shared with kernel 11 (md_stack.cu):
// one cluster of D / 64 CTAs per row group of whole samples.
#include "md_body_cluster.cuh"

using namespace ladiff;

namespace {

__global__ void __launch_bounds__(kCThreads, 1)
md_layer_kernel(const __grid_constant__ MDClusterArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MDCta m = md_cta(smem, a);
  MDStream s;
  float r[kCMT][2][4];
  md_start(r, s, a, m);
  const CLane t = clane();
  bf16* out = a.out + m.row0 * a.D + m.c * kCW;
  md_layer_cl(r, s, a, m, 0, a.value + (size_t)m.s0 * a.D,
              a.ca_ss + (size_t)m.s0 * a.ca_stride, a.ca_stride,
              a.ffn_ss + (size_t)m.s0 * a.ffn_stride, a.ffn_stride,
              [&](const float (&v)[kCMT][2][4]) {
#pragma unroll
                for (int i = 0; i < kCMT; ++i)
#pragma unroll
                  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                      const int row = crow(t, i, hf);
                      if (ctile(t, i) < m.ml && row < m.nrow)
                        st2(out + (size_t)row * a.D + ccol(t, nt),
                            v[i][nt][2 * hf], v[i][nt][2 * hf + 1]);
                    }
              });
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x, extra, kvalid, value, ca_ss, ffn_ss, 24 weights (see
// ops/md_layer.py _PARAM_ORDER), out.  ints: B, T, E, D, H, F1, F2,
// ca_stride, ffn_stride, then the launch geometry (ops/md_layer.py
// md_geometry): samples per row group, row groups, cluster size.
extern "C" int md_layer_forward(const void** p, const int* n, const float*,
                                void* stream) {
  MDClusterArgs a = {};
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
  a.F2 = n[6]; a.ca_stride = n[7]; a.ffn_stride = n[8]; a.spg = n[9];
  a.groups = n[10]; a.C = n[11];
  a.L = 1;
  static SmemGrant grant;
  return md_cluster_launch(md_layer_kernel, a, grant,
                           static_cast<cudaStream_t>(stream));
}

// Clusters of D / 64 CTAs of this kernel that can be resident at once at
// width D and FFN widths F1, F2 (0 when the query fails).
extern "C" int md_layer_slots(int D, int F1, int F2) {
  static SmemGrant grant;
  return md_cluster_slots(md_layer_kernel, D, F1, F2, grant);
}
