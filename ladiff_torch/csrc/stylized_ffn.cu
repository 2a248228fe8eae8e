// Kernel 6: the MD layer's stylized FFN at inference (replaces
// ladiff_tpu/ops/pallas_fused_ffn.py fused_stylized_ffn).  See
// ladiff_torch/ops/stylized_ffn.py for the math, the bound and the design.
//
// K1's cluster body (md_body_cluster.cuh) on the segment alone: one cluster
// of C = D / 64 CTAs per row group of at most 96 rows, the groups sized so
// that the clusters fill the card once.  The rows come in as md_start loads
// them (every CTA all D columns as the A operand, the CTA's columns as the
// f32 residual in registers), then md_stylized_ffn: the GELU FFN with its
// hidden width split over the cluster, + b2, the LayerNorm over the
// cluster, AdaLN, SiLU and the projection + residual.  The weights stream
// through the body's ring from kernel 6's own segment table (md_seg with
// ffn_only: w1 and w2 by hidden chunk, then w3).
#include "md_body_cluster.cuh"

using namespace ladiff;

namespace {

__global__ void __launch_bounds__(kCThreads, 1)
stylized_ffn_kernel(const __grid_constant__ MDClusterArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MDCta m = md_cta(smem, a);
  MDStream s;
  float r[kCMT][2][4];
  md_start(r, s, a, m);
  md_stylized_ffn(r, s, a, m, 0, a.ffn_ss, a.ffn_stride, m.row0, a.ss_t);
  const CLane t = clane();
  bf16* out = a.out + m.row0 * a.D + m.c * kCW;
#pragma unroll
  for (int i = 0; i < kCMT; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = crow(t, i, hf);
        if (ctile(t, i) < m.ml && row < m.nrow)
          st2(out + (size_t)row * a.D + ccol(t, nt), r[i][nt][2 * hf],
              r[i][nt][2 * hf + 1]);
      }
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D], ss [1 or M / T, 2D], w1 [F, D], b1, w2 [D, F], b2, ln_w,
// ln_b, w3 [D, D], b3, out [M, D] (all bf16).  ints: M, D, F, T, ss_stride,
// then the launch geometry (ops/stylized_ffn.py stylized_ffn_geometry):
// rows per group, row groups, cluster size.
extern "C" int stylized_ffn_forward(const void** p, const int* n,
                                    const float*, void* stream) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  MDClusterArgs a = {};
  a.x = w[0];
  a.ffn_ss = w[1];
  for (int k = 0; k < 8; ++k) a.w[16 + k] = w[2 + k];
  a.out = const_cast<bf16*>(w[10]);
  a.B = n[0];  // rows, grouped as samples of one row
  a.T = 1;
  a.D = n[1];
  a.F1 = a.F2 = n[2];
  a.ss_t = n[3];
  a.ffn_stride = n[4];
  a.spg = n[5];
  a.groups = n[6];
  a.C = n[7];
  a.L = 1;
  a.ffn_only = 1;
  static SmemGrant grant;
  return md_cluster_launch(stylized_ffn_kernel, a, grant,
                           static_cast<cudaStream_t>(stream));
}

// Clusters of D / 64 CTAs of this kernel that can be resident at once at
// width D and FFN width F1 = F2 (0 when the query fails).
extern "C" int stylized_ffn_slots(int D, int F1, int F2) {
  static SmemGrant grant;
  return md_cluster_slots(stylized_ffn_kernel, D, F1, F2, grant);
}
