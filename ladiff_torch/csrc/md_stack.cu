// Kernel 11: the whole MD-trans skip stack per launch: L layers in U-Net
// order with the skip Linears between them, then the final LayerNorm
// (replaces ladiff_tpu/ops/pallas_md_stack.py fused_md_stack).  See
// ladiff_torch/ops/md_stack.py for the math, the bound and the design.
//
// One cluster of D / 64 CTAs owns a row group of whole samples for the
// whole stack: samples never interact, so the layers follow each other in
// the cluster with no grid-wide sync.  Each layer is md_body_cluster.cuh's
// (the body of K1), its weight slices streaming on from one layer into the
// next; its output is rounded to bf16 at the layer boundary, as the
// per-layer path rounds it, and padding rows stay zero.  The (L - 1) / 2
// skip activations go to a global scratch [nb, B T, D] in which each CTA
// writes its own 64 columns and reads them back (plain loads: the data is
// written during the launch, so not through the read-only path); the rows
// stay in L2.  A skip Linear [x, skip] [rows, 2D] x [2D, D] is split on its
// output columns like any other product: the CTAs exchange their skip
// columns, then K = 2D runs over x in xa and the skip rows.
#include "md_body_cluster.cuh"

using namespace ladiff;

namespace {

__global__ void __launch_bounds__(kCThreads, 1)
md_stack_kernel(const __grid_constant__ MDClusterArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MDCta m = md_cta(smem, a);
  const CLane t = clane();
  const int D = a.D, nb = (a.L - 1) / 2, nk = D / kCKT;
  const size_t BT = (size_t)a.B * a.T;
  const unsigned lat = (1u << m.ml) - 1u;
  MDStream s;
  float r[kCMT][2][4];
  md_start(r, s, a, m);

  // the layer boundary: v rounded to bf16, the next layer's residual and (in
  // every CTA) its A operand; padding rows stay zero
  auto to_rows = [&](float (&v)[kCMT][2][4]) {
#pragma unroll
    for (int i = 0; i < kCMT; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bool in = ctile(t, i) < m.ml && crow(t, i, hf) < m.nrow;
#pragma unroll
          for (int b = 0; b < 2; ++b)
            r[i][nt][2 * hf + b] = in ? tof(tob(v[i][nt][2 * hf + b])) : 0.f;
        }
  };

  for (int l = 0; l < a.L; ++l) {
    // the extra rows again: the FFN partials overwrote them
    if (l > 0) md_load_extra<false>(a, m);
    if (l > nb) {  // output block: pop a skip, Linear(2D -> D) of [x, skip]
      const int j = l - nb - 1;
      const bf16* skip = a.skips + (size_t)(nb - 1 - j) * BT * D +
                         m.row0 * D + m.c * kCW;
      for (int v = threadIdx.x; v < 16 * m.ml * (kCW / 8); v += kCThreads) {
        const int row = v / (kCW / 8), cc = (v % (kCW / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < m.nrow)
          val = *reinterpret_cast<const uint4*>(skip + (size_t)row * D + cc);
        *reinterpret_cast<uint4*>(m.big + row * m.ld + m.c * kCW + cc) = val;
      }
      push_slice(m.big, m);
      float acc[kCMT][2][4];
      czero(acc);
      cgemm<kCMT>(acc, m.xa, m.big, m.xa, m.ld, 2 * nk, nk, lat, s, a, m);
      cluster_arrive();  // this CTA has read x in xa
      float v[kCMT][2][4];
      czero(v);
      add_biased(v, acc, a.lin_b + (size_t)j * D, m.c);
      to_rows(v);
      cluster_wait();  // every CTA has: the new x may overwrite it
      store_slice(r, m.xa, m);
      push_slice(m.xa, m);
    }
    md_layer_cl(r, s, a, m, l, a.value + ((size_t)l * a.B + m.s0) * D,
                a.ca_ss + (size_t)l * 2 * D, 0,
                a.ffn_ss + (size_t)l * 2 * D, 0,
                [&](float (&v)[kCMT][2][4]) {
                  to_rows(v);
                  if (l < nb) {  // input block: push a skip
                    bf16* skip = a.skips + (size_t)l * BT * D + m.row0 * D +
                                 m.c * kCW;
#pragma unroll
                    for (int i = 0; i < kCMT; ++i)
#pragma unroll
                      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                          const int row = crow(t, i, hf);
                          if (ctile(t, i) < m.ml && row < m.nrow)
                            st2(skip + (size_t)row * D + ccol(t, nt),
                                r[i][nt][2 * hf], r[i][nt][2 * hf + 1]);
                        }
                  }
                  if (l + 1 < a.L) {
                    store_slice(r, m.xa, m);
                    push_slice(m.xa, m);
                  }
                });
  }

  // final LayerNorm
  cluster_ln(r, m, a.norm_w, a.norm_b);
  bf16* out = a.out + m.row0 * D + m.c * kCW;
#pragma unroll
  for (int i = 0; i < kCMT; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = crow(t, i, hf);
        if (ctile(t, i) < m.ml && row < m.nrow)
          st2(out + (size_t)row * D + ccol(t, nt), r[i][nt][2 * hf],
              r[i][nt][2 * hf + 1]);
      }
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x, extra, kvalid, values, ca_ss, ffn_ss, 24 stacked weights (see
// ops/md_layer.py _PARAM_ORDER), lin_w, lin_b, norm_w, norm_b, skips, out.
// ints: B, T, E, D, H, F1, F2, L, then the launch geometry
// (ops/md_layer.py md_geometry): samples per row group, row groups,
// cluster size.
extern "C" int md_stack_forward(const void** p, const int* n, const float*,
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
  const bf16** q = w + 6 + kMDParams;
  a.lin_w = q[0]; a.lin_b = q[1]; a.norm_w = q[2]; a.norm_b = q[3];
  a.skips = const_cast<bf16*>(q[4]);
  a.out = const_cast<bf16*>(q[5]);
  a.B = n[0]; a.T = n[1]; a.E = n[2]; a.D = n[3]; a.H = n[4]; a.F1 = n[5];
  a.F2 = n[6]; a.L = n[7]; a.spg = n[8]; a.groups = n[9]; a.C = n[10];
  static SmemGrant grant;
  return md_cluster_launch(md_stack_kernel, a, grant,
                           static_cast<cudaStream_t>(stream));
}

// Clusters of D / 64 CTAs of this kernel that can be resident at once at
// width D and FFN widths F1, F2 (0 when the query fails).
extern "C" int md_stack_slots(int D, int F1, int F2) {
  static SmemGrant grant;
  return md_cluster_slots(md_stack_kernel, D, F1, F2, grant);
}
