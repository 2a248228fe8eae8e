// Kernel 7: the MD layer's one-token cross-attention block at inference
// (replaces ladiff_tpu/ops/pallas_stylize.py fused_broadcast_stylize).  See
// ladiff_torch/ops/stylize.py for the math, the bound and the design.
//
// K1's cluster body (md_body_cluster.cuh) on its cross-attention segment
// alone: one cluster of C = D / 64 CTAs per row group of at most 96
// consecutive rows, the groups sized so that the clusters fill the card
// once; a group need not hold whole samples.  CTA c reads its 64 columns of
// x straight into the f32 residual registers (x is not a product operand),
// builds the AdaLN -> SiLU rows of its columns (md_value_stats, md_ca_rows),
// sends them to its peers over distributed shared memory, and runs its 64
// output columns of the projection (md_ca_project) from kernel 7's own
// segment table (md_seg with ca_only: the projection's D / 64 slices)
// through the body's ring.
#include "md_body_cluster.cuh"

using namespace ladiff;

namespace {

// Two CTAs an SM: kernel 7's layout is 90 KB at D 256 (md_ca_layout).
__global__ void __launch_bounds__(kCThreads, 2)
stylize_kernel(const __grid_constant__ MDClusterArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MDCta m = md_cta(smem, a, md_ca_layout(a.D));
  const CLane t = clane();
  const int D = a.D, T = a.ss_t, off = (int)(m.row0 % T);
  const size_t s0 = m.row0 / T;  // the group's first sample
  // x's loads issue first; they are read at the end
  float r[kCMT][2][4];
  const bf16* x = a.x + m.row0 * D + m.c * kCW;
#pragma unroll
  for (int i = 0; i < kCMT; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = crow(t, i, hf);
        float2 v = make_float2(0.f, 0.f);
        if (ctile(t, i) < m.ml && row < m.nrow)
          v = ldg2(x + (size_t)row * D + ccol(t, nt));
        r[i][nt][2 * hf] = v.x;
        r[i][nt][2 * hf + 1] = v.y;
      }
  MDStream s;
  stream_start(s, a, m);
  cluster_arrive();  // this CTA runs: its peers may write into it
  for (int row = threadIdx.x; row < kCRows; row += kCThreads)
    m.kvs[row] = row < m.nrow ? ldgf(a.kvalid + m.row0 + row) : 0.f;
  const bf16* value = a.value + s0 * D;
  const bf16* ss = a.ca_ss + s0 * a.ca_stride;
  md_value_stats(m, value, (off + m.nrow - 1) / T + 1);
  __syncthreads();  // the mask and the statistics are written
  md_ca_rows(m, value, ss, a.ca_stride, a.w[12], a.w[13], T, off);
  cluster_wait();
  push_slice(m.big, m);
  md_ca_project(r, s, a, m, a.w[15]);
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

// ptrs: x [M, D], value [M / T, D], mask [M] (f32), ss [1 or M / T, 2D],
// ln_w, ln_b, w [D, D], b, out [M, D] (bf16 unless noted).  ints: M, D, T,
// ss_stride, then the launch geometry (ops/stylize.py
// broadcast_stylize_geometry): rows per group, row groups, cluster size.
extern "C" int stylize_forward(const void** p, const int* n, const float*,
                               void* stream) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  MDClusterArgs a = {};
  a.x = w[0];
  a.value = w[1];
  a.kvalid = reinterpret_cast<const float*>(p[2]);
  a.ca_ss = w[3];
  for (int k = 0; k < 4; ++k) a.w[12 + k] = w[4 + k];
  a.out = const_cast<bf16*>(w[8]);
  a.B = n[0];  // rows, grouped as samples of one row
  a.T = 1;
  a.D = n[1];
  a.ss_t = n[2];
  a.ca_stride = n[3];
  a.spg = n[4];
  a.groups = n[5];
  a.C = n[6];
  a.L = 1;
  a.ca_only = 1;
  static SmemGrant grant;
  return md_cluster_launch(stylize_kernel, a, grant,
                           static_cast<cudaStream_t>(stream));
}

// Clusters of D / 64 CTAs of this kernel that can be resident at once at
// width D (0 when the query fails).
extern "C" int stylize_slots(int D) {
  MDClusterArgs a = {};
  a.D = D;
  a.ca_only = 1;
  static SmemGrant grant;
  return md_cluster_slots(stylize_kernel, a, grant);
}
