// Kernel 11: the whole MD-trans skip stack per launch: L layers in U-Net
// order with the skip Linears between them, then the final LayerNorm
// (replaces ladiff_tpu/ops/pallas_md_stack.py fused_md_stack).  See
// ladiff_torch/ops/md_stack.py for the math, the bound and the design.
//
// One block owns whole samples for the whole stack: samples never interact,
// so the layers follow each other inside the block with no grid-wide sync.
// Each layer is md_layer_body.cuh's (the body of K1); its output is rounded
// to bf16 at the layer boundary, as the per-layer path rounds it.  The
// (L - 1) / 2 skip activations go to a global scratch [nb, B*T, D] that only
// the block that wrote a row reads back (plain loads: the data is written
// during the launch, so not through the read-only path), and the rows stay
// in L2.  A skip Linear is [x, skip] [rows, 2D] x [2D, D]: two products
// into one accumulator, W's first D columns against x, its last D against
// the skip rows (staged in the q/k/v region, free between layers).
#include "md_layer_body.cuh"

using namespace ladiff;

namespace {

struct StackArgs {
  const bf16* x;
  const bf16* extra;
  const float* kvalid;
  const bf16* values;  // [L, B, D]
  const bf16* ca_ss;   // [L, 2D]
  const bf16* ffn_ss;  // [L, 2D]
  const bf16* w[kMDParams];  // each [L, ...]
  const bf16 *lin_w, *lin_b, *norm_w, *norm_b;  // [nb, D, 2D], [nb, D], [D]
  bf16* skips;  // [nb, B*T, D] scratch
  bf16* out;
  int B, T, E, D, H, F1, F2, L, spb;
};

__global__ void __launch_bounds__(kThreads) md_stack_kernel(StackArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, T = a.T, ld = D + 8, ldc = kChunk + 4;
  const MDSmem m = md_smem(smem, D, a.F1, a.F2);
  const int s0 = blockIdx.x * a.spb;
  const int ns = min(a.spb, a.B - s0);
  const int nrow = ns * T;
  const size_t row0 = (size_t)s0 * T, BT = (size_t)a.B * T;
  const int nb = (a.L - 1) / 2;
  const int tid = threadIdx.x;
  md_load_rows(m, a.x + row0 * D, a.extra + (size_t)s0 * a.E * D, D, nrow,
               ns * a.E);

  // the layer boundary: the f32 output rounded to bf16, as the next layer's
  // A operand and (widened again) its residual; padding rows stay zero
  auto to_rows = [&](int i, float v) {
    const int row = i / D, c = i % D;
    const bf16 xv = row < nrow ? tob(v) : tob(0.f);
    m.xb[row * ld + c] = xv;
    m.r[i] = tof(xv);
  };

  for (int l = 0; l < a.L; ++l) {
    if (l > nb) {  // output block: pop a skip, Linear(2D -> D) of [x, skip]
      const int j = l - nb - 1;
      const bf16* skip = a.skips + (size_t)(nb - 1 - j) * BT * D + row0 * D;
      bf16* sb = m.qs;
      for (int i = tid; i < kRows * D; i += blockDim.x) {
        const int row = i / D, c = i % D;
        sb[row * ld + c] = row < nrow ? skip[(size_t)row * D + c] : tob(0.f);
      }
      const bf16* wl = a.lin_w + (size_t)j * D * 2 * D;
      block_gemm(m.xb, ld, wl, 2 * D, D, D, m.cf, ldc, false, m.ws);
      block_gemm(sb, ld, wl + D, 2 * D, D, D, m.cf, ldc, true, m.ws);
      const bf16* bl = a.lin_b + (size_t)j * D;
      for (int i = tid; i < kRows * D; i += blockDim.x) {
        const int row = i / D, c = i % D;
        to_rows(i, m.cf[row * ldc + c] + ldgf(bl + c));
      }
      __syncthreads();
    }
    md_layer_body(md_weights(a.w, l, D, a.F1, a.F2), m, D, T, a.E, a.H, a.F1,
                  a.F2, ns, a.kvalid + row0,
                  a.values + ((size_t)l * a.B + s0) * D,
                  a.ca_ss + (size_t)l * 2 * D, 0,
                  a.ffn_ss + (size_t)l * 2 * D, 0, to_rows);
    __syncthreads();
    if (l < nb) {  // input block: push a skip
      bf16* skip = a.skips + (size_t)l * BT * D + row0 * D;
      for (int i = tid; i < nrow * D; i += blockDim.x)
        skip[i] = m.xb[(i / D) * ld + i % D];
    }
  }

  // final LayerNorm
  block_layernorm_rows(m.r, D, nullptr, 0, m.xb, ld, D, a.norm_w, a.norm_b);
  __syncthreads();
  for (int i = tid; i < nrow * D; i += blockDim.x)
    a.out[row0 * D + i] = m.xb[(i / D) * ld + i % D];
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x, extra, kvalid, values, ca_ss, ffn_ss, 24 stacked weights (see
// ops/md_layer.py _PARAM_ORDER), lin_w, lin_b, norm_w, norm_b, skips, out.
// ints: B, T, E, D, H, F1, F2, L.
extern "C" int md_stack_forward(const void** p, const int* n, const float*,
                                void* stream) {
  StackArgs a;
  const bf16** w = reinterpret_cast<const bf16**>(p);
  a.x = w[0];
  a.extra = w[1];
  a.kvalid = reinterpret_cast<const float*>(p[2]);
  a.values = w[3];
  a.ca_ss = w[4];
  a.ffn_ss = w[5];
  for (int k = 0; k < kMDParams; ++k) a.w[k] = w[6 + k];
  const bf16** q = w + 6 + kMDParams;
  a.lin_w = q[0]; a.lin_b = q[1]; a.norm_w = q[2]; a.norm_b = q[3];
  a.skips = const_cast<bf16*>(q[4]);
  a.out = const_cast<bf16*>(q[5]);
  a.B = n[0]; a.T = n[1]; a.E = n[2]; a.D = n[3]; a.H = n[4]; a.F1 = n[5];
  a.F2 = n[6]; a.L = n[7];
  if (a.T < 1 || a.E < 1 || a.T > kRows || a.E > kRows || a.D > kChunk ||
      a.D % 32 || a.F1 % kKT || a.F2 % kKT || a.L < 1 || a.L % 2 == 0)
    return cudaErrorInvalidValue;
  a.spb = md_samples_per_block(a.T, a.E);
  const size_t bytes = md_layout(a.D, a.F1, a.F2).total;
  static SmemGrant grant;
  if (!allow_smem(md_stack_kernel, bytes, grant)) return cudaErrorInvalidValue;
  const int grid = (a.B + a.spb - 1) / a.spb;
  md_stack_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
