// Kernel K1: one whole MD-trans denoiser layer per launch (replaces
// ladiff_tpu/ops/pallas_md_layer.py fused_md_layer).  See
// ladiff_torch/ops/md_layer.py for the math, the bound and the design.
//
// One block owns `spb` whole samples: their T latent rows (<= 32) and E
// extra rows (text, time; <= 32).  Shared memory holds the bf16 A operand
// of the next product (xb), the extra rows (eb), a 256-column f32 GEMM
// output chunk (cf), the f32 residual stream (r), and one region that
// holds q/k/v during attention and the FFN hidden activations after it.
#include "common.cuh"

using namespace ladiff;

namespace {

struct MDArgs {
  const bf16* x;
  const bf16* extra;
  const float* kvalid;
  const bf16* value;
  const bf16* ca_ss;
  const bf16* ffn_ss;
  const bf16 *sa_in_w, *sa_in_b, *sa_out_w, *sa_out_b, *ln1_w, *ln1_b;
  const bf16 *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
  const bf16 *ca_ln_w, *ca_ln_b, *ca_w, *ca_b;
  const bf16 *fw1, *fb1, *fw2, *fb2, *f_ln_w, *f_ln_b, *fp_w, *fp_b;
  bf16* out;
  int B, T, E, D, H, F1, F2, ca_stride, ffn_stride, spb;
};

struct Layout {
  size_t xb, eb, cf, r, big, ws, total;
};

__host__ __device__ inline Layout md_layout(int D, int F1, int F2) {
  const size_t ld = D + 8, ldh = (F1 > F2 ? F1 : F2) + 8;
  Layout L;
  L.xb = 0;
  L.eb = align128(L.xb + kRows * ld * sizeof(bf16));
  L.cf = align128(L.eb + kRows * ld * sizeof(bf16));
  L.r = align128(L.cf + kRows * (kChunk + 4) * sizeof(float));
  L.big = align128(L.r + kRows * D * sizeof(float));
  const size_t qkv = 5 * kRows * ld * sizeof(bf16);
  const size_t hid = kRows * ldh * sizeof(bf16);
  L.ws = align128(L.big + (qkv > hid ? qkv : hid));
  L.total = align128(L.ws + kWStageBytes);
  return L;
}

__global__ void __launch_bounds__(kThreads) md_layer_kernel(MDArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, T = a.T, E = a.E, H = a.H, Dh = D / H;
  const int ld = D + 8, ldc = kChunk + 4;
  const int ldh = (a.F1 > a.F2 ? a.F1 : a.F2) + 8;
  const Layout L = md_layout(D, a.F1, a.F2);
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  bf16* eb = reinterpret_cast<bf16*>(smem + L.eb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* r = reinterpret_cast<float*>(smem + L.r);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.big);
  bf16* ks = qs + kRows * ld;  // 32 latent rows, then 32 extra rows
  bf16* vs = ks + 2 * kRows * ld;
  bf16* hid = qs;  // reused once attention is done
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int s0 = blockIdx.x * a.spb;
  const int ns = min(a.spb, a.B - s0);
  const int nrow = ns * T, nerow = ns * E;
  const size_t row0 = (size_t)s0 * T, erow0 = (size_t)s0 * E;
  const float* kv = a.kvalid + row0;

  // 1. rows in; padding rows are zero
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const bf16 xv = row < nrow ? ldg(a.x + (row0 + row) * D + c) : tob(0.f);
    xb[row * ld + c] = xv;
    r[row * D + c] = tof(xv);
    eb[row * ld + c] =
        row < nerow ? ldg(a.extra + (erow0 + row) * D + c) : tob(0.f);
  }
  __syncthreads();

  // 2. q, k, v of the latent rows; k, v of the extra rows
  for (int part = 0; part < 3; ++part) {
    block_gemm(xb, ld, a.sa_in_w + (size_t)part * D * D, D, D, D, cf, ldc,
               false, ws);
    store_biased(cf, ldc, a.sa_in_b + part * D, D,
                 part == 0 ? qs : (part == 1 ? ks : vs), ld);
    __syncthreads();
  }
  for (int part = 1; part < 3; ++part) {
    block_gemm(eb, ld, a.sa_in_w + (size_t)part * D * D, D, D, D, cf, ldc,
               false, ws);
    store_biased(cf, ldc, a.sa_in_b + part * D, D,
                 (part == 1 ? ks : vs) + kRows * ld, ld);
    __syncthreads();
  }

  // 3. attention: row i of sample s sees its T latents (masked) and its E
  //    extra rows (always valid); the context overwrites xb
  const float scale = rsqrtf((float)Dh);
  for (int p = warp; p < nrow * H; p += nwarps) {
    const int row = p / H, h = p % H, s = row / T;
    auto k_of = [&](int j) {
      return ks + (j < T ? s * T + j : kRows + s * E + (j - T)) * ld + h * Dh;
    };
    auto v_of = [&](int j) {
      return vs + (j < T ? s * T + j : kRows + s * E + (j - T)) * ld + h * Dh;
    };
    auto bias_of = [&](int j) {
      return (j < T && ldgf(kv + s * T + j) <= 0.5f) ? kNegInf : 0.f;
    };
    warp_attend(qs + row * ld + h * Dh, Dh, T + E, scale, k_of, v_of,
                bias_of, xb + row * ld + h * Dh);
  }
  __syncthreads();

  // 4. out-projection + residual -> LN1 -> ReLU FFN -> + residual -> LN2
  block_gemm(xb, ld, a.sa_out_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    r[i] += cf[row * ldc + c] + ldgf(a.sa_out_b + c);
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln1_w, a.ln1_b);
  __syncthreads();
  block_ffn(xb, ld, D, a.w1, a.b1, a.w2, a.F1, 0, hid, ldh, cf, ldc, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    r[i] += cf[row * ldc + c] + ldgf(a.b2 + c);
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln2_w, a.ln2_b);
  __syncthreads();

  // 5. one-token cross-attention: value row x mask -> LN -> AdaLN -> SiLU
  const int per = D / 32;
  for (int row = warp; row < kRows; row += nwarps) {
    const int s = min(row / T, ns - 1);
    const float m = row < nrow ? ldgf(kv + row) : 0.f;
    const bf16* val = a.value + (size_t)(s0 + s) * D;
    const bf16* ss = a.ca_ss + (size_t)(s0 + s) * a.ca_stride;
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per) v[i] = ldgf(val + lane + 32 * i) * m;
    warp_layernorm(v, D, a.ca_ln_w, a.ca_ln_b);
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        xb[row * ld + c] =
            tob(silu(v[i] * (1.f + ldgf(ss + c)) + ldgf(ss + D + c)));
      }
  }
  __syncthreads();
  block_gemm(xb, ld, a.ca_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const float x3 = r[i] + cf[row * ldc + c] + ldgf(a.ca_b + c);
    r[i] = x3;
    xb[row * ld + c] = tob(x3);
  }
  __syncthreads();

  // 6. stylized GELU FFN -> LN -> AdaLN -> SiLU -> proj + residual
  block_ffn(xb, ld, D, a.fw1, a.fb1, a.fw2, a.F2, 1, hid, ldh, cf, ldc, ws);
  for (int row = warp; row < kRows; row += nwarps) {
    const int s = min(row / T, ns - 1);
    const bf16* ss = a.ffn_ss + (size_t)(s0 + s) * a.ffn_stride;
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        v[i] = cf[row * ldc + c] + ldgf(a.fb2 + c);
      }
    warp_layernorm(v, D, a.f_ln_w, a.f_ln_b);
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        xb[row * ld + c] =
            tob(silu(v[i] * (1.f + ldgf(ss + c)) + ldgf(ss + D + c)));
      }
  }
  __syncthreads();
  block_gemm(xb, ld, a.fp_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < nrow * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    a.out[(row0 + row) * D + c] =
        tob(r[i] + cf[row * ldc + c] + ldgf(a.fp_b + c));
  }
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
  const bf16** q = w + 6;
  a.sa_in_w = q[0]; a.sa_in_b = q[1]; a.sa_out_w = q[2]; a.sa_out_b = q[3];
  a.ln1_w = q[4]; a.ln1_b = q[5]; a.w1 = q[6]; a.b1 = q[7]; a.w2 = q[8];
  a.b2 = q[9]; a.ln2_w = q[10]; a.ln2_b = q[11]; a.ca_ln_w = q[12];
  a.ca_ln_b = q[13]; a.ca_w = q[14]; a.ca_b = q[15]; a.fw1 = q[16];
  a.fb1 = q[17]; a.fw2 = q[18]; a.fb2 = q[19]; a.f_ln_w = q[20];
  a.f_ln_b = q[21]; a.fp_w = q[22]; a.fp_b = q[23];
  a.out = const_cast<bf16*>(w[30]);
  a.B = n[0]; a.T = n[1]; a.E = n[2]; a.D = n[3]; a.H = n[4]; a.F1 = n[5];
  a.F2 = n[6]; a.ca_stride = n[7]; a.ffn_stride = n[8];
  if (a.T < 1 || a.E < 1 || a.T > kRows || a.E > kRows || a.D > kChunk ||
      a.D % 32 || a.F1 % kKT || a.F2 % kKT)
    return cudaErrorInvalidValue;
  a.spb = kRows / a.T < kRows / a.E ? kRows / a.T : kRows / a.E;
  const size_t bytes = md_layout(a.D, a.F1, a.F2).total;
  static SmemGrant grant;
  if (!allow_smem(md_layer_kernel, bytes, grant)) return cudaErrorInvalidValue;
  const int grid = (a.B + a.spb - 1) / a.spb;
  md_layer_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
