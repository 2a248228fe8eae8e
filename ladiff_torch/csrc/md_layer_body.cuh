// One whole MD-trans denoiser layer for the samples of one block, shared by
// kernel K1 (md_layer.cu, one layer per launch) and kernel 11 (md_stack.cu,
// the whole skip stack per launch).  See ladiff_torch/ops/md_layer.py for
// the math and ladiff_torch/ops/md_stack.py for the stack.  Its two AdaLN
// row segments (ca_rows, stylize_rows) are also kernel 7's (stylize.cu) and
// kernel 6's (stylized_ffn.cu).
//
// A block owns `ns` whole samples: their T latent rows (<= 32) and E extra
// rows (text, time; <= 32).  Shared memory holds the bf16 A operand of the
// next product (xb), the extra rows (eb), a 256-column f32 GEMM output chunk
// (cf), the f32 residual stream (r), and one region that holds q/k/v during
// attention and the FFN hidden activations after it.
#pragma once

#include "common.cuh"

namespace ladiff {

constexpr int kMDParams = 24;  // ops/md_layer.py _PARAM_ORDER

// The layer's weights, in _PARAM_ORDER.
struct MDLayerW {
  const bf16 *sa_in_w, *sa_in_b, *sa_out_w, *sa_out_b, *ln1_w, *ln1_b;
  const bf16 *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
  const bf16 *ca_ln_w, *ca_ln_b, *ca_w, *ca_b;
  const bf16 *fw1, *fb1, *fw2, *fb2, *f_ln_w, *f_ln_b, *fp_w, *fp_b;
};

// Elements of each of the 24 tensors of one layer, in _PARAM_ORDER.
__host__ __device__ inline size_t md_param_numel(int k, int D, int F1,
                                                 int F2) {
  const size_t d = D;
  switch (k) {
    case 0: return 3 * d * d;   // sa_in_w
    case 1: return 3 * d;       // sa_in_b
    case 2: case 14: case 22: return d * d;  // sa_out_w, ca_w, fp_w
    case 6: case 8: return (size_t)F1 * d;   // w1, w2
    case 7: return F1;                       // b1
    case 16: case 18: return (size_t)F2 * d; // fw1, fw2
    case 17: return F2;                      // fb1
    default: return d;  // biases and LayerNorm weights of width D
  }
}

// Layer `l` of 24 stacked [L, ...] tensors (l = 0 for one layer's own).
__host__ __device__ inline MDLayerW md_weights(const bf16* const* q, int l,
                                               int D, int F1, int F2) {
  const bf16* p[kMDParams];
#pragma unroll
  for (int k = 0; k < kMDParams; ++k)
    p[k] = q[k] + (size_t)l * md_param_numel(k, D, F1, F2);
  MDLayerW w;
  w.sa_in_w = p[0]; w.sa_in_b = p[1]; w.sa_out_w = p[2]; w.sa_out_b = p[3];
  w.ln1_w = p[4]; w.ln1_b = p[5]; w.w1 = p[6]; w.b1 = p[7]; w.w2 = p[8];
  w.b2 = p[9]; w.ln2_w = p[10]; w.ln2_b = p[11]; w.ca_ln_w = p[12];
  w.ca_ln_b = p[13]; w.ca_w = p[14]; w.ca_b = p[15]; w.fw1 = p[16];
  w.fb1 = p[17]; w.fw2 = p[18]; w.fb2 = p[19]; w.f_ln_w = p[20];
  w.f_ln_b = p[21]; w.fp_w = p[22]; w.fp_b = p[23];
  return w;
}

struct MDLayout {
  size_t xb, eb, cf, r, big, ws, total;
};

__host__ __device__ inline MDLayout md_layout(int D, int F1, int F2) {
  const size_t ld = D + 8, ldh = (F1 > F2 ? F1 : F2) + 8;
  MDLayout L;
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

// The block's view of shared memory.
struct MDSmem {
  bf16 *xb, *eb, *qs, *ks, *vs, *hid, *ws;
  float *cf, *r;
  int ld, ldc, ldh;
};

__device__ __forceinline__ MDSmem md_smem(unsigned char* smem, int D, int F1,
                                          int F2) {
  const MDLayout L = md_layout(D, F1, F2);
  MDSmem m;
  m.ld = D + 8;
  m.ldc = kChunk + 4;
  m.ldh = (F1 > F2 ? F1 : F2) + 8;
  m.xb = reinterpret_cast<bf16*>(smem + L.xb);
  m.eb = reinterpret_cast<bf16*>(smem + L.eb);
  m.cf = reinterpret_cast<float*>(smem + L.cf);
  m.r = reinterpret_cast<float*>(smem + L.r);
  m.qs = reinterpret_cast<bf16*>(smem + L.big);
  m.ks = m.qs + kRows * m.ld;  // 32 latent rows, then 32 extra rows
  m.vs = m.ks + 2 * kRows * m.ld;
  m.hid = m.qs;  // reused once attention is done
  m.ws = reinterpret_cast<bf16*>(smem + L.ws);
  return m;
}

// The block's rows in: x rows into xb (bf16) and r (f32), extra rows into
// eb; padding rows are zero.  Ends synchronized.
__device__ __forceinline__ void md_load_rows(const MDSmem& m, const bf16* x,
                                             const bf16* extra, int D,
                                             int nrow, int nerow) {
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const bf16 xv = row < nrow ? ldg(x + (size_t)row * D + c) : tob(0.f);
    m.xb[row * m.ld + c] = xv;
    m.r[row * D + c] = tof(xv);
    m.eb[row * m.ld + c] =
        row < nerow ? ldg(extra + (size_t)row * D + c) : tob(0.f);
  }
  __syncthreads();
}

// AdaLN -> SiLU of one row held by a warp (v: its LayerNorm output, element
// lane + 32 i in v[i]), (scale, shift) from ss [2D], into the bf16 row dst.
// Here and in the row segments below the column is clamped before the guard,
// as in warp_layernorm: the compiler may issue the read-only loads of the
// unrolled iterations i >= per speculatively, and they must stay inside the
// row (a shared AdaLN row is a tensor of its own, 2D elements long).
__device__ __forceinline__ void adaln_silu_row(const float* v, const bf16* ss,
                                               int D, bf16* dst) {
  const int lane = threadIdx.x & 31, per = D / 32;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int c = min(lane + 32 * i, D - 1);
    if (i < per)
      dst[c] = tob(silu(v[i] * (1.f + ldgf(ss + c)) + ldgf(ss + D + c)));
  }
}

// Rows r = 0..31 of a block are rows row0 + r of a stream of T-row samples;
// the sample of a row is clamped to `last` (padding rows).  ss points at the
// AdaLN (scale, shift) row of sample 0, ss_stride elements between samples
// (0: one row shared by all).  One warp per row; no barrier.

// The one-token cross-attention's rows: the text value row of the row's
// sample (value: sample 0's) x the row's mask (mask: row 0's, read for the
// first nrow rows, 0 beyond) -> LayerNorm -> AdaLN -> SiLU into xb.
__device__ __forceinline__ void ca_rows(bf16* xb, int ld, int D, int T,
                                        int row0, int nrow, int last,
                                        const float* mask, const bf16* value,
                                        const bf16* ss, int ss_stride,
                                        const bf16* ln_w, const bf16* ln_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, per = D / 32;
  for (int row = warp; row < kRows; row += nwarps) {
    const int s = min((row0 + row) / T, last);
    const float mk = row < nrow ? ldgf(mask + row) : 0.f;
    const bf16* val = value + (size_t)s * D;
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int c = min(lane + 32 * i, D - 1);
      if (i < per) v[i] = ldgf(val + c) * mk;
    }
    warp_layernorm(v, D, ln_w, ln_b);
    adaln_silu_row(v, ss + (size_t)s * ss_stride, D, xb + row * ld);
  }
}

// The stylized FFN's rows: the FFN output row in cf + b2 -> LayerNorm ->
// AdaLN -> SiLU into xb.
__device__ __forceinline__ void stylize_rows(const float* cf, int ldc,
                                             const bf16* b2, bf16* xb, int ld,
                                             int D, int T, int row0, int last,
                                             const bf16* ss, int ss_stride,
                                             const bf16* ln_w,
                                             const bf16* ln_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, per = D / 32;
  for (int row = warp; row < kRows; row += nwarps) {
    const int s = min((row0 + row) / T, last);
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int c = min(lane + 32 * i, D - 1);
      if (i < per) v[i] = cf[row * ldc + c] + ldgf(b2 + c);
    }
    warp_layernorm(v, D, ln_w, ln_b);
    adaln_silu_row(v, ss + (size_t)s * ss_stride, D, xb + row * ld);
  }
}

// One MD layer on the block's rows.  Pre: md_load_rows (or the previous
// layer) filled xb and r, eb holds the extra rows.  kv: latent validity of
// the block's first row on; value: the text value row of the block's first
// sample on, one row per sample; ca_ss / ffn_ss: the AdaLN (scale, shift)
// row of the block's first sample, `*_stride` elements between samples (0:
// one row shared by all).  Ends by calling epi(i, v) for every element i =
// row * D + c of the 32 rows, v the layer's f32 output (no barrier after).
template <typename Epi>
__device__ __forceinline__ void md_layer_body(
    const MDLayerW& w, const MDSmem& m, int D, int T, int E, int H, int F1,
    int F2, int ns, const float* kv, const bf16* value, const bf16* ca_ss,
    int ca_stride, const bf16* ffn_ss, int ffn_stride, Epi epi) {
  const int Dh = D / H;
  const int ld = m.ld, ldc = m.ldc, ldh = m.ldh;
  bf16 *xb = m.xb, *eb = m.eb, *qs = m.qs, *ks = m.ks, *vs = m.vs;
  bf16 *hid = m.hid, *ws = m.ws;
  float *cf = m.cf, *r = m.r;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nrow = ns * T;

  // q, k, v of the latent rows; k, v of the extra rows
  for (int part = 0; part < 3; ++part) {
    block_gemm(xb, ld, w.sa_in_w + (size_t)part * D * D, D, D, D, cf, ldc,
               false, ws);
    store_biased(cf, ldc, w.sa_in_b + part * D, D,
                 part == 0 ? qs : (part == 1 ? ks : vs), ld);
    __syncthreads();
  }
  for (int part = 1; part < 3; ++part) {
    block_gemm(eb, ld, w.sa_in_w + (size_t)part * D * D, D, D, D, cf, ldc,
               false, ws);
    store_biased(cf, ldc, w.sa_in_b + part * D, D,
                 (part == 1 ? ks : vs) + kRows * ld, ld);
    __syncthreads();
  }

  // attention: row i of sample s sees its T latents (masked) and its E
  // extra rows (always valid); the context overwrites xb
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

  // out-projection + residual -> LN1 -> ReLU FFN -> + residual -> LN2
  block_gemm(xb, ld, w.sa_out_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    r[i] += cf[row * ldc + c] + ldgf(w.sa_out_b + c);
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, w.ln1_w, w.ln1_b);
  __syncthreads();
  block_ffn(xb, ld, D, w.w1, w.b1, w.w2, F1, 0, hid, ldh, cf, ldc, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    r[i] += cf[row * ldc + c] + ldgf(w.b2 + c);
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, w.ln2_w, w.ln2_b);
  __syncthreads();

  // one-token cross-attention: value row x mask -> LN -> AdaLN -> SiLU
  ca_rows(xb, ld, D, T, 0, nrow, ns - 1, kv, value, ca_ss, ca_stride,
          w.ca_ln_w, w.ca_ln_b);
  __syncthreads();
  block_gemm(xb, ld, w.ca_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const float x3 = r[i] + cf[row * ldc + c] + ldgf(w.ca_b + c);
    r[i] = x3;
    xb[row * ld + c] = tob(x3);
  }
  __syncthreads();

  // stylized GELU FFN -> LN -> AdaLN -> SiLU -> proj + residual
  block_ffn(xb, ld, D, w.fw1, w.fb1, w.fw2, F2, 1, hid, ldh, cf, ldc, ws);
  stylize_rows(cf, ldc, w.fb2, xb, ld, D, T, 0, ns - 1, ffn_ss, ffn_stride,
               w.f_ln_w, w.f_ln_b);
  __syncthreads();
  block_gemm(xb, ld, w.fp_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    epi(i, r[i] + cf[row * ldc + c] + ldgf(w.fp_b + c));
  }
}

// Samples per block: as many whole samples as fit in 32 latent rows and in
// 32 extra rows.
__host__ __device__ inline int md_samples_per_block(int T, int E) {
  return kRows / T < kRows / E ? kRows / T : kRows / E;
}

}  // namespace ladiff
