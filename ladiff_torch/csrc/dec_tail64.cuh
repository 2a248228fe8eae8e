// The forward tail of a post-norm transformer decoder layer on 64-row blocks,
// one body for the inference kernel K2 (decoder_layer.cu) and the training
// kernel 13 (train_decoder_layer.cu, forward and the backward's recompute):
//
//   r1  = x + (ctx Wso^T + bso) * m1               -> LN1 -> t1
//   q   = t1 Wq^T + bq
//   cc  = cross-attention of q into the sample's <= 8 memory rows (k | v from
//         the projection launch; invalid rows -1e9; probabilities * m2)
//   r2  = t1 + (cc Wco^T + bco) * m3               -> LN2 -> h
//   out = LN3(h + ((act(h W1^T + b1) * m4) W2^T + b2) * m5)
//
// (masks 1 to 5 of ops/train_decoder_layer.py, off in K2).  tail64.cuh's
// blocks: 16 warps, mma.sync with the residuals r1, t1, r2, h as f32
// accumulator registers, the weights through the cp.async ring; only the
// bf16 operands (t1, q, cc, h and the FFN's hidden chunk) go through shared
// memory.  The cross-attention is one warp per (row, head): lane 4 j + g
// holds a quarter of memory row j's score, the softmax runs on shuffles,
// and the context's columns are the lanes'.
#pragma once

#include "tail64.cuh"

namespace ladiff {

constexpr int kMaxMem = 8;  // memory rows per sample: a warp's 8 lane quads
constexpr uint32_t kMaskSaRes = 1u, kMaskCaProb = 2u, kMaskCaRes = 3u,
                   kMaskDecHid = 4u, kMaskDecOut = 5u;

struct DecTail64 {
  const bf16 *x, *ctx, *memkv;  // memkv [B*L, 2D]: the memory's k | v
  const float* mvalid;          // [B*L]
  const bf16 *sa_out_w, *sa_out_b, *ln1_w, *ln1_b, *ca_in_w, *ca_in_b;
  const bf16 *ca_out_w, *ca_out_b, *ln2_w, *ln2_b;
  FfnSeg ffn;  // w1, b1, w2, b2, ln3 (and the backward's dout, gd, da, dy)
  bf16* out;
  // what the backward's recompute keeps: r1, r2 (f32); t1, q, cc, h (bf16)
  float *r1, *r2;
  bf16 *t1, *q, *cc, *h;
  int M, T, L, D, H;
  Dropout drop;
};

// The 18 parameters in the host's order (ops/decoder_layer.py _PARAM_ORDER)
// into a, the FFN segment with masks 4 and 5.
inline void dec_fill_params(DecTail64& a, const bf16* const* q, int F,
                            int act) {
  a.sa_out_w = q[2]; a.sa_out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.ca_in_w = q[6]; a.ca_in_b = q[7]; a.ca_out_w = q[8]; a.ca_out_b = q[9];
  a.ln2_w = q[10]; a.ln2_b = q[11];
  a.ffn.w1 = q[12]; a.ffn.b1 = q[13]; a.ffn.w2 = q[14]; a.ffn.b2 = q[15];
  a.ffn.ln_w = q[16]; a.ffn.ln_b = q[17];
  a.ffn.F = F; a.ffn.act = act;
  a.ffn.mask_hid = kMaskDecHid; a.ffn.mask_out = kMaskDecOut;
}

// Sum over the 8 lane quads (the memory rows) of a warp.
__device__ __forceinline__ float quads_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ float quads_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// Lane 4 j + g's quarter of the dot product of a head's Dh values at a
// (smem, bf16 or f32) and memory row j's at b (global bf16): columns
// 16 i + 4 g .. + 3.  Dh a multiple of 16.
__device__ __forceinline__ float quarter_dot(const bf16* a, const bf16* b,
                                             int Dh, int g) {
  float s = 0.f;
  for (int d = 4 * g; d < Dh; d += 16) {
    const uint2 av = *reinterpret_cast<const uint2*>(a + d);
    const uint2 bv = __ldg(reinterpret_cast<const uint2*>(b + d));
    const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av.x));
    const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av.y));
    const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv.x));
    const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv.y));
    s += a0.x * b0.x + a0.y * b0.y + a1.x * b1.x + a1.y * b1.y;
  }
  return s;
}
__device__ __forceinline__ float quarter_dot(const float* a, const bf16* b,
                                             int Dh, int g) {
  float s = 0.f;
  for (int d = 4 * g; d < Dh; d += 16) {
    const float4 av = *reinterpret_cast<const float4*>(a + d);
    const uint2 bv = __ldg(reinterpret_cast<const uint2*>(b + d));
    const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv.x));
    const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv.y));
    s += av.x * b0.x + av.y * b0.y + av.z * b1.x + av.w * b1.y;
  }
  return s;
}

// The cross-attention probability of memory row j = lane / 4 for query row
// grow (q: the head's Dh values in smem) and head h, over the sample's L
// rows (invalid ones get the additive -1e9); the same value in the four
// lanes of the quad, 0 for j >= L.  *keep: its keep-mask value (mask 2,
// element ((b H + h) T + t) L + j).
template <bool kDrop>
__device__ __forceinline__ float cross_prob64(const DecTail64& a,
                                              const bf16* q, size_t grow,
                                              int h, float* keep) {
  const int lane = threadIdx.x & 31, j = lane >> 2, g = lane & 3;
  const int D = a.D, Dh = D / a.H, L = a.L;
  const size_t b = grow / a.T, t = grow % a.T;
  float s = 0.f;
  if (j < L)
    s = quarter_dot(q, a.memkv + (b * L + j) * 2 * D + h * Dh, Dh, g);
  s = quad_sum(s);
  s = j < L ? s * rsqrtf((float)Dh) +
                  (ldgf(a.mvalid + b * L + j) > 0.5f ? 0.f : kNegInf)
            : -INFINITY;
  const float mx = quads_max(s);  // every lane: the shuffles take all 32
  const float e = j < L ? __expf(s - mx) : 0.f;
  const float p = e / quads_sum(e);
  // the quad's first lane draws the mask element, the others read it
  float k = 1.f;
  if (kDrop && j < L && g == 0)
    k = keep_scale(a.drop, kMaskCaProb,
                   (((uint64_t)b * a.H + h) * a.T + t) * L + j);
  *keep = __shfl_sync(0xffffffffu, k, lane & ~3);
  return p;
}

// The cross-attention of the block's rows: row `row` (query q, bf16 in qs,
// row stride D + 8) and head h attend to their sample's memory rows; one
// warp per (row, head).  The context goes to cs (bf16, row stride D + 8)
// and, where g is not null, to the scratch g [M, D]; rows >= nrow get zeros.
template <bool kDrop>
__device__ __forceinline__ void cross_attend64(const DecTail64& a,
                                               const bf16* qs, bf16* cs,
                                               bf16* g, size_t row0,
                                               int nrow) {
  const int D = a.D, H = a.H, Dh = D / H, L = a.L;
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < kTRows * H; p += kTThreads / 32) {
    const int row = p / H, h = p % H;
    bf16* dst = cs + row * (D + 8) + h * Dh;
    if (row >= nrow) {
      for (int d = 2 * lane; d < Dh; d += 64) st2(dst + d, 0.f, 0.f);
      continue;
    }
    const size_t grow = row0 + row;
    float keep;
    const float pr = cross_prob64<kDrop>(a, qs + row * (D + 8) + h * Dh, grow,
                                         h, &keep);
    float w[kMaxMem];
#pragma unroll
    for (int j = 0; j < kMaxMem; ++j)
      w[j] = __shfl_sync(0xffffffffu, pr * keep, 4 * j);
    const bf16* v = a.memkv + (grow / a.T) * L * 2 * D + D + h * Dh;
    for (int d = 2 * lane; d < Dh; d += 64) {
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxMem; ++j)
        if (j < L) {
          const float2 vv = ldg2(v + (size_t)j * 2 * D + d);
          c0 += w[j] * vv.x;
          c1 += w[j] * vv.y;
        }
      st2(dst + d, c0, c1);
      if (g) st2(g + grow * D + h * Dh + d, c0, c1);
    }
  }
}

// The tail from the self-attention context to h = LN2(r2) for the block's
// rows: h (f32) in registers and bf16 in xa, with LN2's mean and rstd.
// Uses xa, xb, the ring and red.  kKeep: r1, r2 (f32), t1, q, cc and h
// (bf16) to the scratch, for the backward.
template <int NT, bool kDrop, bool kKeep>
__device__ __forceinline__ void dec_front(float (&h)[kTMT][NT][4],
                                          float (&mean)[kTMT][2],
                                          float (&rstd)[kTMT][2],
                                          const DecTail64& a,
                                          const TailSmem& m, size_t row0,
                                          int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
  // r1 = x + drop(ctx Wso^T + bso); t1 = LN1(r1) (f32 in h, bf16 in xa)
  load_rows64<D>(a.ctx, row0, nrow, m.xa);
  tail_zero(h);
  tail_gemm<NT, false>(h, m.xa, D + 8, a.sa_out_w, D, D, m.ring);
  residual_sum<NT, kDrop>(h, a.x, a.sa_out_b, a.drop, kMaskSaRes, row0, nrow);
  if (kKeep) store_rows_f32(h, a.r1, row0, nrow);
  tail_normalize(h, D, m.red, mean, rstd);
  tail_affine(h, a.ln1_w, a.ln1_b);
  store_rows(h, m.xa, D + 8, kKeep ? a.t1 : nullptr, row0, nrow);
  // q = t1 Wq^T + bq (bf16 in xb); cc (bf16) into xa over t1
  float y[kTMT][NT][4];
  tail_zero(y);
  tail_gemm<NT, false>(y, m.xa, D + 8, a.ca_in_w, D, D, m.ring);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 bq = ldg2(a.ca_in_b + tcol<NT>(t, nt));
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt) {
      y[mt][nt][0] += bq.x;
      y[mt][nt][1] += bq.y;
      y[mt][nt][2] += bq.x;
      y[mt][nt][3] += bq.y;
    }
  }
  store_rows(y, m.xb, D + 8, kKeep ? a.q : nullptr, row0, nrow);
  __syncthreads();
  cross_attend64<kDrop>(a, m.xb, m.xa, kKeep ? a.cc : nullptr, row0, nrow);
  // r2 = t1 + drop(cc Wco^T + bco); h = LN2(r2)
  tail_zero(y);
  tail_gemm<NT, false>(y, m.xa, D + 8, a.ca_out_w, D, D, m.ring);
  residual_add<NT, kDrop>(h, y, a.ca_out_b, a.drop, kMaskCaRes, row0);
  if (kKeep) store_rows_f32(h, a.r2, row0, nrow);
  tail_normalize(h, D, m.red, mean, rstd);
  tail_affine(h, a.ln2_w, a.ln2_b);
  store_rows(h, m.xa, D + 8, kKeep ? a.h : nullptr, row0, nrow);
}

// Per 64-row block, from the self-attention context to the layer's output.
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
dec_tail_fwd_kernel(DecTail64 a) {
  constexpr int D = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem m = tail_smem(smem, D, true);
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(a.M - row0));
  float h[kTMT][NT][4], mean[kTMT][2], rstd[kTMT][2];
  dec_front<NT, kDrop, false>(h, mean, rstd, a, m, row0, nrow);
  ffn_seg_forward<NT, kDrop>(h, a.ffn, a.drop, kMaskDecOut, m, row0, nrow,
                             a.out);
}

// Internal linkage: each library keeps its own shared-memory grants (see
// attn_tile.cuh).
template <int NT, bool kDrop>
static inline cudaError_t dec_tail_fwd_d(const DecTail64& a,
                                         cudaStream_t stream) {
  static SmemGrant grant;
  const size_t bytes = tail_smem_bytes(32 * NT, true, false);
  if (!allow_smem(dec_tail_fwd_kernel<NT, kDrop>, bytes, grant))
    return cudaErrorInvalidValue;
  dec_tail_fwd_kernel<NT, kDrop>
      <<<(a.M + kTRows - 1) / kTRows, kTThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The forward tail's launch at width D (64, 128, 192 or 256), L <= 8
// memory rows, head widths that are a multiple of 16.
template <bool kDrop>
static inline cudaError_t launch_dec_tail_fwd(const DecTail64& a,
                                              cudaStream_t stream) {
  if (a.L < 1 || a.L > kMaxMem || a.D % a.H || (a.D / a.H) % 16 ||
      a.ffn.F % kTFC || a.ffn.F < kTFC)
    return cudaErrorInvalidValue;
  switch (a.D) {
    case 64: return dec_tail_fwd_d<2, kDrop>(a, stream);
    case 128: return dec_tail_fwd_d<4, kDrop>(a, stream);
    case 192: return dec_tail_fwd_d<6, kDrop>(a, stream);
    case 256: return dec_tail_fwd_d<8, kDrop>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ladiff
