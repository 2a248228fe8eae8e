// Kernel 12: one whole post-norm transformer encoder layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_layer.py
// train_encoder_layer).  See ladiff_torch/ops/train_layer.py for the math,
// the dropout contract, what is saved and the weight-gradient scheme.
//
// Forward, a fixed sequence of launches:
//   linear_kernel        qkv = x Wqkv^T + bqkv                   (kernel 8's)
//   attn_fwd_kernel      register-resident flash tile, probability dropout
//                        (mask 0); ctx, log-sum-exp   (flash_tile.cuh, 8's)
//   enc_tail_fwd_kernel  per 64-row block, from ctx to the layer's output:
//                        out-projection, residual dropout (mask 1), LN1, the
//                        FFN in 128-column hidden chunks (masks 2, 3), LN2;
//                        r, h and the hidden rows never leave the block
// Backward:
//   enc_tail_bwd_kernel  per 64-row block, from dout to dctx: r and h again,
//                        the FFN's backward chunk by chunk (dh accumulating
//                        in registers), both LayerNorms' backward, the
//                        residual dropout and the out-projection's backward:
//                        writes dr (the residual path's dx), dattn, dctx,
//                        delta = dctx . ctx, and the scratch rows the weight
//                        gradients need
//   reduce_kernel        LayerNorm gradients over the blocks
//   attn_bwd_kernel x2   dq; dk, dv, wholly masked key tiles skipped
//                                                  (flash_tile.cuh, 8's)
//   linear_nn_kernel     dx = dr + dqkv Wqkv                      (kernel 8's)
//   wgrad / colsum       dWqkv, dbqkv, dWout, dbout, dW1, db1, dW2, db2
//
// What bounds the tails on the H100: ~75 MFLOP forward and ~185 MFLOP
// backward per 64 rows against ~1.2 MB of weights: the tensor cores, and
// the weight bytes each block streams from L2 (on the 32-row blocks, 486
// MB per forward tail at 64 x 206 rows).  The tails (tail64.cuh) run
// 64-row blocks of 16 warps with mma.sync register accumulators and a
// three-stage cp.async weight ring, so each byte of weight serves 64 rows;
// the LayerNorms reduce over the accumulator registers.
#include "ffn_bwd.cuh"
#include "tail64.cuh"
#include "train_attn.cuh"

namespace {

constexpr uint32_t kMaskRes = 1u, kMaskHid = 2u, kMaskOut = 3u;

struct EncTail {
  const bf16 *x, *ctx;
  const bf16 *out_w, *out_b, *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w,
      *ln2_b;
  const bf16* dout;
  bf16* out;
  // backward scratch: r (f32), h, gd, da, dy, dr, dattn, dctx (bf16),
  // delta [M, H] and the LayerNorm partials [blocks, 4 D] (f32)
  float* r;
  bf16 *h, *gd, *da, *dy, *dr, *dattn, *dctx;
  float *delta, *lnpart;
  int M, D, H, F, act;
  Dropout drop;
};

// The tails' shared memory: xa, xb [64][D + 8] bf16 (xb: the backward
// only), the FFN chunk [64][128 + 8] bf16, the weight ring, the row
// exchange (2 x 64 x 4 floats) and the column exchange (kTRowWarps x 2 D
// floats).
inline size_t tail_smem_bytes(int D, bool bwd) {
  const size_t xa = (size_t)kTRows * (D + 8) * sizeof(bf16);
  return xa * (bwd ? 2 : 1) + (size_t)kTRows * (kTFC + 8) * sizeof(bf16) +
         kTRingBytes + 2 * kTRows * 4 * sizeof(float) +
         (bwd ? (size_t)kTRowWarps * 2 * D * sizeof(float) : 0);
}

struct TailSmem {
  bf16 *xa, *xb, *hid, *ring;
  float *red, *colbuf;
};

__device__ __forceinline__ TailSmem tail_smem(unsigned char* smem, int D,
                                              bool bwd) {
  TailSmem m;
  m.xa = reinterpret_cast<bf16*>(smem);
  m.xb = m.xa + kTRows * (D + 8);
  m.hid = bwd ? m.xb + kTRows * (D + 8) : m.xb;
  m.ring = m.hid + kTRows * (kTFC + 8);
  m.red = reinterpret_cast<float*>(m.ring + kTStages * kTStageEl);
  m.colbuf = m.red + 2 * kTRows * 4;
  return m;
}

// ctx rows row0 .. row0 + 63 into xa (zero rows past the end), committed.
template <int D>
__device__ __forceinline__ void load_ctx(const bf16* ctx, size_t row0,
                                         int nrow, bf16* xa) {
  for (int i = threadIdx.x; i < kTRows * D / 8; i += kTThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool in = r < nrow;
    cp_async16_zfill(xa + r * (D + 8) + c,
                     ctx + (row0 + (in ? r : 0)) * D + c, in);
  }
  cp_async_commit();
}

// v[row][c] = x + (v + out_b) * m_res for the block's rows (zero rows past
// the end): the attention segment's residual sum from ctx Wout^T.
template <int NT, bool kDrop>
__device__ __forceinline__ void residual_sum(float (&v)[kTMT][NT][4],
                                             const EncTail& a, size_t row0,
                                             int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = tcol<NT>(t, nt);
    const float2 bo = ldg2(a.out_b + c);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        float* e = &v[mt][nt][2 * hf];
        if (row >= nrow) {
          e[0] = e[1] = 0.f;
          continue;
        }
        const size_t idx = (row0 + row) * D + c;
        float y0 = e[0] + bo.x, y1 = e[1] + bo.y;
        if (kDrop) {
          float k0, k1;
          keep_scale2(a.drop, kMaskRes, idx, k0, k1);
          y0 *= k0;
          y1 *= k1;
        }
        const float2 xv = ldg2(a.x + idx);
        e[0] = xv.x + y0;
        e[1] = xv.y + y1;
      }
  }
}

// The thread's elements of v as bf16 into dst (row stride ld) and, for
// rows < nrow, into the [M, D] scratch g (may be null).
template <int NT>
__device__ __forceinline__ void store_rows(const float (&v)[kTMT][NT][4],
                                           bf16* dst, int ld, bf16* g,
                                           size_t row0, int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf), c = tcol<NT>(t, nt);
        const float v0 = v[mt][nt][2 * hf], v1 = v[mt][nt][2 * hf + 1];
        if (dst) st2(dst + row * ld + c, v0, v1);
        if (g && row < nrow) st2(g + (row0 + row) * D + c, v0, v1);
      }
}

// The FFN hidden chunk's epilogue: hid = bf16(act(u + b1) * m_hid) for
// columns c0 .. c0 + 127, and to the scratch gd for rows < nrow.
template <bool kDrop>
__device__ __forceinline__ void hidden_chunk(const float (&u)[kTMT][4][4],
                                             const EncTail& a, int c0,
                                             size_t row0, int nrow,
                                             bf16* hid, bf16* gd) {
  const TailLane t = tail_lane();
  const int F = a.F;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int cc = tcol<4>(t, nt);
    const float2 bv = ldg2(a.b1 + c0 + cc);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        const float a0 = u[mt][nt][2 * hf] + bv.x;
        const float a1 = u[mt][nt][2 * hf + 1] + bv.y;
        float g0 = a.act ? gelu_erf(a0) : fmaxf(a0, 0.f);
        float g1 = a.act ? gelu_erf(a1) : fmaxf(a1, 0.f);
        if (kDrop) {
          float k0, k1;
          keep_scale2(a.drop, kMaskHid, (row0 + row) * F + c0 + cc, k0, k1);
          g0 *= k0;
          g1 *= k1;
        }
        st2(hid + row * (kTFC + 8) + cc, g0, g1);
        if (gd && row < nrow) st2(gd + (row0 + row) * F + c0 + cc, g0, g1);
      }
  }
}

// y = sum over the hidden chunks of bf16(act(h W1^T + b1) * m_hid) W2^T,
// h (bf16) in xa; gd (may be null) takes the hidden rows.
template <int NT, bool kDrop>
__device__ __forceinline__ void ffn_forward(float (&y)[kTMT][NT][4],
                                            const EncTail& a,
                                            const TailSmem& m, size_t row0,
                                            int nrow, bf16* gd) {
  constexpr int D = 32 * NT;
  tail_zero(y);
  for (int c0 = 0; c0 < a.F; c0 += kTFC) {
    float u[kTMT][4][4];
    tail_zero(u);
    tail_gemm<4, false>(u, m.xa, D + 8, a.w1 + (size_t)c0 * D, D, D, m.ring);
    hidden_chunk<kDrop>(u, a, c0, row0, nrow, m.hid, gd);
    tail_gemm<NT, false>(y, m.hid, kTFC + 8, a.w2 + c0, a.F, kTFC, m.ring);
  }
}

// v <- v + (y + b2) * m_out (the FFN's residual sum)
template <int NT, bool kDrop>
__device__ __forceinline__ void ffn_residual(float (&v)[kTMT][NT][4],
                                             const float (&y)[kTMT][NT][4],
                                             const EncTail& a, size_t row0) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = tcol<NT>(t, nt);
    const float2 bv = ldg2(a.b2 + c);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float y0 = y[mt][nt][2 * hf] + bv.x, y1 = y[mt][nt][2 * hf + 1] + bv.y;
        if (kDrop) {
          float k0, k1;
          keep_scale2(a.drop, kMaskOut,
                      (row0 + trow(t, mt, hf)) * D + c, k0, k1);
          y0 *= k0;
          y1 *= k1;
        }
        v[mt][nt][2 * hf] += y0;
        v[mt][nt][2 * hf + 1] += y1;
      }
  }
}

// Per 64-row block, from ctx to the layer's output: out-projection,
// residual dropout (mask 1), LN1, the FFN in 128-column hidden chunks
// (masks 2, 3; the hidden rows never leave the block), LN2.
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
enc_tail_fwd_kernel(EncTail a) {
  constexpr int D = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem m = tail_smem(smem, D, false);
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(a.M - row0));
  float mean[kTMT][2], rstd[kTMT][2];

  load_ctx<D>(a.ctx, row0, nrow, m.xa);
  float h[kTMT][NT][4];
  tail_zero(h);
  tail_gemm<NT, false>(h, m.xa, D + 8, a.out_w, D, D, m.ring);
  residual_sum<NT, kDrop>(h, a, row0, nrow);
  tail_normalize(h, D, m.red, mean, rstd);
  tail_affine(h, a.ln1_w, a.ln1_b);
  store_rows(h, m.xa, D + 8, nullptr, row0, nrow);
  float y[kTMT][NT][4];
  ffn_forward<NT, kDrop>(y, a, m, row0, nrow, nullptr);
  ffn_residual<NT, kDrop>(h, y, a, row0);
  tail_normalize(h, D, m.red, mean, rstd);
  tail_affine(h, a.ln2_w, a.ln2_b);
  store_rows(h, nullptr, 0, a.out, row0, nrow);
}

// Per 64-row block, from dout to dctx: the forward tail again (r to the
// scratch for LN1's backward, h and gd to the scratch for the weight
// gradients), LN2's backward (dy), the FFN's backward in 128-column hidden
// chunks (da, dh = ds + da W1 accumulating in registers), LN1's backward,
// the residual dropout (dr, dattn) and dctx = dattn Wout with
// delta = dctx . ctx per row and head; LayerNorm gradient partials per
// block to lnpart [blocks, 4 D].
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
enc_tail_bwd_kernel(EncTail a) {
  constexpr int D = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem m = tail_smem(smem, D, true);
  const TailLane t = tail_lane();
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(a.M - row0));
  float* lnpart = a.lnpart + (size_t)blockIdx.x * 4 * D;
  float mean1[kTMT][2], rstd1[kTMT][2], mean2[kTMT][2], rstd2[kTMT][2];

  // r = x + drop(ctx Wout^T + bout): kept (f32) for LN1's backward
  load_ctx<D>(a.ctx, row0, nrow, m.xa);
  float h[kTMT][NT][4];
  tail_zero(h);
  tail_gemm<NT, false>(h, m.xa, D + 8, a.out_w, D, D, m.ring);
  residual_sum<NT, kDrop>(h, a, row0, nrow);
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        if (row < nrow)
          *reinterpret_cast<float2*>(a.r + (row0 + row) * D +
                                     tcol<NT>(t, nt)) =
              make_float2(h[mt][nt][2 * hf], h[mt][nt][2 * hf + 1]);
      }
  // h = LN1(r): bf16 in xa and the scratch (dW1 = da^T h)
  tail_normalize(h, D, m.red, mean1, rstd1);
  tail_affine(h, a.ln1_w, a.ln1_b);
  store_rows(h, m.xa, D + 8, a.h, row0, nrow);
  // the FFN again (gd to the scratch), s = h + y * m_out
  float y[kTMT][NT][4];
  ffn_forward<NT, kDrop>(y, a, m, row0, nrow, a.gd);
  ffn_residual<NT, kDrop>(h, y, a, row0);
  // LN2's backward: y <- ds from dout; dy = ds * m_out to xb and scratch
  tail_normalize(h, D, m.red, mean2, rstd2);  // h <- xhat2
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        float2 d = make_float2(0.f, 0.f);
        if (row < nrow) d = ldg2(a.dout + (row0 + row) * D + tcol<NT>(t, nt));
        y[mt][nt][2 * hf] = d.x;
        y[mt][nt][2 * hf + 1] = d.y;
      }
  float gw[NT][2], gb[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) gw[nt][0] = gw[nt][1] = gb[nt][0] = gb[nt][1] = 0.f;
  tail_ln_bwd(h, y, rstd2, a.ln2_w, D, m.red, gw, gb);
  tail_col_sums(gw, gb, D, m.colbuf, lnpart + 2 * D);
  // dh starts as ds; dy = ds * m_out
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float d0 = y[mt][nt][2 * hf], d1 = y[mt][nt][2 * hf + 1];
        h[mt][nt][2 * hf] = d0;
        h[mt][nt][2 * hf + 1] = d1;
        if (kDrop) {
          float k0, k1;
          keep_scale2(a.drop, kMaskOut,
                      (row0 + trow(t, mt, hf)) * D + tcol<NT>(t, nt), k0, k1);
          d0 *= k0;
          d1 *= k1;
        }
        y[mt][nt][2 * hf] = d0;
        y[mt][nt][2 * hf + 1] = d1;
      }
  store_rows(y, m.xb, D + 8, a.dy, row0, nrow);
  // per hidden chunk: da = (dy W2) * m_hid * act'(h W1^T + b1) to the
  // scratch, dh += da W1
  for (int c0 = 0; c0 < a.F; c0 += kTFC) {
    float u[kTMT][4][4], gv[kTMT][4][4];
    tail_zero(u);
    tail_zero(gv);
    tail_gemm<4, false>(u, m.xa, D + 8, a.w1 + (size_t)c0 * D, D, D, m.ring);
    tail_gemm<4, true>(gv, m.xb, D + 8, a.w2 + c0, a.F, D, m.ring);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int cc = tcol<4>(t, nt);
      const float2 bv = ldg2(a.b1 + c0 + cc);
#pragma unroll
      for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = trow(t, mt, hf);
          float d0 = gv[mt][nt][2 * hf] * act_grad(u[mt][nt][2 * hf] + bv.x,
                                                   a.act);
          float d1 = gv[mt][nt][2 * hf + 1] *
                     act_grad(u[mt][nt][2 * hf + 1] + bv.y, a.act);
          if (kDrop) {
            float k0, k1;
            keep_scale2(a.drop, kMaskHid, (row0 + row) * a.F + c0 + cc, k0,
                        k1);
            d0 *= k0;
            d1 *= k1;
          }
          st2(m.hid + row * (kTFC + 8) + cc, d0, d1);
          if (row < nrow) st2(a.da + (row0 + row) * a.F + c0 + cc, d0, d1);
        }
    }
    tail_gemm<NT, true>(h, m.hid, kTFC + 8, a.w1 + (size_t)c0 * D, D, kTFC,
                        m.ring);
  }
  // LN1's backward from the kept r: h <- dr
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        float2 r = make_float2(0.f, 0.f);
        if (row < nrow)
          r = *reinterpret_cast<const float2*>(a.r + (row0 + row) * D +
                                               tcol<NT>(t, nt));
        y[mt][nt][2 * hf] = (r.x - mean1[mt][hf]) * rstd1[mt][hf];
        y[mt][nt][2 * hf + 1] = (r.y - mean1[mt][hf]) * rstd1[mt][hf];
      }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) gw[nt][0] = gw[nt][1] = gb[nt][0] = gb[nt][1] = 0.f;
  tail_ln_bwd(y, h, rstd1, a.ln1_w, D, m.red, gw, gb);
  tail_col_sums(gw, gb, D, m.colbuf, lnpart);
  // dr to the scratch; dattn = dr * m_res to xa and the scratch
  store_rows(h, nullptr, 0, a.dr, row0, nrow);
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (kDrop) {
          float k0, k1;
          keep_scale2(a.drop, kMaskRes,
                      (row0 + trow(t, mt, hf)) * D + tcol<NT>(t, nt), k0, k1);
          h[mt][nt][2 * hf] *= k0;
          h[mt][nt][2 * hf + 1] *= k1;
        }
      }
  store_rows(h, m.xa, D + 8, a.dattn, row0, nrow);
  // dctx = bf16(dattn Wout) to xb and the scratch; delta = dctx . ctx
  tail_zero(y);
  tail_gemm<NT, true>(y, m.xa, D + 8, a.out_w, D, D, m.ring);
  store_rows(y, m.xb, D + 8, a.dctx, row0, nrow);
  __syncthreads();
  const int Dh = D / a.H, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < nrow * a.H; p += kTThreads / 32) {
    const int row = p / a.H, hh = p % a.H;
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32)
      acc += tof(m.xb[row * (D + 8) + hh * Dh + d]) *
             ldgf(a.ctx + (row0 + row) * D + hh * Dh + d);
    acc = warp_sum(acc);
    if (lane == 0) a.delta[(row0 + row) * a.H + hh] = acc;
  }
}

template <int NT>
static inline cudaError_t tail_fwd_d(const EncTail& a, bool on,
                                     cudaStream_t stream) {
  static SmemGrant g0, g1;
  const size_t bytes = tail_smem_bytes(32 * NT, false);
  const int blocks = (a.M + kTRows - 1) / kTRows;
  if (on) {
    if (!allow_smem(enc_tail_fwd_kernel<NT, true>, bytes, g1))
      return cudaErrorInvalidValue;
    enc_tail_fwd_kernel<NT, true><<<blocks, kTThreads, bytes, stream>>>(a);
  } else {
    if (!allow_smem(enc_tail_fwd_kernel<NT, false>, bytes, g0))
      return cudaErrorInvalidValue;
    enc_tail_fwd_kernel<NT, false><<<blocks, kTThreads, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int NT>
static inline cudaError_t tail_bwd_d(const EncTail& a, bool on,
                                     cudaStream_t stream) {
  static SmemGrant g0, g1;
  const size_t bytes = tail_smem_bytes(32 * NT, true);
  const int blocks = (a.M + kTRows - 1) / kTRows;
  if (on) {
    if (!allow_smem(enc_tail_bwd_kernel<NT, true>, bytes, g1))
      return cudaErrorInvalidValue;
    enc_tail_bwd_kernel<NT, true><<<blocks, kTThreads, bytes, stream>>>(a);
  } else {
    if (!allow_smem(enc_tail_bwd_kernel<NT, false>, bytes, g0))
      return cudaErrorInvalidValue;
    enc_tail_bwd_kernel<NT, false><<<blocks, kTThreads, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

// The tail launches at width D (64, 128, 192 or 256).
static inline cudaError_t launch_tail(const EncTail& a, bool bwd, bool on,
                                      cudaStream_t stream) {
  switch (a.D) {
    case 64: return bwd ? tail_bwd_d<2>(a, on, stream) : tail_fwd_d<2>(a, on, stream);
    case 128: return bwd ? tail_bwd_d<4>(a, on, stream) : tail_fwd_d<4>(a, on, stream);
    case 192: return bwd ? tail_bwd_d<6>(a, on, stream) : tail_fwd_d<6>(a, on, stream);
    case 256: return bwd ? tail_bwd_d<8>(a, on, stream) : tail_fwd_d<8>(a, on, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline bool layer_shape_ok(int B, int S, int D, int H, int F) {
  return shape_ok(B, S, D, H) && F % kBC == 0 && F >= kBC && F <= 1024;
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D] bf16, kvalid [M] f32, the 12 parameters (bf16, in the
// order in_w [3D, D], in_b, out_w [D, D], out_b, ln1_w, ln1_b, w1 [F, D],
// b1, w2 [D, F], b2, ln2_w, ln2_b), then what the backward reuses: qkv
// [M, 3D], ctx [M, D] (bf16), lse [M, H] (f32); out [M, D] (bf16).  ints: B,
// S, D, H, F, act, seed lo, seed hi.  floats: rate.
extern "C" int train_layer_forward(const void** p, const int* n,
                                   const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int B = n[0], S = n[1], D = n[2], H = n[3], F = n[4];
  if (!layer_shape_ok(B, S, D, H, F)) return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[6], n[7], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = reinterpret_cast<const float*>(p[1]);
  const bf16** q = w + 2;
  bf16* qkv = const_cast<bf16*>(w[14]);
  bf16* ctx = const_cast<bf16*>(w[15]);
  float* lse = reinterpret_cast<float*>(const_cast<void*>(p[16]));
  EncTail a = {};
  a.x = x; a.ctx = ctx;
  a.out_w = q[2]; a.out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.w1 = q[6]; a.b1 = q[7]; a.w2 = q[8]; a.b2 = q[9];
  a.ln2_w = q[10]; a.ln2_b = q[11];
  a.out = const_cast<bf16*>(w[17]);
  a.M = M; a.D = D; a.H = H; a.F = F; a.act = n[5];
  a.drop = drop;

  const size_t rb = row_gemm_bytes(D);
  static SmemGrant g_lin;
  if (!allow_smem(linear_kernel, rb, g_lin)) return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  linear_kernel<<<dim3(blocks, (3 * D + kChunk - 1) / kChunk), kThreads, rb,
                  stream>>>(x, M, D, q[0], q[1], 3 * D, qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_attn_fwd(qkv, kvalid, ctx, lse, B, S, D, H, drop, on,
                             stream)) != cudaSuccess)
    return err;
  return launch_tail(a, false, on, stream);
}

// ptrs: x [M, D] bf16, kvalid [M] f32, dout [M, D] bf16; the 12 parameters
// (bf16, the forward's order); the forward's qkv, ctx (bf16), lse (f32);
// scratch r [M, D] (f32), h [M, D], gd [M, F], da [M, F], dy [M, D], dr
// [M, D], dattn [M, D], dctx [M, D] (bf16), delta [M, H], dqkv [M, 3D]
// (bf16), lnpart [blocks, 4 D], wpart [split, max(3 D D, F D)] (f32); dx
// [M, D] (bf16); the 12 parameter gradients (f32, the forward's order).
// ints: B, S, D, H, F, act, seed lo, seed hi, split.  floats: rate.
extern "C" int train_layer_backward(const void** p, const int* n,
                                    const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  auto fptr = [&](int i) {
    return reinterpret_cast<float*>(const_cast<void*>(p[i]));
  };
  auto bptr = [&](int i) { return const_cast<bf16*>(w[i]); };
  const int B = n[0], S = n[1], D = n[2], H = n[3], F = n[4], split = n[8];
  if (!layer_shape_ok(B, S, D, H, F) || split < 1)
    return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[6], n[7], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = fptr(1);
  const bf16** q = w + 3;
  const bf16 *qkv = w[15], *ctx = w[16];
  const float* lse = fptr(17);
  EncTail a = {};
  a.x = x; a.ctx = ctx; a.dout = w[2];
  a.out_w = q[2]; a.out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.w1 = q[6]; a.b1 = q[7]; a.w2 = q[8]; a.b2 = q[9];
  a.ln2_w = q[10]; a.ln2_b = q[11];
  a.r = fptr(18);
  a.h = bptr(19); a.gd = bptr(20); a.da = bptr(21); a.dy = bptr(22);
  a.dr = bptr(23); a.dattn = bptr(24); a.dctx = bptr(25);
  a.delta = fptr(26);
  bf16* dqkv = bptr(27);
  a.lnpart = fptr(28);
  float* wpart = fptr(29);
  bf16* dx = bptr(30);
  float* g[12];
  for (int i = 0; i < 12; ++i) g[i] = fptr(31 + i);
  a.M = M; a.D = D; a.H = H; a.F = F; a.act = n[5];
  a.drop = drop;

  const size_t rb3 = row_gemm_bytes(3 * D);
  static SmemGrant g_dx;
  if (!allow_smem(linear_nn_kernel, rb3, g_dx)) return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  const int tail_blocks = (M + kTRows - 1) / kTRows;
  cudaError_t err;
  if ((err = launch_tail(a, true, on, stream)) != cudaSuccess) return err;
  // LayerNorm gradients: ln1_w, ln1_b, ln2_w, ln2_b = g[4], g[5], g[10], g[11]
  float* ln_out[4] = {g[4], g[5], g[10], g[11]};
  for (int k = 0; k < 4; ++k)
    if ((err = reduce_partials(a.lnpart + k * D, tail_blocks, (size_t)4 * D,
                               D, ln_out[k], stream)) != cudaSuccess)
      return err;
  if ((err = launch_attn_bwd(qkv, a.dctx, kvalid, lse, a.delta, dqkv, B, S, D,
                             H, drop, on, stream)) != cudaSuccess)
    return err;
  linear_nn_kernel<<<blocks, kThreads, rb3, stream>>>(dqkv, M, 3 * D, q[0], D,
                                                      a.dr, dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = weight_grad(dqkv, 3 * D, 3 * D, x, D, D, M, split, wpart, g[0],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(dqkv, 3 * D, 3 * D, M, split, wpart, g[1],
                       stream)) != cudaSuccess) return err;
  if ((err = weight_grad(a.dattn, D, D, ctx, D, D, M, split, wpart, g[2],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(a.dattn, D, D, M, split, wpart, g[3], stream)) !=
      cudaSuccess) return err;
  if ((err = weight_grad(a.da, F, F, a.h, D, D, M, split, wpart, g[6],
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(a.da, F, F, M, split, wpart, g[7], stream)) !=
      cudaSuccess) return err;
  if ((err = weight_grad(a.dy, D, D, a.gd, F, F, M, split, wpart, g[8],
                         stream)) != cudaSuccess) return err;
  return bias_grad(a.dy, D, D, M, split, wpart, g[9], stream);
}

// ptrs: pm [B, H, S, S], rm [M, D], m1 [M, F], m2 [M, D] (f32): the four
// keep-masks of a seed (probabilities, residual, FFN hidden, FFN output).
// ints: B, S, D, H, F, seed lo, seed hi.  floats: rate.
extern "C" int train_layer_masks(const void** p, const int* n, const float* f,
                                 void* stream_ptr) {
  const unsigned long long B = n[0], S = n[1], D = n[2], H = n[3], F = n[4];
  const Dropout d = make_dropout(n[5], n[6], f[0]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned long long sizes[4] = {B * H * S * S, B * S * D, B * S * F,
                                       B * S * D};
  for (uint32_t k = 0; k < 4; ++k) {
    cudaError_t err = fill_mask(
        reinterpret_cast<float*>(const_cast<void*>(p[k])), sizes[k], d, k,
        stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
