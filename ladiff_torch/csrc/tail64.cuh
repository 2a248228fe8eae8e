// Building blocks of the tails and projections on 64-row blocks: kernel
// 12's (train_layer.cu), kernel 13's and K2's (dec_tail64.cuh,
// train_decoder_layer.cu, decoder_layer.cu), and the FFN tail of kernels 5
// and 9 (ffn_tail64.cuh).
//
// A block of 16 warps owns 64 rows: warp w computes the 16-row tile w / 4
// and one quarter of the output columns (about 80 accumulator registers a
// thread, so the 16 warps fit one SM's register file).  Products are
// mma.sync.m16n8k16 bf16 -> f32 with the accumulators in registers; the A
// operand (activations, bf16) is in shared memory and reaches the tensor
// cores through ldmatrix; the weight streams through a three-stage cp.async
// ring of 64-deep k slices, each slice serving all 64 rows (twice the rows a
// byte of weight served on the first port's 32-row blocks).  The
// epilogues work on the accumulator registers: a LayerNorm's row sums are
// quad shuffles plus one 4-way exchange through shared memory, its column
// sums (the weight gradients' partials) shuffles plus one kTRowWarps-way
// exchange.
//
// Element e of accumulator [mt][nt] of a thread (lane l, warp w) sits at
// row 16 kTMT (w / 4) + 16 mt + l / 4 + 8 (e / 2) and column
// (w % 4) N / 4 + 8 nt + 2 (l % 4) + e % 2 of the product's N columns.
#pragma once

#include "flash_tile.cuh"

namespace ladiff {

constexpr int kTRows = 64;       // rows of a tail block
constexpr int kTRowWarps = 4;    // warps along the rows (x 4 along columns)
constexpr int kTThreads = 32 * 4 * kTRowWarps;
constexpr int kTMT = kTRows / 16 / kTRowWarps;  // 16-row tiles a warp owns
constexpr int kTKT = 64;         // k per ring stage
constexpr int kTStages = 3;
constexpr int kTFC = 128;        // FFN hidden columns per chunk
// the largest stage: 256 weight rows x (64 + 8) (>= 64 x (256 + 8))
constexpr int kTStageEl = 256 * (kTKT + 8);
constexpr size_t kTRingBytes = (size_t)kTStages * kTStageEl * sizeof(bf16);

struct TailLane {
  int wr, wc, g, tq;
};

__device__ __forceinline__ TailLane tail_lane() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {warp >> 2, warp & 3, lane >> 2, lane & 3};
}

// The row of element half hf (e / 2) of row tile mt, and the column of
// pair element b (e % 2) of column tile nt in an N = 32 NT wide product.
__device__ __forceinline__ int trow(const TailLane& t, int mt, int hf) {
  return 16 * kTMT * t.wr + 16 * mt + t.g + 8 * hf;
}
template <int NT>
__device__ __forceinline__ int tcol(const TailLane& t, int nt) {
  return t.wc * 8 * NT + 8 * nt + 2 * t.tq;
}

__device__ __forceinline__ float2 ldg2(const bf16* p) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
  __nv_bfloat162 v;
  *reinterpret_cast<unsigned*>(&v) = u;
  return __bfloat1622float2(v);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc[64 x 32 NT] += A[64 x K] (bf16, smem, row stride lda) times a weight:
//   kNN false: W^T, W pointing at row 0 of 32 NT rows of a torch Linear
//              weight [out, in] (row stride ldw, K columns used);
//   kNN true:  W, W pointing at row 0 of K rows of a row-major matrix (row
//              stride ldw, 32 NT columns used): a Linear weight used from
//              its "out" side, as a backward needs it.
// K a multiple of kTKT; 16-byte aligned rows.  All threads call it; it
// starts and ends with __syncthreads (A may be rewritten after it).
template <int NT, bool kNN>
__device__ __forceinline__ void tail_gemm(float (&acc)[kTMT][NT][4],
                                          const bf16* A, int lda,
                                          const bf16* W, int ldw, int K,
                                          bf16* ring) {
  constexpr int N = 32 * NT;
  constexpr int kLdB = kNN ? N + 8 : kTKT + 8;
  static_assert((kNN ? kTKT * (N + 8) : N * (kTKT + 8)) <= kTStageEl,
                "stage too small");
  const TailLane t = tail_lane();
  const int lane = threadIdx.x & 31;
  const int nk = K / kTKT;
  auto load = [&](int kt) {
    if (kt < nk) {
      bf16* dst = ring + (kt % kTStages) * kTStageEl;
      if (kNN) {
        constexpr int kV = N / 8;
        for (int v = threadIdx.x; v < kTKT * kV; v += kTThreads) {
          const int r = v / kV, c = (v % kV) * 8;
          cp_async16(dst + r * kLdB + c,
                     W + (size_t)(kt * kTKT + r) * ldw + c);
        }
      } else {
        for (int v = threadIdx.x; v < N * (kTKT / 8); v += kTThreads) {
          const int n = v / (kTKT / 8), c = (v % (kTKT / 8)) * 8;
          cp_async16(dst + n * kLdB + c, W + (size_t)n * ldw + kt * kTKT + c);
        }
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // the previous users of the ring (and A's writers) done
#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) load(s);
  const bf16* a0 =
      A + (16 * kTMT * t.wr + (lane & 15)) * lda + (lane >> 4) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTStages - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 is consumed
    load(kt + kTStages - 1);
    const bf16* st = ring + (kt % kTStages) * kTStageEl;
#pragma unroll
    for (int kk = 0; kk < kTKT; kk += 16) {
      uint32_t af[kTMT][4];
#pragma unroll
      for (int mt = 0; mt < kTMT; ++mt)
        ldsm4(af[mt], a0 + 16 * mt * lda + kt * kTKT + kk);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int n0 = t.wc * 8 * NT + 16 * j;
        uint32_t b[4];
        if (kNN)
          ldsm4t(b, st + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdB +
                        n0 + (lane >> 4) * 8);
        else
          ldsm4(b, st + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kLdB + kk +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < kTMT; ++mt) {
          mma16816(acc[mt][2 * j], af[mt], b[0], b[1]);
          mma16816(acc[mt][2 * j + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int NT>
__device__ __forceinline__ void tail_zero(float (&acc)[kTMT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// p[mt][hf] and q[mt][hf] <- their sums over the row's D columns (the
// quad's, then the 4 column quarters' through red, 2 x 64 x 4 floats).
__device__ __forceinline__ void tail_row_sum2(float (&p)[kTMT][2],
                                              float (&q)[kTMT][2], float* red) {
  const TailLane t = tail_lane();
  __syncthreads();  // red's previous readers are done
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      p[mt][hf] = quad_sum(p[mt][hf]);
      q[mt][hf] = quad_sum(q[mt][hf]);
      if (t.tq == 0) {
        const int r = trow(t, mt, hf);
        red[r * 4 + t.wc] = p[mt][hf];
        red[kTRows * 4 + r * 4 + t.wc] = q[mt][hf];
      }
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* rp = red + trow(t, mt, hf) * 4;
      const float* rq = rp + kTRows * 4;
      p[mt][hf] = (rp[0] + rp[1]) + (rp[2] + rp[3]);
      q[mt][hf] = (rq[0] + rq[1]) + (rq[2] + rq[3]);
    }
}

// v <- (v - mean) * rstd per row (two passes); returns mean and rstd.
template <int NT>
__device__ __forceinline__ void tail_normalize(float (&v)[kTMT][NT][4], int D,
                                               float* red, float (&mean)[kTMT][2],
                                               float (&rstd)[kTMT][2]) {
  float s[kTMT][2] = {}, z[kTMT][2] = {};
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][e >> 1] += v[mt][nt][e];
  tail_row_sum2(s, z, red);
  float q[kTMT][2] = {};
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) mean[mt][hf] = s[mt][hf] / D;
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[mt][nt][e] - mean[mt][e >> 1];
        q[mt][e >> 1] += d * d;
      }
  tail_row_sum2(q, z, red);
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      rstd[mt][hf] = rsqrtf(q[mt][hf] / D + kLnEps);
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[mt][nt][e] = (v[mt][nt][e] - mean[mt][e >> 1]) * rstd[mt][e >> 1];
}

// v <- v * w[col] + b[col]
template <int NT>
__device__ __forceinline__ void tail_affine(float (&v)[kTMT][NT][4],
                                            const bf16* w, const bf16* b) {
  const TailLane t = tail_lane();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = tcol<NT>(t, nt);
    const float2 wv = ldg2(w + c), bv = ldg2(b + c);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt) {
      v[mt][nt][0] = v[mt][nt][0] * wv.x + bv.x;
      v[mt][nt][1] = v[mt][nt][1] * wv.y + bv.y;
      v[mt][nt][2] = v[mt][nt][2] * wv.x + bv.x;
      v[mt][nt][3] = v[mt][nt][3] * wv.y + bv.y;
    }
  }
}

// The LayerNorm VJP of the rows held as xhat (normalized input) with rstd:
// d (the upstream gradient) <- the input's gradient; gw[nt][b] += d xhat,
// gb[nt][b] += d summed over the thread's rows (the weight and bias
// gradients' partials).
template <int NT>
__device__ __forceinline__ void tail_ln_bwd(const float (&xhat)[kTMT][NT][4],
                                            float (&d)[kTMT][NT][4],
                                            const float (&rstd)[kTMT][2],
                                            const bf16* w, int D, float* red,
                                            float (&gw)[NT][2],
                                            float (&gb)[NT][2]) {
  const TailLane t = tail_lane();
  float sg[kTMT][2] = {}, sx[kTMT][2] = {};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 wv = ldg2(w + tcol<NT>(t, nt));
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dv = d[mt][nt][e], xh = xhat[mt][nt][e];
        gw[nt][e & 1] += dv * xh;
        gb[nt][e & 1] += dv;
        const float gv = dv * ((e & 1) ? wv.y : wv.x);
        d[mt][nt][e] = gv;
        sg[mt][e >> 1] += gv;
        sx[mt][e >> 1] += gv * xh;
      }
  }
  tail_row_sum2(sg, sx, red);
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        d[mt][nt][e] = rstd[mt][hf] * (d[mt][nt][e] - sg[mt][hf] / D -
                                       xhat[mt][nt][e] * sx[mt][hf] / D);
      }
}

// out[0:D] = the block's column sums of gw, out[D:2D] of gb (buf:
// kTRowWarps x 2 D floats of shared memory).
template <int NT>
__device__ __forceinline__ void tail_col_sums(float (&gw)[NT][2],
                                              float (&gb)[NT][2], int D,
                                              float* buf, float* out) {
  const TailLane t = tail_lane();
  __syncthreads();  // buf's previous readers are done
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float w = gw[nt][b], s = gb[nt][b];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        w += __shfl_xor_sync(0xffffffffu, w, o);
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      if (t.g == 0) {
        const int c = tcol<NT>(t, nt) + b;
        buf[t.wr * 2 * D + c] = w;
        buf[t.wr * 2 * D + D + c] = s;
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * D; i += kTThreads) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kTRowWarps; ++r) v += buf[r * 2 * D + i];
    out[i] = v;
  }
}

// The column sums of the thread's 16 kTMT rows of v (N = 32 NT columns) to
// buf[wr * ld + c0 + column]: one row of buf per row warp, each element
// written by one lane (no barrier; the reader synchronizes).
template <int NT>
__device__ __forceinline__ void col_sums_to(const float (&v)[kTMT][NT][4],
                                            float* buf, int ld, int c0) {
  const TailLane t = tail_lane();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < kTMT; ++mt) s += v[mt][nt][b] + v[mt][nt][2 + b];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (t.g == 0) buf[t.wr * ld + c0 + tcol<NT>(t, nt) + b] = s;
    }
}

// ---------------------------------------------------------------------------
// The post-norm tails' pieces (kernel 12's encoder tails, the decoder tails of
// K2 and kernel 13 in dec_tail64.cuh).

// Shared memory: xa [64][D + 8] bf16; xb the same (where the tail needs a
// second row tile); the FFN chunk [64][128 + 8] bf16; the weight ring; the
// row exchange (2 x 64 x 4 floats); the column exchange (kTRowWarps x 2 D
// floats, for a backward's LayerNorm gradient sums).
inline size_t tail_smem_bytes(int D, bool xb, bool colbuf) {
  const size_t xa = (size_t)kTRows * (D + 8) * sizeof(bf16);
  return xa * (xb ? 2 : 1) + (size_t)kTRows * (kTFC + 8) * sizeof(bf16) +
         kTRingBytes + 2 * kTRows * 4 * sizeof(float) +
         (colbuf ? (size_t)kTRowWarps * 2 * D * sizeof(float) : 0);
}

struct TailSmem {
  bf16 *xa, *xb, *hid, *ring;
  float *red, *colbuf;
};

__device__ __forceinline__ TailSmem tail_smem(unsigned char* smem, int D,
                                              bool xb) {
  TailSmem m;
  m.xa = reinterpret_cast<bf16*>(smem);
  m.xb = m.xa + kTRows * (D + 8);
  m.hid = xb ? m.xb + kTRows * (D + 8) : m.xb;
  m.ring = m.hid + kTRows * (kTFC + 8);
  m.red = reinterpret_cast<float*>(m.ring + kTStages * kTStageEl);
  m.colbuf = m.red + 2 * kTRows * 4;
  return m;
}

// Rows row0 .. row0 + 63 of src [M, D] (bf16) into dst [64][D + 8] (zero
// rows past the end), one cp.async group committed.
template <int D>
__device__ __forceinline__ void load_rows64(const bf16* src, size_t row0,
                                            int nrow, bf16* dst) {
  for (int i = threadIdx.x; i < kTRows * D / 8; i += kTThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool in = r < nrow;
    cp_async16_zfill(dst + r * (D + 8) + c,
                     src + (row0 + (in ? r : 0)) * D + c, in);
  }
  cp_async_commit();
}

// v[row][c] = x + (v + bias) * keep-mask `mask` for the block's rows (zero
// rows past the end): a residual sum from a product in v.
template <int NT, bool kDrop>
__device__ __forceinline__ void residual_sum(float (&v)[kTMT][NT][4],
                                             const bf16* x, const bf16* bias,
                                             const Dropout& drop,
                                             uint32_t mask, size_t row0,
                                             int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = tcol<NT>(t, nt);
    const float2 bo = ldg2(bias + c);
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
          keep_scale2(drop, mask, idx, k0, k1);
          y0 *= k0;
          y1 *= k1;
        }
        const float2 xv = ldg2(x + idx);
        e[0] = xv.x + y0;
        e[1] = xv.y + y1;
      }
  }
}

// v <- v + (y + bias) * keep-mask `mask` (a residual sum onto rows held in
// registers).
template <int NT, bool kDrop>
__device__ __forceinline__ void residual_add(float (&v)[kTMT][NT][4],
                                             const float (&y)[kTMT][NT][4],
                                             const bf16* bias,
                                             const Dropout& drop,
                                             uint32_t mask, size_t row0) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = tcol<NT>(t, nt);
    const float2 bv = ldg2(bias + c);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float y0 = y[mt][nt][2 * hf] + bv.x, y1 = y[mt][nt][2 * hf + 1] + bv.y;
        if (kDrop) {
          float k0, k1;
          keep_scale2(drop, mask, (row0 + trow(t, mt, hf)) * D + c, k0, k1);
          y0 *= k0;
          y1 *= k1;
        }
        v[mt][nt][2 * hf] += y0;
        v[mt][nt][2 * hf + 1] += y1;
      }
  }
}

// The thread's elements of v as bf16 into dst (row stride ld; may be null)
// and, for rows < nrow, into the [M, D] scratch g (may be null).
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

// The thread's elements of v to the f32 scratch g [M, D] (rows < nrow), and
// back: plain loads, which see this kernel's own stores of the same thread.
template <int NT>
__device__ __forceinline__ void store_rows_f32(const float (&v)[kTMT][NT][4],
                                               float* g, size_t row0,
                                               int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        if (row < nrow)
          *reinterpret_cast<float2*>(g + (row0 + row) * D + tcol<NT>(t, nt)) =
              make_float2(v[mt][nt][2 * hf], v[mt][nt][2 * hf + 1]);
      }
}
template <int NT>
__device__ __forceinline__ void load_rows_f32(float (&v)[kTMT][NT][4],
                                              const float* g, size_t row0,
                                              int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        float2 r = make_float2(0.f, 0.f);
        if (row < nrow)
          r = *reinterpret_cast<const float2*>(g + (row0 + row) * D +
                                               tcol<NT>(t, nt));
        v[mt][nt][2 * hf] = r.x;
        v[mt][nt][2 * hf + 1] = r.y;
      }
}

// The FFN segment of a post-norm tail: y = (act(h W1^T + b1) * m_hid) W2^T,
// out = LN(h + (y + b2) * m_out) with the LayerNorm's ln_w, ln_b (act: 0
// relu, 1 erf GELU; masks mask_hid [M, F], mask_out [M, D]).  A backward
// reads dout and writes the scratch rows the weight gradients need: the
// hidden rows gd and their gradient da [M, F], dy [M, D] (gd may be null
// in a forward).
struct FfnSeg {
  const bf16 *w1, *b1, *w2, *b2, *ln_w, *ln_b;
  const bf16* dout;
  bf16 *gd, *da, *dy;
  int F, act;
  uint32_t mask_hid, mask_out;
};

// The FFN hidden chunk's epilogue: hid = bf16(act(u + b1) * m_hid) for
// columns c0 .. c0 + 127, and to the scratch gd for rows < nrow.
template <bool kDrop>
__device__ __forceinline__ void hidden_chunk(const float (&u)[kTMT][4][4],
                                             const FfnSeg& f,
                                             const Dropout& drop, int c0,
                                             size_t row0, int nrow,
                                             bf16* hid, bf16* gd) {
  const TailLane t = tail_lane();
  const int F = f.F;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int cc = tcol<4>(t, nt);
    const float2 bv = ldg2(f.b1 + c0 + cc);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        const float a0 = u[mt][nt][2 * hf] + bv.x;
        const float a1 = u[mt][nt][2 * hf + 1] + bv.y;
        float g0 = f.act ? gelu_erf(a0) : fmaxf(a0, 0.f);
        float g1 = f.act ? gelu_erf(a1) : fmaxf(a1, 0.f);
        if (kDrop) {
          float k0, k1;
          keep_scale2(drop, f.mask_hid, (row0 + row) * F + c0 + cc, k0, k1);
          g0 *= k0;
          g1 *= k1;
        }
        st2(hid + row * (kTFC + 8) + cc, g0, g1);
        if (gd && row < nrow) st2(gd + (row0 + row) * F + c0 + cc, g0, g1);
      }
  }
}

// y = sum over the hidden chunks of bf16(act(h W1^T + b1) * m_hid) W2^T,
// h (bf16) in xa; gd (may be null) takes the hidden rows.  Hidden columns
// [f0, f1) (f1 0: to F), multiples of kTFC: a cluster's CTA takes its
// share.
template <int NT, bool kDrop>
__device__ __forceinline__ void ffn_forward(float (&y)[kTMT][NT][4],
                                            const FfnSeg& f,
                                            const Dropout& drop,
                                            const TailSmem& m, size_t row0,
                                            int nrow, bf16* gd, int f0 = 0,
                                            int f1 = 0) {
  constexpr int D = 32 * NT;
  tail_zero(y);
  for (int c0 = f0; c0 < (f1 ? f1 : f.F); c0 += kTFC) {
    float u[kTMT][4][4];
    tail_zero(u);
    tail_gemm<4, false>(u, m.xa, D + 8, f.w1 + (size_t)c0 * D, D, D, m.ring);
    hidden_chunk<kDrop>(u, f, drop, c0, row0, nrow, m.hid, gd);
    tail_gemm<NT, false>(y, m.hid, kTFC + 8, f.w2 + c0, f.F, kTFC, m.ring);
  }
}

// The FFN segment's forward from its input h (f32; its bf16 copy in xa):
// out = LN(h + (FFN(h) + b2) * m_out) (keep-mask mask_out) for rows < nrow.
template <int NT, bool kDrop>
__device__ __forceinline__ void ffn_seg_forward(float (&h)[kTMT][NT][4],
                                                const FfnSeg& f,
                                                const Dropout& drop,
                                                uint32_t mask_out,
                                                const TailSmem& m,
                                                size_t row0, int nrow,
                                                bf16* out) {
  constexpr int D = 32 * NT;
  float mean[kTMT][2], rstd[kTMT][2];
  float y[kTMT][NT][4];
  ffn_forward<NT, kDrop>(y, f, drop, m, row0, nrow, nullptr);
  residual_add<NT, kDrop>(h, y, f.b2, drop, mask_out, row0);
  tail_normalize(h, D, m.red, mean, rstd);
  tail_affine(h, f.ln_w, f.ln_b);
  store_rows(h, nullptr, 0, out, row0, nrow);
}

// The FFN segment's backward for the block's rows.  Pre: h holds the
// segment's input (f32) and xa its bf16 copy.  Runs the FFN forward again
// (the hidden rows to gd), the closing LayerNorm's backward from dout (its
// weight and bias gradient sums to part[0:2D]), dy = ds * m_out to xb and
// the scratch, and the FFN's backward in 128-column hidden chunks (da to
// the scratch, dh accumulating in registers).  Returns in h the gradient
// of the segment's input: ds + da W1.  With kBias, also the block's column
// sums of da and dy (the bias gradients' partials, f32 before rounding) to
// bpart[0:F] and bpart[F:F + D], through bbuf (kTRowWarps x (F + D) floats
// of shared memory).
template <int NT, bool kDrop, bool kBias = false>
__device__ __forceinline__ void ffn_ln_bwd(float (&h)[kTMT][NT][4],
                                           const FfnSeg& f,
                                           const Dropout& drop,
                                           const TailSmem& m, size_t row0,
                                           int nrow, float* part,
                                           float* bbuf = nullptr,
                                           float* bpart = nullptr) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
  float mean[kTMT][2], rstd[kTMT][2];
  float y[kTMT][NT][4];
  ffn_forward<NT, kDrop>(y, f, drop, m, row0, nrow, f.gd);
  residual_add<NT, kDrop>(h, y, f.b2, drop, f.mask_out, row0);
  // the closing LayerNorm's backward: y <- ds from dout
  tail_normalize(h, D, m.red, mean, rstd);  // h <- xhat
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        float2 d = make_float2(0.f, 0.f);
        if (row < nrow) d = ldg2(f.dout + (row0 + row) * D + tcol<NT>(t, nt));
        y[mt][nt][2 * hf] = d.x;
        y[mt][nt][2 * hf + 1] = d.y;
      }
  float gw[NT][2], gb[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) gw[nt][0] = gw[nt][1] = gb[nt][0] = gb[nt][1] = 0.f;
  tail_ln_bwd(h, y, rstd, f.ln_w, D, m.red, gw, gb);
  tail_col_sums(gw, gb, D, m.colbuf, part);
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
          keep_scale2(drop, f.mask_out,
                      (row0 + trow(t, mt, hf)) * D + tcol<NT>(t, nt), k0, k1);
          d0 *= k0;
          d1 *= k1;
        }
        y[mt][nt][2 * hf] = d0;
        y[mt][nt][2 * hf + 1] = d1;
      }
  store_rows(y, m.xb, D + 8, f.dy, row0, nrow);
  if (kBias) col_sums_to<NT>(y, bbuf + f.F, f.F + D, 0);
  // per hidden chunk: da = (dy W2) * m_hid * act'(h W1^T + b1) to the
  // scratch, dh += da W1
  for (int c0 = 0; c0 < f.F; c0 += kTFC) {
    float u[kTMT][4][4], gv[kTMT][4][4];
    tail_zero(u);
    tail_zero(gv);
    tail_gemm<4, false>(u, m.xa, D + 8, f.w1 + (size_t)c0 * D, D, D, m.ring);
    tail_gemm<4, true>(gv, m.xb, D + 8, f.w2 + c0, f.F, D, m.ring);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int cc = tcol<4>(t, nt);
      const float2 bv = ldg2(f.b1 + c0 + cc);
#pragma unroll
      for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = trow(t, mt, hf);
          float d0 = gv[mt][nt][2 * hf] * act_grad(u[mt][nt][2 * hf] + bv.x,
                                                   f.act);
          float d1 = gv[mt][nt][2 * hf + 1] *
                     act_grad(u[mt][nt][2 * hf + 1] + bv.y, f.act);
          if (kDrop) {
            float k0, k1;
            keep_scale2(drop, f.mask_hid, (row0 + row) * f.F + c0 + cc, k0,
                        k1);
            d0 *= k0;
            d1 *= k1;
          }
          st2(m.hid + row * (kTFC + 8) + cc, d0, d1);
          if (row < nrow) st2(f.da + (row0 + row) * f.F + c0 + cc, d0, d1);
          if (kBias) {
            gv[mt][nt][2 * hf] = d0;
            gv[mt][nt][2 * hf + 1] = d1;
          }
        }
    }
    if (kBias) col_sums_to<4>(gv, bbuf, f.F + D, c0);
    tail_gemm<NT, true>(h, m.hid, kTFC + 8, f.w1 + (size_t)c0 * D, D, kTFC,
                        m.ring);
  }
  if (kBias) {
    // the row warps' sums in a fixed order (tail_gemm ended synchronized)
    for (int i = threadIdx.x; i < f.F + D; i += kTThreads) {
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kTRowWarps; ++r) v += bbuf[r * (f.F + D) + i];
      bpart[i] = v;
    }
  }
}

// LN_a's backward for the block's rows: y holds its input (f32; consumed),
// mean and rstd its statistics, d the gradient of its output, which becomes
// its input's; the block's weight and bias gradient sums to part[0:2D].
template <int NT>
__device__ __forceinline__ void tail_ln_bwd_rows(float (&y)[kTMT][NT][4],
                                                 float (&d)[kTMT][NT][4],
                                                 const float (&mean)[kTMT][2],
                                                 const float (&rstd)[kTMT][2],
                                                 const bf16* w,
                                                 const TailSmem& m,
                                                 float* part) {
  constexpr int D = 32 * NT;
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[mt][nt][e] = (y[mt][nt][e] - mean[mt][e >> 1]) * rstd[mt][e >> 1];
  float gw[NT][2], gb[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) gw[nt][0] = gw[nt][1] = gb[nt][0] = gb[nt][1] = 0.f;
  tail_ln_bwd(y, d, rstd, w, D, m.red, gw, gb);
  tail_col_sums(gw, gb, D, m.colbuf, part);
}

// The self-attention segment's out-projection backward for the block's rows,
// from d = dr, the gradient of the residual sum x + (ctx W^T + b) * m (f32;
// consumed): dr to the scratch; dattn = dr * m (keep-mask `mask`) to xa and
// the scratch; dctx = bf16(dattn W) to xb and the scratch; delta = dctx . ctx
// per row and head (the attention backward's row term).
template <int NT, bool kDrop>
__device__ __forceinline__ void attn_out_bwd(float (&d)[kTMT][NT][4],
                                             const bf16* ctx,
                                             const bf16* out_w,
                                             const Dropout& drop,
                                             uint32_t mask, bf16* dr,
                                             bf16* dattn, bf16* dctx,
                                             float* delta, int H,
                                             const TailSmem& m, size_t row0,
                                             int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
  store_rows(d, nullptr, 0, dr, row0, nrow);
  if (kDrop) {
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float k0, k1;
          keep_scale2(drop, mask,
                      (row0 + trow(t, mt, hf)) * D + tcol<NT>(t, nt), k0, k1);
          d[mt][nt][2 * hf] *= k0;
          d[mt][nt][2 * hf + 1] *= k1;
        }
  }
  store_rows(d, m.xa, D + 8, dattn, row0, nrow);
  float y[kTMT][NT][4];
  tail_zero(y);
  tail_gemm<NT, true>(y, m.xa, D + 8, out_w, D, D, m.ring);
  store_rows(y, m.xb, D + 8, dctx, row0, nrow);
  __syncthreads();
  const int Dh = D / H, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < nrow * H; p += kTThreads / 32) {
    const int row = p / H, hh = p % H;
    float acc = 0.f;
    for (int c = lane; c < Dh; c += 32)
      acc += tof(m.xb[row * (D + 8) + hh * Dh + c]) *
             ldgf(ctx + (row0 + row) * D + hh * Dh + c);
    acc = warp_sum(acc);
    if (lane == 0) delta[(row0 + row) * H + hh] = acc;
  }
}

// ---------------------------------------------------------------------------
// linear64: a row-block product on the tails' blocks, for the projections
// of the decoder layers (K2, kernel 13):
//   kNN false: out = A W^T + bias, W a torch Linear weight [N, K];
//   kNN true:  out = add + A W, W [K, N] row-major with row stride ldw (a
//              Linear weight used from its "out" side; add may be null).
// A [M, K] bf16 with K a multiple of 64 up to 768; one block per 64 rows and
// 32 NT output columns (blockIdx.y); the A tile stays in shared memory while
// the weight streams through the ring.
inline size_t linear64_smem_bytes(int K) {
  return (size_t)kTRows * (K + 8) * sizeof(bf16) + kTRingBytes;
}

template <int NT, bool kNN>
__global__ void __launch_bounds__(kTThreads)
linear64_kernel(const bf16* A, int M, int K, const bf16* W, int ldw,
                const bf16* bias, const bf16* add, int N, bf16* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xa = reinterpret_cast<bf16*>(smem);
  bf16* ring = xa + kTRows * (K + 8);
  const TailLane t = tail_lane();
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(M - row0));
  const int n0 = blockIdx.y * 32 * NT;
  const int kv = K / 8;
  for (int i = threadIdx.x; i < kTRows * kv; i += kTThreads) {
    const int r = i / kv, c = (i % kv) * 8;
    const bool in = r < nrow;
    cp_async16_zfill(xa + r * (K + 8) + c,
                     A + (row0 + (in ? r : 0)) * K + c, in);
  }
  cp_async_commit();
  float acc[kTMT][NT][4];
  tail_zero(acc);
  if (kNN)
    tail_gemm<NT, true>(acc, xa, K + 8, W + n0, ldw, K, ring);
  else
    tail_gemm<NT, false>(acc, xa, K + 8, W + (size_t)n0 * ldw, ldw, K, ring);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n0 + tcol<NT>(t, nt);
    const float2 bv = (!kNN && bias) ? ldg2(bias + c) : make_float2(0.f, 0.f);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        if (row >= nrow) continue;
        const size_t o = (row0 + row) * N + c;
        float v0 = acc[mt][nt][2 * hf] + bv.x, v1 = acc[mt][nt][2 * hf + 1] + bv.y;
        if (kNN && add) {
          const float2 av = ldg2(add + o);
          v0 += av.x;
          v1 += av.y;
        }
        st2(out + o, v0, v1);
      }
  }
}

// Internal linkage: each library keeps its own shared-memory grants (see
// attn_tile.cuh).
template <int NT, bool kNN>
static inline cudaError_t linear64_nt(const bf16* A, int M, int K,
                                      const bf16* W, int ldw,
                                      const bf16* bias, const bf16* add,
                                      int N, bf16* out, cudaStream_t stream) {
  static SmemGrant grant;
  const size_t bytes = linear64_smem_bytes(K);
  if (!allow_smem(linear64_kernel<NT, kNN>, bytes, grant))
    return cudaErrorInvalidValue;
  linear64_kernel<NT, kNN>
      <<<dim3((M + kTRows - 1) / kTRows, N / (32 * NT)), kTThreads, bytes,
         stream>>>(A, M, K, W, ldw, bias, add, N, out);
  return cudaGetLastError();
}

// out [M, N] = A W^T + bias (kNN false) or add + A W (kNN true); N a
// multiple of 64, each block taking the widest of 256, 192, 128 or 64
// columns that divides N.
template <bool kNN>
static inline cudaError_t launch_linear64(const bf16* A, int M, int K,
                                          const bf16* W, int ldw,
                                          const bf16* bias, const bf16* add,
                                          int N, bf16* out,
                                          cudaStream_t stream) {
  if (M < 1 || K % kTKT || K < kTKT || K > 768 || N % 64 || N < 64)
    return cudaErrorInvalidValue;
  if (N % 256 == 0)
    return linear64_nt<8, kNN>(A, M, K, W, ldw, bias, add, N, out, stream);
  if (N % 192 == 0)
    return linear64_nt<6, kNN>(A, M, K, W, ldw, bias, add, N, out, stream);
  if (N % 128 == 0)
    return linear64_nt<4, kNN>(A, M, K, W, ldw, bias, add, N, out, stream);
  return linear64_nt<2, kNN>(A, M, K, W, ldw, bias, add, N, out, stream);
}

}  // namespace ladiff
