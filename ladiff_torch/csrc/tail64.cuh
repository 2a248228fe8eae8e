// Building blocks of kernel 12's tails on 64-row blocks (train_layer.cu).
//
// A block of 16 warps owns 64 rows: warp w computes the 16-row tile w / 4
// and one quarter of the output columns (about 80 accumulator registers a
// thread, so the 16 warps fit one SM's register file).  Products are
// mma.sync.m16n8k16 bf16 -> f32 with the accumulators in registers; the A
// operand (activations, bf16) is in shared memory and reaches the tensor
// cores through ldmatrix; the weight streams through a three-stage cp.async
// ring of 64-deep k slices, each slice serving all 64 rows (twice the rows a
// byte of weight served on the 32-row blocks of ffn_tail.cuh).  The
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

}  // namespace ladiff
