// Float32 products on the H100's tensor cores in three-term TF32, for the
// float32 training kernels 12 and 13 and the float32 inference kernels K2
// and 10 (f32_train_layer.cu).
//
// Each float32 operand x is split into hi = x rounded to TF32 (10 mantissa
// bits, to nearest, ties away from zero: cvt.rna.tf32.f32's result, here
// in two integer operations) and lo = x - hi (exact in float32; the tensor
// core reads its top 10 mantissa bits); a product accumulates lo_a hi_b +
// hi_a lo_b + hi_a hi_b in float32 (mma.sync.m16n8k8 TF32, the small terms
// first).  The dropped lo_a lo_b and lo's cut bits leave a relative error
// of about 2^-21 a product: float32 accuracy at three times the TF32 work
// (495 / 3 = 165 TFLOP/s on the H100 against the FFMA pipes' 67).  The
// split is three ALU operations a fragment element; the cvt instruction
// runs on the SM's conversion pipe, a quarter of the ALU rate.  mma.sync
// loads its fragments from shared memory element by element, so an
// operand staged in either layout (K-major rows or M/N-major rows, each
// copied in 16-byte cp.async pieces) feeds it: the transposed products dY
// W and dY^T X read their operands as they lie in device memory.
//
//   gemm_tc_kernel   C = epilogue(A B^T) over a group of up to kMaxProb
//                    problems of one layout in one launch: 256 threads, a
//                    4-stage cp.async ring of 16-deep k slices, warps of 32
//                    x 64 outputs (32 x 32 in inference's 64-row product
//                    tiles and 32-row row blocks).  Epilogues:
//                    bias, ReLU / exact-erf GELU (the pre-activation
//                    stored), the activation's derivative, a dropout
//                    keep-scale, a residual (kEpiGen);
//                    float32 split-K partials with the column sums of A
//                    (kEpiPart: weight and bias gradients, summed later in
//                    split order); whole rows of D <= 256 staged in shared
//                    memory (kEpiRow): the LayerNorm after a residual (the
//                    residual and the normalised row stored), a LayerNorm's
//                    backward (dx, dx times a keep-scale, the block's column
//                    sums of g xhat and g), or the attention backward's
//                    delta = dctx . ctx per head.
//   attn_fwd_tc      flash attention forward: one block of 4 warps per
//                    (sample, head, 64-query tile), keys in 64-key tiles,
//                    the online softmax in registers, P rearranged from
//                    the accumulator layout into P V's operand by shuffles.
//   attn_inf_tc      the same at inference (no dropout, no log-sum-exp):
//                    the operands split once (see InfSmem), key tiles
//                    without a valid key skipped.
//   attn_bwd_tc      its backward: one block of 8 warps per (sample, head,
//                    64-key tile) walks the query tiles; each logit is
//                    computed once: S and dP of 16 queries a warp, P, P
//                    keep and dS to shared memory, then dV += (P keep)^T dO
//                    and dK += dS^T Q of 16 keys a warp, and the block's
//                    share of dQ = dS K written as its key tile's partial
//                    (summed over the key tiles in order by the reduction:
//                    no atomics).
//
// What bounds them on the H100: FLOP / 165 TFLOP/s against 4 bytes an
// element at 3.35 TB/s; at the layers' shapes (D 256, F 1024, 13,184 rows)
// the products carry ~100 FLOP a byte, above the ~49 where float32 at 165
// TFLOP/s turns compute-bound, so the tensor cores are the limit and the
// design keeps them fed: operands in shared memory reused by 8 warps,
// epilogues fused so no intermediate takes another pass.  The attention at
// inference: at the frozen encode's 128 x 206 tokens (D 256) its q, k, v
// and output take 0.032 ms at 3.35 TB/s against 0.018 ms for the valid
// pairs' products at 165 TFLOP/s, so the bytes bound it there and the
// products at head width 128 over ~200 unmasked keys; a tile that splits
// every fragment element at each load (four warps splitting the same K and
// V) is held back by those splits, so the inference tile splits K and V
// once a block and skips key tiles without a valid key.
#pragma once

#include "f32_tile.cuh"

namespace ladiff {
namespace tc {

// the float32 chains' dropout, activations and logits (f32_tile.cuh)
using f32::act_f32;
using f32::act_grad_f32;
using f32::Drop;
using f32::key_logit;
using f32::make_drop;

// hi = x rounded to TF32 (cvt.rna.tf32.f32 for finite x: half an ulp of the
// 10-bit mantissa added to the magnitude, the 13 low bits cut), lo = x - hi.
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b over one m16n8k8 TF32 tile
__device__ __forceinline__ void mma8(float* d, const uint32_t* a,
                                     const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t h[4], l[4];
};
struct FragB {
  uint32_t h[2], l[2];
};

// Element (r, k) of an operand tile in shared memory: [r][k] rows of ld
// floats (K-major), or [k][r] (MN: M/N-major).
template <bool MN>
__device__ __forceinline__ float at(const float* s, int ld, int r, int k) {
  return MN ? s[k * ld + r] : s[r * ld + k];
}

// The A fragment of the 16 x 8 tile at (r0, k0): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); g = lane / 4, t = lane % 4.
template <bool MN>
__device__ __forceinline__ void load_a(FragA& f, const float* s, int ld,
                                       int r0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split3(at<MN>(s, ld, r0 + g, k0 + t), f.h[0], f.l[0]);
  split3(at<MN>(s, ld, r0 + g + 8, k0 + t), f.h[1], f.l[1]);
  split3(at<MN>(s, ld, r0 + g, k0 + t + 4), f.h[2], f.l[2]);
  split3(at<MN>(s, ld, r0 + g + 8, k0 + t + 4), f.h[3], f.l[3]);
}

// The B fragment of the 8 (k) x 8 (n) tile at (n0, k0): b0 (k t, n g), b1
// (k t + 4, n g).
template <bool MN>
__device__ __forceinline__ void load_b(FragB& f, const float* s, int ld,
                                       int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split3(at<MN>(s, ld, n0 + g, k0 + t), f.h[0], f.l[0]);
  split3(at<MN>(s, ld, n0 + g, k0 + t + 4), f.h[1], f.l[1]);
}

// d += a b in three-term TF32
__device__ __forceinline__ void mma3(float* d, const FragA& a,
                                     const FragB& b) {
  mma8(d, a.l, b.h);
  mma8(d, a.h, b.l);
  mma8(d, a.h, b.h);
}

// A 16-byte asynchronous copy, or 16 zero bytes where !ok (src is then not
// read, but stays a valid address).
__device__ __forceinline__ void cp16z(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// ---------------------------------------------------------------------------
// The GEMM

constexpr int kBK = 16, kStages = 4, kThreads = 256, kMaxProb = 8;
constexpr int kRowBM = 64;  // rows of a row-epilogue block (LN partials)
enum { kEpiGen = 0, kEpiPart = 1, kEpiRow = 2 };
enum { kRowLnF = 1, kRowLnB = 2, kRowDelta = 3 };

// One product C[m, n] = epi(sum_k A(m, k) B(n, k)): A(m, k) = A[m lda + k]
// (a_mn: A[k lda + m]), B(n, k) = B[n ldb + k] (b_mn: B[k ldb + n]).
struct Prob {
  const float* A;
  const float* B;
  float* C;
  int M, N, K, lda, ldb, ldc;
  int ksplit, tm, tn, splits, block0;
  // kEpiPart: a split's rows go to nsub partials of kflush rows each (the
  // tensor cores' float32 accumulation rounds toward zero, so a chain of
  // thousands of rows drifts: each partial sums at most kflush rows, and
  // the partials are summed to nearest)
  int kflush, nsub;
  size_t cstride;   // kEpiPart: C's elements a partial
  float* colsum;    // kEpiPart: sum_k A(m, k) over a split, or null
  size_t sstride;
  // kEpiGen and kEpiRow: v = act(acc + bias) (acc + bias to pre), times
  // act'(gin), times keep(drop, m N + n), plus R
  const float* bias;
  int act;
  float* pre;
  int ldpre;
  const float* gin;
  int ldg, gact;
  Drop drop;
  const float* R;
  int ldr;
  // kEpiRow (N <= 256 columns, one column tile)
  int row;
  float* xout;        // kRowLnF: v itself (the residual stream), or null
  int ldx;
  const float* lnw;   // the LayerNorm's weight and bias (kRowLnB: weight)
  const float* lnb;
  const float* lnx;   // kRowLnB: the LayerNorm's input rows
  int ldlnx;
  float* C2;          // kRowLnB: dx * keep(drop2, m N + n), or null
  Drop drop2;
  float* part;        // kRowLnB: [tile m][2 N] column sums of g xhat, g
  int ldpart;
  const float* ctx;   // kRowDelta: delta[m H + h] = sum over head h of v ctx
  int ldctx;
  float* delta;
  int H;
};

struct Group {
  Prob p[kMaxProb];
  int n;
};

template <int BM, int BN, int WM, int WN, bool AMN, bool BMN, int EPI>
struct GemmCfg {
  static constexpr int kWM = BM / WM, kWN = BN / WN;
  static constexpr int MT = kWM / 16, NT = kWN / 8;
  static constexpr int LDA = AMN ? BM + 8 : kBK + 4;
  static constexpr int LDB = BMN ? BN + 8 : kBK + 4;
  static constexpr int A_FLOATS = AMN ? kBK * LDA : BM * LDA;
  static constexpr int B_FLOATS = BMN ? kBK * LDB : BN * LDB;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int LDT = BN + 4;
  static constexpr int ROW_FLOATS = BM * LDT + 8 * 2 * BN;
  static constexpr int FLOATS =
      EPI == kEpiRow && ROW_FLOATS > kStages * STAGE ? ROW_FLOATS
                                                     : kStages * STAGE;
  static constexpr size_t SMEM = (size_t)FLOATS * sizeof(float);
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(kWM % 16 == 0 && kWN % 8 == 0, "warp tile");
};

// Copies rows [r0, r0 + R) x k [k0, k0 + kBK) of an operand into a stage:
// K-major as [r][k] (16-byte pieces along k), M/N-major as [k][r] (pieces
// along r).  Rows past `rows` and k past ke are zero.
template <int R, bool MN>
__device__ __forceinline__ void load_tile(float* s, int ld_s, const float* src,
                                          int ld, int r0, int rows, int k0,
                                          int ke) {
  constexpr int PIECES = R * kBK / 4;
  static_assert(PIECES % kThreads == 0 || PIECES < kThreads,
                "whole pieces a thread, or one piece a thread for some");
  constexpr int ITS = (PIECES + kThreads - 1) / kThreads;
  if (PIECES < kThreads && (int)threadIdx.x >= PIECES) return;
  if (!MN) {
#pragma unroll
    for (int it = 0; it < ITS; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kBK / 4), kq = (i % (kBK / 4)) * 4;
      const bool ok = r0 + r < rows && k0 + kq < ke;
      cp16z(s + r * ld_s + kq,
            ok ? src + (size_t)(r0 + r) * ld + k0 + kq : src, ok);
    }
  } else {
#pragma unroll
    for (int it = 0; it < ITS; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int k = i / (R / 4), rq = (i % (R / 4)) * 4;
      const bool ok = k0 + k < ke && r0 + rq < rows;
      cp16z(s + k * ld_s + rq,
            ok ? src + (size_t)(k0 + k) * ld + r0 + rq : src, ok);
    }
  }
}

// The keep-scales k[i] of columns lane + 32 i (i < per <= 8) of a row whose
// element 0 has index base (a multiple of 4): each lane draws one Philox
// block for every four 32-column chunks, and the lanes pass the words
// round.  Every lane of the warp calls it.
__device__ __forceinline__ void row_keep(const Drop& d, uint64_t base,
                                         int per, int lane, float (&k)[8]) {
#pragma unroll
  for (int c0 = 0; c0 < 8; c0 += 4) {
    if (c0 >= per) break;
    const uint64_t q = (base >> 2) + 8 * (c0 + (lane >> 3)) + (lane & 7);
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                   d.mask_id, 0u),
        d.d.key0, d.d.key1);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int src = 8 * cc + (lane >> 2);
      const uint32_t x = __shfl_sync(0xffffffffu, r.x, src);
      const uint32_t y = __shfl_sync(0xffffffffu, r.y, src);
      const uint32_t z = __shfl_sync(0xffffffffu, r.z, src);
      const uint32_t w = __shfl_sync(0xffffffffu, r.w, src);
      const int word = lane & 3;
      const uint32_t bits = word == 0 ? x : word == 1 ? y : word == 2 ? z : w;
      k[c0 + cc] = bits < d.d.thresh ? d.d.inv_keep : 0.f;
    }
  }
}

// The keep-scales of the four elements a lane holds of one accumulator
// tile, (m, n), (m, n + 1) and (m + 8, n), (m + 8, n + 1) (k[row][col]):
// with N % 4 == 0 the lanes t and t ^ 1 of a quad hold the two halves of
// one Philox block of each row, so each draws one block (the even lane row
// m's, the odd lane row m + 8's) and passes the other half to its
// neighbour: one Philox call per four elements.  Every lane of the warp
// calls it.
__device__ __forceinline__ void keep_quad(const Drop& d, int N, int m, int n,
                                          int t, float (&k)[2][2]) {
  const bool odd = t & 1;
  const uint64_t q = ((uint64_t)(m + (odd ? 8 : 0)) * N + n) >> 2;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                 d.mask_id, 0u),
      d.d.key0, d.d.key1);
  const uint32_t ra = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t rb = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  const uint32_t w[2][2] = {{odd ? ra : r.x, odd ? rb : r.y},
                            {odd ? r.z : ra, odd ? r.w : rb}};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      k[h][c] = w[h][c] < d.d.thresh ? d.d.inv_keep : 0.f;
}

// The element-wise epilogue before any row step: bias, pre, act, act',
// the dropout keep-scales kp, residual of elements (m, n) and (m, n + 1).
__device__ __forceinline__ void epi_pair(const Prob& P, int m, int n,
                                         const float* kp, float& v0,
                                         float& v1) {
  if (P.bias) {
    v0 += __ldg(P.bias + n);
    v1 += __ldg(P.bias + n + 1);
  }
  if (P.pre) {
    *reinterpret_cast<float2*>(P.pre + (size_t)m * P.ldpre + n) =
        make_float2(v0, v1);
  }
  v0 = act_f32(v0, P.act);
  v1 = act_f32(v1, P.act);
  if (P.gin) {
    const float2 gi =
        *reinterpret_cast<const float2*>(P.gin + (size_t)m * P.ldg + n);
    v0 *= act_grad_f32(gi.x, P.gact);
    v1 *= act_grad_f32(gi.y, P.gact);
  }
  v0 *= kp[0];
  v1 *= kp[1];
  if (P.R) {
    const float2 r =
        *reinterpret_cast<const float2*>(P.R + (size_t)m * P.ldr + n);
    v0 += r.x;
    v1 += r.y;
  }
}

// The row step of kEpiRow: warp w takes rows w, w + 8, .. of the block's BM
// rows (v staged in T, row stride ldt), lane columns lane + 32 i.
template <int BM>
__device__ void row_epilogue(const Prob& P, const float* T, int ldt, int m0,
                             int tile_m, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = P.N, per = N / 32;
  float pw[8], pb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) pw[i] = pb[i] = 0.f;
  for (int r = warp; r < BM; r += 8) {
    const int m = m0 + r;
    if (m >= P.M) break;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = i < per ? T[r * ldt + lane + 32 * i] : 0.f;
    if (P.row == kRowLnF) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) {
          if (P.xout) P.xout[(size_t)m * P.ldx + lane + 32 * i] = v[i];
          s += v[i];
        }
      const float mean = warp_sum(s) / N;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) q += (v[i] - mean) * (v[i] - mean);
      const float rstd = rsqrtf(warp_sum(q) / N + kLnEps);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) {
          const int c = lane + 32 * i;
          P.C[(size_t)m * P.ldc + c] =
              (v[i] - mean) * rstd * __ldg(P.lnw + c) + __ldg(P.lnb + c);
        }
    } else if (P.row == kRowLnB) {
      // v is g, the gradient of LN(x) for x = lnx
      const float* xr = P.lnx + (size_t)m * P.ldlnx;
      float x[8], s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = i < per ? xr[lane + 32 * i] : 0.f;
        s += x[i];
      }
      const float mean = warp_sum(s) / N;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) q += (x[i] - mean) * (x[i] - mean);
      const float rstd = rsqrtf(warp_sum(q) / N + kLnEps);
      float sg = 0.f, sgx = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) {
          x[i] = (x[i] - mean) * rstd;  // xhat
          const float gw = v[i] * __ldg(P.lnw + lane + 32 * i);
          sg += gw;
          sgx += gw * x[i];
          pw[i] += v[i] * x[i];
          pb[i] += v[i];
        }
      const float mg = warp_sum(sg) / N, mgx = warp_sum(sgx) / N;
      float keep[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
      if (P.C2 && P.drop2.on)
        row_keep(P.drop2, (uint64_t)m * N, per, lane, keep);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) {
          const int c = lane + 32 * i;
          const float dx =
              rstd * (v[i] * __ldg(P.lnw + c) - mg - x[i] * mgx);
          P.C[(size_t)m * P.ldc + c] = dx;
          if (P.C2) P.C2[(size_t)m * P.ldc + c] = dx * keep[i];
        }
    } else {  // kRowDelta
      const float* cr = P.ctx + (size_t)m * P.ldctx;
      const int dh = N / P.H;
      float prod[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) {
          const int c = lane + 32 * i;
          P.C[(size_t)m * P.ldc + c] = v[i];
          prod[i] = v[i] * cr[c];
        }
      for (int h = 0; h < P.H; ++h) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < per && (lane + 32 * i) / dh == h) s += prod[i];
        s = warp_sum(s);
        if (lane == 0) P.delta[(size_t)m * P.H + h] = s;
      }
    }
  }
  if (P.row == kRowLnB && P.part) {
    // the block's column sums, its warps summed in warp order
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < per) {
        red[warp * 2 * N + lane + 32 * i] = pw[i];
        red[warp * 2 * N + N + lane + 32 * i] = pb[i];
      }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * N; c += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w * 2 * N + c];
      P.part[(size_t)tile_m * P.ldpart + c] = t;
    }
  }
}

// kExact (the inference tiles): each 8-deep step's three products are
// summed from zero and added to the accumulator in float32, rounded to
// nearest, so the tensor cores' truncating accumulation acts within one
// step and not along the whole k loop: without it K2's layer read 4.7e-6
// from its float32 plain version on an H100, enough to move a decode's
// joints 1.5e-3 from the CPU's.
template <int BM, int BN, int WM, int WN, bool AMN, bool BMN, int EPI,
          bool kExact = false>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_tc_kernel(const __grid_constant__ Group grp) {
  using Cfg = GemmCfg<BM, BN, WM, WN, AMN, BMN, EPI>;
  extern __shared__ __align__(16) float smem[];
  // this block's problem, tile and split
  int pi = 0;
#pragma unroll
  for (int i = 1; i < kMaxProb; ++i)
    if (i < grp.n && (int)blockIdx.x >= grp.p[i].block0) pi = i;
  const Prob& P = grp.p[pi];
  const int local = blockIdx.x - P.block0;
  const int tiles = P.tm * P.tn;
  const int z = local / tiles, rem = local % tiles;
  const int tile_m = rem / P.tn, tile_n = rem % P.tn;
  const int m0 = tile_m * BM, n0 = tile_n * BN;
  const int kb = z * P.ksplit, ke = min(P.K, kb + P.ksplit);
  const int nk = (ke - kb + kBK - 1) / kBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / WN) * Cfg::kWM, wn0 = (warp % WN) * Cfg::kWN;

  auto load = [&](int stage, int kt) {
    float* As = smem + stage * Cfg::STAGE;
    float* Bs = As + Cfg::A_FLOATS;
    const int k0 = kb + kt * kBK;
    load_tile<BM, AMN>(As, Cfg::LDA, P.A, P.lda, m0, P.M, k0, ke);
    load_tile<BN, BMN>(Bs, Cfg::LDB, P.B, P.ldb, n0, P.N, k0, ke);
  };

  float acc[Cfg::MT][Cfg::NT][4];
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // kEpiPart: acc to partial s of this split, then zero
  auto flush = [&](int s) {
    float* C = P.C + ((size_t)z * P.nsub + s) * P.cstride;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + 16 * i + g + 8 * h;
#pragma unroll
        for (int j = 0; j < Cfg::NT; ++j) {
          const int n = n0 + wn0 + 8 * j + 2 * t;
          if (m < P.M && n < P.N)
            *reinterpret_cast<float2*>(C + (size_t)m * P.ldc + n) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
        }
      }
  };
  float csum = 0.f;
  static_assert(EPI != kEpiPart || AMN, "the column sums read A as [k][m]");
  const bool do_colsum =
      EPI == kEpiPart && P.colsum && tile_n == 0 && threadIdx.x < BM;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const float* As = smem + (kt % kStages) * Cfg::STAGE;
    const float* Bs = As + Cfg::A_FLOATS;
    if (do_colsum) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) csum += As[k * Cfg::LDA + threadIdx.x];
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      FragA a[Cfg::MT];
#pragma unroll
      for (int i = 0; i < Cfg::MT; ++i)
        load_a<AMN>(a[i], As, Cfg::LDA, wm0 + 16 * i, kk, lane);
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j) {
        FragB b;
        load_b<BMN>(b, Bs, Cfg::LDB, wn0 + 8 * j, kk, lane);
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i) {
          if constexpr (kExact) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(t, a[i], b);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
          } else {
            mma3(acc[i][j], a[i], b);
          }
        }
      }
    }
    if (EPI == kEpiPart && (kt + 1) % (P.kflush / kBK) == 0 && kt + 1 < nk)
      flush(kt / (P.kflush / kBK));
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  if (EPI == kEpiPart) {
    if (do_colsum && m0 + (int)threadIdx.x < P.M)
      P.colsum[z * P.sstride + m0 + threadIdx.x] = csum;
    // the last partial of the split, then zeros for those past its rows
    for (int s = nk > 0 ? (nk - 1) / (P.kflush / kBK) : 0; s < P.nsub; ++s)
      flush(s);
  } else {
    // kEpiGen writes C; kEpiRow stages the whole row block, then a warp a
    // row
    if (EPI == kEpiRow) __syncthreads();  // every warp is done with the ring
    float* T = smem;
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j) {
        const int r = wm0 + 16 * i + g, n = n0 + wn0 + 8 * j + 2 * t;
        float kp[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
        if (P.drop.on) keep_quad(P.drop, P.N, m0 + r, n, t, kp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r + 8 * h;
          float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (m < P.M && n < P.N) {
            epi_pair(P, m, n, kp[h], v0, v1);
            if (EPI == kEpiGen)
              *reinterpret_cast<float2*>(P.C + (size_t)m * P.ldc + n) =
                  make_float2(v0, v1);
          }
          if (EPI == kEpiRow)
            *reinterpret_cast<float2*>(T + (r + 8 * h) * Cfg::LDT + n - n0) =
                make_float2(v0, v1);
        }
      }
  }
  if (EPI == kEpiRow) {
    __syncthreads();
    row_epilogue<BM>(P, smem, Cfg::LDT, m0, tile_m, smem + BM * Cfg::LDT);
  }
}

// ---------------------------------------------------------------------------
// Attention

constexpr int kAT = 64;          // query and key tile
constexpr int kAttnThreads = 128;     // the forward: 4 warps
constexpr int kAttnBwdThreads = 256;  // the backward: 8 warps
constexpr int kLdP = kAT + 4;    // row stride of the P / dS tiles

struct AttnArgs {
  const float *q, *k, *v, *valid;
  float *out, *lse;
  // backward
  const float *dout, *delta;
  float *dqpart, *dk, *dv;
  int B, Sq, Nk, H, ldq, ldk, ldo, ldd, lddk, tiles;
  float scale;
  Drop drop;
};

// Copies `rows` rows x DH floats (row stride ld, from row r0 of sample b's
// `count` rows, column hoff) into a shared tile of row stride ls; rows past
// `count` are zero.
template <int DH>
__device__ __forceinline__ void load_head_rows(float* s, int ls,
                                               const float* src, int ld, int b,
                                               int count, int r0, int hoff) {
  constexpr int NV = DH / 4;
  for (int i = threadIdx.x; i < kAT * NV; i += blockDim.x) {
    const int r = i / NV, c = (i % NV) * 4;
    const bool ok = r0 + r < count;
    cp16z(s + r * ls + c,
          ok ? src + ((size_t)b * count + r0 + r) * ld + hoff + c : src, ok);
  }
}

// The validity of keys k0 .. k0 + 63 of sample b (0 past the keys).
__device__ __forceinline__ void load_valid(float* vs, const AttnArgs& a, int b,
                                           int k0) {
  for (int j = threadIdx.x; j < kAT; j += blockDim.x) {
    const int kj = k0 + j;
    vs[j] = kj >= a.Nk ? 0.f
                       : (a.valid ? a.valid[(size_t)b * a.Nk + kj] : 1.f);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

template <int DH>
struct AttnSmem {
  static constexpr int LD = DH + 4;
  static constexpr int TILE = kAT * LD;
  // forward: Q, K, V, valid
  static constexpr size_t FWD = (size_t)(3 * TILE + kAT) * 4;
  // backward: K, V, Q, dO, P (then dS), P keep, lse, delta, valid
  static constexpr size_t BWD =
      (size_t)(4 * TILE + 2 * kAT * kLdP + 3 * kAT) * 4;
};

// The A fragment of P = the 16 x 8 block of a C fragment (c0 (g, 2t), c1
// (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)), rearranged across the
// quad by shuffles (column t sits at lane t / 2, element t % 2; column
// t + 4 at lane 2 + t / 2), then split.
__device__ __forceinline__ void c_to_a(FragA& f, const float* c, int lane) {
  const int t = lane & 3;
  const int s1 = (lane & ~3) | (t >> 1), s2 = s1 + 2;
  const bool odd = t & 1;
  float v[4];
  {
    const float x0 = __shfl_sync(0xffffffffu, c[0], s1);
    const float x1 = __shfl_sync(0xffffffffu, c[1], s1);
    const float y0 = __shfl_sync(0xffffffffu, c[2], s1);
    const float y1 = __shfl_sync(0xffffffffu, c[3], s1);
    const float z0 = __shfl_sync(0xffffffffu, c[0], s2);
    const float z1 = __shfl_sync(0xffffffffu, c[1], s2);
    const float w0 = __shfl_sync(0xffffffffu, c[2], s2);
    const float w1 = __shfl_sync(0xffffffffu, c[3], s2);
    v[0] = odd ? x1 : x0;  // (g, t)
    v[1] = odd ? y1 : y0;  // (g + 8, t)
    v[2] = odd ? z1 : z0;  // (g, t + 4)
    v[3] = odd ? w1 : w0;  // (g + 8, t + 4)
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split3(v[e], f.h[e], f.l[e]);
}

// One block of 4 warps per (sample, head, 64-query tile), each warp 16
// queries; 52 KB of shared memory at head width 64 (Q, one K and V tile),
// so four blocks share an SM and hide each other's loads and mma latency.
template <int DH>
__global__ void __launch_bounds__(kAttnThreads, 4)
    attn_fwd_tc(const __grid_constant__ AttnArgs a) {
  using Sm = AttnSmem<DH>;
  constexpr int LD = Sm::LD, NO = DH / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + Sm::TILE;
  float* Vs = Ks + Sm::TILE;
  float* Vld = Vs + Sm::TILE;  // [kAT]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x % a.tiles, bh = blockIdx.x / a.tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = tile * kAT, hoff = h * DH;
  const bool any_valid = f32::sample_has_valid_key(a.valid, b, a.Nk, 0);
  const int nkt = (a.Nk + kAT - 1) / kAT;

  load_head_rows<DH>(Qs, LD, a.q, a.ldq, b, a.Sq, q0, hoff);
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int r0 = 16 * warp;
  // a warp whose 16 queries are all past the sample's end computes nothing
  const bool live = q0 + r0 < a.Sq;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kAT;
    if (kt > 0) __syncthreads();  // every warp is done with the last tile
    load_head_rows<DH>(Ks, LD, a.k, a.ldk, b, a.Nk, k0, hoff);
    load_head_rows<DH>(Vs, LD, a.v, a.ldk, b, a.Nk, k0, hoff);
    load_valid(Vld, a, b, k0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // the tile's 8-key groups that hold keys
    const int nj = (min(kAT, a.Nk - k0) + 7) / 8;
    if (!live) continue;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      FragA qa;
      load_a<false>(qa, Qs, LD, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nj) break;
        FragB kb;
        load_b<false>(kb, Ks, LD, 8 * j, kk, lane);
        mma3(s[j], qa, kb);
      }
    }
    // logits, the rows' maxima (rows g and g + 8 of the warp's 16)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1);
        s[j][e] = key_logit(s[j][e], k0 + kc, a.Nk, any_valid,
                            Vld[kc] > 0.5f, a.scale);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m_run[hr], quad_max(mx[hr]));
      alpha[hr] = expf(m_run[hr] - m_new);
      m_run[hr] = m_new;
    }
    // s becomes P keep (the row sums take P before the dropout)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float p0 = expf(s[j][2 * hr] - m_run[hr]);
        float p1 = expf(s[j][2 * hr + 1] - m_run[hr]);
        sum[hr] += p0 + p1;
        const int qi = q0 + r0 + g + 8 * hr;
        const int kc = 8 * j + 2 * t;
        if (a.drop.on && qi < a.Sq && j < nj) {
          float k0s, k1s;
          keep_scale2(a.drop.d, a.drop.mask_id,
                      ((uint64_t)(b * a.H + h) * a.Sq + qi) * a.Nk + k0 + kc,
                      k0s, k1s);
          p0 *= k0s;
          p1 *= k1s;
        }
        s[j][2 * hr] = p0;
        s[j][2 * hr + 1] = p1;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      l_run[hr] = l_run[hr] * alpha[hr] + quad_sum(sum[hr]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int jk = 0; jk < 8; ++jk) {
      if (jk >= nj) break;
      FragA pa;
      c_to_a(pa, s[jk], lane);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        FragB vb;
        load_b<true>(vb, Vs, LD, 8 * j, 8 * jk, lane);
        mma3(o[j], pa, vb);
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    if (qi >= a.Sq) continue;
    const float inv = 1.f / l_run[hr];
    float* orow = a.out + ((size_t)b * a.Sq + qi) * a.ldo + hoff;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
    if (t == 0)
      a.lse[((size_t)b * a.Sq + qi) * a.H + h] = m_run[hr] + logf(l_run[hr]);
  }
}

// ---------------------------------------------------------------------------
// Attention at inference (kernel 10's float32 route, K2's self-attention)

// Shared memory of attn_inf_tc.  Each 64-key tile's K and V are split
// once into "planes" in the order the B fragments read them; at head
// widths up to 64 a warp's Q fragments sit split in registers for the
// whole key loop, wider heads keep the block's raw Q rows (split at each
// fragment load, 16 elements a lane a 64-key tile).  A plane row (a key of
// K, a head column of V) holds, for each lane slot t = 0..3 and 8-deep k
// group c, the 16 bytes hi(8c + t), hi(8c + t + 4), lo(8c + t),
// lo(8c + t + 4) at word t TS + 4 c
// (TS = k extent / 2 + 4): one 16-byte load gives a lane its fragment, the
// 8 lanes of a load phase (rows g, g + 1; t 0..3) read 32 banks (rows
// 16 banks apart, t slots 4 apart), and a thread that split 8 consecutive
// k of a row writes 4 x 16 bytes that its neighbours' groups continue.
// Head widths up to 64 take blocks of 4 warps (74 KB at 64, three blocks
// an SM), wider ones blocks of 8 warps (211 KB at 128, one block an SM):
// their planes serve twice the queries, and split Q fragments would not
// fit the registers.  At novae's 64 x 198 tokens, head width 128, that
// read 0.208 ms on an H100 against 0.234 for blocks of 4 warps that split
// raw K and V tiles at each fragment load (scripts/f32_tc_ab.py).
template <int DH>
struct InfSmem {
  static constexpr bool kQReg = DH <= 64;  // Q fragments in registers
  static constexpr int W = kQReg ? 4 : 8;                  // warps
  static constexpr int QT = 16 * W;                        // queries
  static constexpr int KTS = DH / 2 + 4, KLD = 4 * KTS;    // K plane
  static constexpr int VTS = kAT / 2 + 4, VLD = 4 * VTS;   // V plane
  static constexpr int LD = DH + 4;                        // raw Q rows
  static constexpr size_t BYTES =
      (size_t)(kAT * KLD + DH * VLD + kAT + (kQReg ? 0 : QT * LD)) * 4;
  static_assert(KLD % 32 == 16 && VLD % 32 == 16, "rows 16 banks apart");
};

// The split of x[0..7] (k 8c .. 8c + 7 of a plane row) to p = row + 4 c.
__device__ __forceinline__ void put_plane(uint32_t* p, int ts,
                                          const float (&x)[8]) {
  uint32_t hi[8], lo[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) split3(x[j], hi[j], lo[j]);
#pragma unroll
  for (int t = 0; t < 4; ++t)
    *reinterpret_cast<uint4*>(p + t * ts) =
        make_uint4(hi[t], hi[t + 4], lo[t], lo[t + 4]);
}

// The B fragment of the 8 (k) x 8 (n) tile at (n0, k0) of a plane.
__device__ __forceinline__ void load_b_plane(FragB& f, const uint32_t* P,
                                             int ld, int ts, int n0, int k0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint4 w = *reinterpret_cast<const uint4*>(P + (n0 + g) * ld +
                                                  t * ts + (k0 >> 1));
  f.h[0] = w.x;
  f.h[1] = w.y;
  f.l[0] = w.z;
  f.l[1] = w.w;
}

// Four floats of row `row` (of sample b's `count`), column c: zeros past
// the sample's rows.
__device__ __forceinline__ float4 head_quad(const float* src, int ld, int b,
                                            int count, int row, int c) {
  if (row >= count) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(
      src + ((size_t)b * count + row) * ld + c));
}

// Keys k0 .. k0 + 63 of sample b, head columns hoff .. hoff + DH, split
// into the K and V planes (zeros past the sample's keys): K in items of
// (key, 8 columns), V in items of (8 keys, 4 columns), each a thread's.
template <int DH>
__device__ __forceinline__ void stage_planes(uint32_t* Kp, uint32_t* Vp,
                                             const AttnArgs& a, int b,
                                             int k0, int hoff) {
  using Sm = InfSmem<DH>;
  constexpr int KG = DH / 8, NT = 32 * Sm::W;
#pragma unroll
  for (int it = 0; it < (kAT * KG + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (kAT * KG % NT && i >= kAT * KG) break;
    const int r = i / KG, c = i % KG;
    const float4 x0 = head_quad(a.k, a.ldk, b, a.Nk, k0 + r, hoff + 8 * c);
    const float4 x1 =
        head_quad(a.k, a.ldk, b, a.Nk, k0 + r, hoff + 8 * c + 4);
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    put_plane(Kp + r * Sm::KLD + 4 * c, Sm::KTS, x);
  }
  constexpr int VI = 8 * (DH / 4);
#pragma unroll
  for (int it = 0; it < (VI + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (VI % NT && i >= VI) break;
    const int c = i % 8, d = i / 8;  // keys 8c .., columns 4d ..
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = head_quad(a.v, a.ldk, b, a.Nk, k0 + 8 * c + j, hoff + 4 * d);
    const float x0[8] = {v[0].x, v[1].x, v[2].x, v[3].x,
                         v[4].x, v[5].x, v[6].x, v[7].x};
    const float x1[8] = {v[0].y, v[1].y, v[2].y, v[3].y,
                         v[4].y, v[5].y, v[6].y, v[7].y};
    const float x2[8] = {v[0].z, v[1].z, v[2].z, v[3].z,
                         v[4].z, v[5].z, v[6].z, v[7].z};
    const float x3[8] = {v[0].w, v[1].w, v[2].w, v[3].w,
                         v[4].w, v[5].w, v[6].w, v[7].w};
    uint32_t* row = Vp + 4 * d * Sm::VLD + 4 * c;
    put_plane(row, Sm::VTS, x0);
    put_plane(row + Sm::VLD, Sm::VTS, x1);
    put_plane(row + 2 * Sm::VLD, Sm::VTS, x2);
    put_plane(row + 3 * Sm::VLD, Sm::VTS, x3);
  }
}

// A warp's Q fragments (rows r0 .. r0 + 15 of sample b, all DH columns),
// split, from device memory; zeros past the sample's rows.
template <int DH>
__device__ __forceinline__ void load_q_frags(FragA (&qa)[DH / 8],
                                             const AttnArgs& a, int b,
                                             int r0, int hoff, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = 8 * kk + t + 4 * (e >> 1);
      const float x =
          r < a.Sq ? __ldg(a.q + ((size_t)b * a.Sq + r) * a.ldq + hoff + c)
                   : 0.f;
      split3(x, qa[kk].h[e], qa[kk].l[e]);
    }
}

// One block of W warps per (sample, head, 16 W-query tile), each warp 16
// queries; a 64-key tile that holds no valid key of a sample that has one
// is skipped (its keys' probabilities are exactly 0 once a valid key sets
// the row maximum); a sample without a valid key attends uniformly over
// all its keys (key_logit).  The softmax runs in
// base 2 (logits times log2 e, exp2).  Loads are not overlapped within a
// block: at head widths up to 64 three blocks share an SM and cover each
// other's (a staging tile for the next key tile's cp.async, which would
// hold two blocks an SM at head width 64, read 0.216 ms against 0.178 at
// the frozen encode's 128 x 206 tokens on an H100).
template <int DH>
__global__ void __launch_bounds__(32 * InfSmem<DH>::W,
                                  InfSmem<DH>::kQReg ? 3 : 1)
    attn_inf_tc(const __grid_constant__ AttnArgs a) {
  using Sm = InfSmem<DH>;
  constexpr int NO = DH / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) float smem[];
  uint32_t* Kp = reinterpret_cast<uint32_t*>(smem);   // planes
  uint32_t* Vp = Kp + kAT * Sm::KLD;
  float* Vld = reinterpret_cast<float*>(Vp + DH * Sm::VLD);
  float* Qs = Vld + kAT;                              // raw Q rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x % a.tiles, bh = blockIdx.x / a.tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = tile * Sm::QT, hoff = h * DH, r0 = 16 * warp;
  const bool any_valid = f32::sample_has_valid_key(a.valid, b, a.Nk, 0);
  // a warp whose 16 queries are all past the sample's end computes nothing
  const bool live = q0 + r0 < a.Sq;
  FragA qa[Sm::kQReg ? DH / 8 : 1];
  if constexpr (Sm::kQReg) {
    if (live) load_q_frags<DH>(qa, a, b, q0 + r0, hoff, lane);
  } else {
#pragma unroll
    for (int r = 0; r < Sm::QT; r += kAT)
      load_head_rows<DH>(Qs + r * Sm::LD, Sm::LD, a.q, a.ldq, b, a.Sq,
                         q0 + r, hoff);
    cp_async_commit();
  }
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int nkt = (a.Nk + kAT - 1) / kAT;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kAT;
    float vj = 0.f;
    if ((int)threadIdx.x < kAT && k0 + (int)threadIdx.x < a.Nk)
      vj = a.valid ? a.valid[(size_t)b * a.Nk + k0 + threadIdx.x] : 1.f;
    // a barrier too: every warp is done with the last tile
    if (!__syncthreads_or(vj > 0.5f) && any_valid) continue;
    if ((int)threadIdx.x < kAT) Vld[threadIdx.x] = vj;
    stage_planes<DH>(Kp, Vp, a, b, k0, hoff);
    if constexpr (!Sm::kQReg) cp_async_wait<0>();  // Q's rows: first tile
    __syncthreads();
    if (!live) continue;
    // the tile's 8-key groups that hold keys
    const int nj = (min(kAT, a.Nk - k0) + 7) / 8;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      FragA qf;
      if constexpr (Sm::kQReg)
        qf = qa[kk / 8];
      else
        load_a<false>(qf, Qs, Sm::LD, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nj) break;
        FragB kb;
        load_b_plane(kb, Kp, Sm::KLD, Sm::KTS, 8 * j, kk, lane);
        mma3(s[j], qf, kb);
      }
    }
    // logits in base 2 (times log2 e), the rows' maxima (rows g and g + 8
    // of the warp's 16)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1);
        s[j][e] = kLog2e * key_logit(s[j][e], k0 + kc, a.Nk, any_valid,
                                     Vld[kc] > 0.5f, a.scale);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m_run[hr], quad_max(mx[hr]));
      alpha[hr] = exp2f(m_run[hr] - m_new);
      m_run[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      l_run[hr] = l_run[hr] * alpha[hr] + quad_sum(sum[hr]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int jk = 0; jk < 8; ++jk) {
      if (jk >= nj) break;
      FragA pa;
      c_to_a(pa, s[jk], lane);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        FragB vb;
        load_b_plane(vb, Vp, Sm::VLD, Sm::VTS, 8 * j, 8 * jk, lane);
        mma3(o[j], pa, vb);
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    if (qi >= a.Sq) continue;
    const float inv = 1.f / l_run[hr];
    float* orow = a.out + ((size_t)b * a.Sq + qi) * a.ldo + hoff;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
  }
}

// One block of 8 warps per (sample, head, 64-key tile) walks the query
// tiles.  Warp w takes query group and key group w % 4 (16 rows each) and
// role w / 4: in role 0 it computes S, P and P keep of its queries and
// accumulates dV of its keys; in role 1 dP and dS = dP (P keep) - P delta
// (= P (dP keep - delta)) and dK.  Both roles then compute half the
// columns of the key tile's share of dQ = dS K for their queries.  So a
// warp holds one persistent accumulator, and two blocks (16 warps) share
// an SM.
template <int DH>
__global__ void __launch_bounds__(kAttnBwdThreads, 2)
    attn_bwd_tc(const __grid_constant__ AttnArgs a) {
  using Sm = AttnSmem<DH>;
  constexpr int LD = Sm::LD, NO = DH / 8, NH = NO / 2;
  static_assert(NO % 2 == 0, "dQ's columns in two halves");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + Sm::TILE;
  float* Qs = Vs + Sm::TILE;
  float* Os = Qs + Sm::TILE;    // dO
  float* Ps = Os + Sm::TILE;    // [query][key] P, then dS
  float* PKs = Ps + kAT * kLdP; // [query][key] P keep
  float* lse_s = PKs + kAT * kLdP;
  float* del_s = lse_s + kAT;
  float* vld = del_s + kAT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp & 3, role = warp >> 2;
  const int kt = blockIdx.x % a.tiles, bh = blockIdx.x / a.tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int k0 = kt * kAT, hoff = h * DH;
  const bool any_valid = f32::sample_has_valid_key(a.valid, b, a.Nk, 0);
  const int D = a.H * DH;
  const size_t Mq = (size_t)a.B * a.Sq;

  load_head_rows<DH>(Ks, LD, a.k, a.ldk, b, a.Nk, k0, hoff);
  load_head_rows<DH>(Vs, LD, a.v, a.ldk, b, a.Nk, k0, hoff);
  load_valid(vld, a, b, k0);
  const int r0 = 16 * grp;  // the warp's 16 queries, and its 16 keys
  // whole 8-key groups of the tile that hold keys; a warp whose 16 keys
  // are all past the sample's end accumulates nothing
  const int kn8 = (min(kAT, a.Nk - k0) + 7) / 8 * 8;
  const bool keys_live = r0 < kn8;
  float acc[NO][4];  // role 0: dV, role 1: dK
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int q0 = 0; q0 < a.Sq; q0 += kAT) {
    load_head_rows<DH>(Qs, LD, a.q, a.ldq, b, a.Sq, q0, hoff);
    load_head_rows<DH>(Os, LD, a.dout, a.ldd, b, a.Sq, q0, hoff);
    cp_async_commit();
    for (int i = threadIdx.x; i < kAT; i += blockDim.x) {
      const int qi = q0 + i;
      const size_t row = ((size_t)b * a.Sq + qi) * a.H + h;
      lse_s[i] = qi < a.Sq ? a.lse[row] : 0.f;
      del_s[i] = qi < a.Sq ? a.delta[row] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    // whole 8-query groups of the tile that hold queries
    const int qn8 = (min(kAT, a.Sq - q0) + 7) / 8 * 8;
    const bool queries_live = r0 < qn8;
    // role 0: S = Q K^T; role 1: dP = dO V^T; the warp's 16 queries
    float x[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    const float* Ar = role ? Os : Qs;
    const float* Br = role ? Vs : Ks;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      if (!queries_live) break;
      FragA fa;
      load_a<false>(fa, Ar, LD, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= kn8) break;
        FragB fb;
        load_b<false>(fb, Br, LD, 8 * j, kk, lane);
        mma3(x[j], fa, fb);
      }
    }
    if (role == 0) {  // P and P keep
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + g + 8 * hr, qi = q0 + r;
        const float lse = lse_s[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kc = 8 * j + 2 * t;
          float p[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f};
          if (qi < a.Sq && 8 * j < kn8) {
            float keep[2] = {1.f, 1.f};
            if (a.drop.on)
              keep_scale2(a.drop.d, a.drop.mask_id,
                          ((uint64_t)(b * a.H + h) * a.Sq + qi) * a.Nk + k0 +
                              kc,
                          keep[0], keep[1]);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int kj = k0 + kc + u;
              if (kj < a.Nk) {
                p[u] = expf(key_logit(x[j][2 * hr + u], kj, a.Nk, any_valid,
                                      vld[kc + u] > 0.5f, a.scale) -
                            lse);
                pk[u] = p[u] * keep[u];
              }
            }
          }
          *reinterpret_cast<float2*>(Ps + r * kLdP + kc) =
              make_float2(p[0], p[1]);
          *reinterpret_cast<float2*>(PKs + r * kLdP + kc) =
              make_float2(pk[0], pk[1]);
        }
      }
    }
    __syncthreads();
    if (role == 1) {  // dS = dP (P keep) - P delta, over P
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + g + 8 * hr;
        const float del = del_s[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kc = 8 * j + 2 * t;
          float2* pp = reinterpret_cast<float2*>(Ps + r * kLdP + kc);
          const float2 pv = *pp;
          const float2 pk =
              *reinterpret_cast<const float2*>(PKs + r * kLdP + kc);
          *pp = make_float2(x[j][2 * hr] * pk.x - pv.x * del,
                            x[j][2 * hr + 1] * pk.y - pv.y * del);
        }
      }
    }
    __syncthreads();
    // role 0: dV += (P keep)^T dO; role 1: dK += dS^T Q; the warp's 16
    // keys over the tile's queries
    const float* Ap = role ? Ps : PKs;
    const float* Bp = role ? Qs : Os;
#pragma unroll
    for (int kk = 0; kk < kAT; kk += 8) {
      if (kk >= qn8 || !keys_live) break;
      FragA fa;
      load_a<true>(fa, Ap, kLdP, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        FragB fb;
        load_b<true>(fb, Bp, LD, 8 * j, kk, lane);
        mma3(acc[j], fa, fb);
      }
    }
    // the key tile's share of dQ = dS K: the warp's 16 queries, column
    // half `role`
    float dq[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kAT; kk += 8) {
      if (kk >= kn8 || !queries_live) break;
      FragA fa;
      load_a<false>(fa, Ps, kLdP, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        FragB fb;
        load_b<true>(fb, Ks, LD, 8 * (role * NH + j), kk, lane);
        mma3(dq[j], fa, fb);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + r0 + g + 8 * hr;
      if (qi >= a.Sq) continue;
      float* row = a.dqpart + ((size_t)kt * Mq + (size_t)b * a.Sq + qi) * D +
                   hoff + 8 * role * NH;
#pragma unroll
      for (int j = 0; j < NH; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t) = make_float2(
            dq[j][2 * hr] * a.scale, dq[j][2 * hr + 1] * a.scale);
    }
    __syncthreads();  // Q, dO, P and dS are refilled next
  }
  const float sc = role ? a.scale : 1.f;
  float* out = role ? a.dk : a.dv;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + r0 + g + 8 * hr;
    if (kj >= a.Nk) continue;
    const size_t row = ((size_t)b * a.Nk + kj) * a.lddk + hoff;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(out + row + 8 * j + 2 * t) =
          make_float2(acc[j][2 * hr] * sc, acc[j][2 * hr + 1] * sc);
  }
}

}  // namespace tc
}  // namespace ladiff
