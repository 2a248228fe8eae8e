// The float32 training kernels 12 (train_encoder_layer) and 13
// (train_decoder_layer), forward and backward, and the float32 inference
// kernels K2 (fused_decoder_layer) and 10 (masked attention), on the
// H100's tensor cores in three-term TF32 (f32_tc_tile.cuh).  Replaces the
// TPU kernels ladiff_tpu/ops/pallas_train_layer.py:207 train_encoder_layer
// (forward pallas_call :244, backward :294),
// ladiff_tpu/ops/pallas_train_decoder_layer.py:410 train_decoder_layer
// (:464, :521), ladiff_tpu/ops/pallas_decoder_layer.py:234
// fused_decoder_layer (:364) and ladiff_tpu/ops/pallas_attention.py:52
// pallas_masked_attention (:82) at the type of every published
// configuration (TRAIN.MIXED_PRECISION false).  Each is a fixed sequence
// of these launches behind its wrapper (ladiff_torch/ops/f32_train.py,
// ladiff_torch/ops/f32_layer.py):
//
//   f32l_gemm            a group of up to 8 products of one layout in one
//                        launch (gemm_tc_kernel): the projections with their
//                        bias / activation / dropout / residual epilogues,
//                        the out-projections and W2 with the LayerNorm after
//                        the residual in the epilogue (64 whole rows of D <=
//                        256 a block; 32 at inference), dY W with the
//                        activation's derivative, with a LayerNorm's
//                        backward or with the softmax's delta in the
//                        epilogue, and every weight gradient dY^T X of a
//                        backward as split-K partials in one launch
//   f32l_attention       the self-attention forward (attn_fwd_tc) with the
//                        probability dropout and each row's log-sum-exp
//   f32l_attention_bwd   its backward (attn_bwd_tc): dK, dV whole per key
//                        tile, dQ as one partial per key tile
//   f32l_masked_attention  the attention at inference (attn_inf_tc): kernel
//                        10 and K2's self-attention, head widths 16 to 128
//   f32l_cross_attention the decoder's cross-attention over the L <= 8
//                        memory rows: one warp per (row, head), SIMT (its
//                        products are L dot products a row); at inference
//                        without the log-sum-exp, head widths up to 128
//   f32l_cross_attention_bwd  its backward: one block per (sample, head),
//                        dq per row, each memory row's dk, dv summed over the
//                        sample's rows in warp order
//   f32l_ln_bwd          the last LayerNorm's backward (dx, dx times the
//                        output dropout's keep-scale, per-block column sums)
//   f32l_reduce          sums partials over their splits in split order (the
//                        dQ partials; the weight, bias and LayerNorm
//                        parameter gradients)
//
// What bounds them on the H100: at 64 x 206 rows, D 256, F 1024, kernel 12
// needs ~23 GFLOP forward and ~46 backward against ~0.1 and ~0.4 GB moved at
// 4 bytes an element: 0.14 / 0.28 ms at 165 TFLOP/s (the three-term TF32
// rate) against 0.03 / 0.12 ms at 3.35 TB/s, so the tensor cores bound it;
// kernel 13 alike, and K2, kernel 13's forward without dropout or saved
// activations (~12 GFLOP at the test.py eval batch's 32 x 196 rows: 0.074
// ms at 165 TFLOP/s).  The design: every product on the tensor cores; the
// forward saves r, h, the pre-activation, the hidden rows and the pre-LN2
// sum (13: also r1, t1, q, cc, the cross log-sum-exp and r2), so the
// backward recomputes no product; epilogues take the LayerNorms, the
// dropout keep-scales, the residuals and delta, so no element-wise pass of
// its own remains.  K2 is 8 launches: qkv, the attention, out-proj +
// residual + LN1, the cross q with the memory's k / v (one group), the
// cross-attention, cross out-proj + residual + LN2, W1 + activation, W2 +
// residual + LN3.  It runs on the inference tiles, which add each 8-deep
// step of a product to the accumulator in float32 (kExact): 64 x 128
// product tiles and 32-row LayerNorm blocks.  From wave arithmetic at the
// eval batch's 6272 rows on 132 SMs, two blocks an SM: qkv's 64-row tiles
// are 588 blocks, 3 rounds of 64 rows on 264 slots against 2 rounds of
// 128 for 294 blocks; the 32-row blocks are 196, one round, where 64-row
// ones fill 98 of 264 slots and 48-row ones (131, one an SM) spill with
// the exact accumulation.  On an H100 the whole layer read 0.481 ms
// against 0.502 with 48-row and 0.556 with 64-row blocks
// (scripts/f32_tc_ab.py --tiles).
// Deterministic: every sum across blocks goes through
// partials summed in a fixed order, no atomics.  Dropout is Philox-4x32-10
// keyed by (seed, mask id, element) as everywhere in the port (common.cuh
// keep_scale), so the masks are those of the bf16 kernels and of the
// float32 chains.
#include <limits.h>

#include "f32_tc_tile.cuh"

using namespace ladiff;
using namespace ladiff::tc;

LADIFF_ERROR_STRING_FN

namespace {

constexpr int kPtrsPer = 16, kIntsPer = 26;

float* fp(const void* p) { return static_cast<float*>(const_cast<void*>(p)); }
const float* cfp(const void* p) { return static_cast<const float*>(p); }
bool a16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
bool a8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

Drop drop_of(int mask, int lo, int hi, float rate) {
  if (mask < 0 || !(rate > 0.f)) {
    Drop d = {};
    return d;
  }
  return make_drop(lo, hi, rate, mask);
}

template <int BM, int BN, int WM, int WN, bool AMN, bool BMN, int EPI,
          bool kExact = false>
int launch_gemm(Group& grp, cudaStream_t s) {
  using Cfg = GemmCfg<BM, BN, WM, WN, AMN, BMN, EPI>;
  static SmemGrant grant;  // internal linkage: one per library
  long long blocks = 0;
  for (int i = 0; i < grp.n; ++i) {
    Prob& P = grp.p[i];
    P.tm = (P.M + BM - 1) / BM;
    P.tn = (P.N + BN - 1) / BN;
    P.splits = (P.K + P.ksplit - 1) / P.ksplit;
    P.nsub = EPI == kEpiPart ? (P.ksplit + P.kflush - 1) / P.kflush : 1;
    if (EPI == kEpiRow && P.tn != 1) return cudaErrorInvalidValue;
    if (EPI != kEpiPart && P.splits != 1) return cudaErrorInvalidValue;
    P.block0 = (int)blocks;
    blocks += (long long)P.tm * P.tn * P.splits;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
  }
  if (blocks < 1) return cudaErrorInvalidValue;
  auto kern = gemm_tc_kernel<BM, BN, WM, WN, AMN, BMN, EPI, kExact>;
  if (!allow_smem(kern, Cfg::SMEM, grant)) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, Cfg::SMEM, s>>>(grp);
  return cudaGetLastError();
}

// Checks one problem's shapes, layouts and alignment (16-byte pieces along
// each operand's contiguous dimension; float2 epilogue accesses).
bool valid_prob(const Prob& P, bool a_mn, bool b_mn, bool part, int row) {
  if (P.M < 1 || P.N < 1 || P.K < 1 || P.ksplit < kBK || P.ksplit % kBK ||
      !P.A || !P.B || !P.C || P.N % 4 || P.ldc % 2 || !a8(P.C) ||
      P.act < 0 || P.act > 2)
    return false;
  if (a_mn ? (P.M % 4 || P.lda % 4 || !a16(P.A))
           : (P.K % 4 || P.lda % 4 || !a16(P.A)))
    return false;
  if (b_mn ? (P.N % 4 || P.ldb % 4 || !a16(P.B))
           : (P.K % 4 || P.ldb % 4 || !a16(P.B)))
    return false;
  if (P.pre && (P.ldpre % 2 || !a8(P.pre))) return false;
  if (P.gin && (P.ldg % 2 || !a8(P.gin) || P.gact < 1 || P.gact > 2))
    return false;
  if (P.R && (P.ldr % 2 || !a8(P.R))) return false;
  if (part)
    return a_mn && b_mn && P.cstride >= (size_t)P.M * P.ldc &&
           P.kflush >= kBK && P.kflush % kBK == 0;
  if (!row) return true;
  if (P.N > 256 || P.N % 32) return false;
  if (row == kRowLnF) return P.lnw && P.lnb;
  if (row == kRowLnB)
    return P.lnx && P.lnw && (!P.part || P.ldpart >= 2 * P.N);
  if (row == kRowDelta)
    return P.ctx && P.delta && P.H >= 1 && P.N % P.H == 0;
  return false;
}

// ---------------------------------------------------------------------------
// kernel 13's cross-attention over L <= kMaxL memory rows

constexpr int kMaxL = 8;

struct CrossArgs {
  const float *q, *kv, *valid, *dout, *lse, *delta;
  float *out, *lseo, *dq, *dkv;
  int B, S, L, H, Dh, ldq, ldkv, ldo, ldd, lddq, lddkv;
  float scale;
  Drop drop;
};

// Whether sample b has a valid memory row (every lane gets the answer).
__device__ __forceinline__ bool any_memory(const CrossArgs& a, int b) {
  if (!a.valid) return true;
  bool any = false;
  for (int j = 0; j < a.L; ++j) any |= a.valid[(size_t)b * a.L + j] > 0.5f;
  return any;
}

__device__ __forceinline__ bool memory_valid(const CrossArgs& a, int b,
                                             int j) {
  return !a.valid || a.valid[(size_t)b * a.L + j] > 0.5f;
}

// One warp per (row, head); lanes hold head columns lane + 32 u (u < NU:
// head widths up to 32 NU).  The log-sum-exp is stored where lseo is given.
template <int NU>
__global__ void __launch_bounds__(256)
    cross_fwd_kernel(const __grid_constant__ CrossArgs a) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= (long long)a.B * a.S * a.H) return;  // whole warps
  const int h = (int)(w % a.H);
  const long long m = w / a.H;
  const int b = (int)(m / a.S), i = (int)(m % a.S);
  const int D = a.H * a.Dh, hoff = h * a.Dh;
  float qv[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int c = lane + 32 * u;
    qv[u] = c < a.Dh ? a.q[m * a.ldq + hoff + c] : 0.f;
  }
  const bool any = any_memory(a, b);
  float lg[kMaxL], mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxL; ++j) {
    lg[j] = -INFINITY;
    if (j < a.L) {
      const float* kr = a.kv + ((size_t)b * a.L + j) * a.ldkv + hoff;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int c = lane + 32 * u;
        if (c < a.Dh) s += qv[u] * kr[c];
      }
      s = warp_sum(s);
      lg[j] = key_logit(s, j, a.L, any, memory_valid(a, b, j), a.scale);
      mx = fmaxf(mx, lg[j]);
    }
  }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxL; ++j)
    if (j < a.L) {
      lg[j] = expf(lg[j] - mx);
      l += lg[j];
    }
  const float inv = 1.f / l;
  // lane j draws memory row j's keep-scale
  const float keep_lane =
      a.drop.on && lane < a.L
          ? keep_scale(a.drop.d, a.drop.mask_id,
                       ((uint64_t)(b * a.H + h) * a.S + i) * a.L + lane)
          : 1.f;
  float o[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) o[u] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxL; ++j)
    if (j < a.L) {
      const float p =
          lg[j] * inv * __shfl_sync(0xffffffffu, keep_lane, j);
      const float* vr = a.kv + ((size_t)b * a.L + j) * a.ldkv + D + hoff;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int c = lane + 32 * u;
        if (c < a.Dh) o[u] += p * vr[c];
      }
    }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int c = lane + 32 * u;
    if (c < a.Dh) a.out[m * a.ldo + hoff + c] = o[u];
  }
  if (a.lseo && lane == 0) a.lseo[m * a.H + h] = mx + logf(l);
}

// One block of 8 warps per (sample, head); warp w takes rows w, w + 8, ..
// of the sample, then the warps' dk, dv are summed in warp order.
__global__ void __launch_bounds__(256)
    cross_bwd_kernel(const __grid_constant__ CrossArgs a) {
  __shared__ float red[8][2][kMaxL][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x % a.H, b = blockIdx.x / a.H;
  const int D = a.H * a.Dh, hoff = h * a.Dh;
  const bool any = any_memory(a, b);
  float kreg[kMaxL][2], vreg[kMaxL][2], dk[kMaxL][2], dv[kMaxL][2];
#pragma unroll
  for (int j = 0; j < kMaxL; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      const bool ok = j < a.L && c < a.Dh;
      const size_t r = ((size_t)b * a.L + j) * a.ldkv + hoff + c;
      kreg[j][u] = ok ? a.kv[r] : 0.f;
      vreg[j][u] = ok ? a.kv[r + D] : 0.f;
      dk[j][u] = dv[j][u] = 0.f;
    }
  for (int i = warp; i < a.S; i += 8) {
    const size_t m = (size_t)b * a.S + i;
    float qv[2], dov[2], dq[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      qv[u] = c < a.Dh ? a.q[m * a.ldq + hoff + c] : 0.f;
      dov[u] = c < a.Dh ? a.dout[m * a.ldd + hoff + c] : 0.f;
    }
    const float lse = a.lse[m * a.H + h], del = a.delta[m * a.H + h];
    const float keep_lane =
        a.drop.on && lane < a.L
            ? keep_scale(a.drop.d, a.drop.mask_id,
                         ((uint64_t)(b * a.H + h) * a.S + i) * a.L + lane)
            : 1.f;
#pragma unroll
    for (int j = 0; j < kMaxL; ++j)
      if (j < a.L) {
        const float s =
            warp_sum(qv[0] * kreg[j][0] + qv[1] * kreg[j][1]);
        const float dp =
            warp_sum(dov[0] * vreg[j][0] + dov[1] * vreg[j][1]);
        const float p = expf(
            key_logit(s, j, a.L, any, memory_valid(a, b, j), a.scale) -
            lse);
        const float keep = __shfl_sync(0xffffffffu, keep_lane, j);
        const float ds = p * (dp * keep - del);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          dq[u] += ds * kreg[j][u];
          dk[j][u] += ds * qv[u];
          dv[j][u] += p * keep * dov[u];
        }
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c < a.Dh) a.dq[m * a.lddq + hoff + c] = dq[u] * a.scale;
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxL; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c < 64) {
        red[warp][0][j][c] = dk[j][u];
        red[warp][1][j][c] = dv[j][u];
      }
    }
  __syncthreads();
  const int n = a.L * a.Dh;
  for (int idx = threadIdx.x; idx < 2 * n; idx += blockDim.x) {
    const int which = idx / n, j = (idx % n) / a.Dh, c = idx % a.Dh;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w][which][j][c];
    a.dkv[((size_t)b * a.L + j) * a.lddkv + which * D + hoff + c] =
        which ? s : s * a.scale;
  }
}

// ---------------------------------------------------------------------------
// the last LayerNorm's backward: 64 rows a block, the row step of the GEMM's
// row epilogue reading g from device memory

__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const __grid_constant__ Prob P, const float* g, int ldg) {
  __shared__ float red[8 * 2 * 256];
  const int m0 = blockIdx.x * kRowBM;
  row_epilogue<kRowBM>(P, g + (size_t)m0 * ldg, ldg, m0, blockIdx.x, red);
}

// ---------------------------------------------------------------------------
// partials summed over their splits in split order

constexpr int kMaxSeg = 32;
struct Seg {
  const float* part;
  float* out;
  size_t pstride;  // elements between splits
  int splits, rows, cols, ldo;
};
struct Segs {
  Seg s[kMaxSeg];
  int n;
};

__global__ void __launch_bounds__(256)
    reduce_segs_kernel(const __grid_constant__ Segs a) {
  const Seg& S = a.s[blockIdx.y];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S.rows * S.cols) return;
  float t = 0.f;
  for (int z = 0; z < S.splits; ++z) t += S.part[z * S.pstride + i];
  S.out[(i / S.cols) * S.ldo + i % S.cols] = t;
}

SmemGrant g_attn_grant[2][5];

template <int DH>
int launch_attention(const AttnArgs& a, bool bwd, cudaStream_t s) {
  using Sm = AttnSmem<DH>;
  const long long blocks = (long long)a.B * a.H * a.tiles;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (bwd) {
    if (!allow_smem(attn_bwd_tc<DH>, Sm::BWD, g_attn_grant[1][DH / 16]))
      return cudaErrorInvalidValue;
    attn_bwd_tc<DH><<<(unsigned)blocks, kAttnBwdThreads, Sm::BWD, s>>>(
        a);
  } else {
    if (!allow_smem(attn_fwd_tc<DH>, Sm::FWD, g_attn_grant[0][DH / 16]))
      return cudaErrorInvalidValue;
    attn_fwd_tc<DH><<<(unsigned)blocks, kAttnThreads, Sm::FWD, s>>>(a);
  }
  return cudaGetLastError();
}

SmemGrant g_inf_grant[8];

template <int DH>
int launch_inf_attention(AttnArgs& a, cudaStream_t s) {
  using Sm = InfSmem<DH>;
  a.tiles = (a.Sq + Sm::QT - 1) / Sm::QT;
  const long long blocks = (long long)a.B * a.H * a.tiles;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (!allow_smem(attn_inf_tc<DH>, Sm::BYTES, g_inf_grant[DH / 16 - 1]))
    return cudaErrorInvalidValue;
  attn_inf_tc<DH><<<(unsigned)blocks, 32 * Sm::W, Sm::BYTES, s>>>(a);
  return cudaGetLastError();
}

int attention(AttnArgs& a, int Dh, bool bwd, cudaStream_t s) {
  if (a.B < 1 || a.Sq < 1 || a.Nk < 1 || a.H < 1 || a.ldq % 4 || a.ldk % 4 ||
      !a16(a.q) || !a16(a.k) || !a16(a.v) || !a.lse)
    return cudaErrorInvalidValue;
  if (bwd) {
    if (a.ldd % 4 || a.lddk % 2 || !a16(a.dout) || !a.delta || !a.dqpart ||
        !a8(a.dk) || !a8(a.dv))
      return cudaErrorInvalidValue;
    a.tiles = (a.Nk + kAT - 1) / kAT;
  } else {
    if (a.ldo % 2 || !a8(a.out)) return cudaErrorInvalidValue;
    a.tiles = (a.Sq + kAT - 1) / kAT;
  }
  switch (Dh) {
    case 16: return launch_attention<16>(a, bwd, s);
    case 32: return launch_attention<32>(a, bwd, s);
    case 48: return launch_attention<48>(a, bwd, s);
    case 64: return launch_attention<64>(a, bwd, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// A group of products of one layout.  ints: the problem count, seed lo,
// seed hi, then per problem (kIntsPer): M, N, K, lda, ldb, ldc, a_mn, b_mn,
// act, ldpre, ldg, gact, ldr, mask id (-1: none), ksplit, row (0, or 1
// LayerNorm, 2 LayerNorm backward, 3 delta), ldx, ldlnx, mask2 (-1: none),
// ldpart, ldctx, H, cstride (> 0: split-K partials, a split's rows in
// ceil(ksplit / kflush) partials of kflush rows each), sstride, kflush,
// tile (the output tile's rows, one for the group: 0 the default, 128
// products or 64-row row blocks; the inference tiles, K-major weights and
// each 8-deep step added in float32 (kExact): 64-row products, 32-row
// LayerNorm blocks).
// ptrs per
// problem (kPtrsPer): A, B, C, bias, pre, gin, R, colsum, xout, lnw, lnb,
// lnx, C2, part, ctx, delta (null where unused).  floats: rate.
extern "C" int f32l_gemm(const void** p, const int* n, const float* f,
                         void* stream_ptr) {
  const int np = n[0];
  if (np < 1 || np > kMaxProb) return cudaErrorInvalidValue;
  Group grp = {};
  grp.n = np;
  int a_mn = -1, b_mn = -1, part = -1, row = -1, tile = 0;
  for (int i = 0; i < np; ++i) {
    const void** pp = p + i * kPtrsPer;
    const int* q = n + 3 + i * kIntsPer;
    Prob& P = grp.p[i];
    P.A = cfp(pp[0]); P.B = cfp(pp[1]); P.C = fp(pp[2]);
    P.bias = cfp(pp[3]); P.pre = fp(pp[4]); P.gin = cfp(pp[5]);
    P.R = cfp(pp[6]); P.colsum = fp(pp[7]); P.xout = fp(pp[8]);
    P.lnw = cfp(pp[9]); P.lnb = cfp(pp[10]); P.lnx = cfp(pp[11]);
    P.C2 = fp(pp[12]); P.part = fp(pp[13]); P.ctx = cfp(pp[14]);
    P.delta = fp(pp[15]);
    P.M = q[0]; P.N = q[1]; P.K = q[2];
    P.lda = q[3]; P.ldb = q[4]; P.ldc = q[5];
    P.act = q[8]; P.ldpre = q[9]; P.ldg = q[10]; P.gact = q[11];
    P.ldr = q[12];
    P.drop = drop_of(q[13], n[1], n[2], f[0]);
    P.ksplit = q[14];
    P.row = q[15]; P.ldx = q[16]; P.ldlnx = q[17];
    P.drop2 = drop_of(q[18], n[1], n[2], f[0]);
    P.ldpart = q[19]; P.ldctx = q[20]; P.H = q[21];
    P.cstride = (size_t)q[22];
    P.sstride = (size_t)q[23];
    P.kflush = q[24];
    const int this_part = q[22] > 0;
    if (i == 0) {
      a_mn = q[6]; b_mn = q[7]; part = this_part; row = P.row; tile = q[25];
    } else if (a_mn != q[6] || b_mn != q[7] || part != this_part ||
               (row > 0) != (P.row > 0) || tile != q[25]) {
      return cudaErrorInvalidValue;
    }
    // the inference tiles: K-major weights, row blocks for LayerNorms only
    if (tile && tile != (P.row > 0 ? kRowBM : 128) &&
        (q[7] || (P.row > 0 && P.row != kRowLnF)))
      return cudaErrorInvalidValue;
    if (!valid_prob(P, q[6] != 0, q[7] != 0, this_part, P.row))
      return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (part)
    return tile ? cudaErrorInvalidValue
                : launch_gemm<128, 128, 4, 2, true, true, kEpiPart>(grp, s);
  if (a_mn) return cudaErrorInvalidValue;
  if (row > 0) {
    if (tile == 32)
      return launch_gemm<32, 256, 1, 8, false, false, kEpiRow, true>(grp, s);
    if (tile && tile != kRowBM) return cudaErrorInvalidValue;
    return b_mn ? launch_gemm<kRowBM, 256, 2, 4, false, true, kEpiRow>(grp, s)
                : launch_gemm<kRowBM, 256, 2, 4, false, false, kEpiRow>(grp, s);
  }
  if (tile == 64)
    return launch_gemm<64, 128, 2, 4, false, false, kEpiGen, true>(grp, s);
  if (tile && tile != 128) return cudaErrorInvalidValue;
  return b_mn ? launch_gemm<128, 128, 4, 2, false, true, kEpiGen>(grp, s)
              : launch_gemm<128, 128, 4, 2, false, false, kEpiGen>(grp, s);
}

// ptrs: q (row stride ldq), k, v (row stride ldk), valid [B Nk] or null,
// out (row stride ldo), lse [B Sq, H].  ints: B, Sq, Nk, H, Dh, ldq, ldk,
// ldo, mask id, seed lo, seed hi.  floats: the logit scale, rate.
extern "C" int f32l_attention(const void** p, const int* n, const float* f,
                              void* stream_ptr) {
  AttnArgs a = {};
  a.q = cfp(p[0]); a.k = cfp(p[1]); a.v = cfp(p[2]); a.valid = cfp(p[3]);
  a.out = fp(p[4]); a.lse = fp(p[5]);
  a.B = n[0]; a.Sq = n[1]; a.Nk = n[2]; a.H = n[3];
  a.ldq = n[5]; a.ldk = n[6]; a.ldo = n[7];
  a.drop = drop_of(n[8], n[9], n[10], f[1]);
  a.scale = f[0];
  return attention(a, n[4], false, static_cast<cudaStream_t>(stream_ptr));
}

// ptrs: q (row stride ldq), k, v (row stride ldk), valid [B Nk] or null,
// dout (row stride ldd), lse, delta [B Sq, H], dqpart [ceil(Nk / 64), B Sq,
// H Dh] (key tile t's share of dq), dk, dv (row stride lddk).  ints: B, Sq,
// Nk, H, Dh, ldq, ldk, ldd, lddk, mask id, seed lo, seed hi.  floats: the
// logit scale, rate.
extern "C" int f32l_attention_bwd(const void** p, const int* n,
                                  const float* f, void* stream_ptr) {
  AttnArgs a = {};
  a.q = cfp(p[0]); a.k = cfp(p[1]); a.v = cfp(p[2]); a.valid = cfp(p[3]);
  a.dout = cfp(p[4]); a.lse = fp(p[5]); a.delta = cfp(p[6]);
  a.dqpart = fp(p[7]); a.dk = fp(p[8]); a.dv = fp(p[9]);
  a.B = n[0]; a.Sq = n[1]; a.Nk = n[2]; a.H = n[3];
  a.ldq = n[5]; a.ldk = n[6]; a.ldd = n[7]; a.lddk = n[8];
  a.drop = drop_of(n[9], n[10], n[11], f[1]);
  a.scale = f[0];
  return attention(a, n[4], true, static_cast<cudaStream_t>(stream_ptr));
}

// The attention at inference.  ptrs: q (row stride ldq), k, v (row stride
// ldk), valid [B Nk] or null, out (row stride ldo).  ints: B, Sq, Nk, H,
// Dh (16 to 128, a multiple of 16), ldq, ldk, ldo.  floats: the logit
// scale.
extern "C" int f32l_masked_attention(const void** p, const int* n,
                                     const float* f, void* stream_ptr) {
  AttnArgs a = {};
  a.q = cfp(p[0]); a.k = cfp(p[1]); a.v = cfp(p[2]); a.valid = cfp(p[3]);
  a.out = fp(p[4]);
  a.B = n[0]; a.Sq = n[1]; a.Nk = n[2]; a.H = n[3];
  a.ldq = n[5]; a.ldk = n[6]; a.ldo = n[7];
  a.scale = f[0];
  if (a.B < 1 || a.Sq < 1 || a.Nk < 1 || a.H < 1 || a.ldq % 4 ||
      a.ldk % 4 || a.ldo % 2 || !a16(a.q) || !a16(a.k) || !a16(a.v) ||
      !a8(a.out))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (n[4]) {
    case 16: return launch_inf_attention<16>(a, s);
    case 32: return launch_inf_attention<32>(a, s);
    case 48: return launch_inf_attention<48>(a, s);
    case 64: return launch_inf_attention<64>(a, s);
    case 80: return launch_inf_attention<80>(a, s);
    case 96: return launch_inf_attention<96>(a, s);
    case 112: return launch_inf_attention<112>(a, s);
    case 128: return launch_inf_attention<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ptrs: q (row stride ldq), kv [B L, 2 D] (k, then v; row stride ldkv),
// valid [B L] or null, out (row stride ldo), lse [B S, H] or null (at
// inference).  ints: B, S, L, H, Dh (up to 128), ldq, ldkv, ldo, mask id
// (-1: none), seed lo, seed hi.  floats: the logit scale, rate.
extern "C" int f32l_cross_attention(const void** p, const int* n,
                                    const float* f, void* stream_ptr) {
  CrossArgs a = {};
  a.q = cfp(p[0]); a.kv = cfp(p[1]); a.valid = cfp(p[2]);
  a.out = fp(p[3]); a.lseo = fp(p[4]);
  a.B = n[0]; a.S = n[1]; a.L = n[2]; a.H = n[3]; a.Dh = n[4];
  a.ldq = n[5]; a.ldkv = n[6]; a.ldo = n[7];
  a.drop = drop_of(n[8], n[9], n[10], f[1]);
  a.scale = f[0];
  if (a.B < 1 || a.S < 1 || a.L < 1 || a.L > kMaxL || a.H < 1 || a.Dh < 1 ||
      a.Dh > 128 || !a.q || !a.kv || !a.out)
    return cudaErrorInvalidValue;
  const long long warps = (long long)a.B * a.S * a.H;
  if ((warps + 7) / 8 > INT_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (a.Dh <= 64)
    cross_fwd_kernel<2><<<blocks, 256, 0, s>>>(a);
  else
    cross_fwd_kernel<4><<<blocks, 256, 0, s>>>(a);
  return cudaGetLastError();
}

// ptrs: q, kv, valid (as the forward), dout (row stride ldd), lse, delta
// [B S, H], dq (row stride lddq), dkv [B L, 2 D] (row stride lddkv).  ints:
// B, S, L, H, Dh, ldq, ldkv, ldd, lddq, lddkv, mask id, seed lo, seed hi.
// floats: the logit scale, rate.
extern "C" int f32l_cross_attention_bwd(const void** p, const int* n,
                                        const float* f, void* stream_ptr) {
  CrossArgs a = {};
  a.q = cfp(p[0]); a.kv = cfp(p[1]); a.valid = cfp(p[2]);
  a.dout = cfp(p[3]); a.lse = cfp(p[4]); a.delta = cfp(p[5]);
  a.dq = fp(p[6]); a.dkv = fp(p[7]);
  a.B = n[0]; a.S = n[1]; a.L = n[2]; a.H = n[3]; a.Dh = n[4];
  a.ldq = n[5]; a.ldkv = n[6]; a.ldd = n[7]; a.lddq = n[8]; a.lddkv = n[9];
  a.drop = drop_of(n[10], n[11], n[12], f[1]);
  a.scale = f[0];
  if (a.B < 1 || a.S < 1 || a.L < 1 || a.L > kMaxL || a.H < 1 || a.Dh < 1 ||
      a.Dh > 64 || !a.q || !a.kv || !a.dout || !a.lse || !a.delta || !a.dq ||
      !a.dkv || (long long)a.B * a.H > INT_MAX)
    return cudaErrorInvalidValue;
  cross_bwd_kernel<<<(unsigned)(a.B * a.H), 256, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return cudaGetLastError();
}

// ptrs: x (row stride ldx), w [D], g (row stride ldg), dx (row stride
// lddx), dxk (row stride lddx) or null, part [ceil(M / 64), ldpart].  ints:
// M, D, ldx, ldg, lddx, ldpart, mask id (-1: none), seed lo, seed hi.
// floats: rate.
extern "C" int f32l_ln_bwd(const void** p, const int* n, const float* f,
                           void* stream_ptr) {
  Prob P = {};
  P.lnx = cfp(p[0]); P.lnw = cfp(p[1]); P.C = fp(p[3]); P.C2 = fp(p[4]);
  P.part = fp(p[5]);
  P.M = n[0]; P.N = n[1]; P.ldlnx = n[2]; P.ldc = n[4]; P.ldpart = n[5];
  P.row = kRowLnB;
  P.drop2 = drop_of(n[6], n[7], n[8], f[0]);
  const float* g = cfp(p[2]);
  if (P.M < 1 || P.N < 32 || P.N > 256 || P.N % 32 || !P.lnx || !P.lnw ||
      !g || !P.C || !P.part || P.ldpart < 2 * P.N)
    return cudaErrorInvalidValue;
  ln_bwd_kernel<<<(P.M + kRowBM - 1) / kRowBM, kThreads, 0,
                  static_cast<cudaStream_t>(stream_ptr)>>>(P, g, n[3]);
  return cudaGetLastError();
}

// ptrs: per segment its partials and its output.  ints: the segment count,
// then per segment: splits, the elements between splits, rows, columns, the
// output's row stride.  Output element (r, c) = sum over splits z of
// part[z pstride + r cols + c].
extern "C" int f32l_reduce(const void** p, const int* n, const float*,
                           void* stream_ptr) {
  Segs a = {};
  a.n = n[0];
  if (a.n < 1 || a.n > kMaxSeg) return cudaErrorInvalidValue;
  long long most = 0;
  for (int i = 0; i < a.n; ++i) {
    Seg& S = a.s[i];
    const int* q = n + 1 + 5 * i;
    S.part = cfp(p[2 * i]);
    S.out = fp(p[2 * i + 1]);
    S.splits = q[0];
    S.pstride = (size_t)q[1];
    S.rows = q[2];
    S.cols = q[3];
    S.ldo = q[4];
    if (!S.part || !S.out || S.splits < 1 || S.rows < 1 || S.cols < 1 ||
        S.ldo < S.cols || (S.splits > 1 &&
                           S.pstride < (size_t)S.rows * S.cols))
      return cudaErrorInvalidValue;
    const long long cells = (long long)S.rows * S.cols;
    if (cells > most) most = cells;
  }
  const long long bx = (most + 255) / 256;
  if (bx > INT_MAX) return cudaErrorInvalidValue;
  reduce_segs_kernel<<<dim3((unsigned)bx, a.n), 256, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return cudaGetLastError();
}
