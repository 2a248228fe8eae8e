// The float32 tiles shared by the float32 chains of the inference kernels
// (f32_layer.cu: K1, K2, kernels 5 and 10) and of the training kernels
// (f32_train.cu: kernels 8, 9, 12 and 13): plain SIMT float32, FFMA with
// float32 accumulators, no TF32, no bf16 operand, no library call.
//
//   gemm_f32_kernel       C = epilogue(A B^T) over a 64 x 64 output tile per
//                         block of 256 threads, 4 x 4 outputs a thread, A
//                         and B through a 4-slot cp.async ring of 16-deep k
//                         slices.  Each operand is read K-contiguous (a row
//                         of A or of a torch weight [N, K]: 16-byte pieces)
//                         or M/N-contiguous (a weight read as [K, N] for dx
//                         = dY W, or an activation read as its transpose for
//                         the weight gradients dW = dY^T X: 4-byte pieces,
//                         neighbouring threads on neighbouring addresses).
//                         Epilogue: bias, ReLU or exact-erf GELU (storing
//                         the pre-activation where asked), the activation's
//                         derivative at a given pre-activation, a dropout
//                         keep-scale from (seed, mask id, m N + n), a
//                         residual.  Split-K over blockIdx.z writes float32
//                         partials (and, in the blocks of the first column
//                         tile, the column sums of A over the split: the
//                         bias gradient), summed later in split order.
//   f32_rownorm_kernel    one warp a row: LayerNorm (eps 1e-5, two passes)
//                         of an optionally row-scaled source row, then
//                         optionally AdaLN (x (1 + scale) + shift) and SiLU.
//   f32_attention_kernel  masked softmax attention: one block of 128
//                         threads per (sample, head, 32-query tile), keys in
//                         64-key tiles through cp.async, both products as
//                         4 x 4 FFMA tiles a thread, an online softmax; keys
//                         from one or two sources (the second always valid).
//                         A masked key's logit is -1e9, as in the plain
//                         versions; a sample without a valid key attends
//                         uniformly (every logit 0: the plain versions'
//                         equal -1e9 logits).  In training the
//                         probabilities take a dropout keep-scale from
//                         (seed, mask id, ((b H + h) Sq + i) Nk + j) after
//                         the row sum, and each row's log-sum-exp is
//                         written for the backward.
//
// What bounds them on the H100: every product is float32 at 4 bytes an
// element, and the FFMA pipes' 67 TFLOP/s are this design's ceiling
// (three-term TF32 on the tensor cores, ~165 TFLOP/s, is the faster design
// left for later).
#pragma once

#include "common.cuh"

namespace ladiff {
namespace f32 {

constexpr int kBM = 64, kBN = 64, kBK = 16, kStages = 4, kLinThreads = 256;
constexpr int kLd = kBK + 4;  // row stride of a k slice in shared memory
constexpr int kQT = 32, kKT = 64, kAttnThreads = 128;

// act: 0 none, 1 ReLU, 2 exact-erf GELU
__device__ __forceinline__ float act_f32(float v, int act) {
  if (act == 1) return v > 0.f ? v : 0.f;
  if (act == 2) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

// the derivative of act (1 ReLU, 2 exact-erf GELU) at the pre-activation a
__device__ __forceinline__ float act_grad_f32(float a, int act) {
  if (act == 1) return a > 0.f ? 1.f : 0.f;
  const float cdf = 0.5f * (1.f + erff(a * 0.70710678118654752f));
  const float pdf = 0.39894228040143268f * expf(-0.5f * a * a);
  return cdf + a * pdf;
}

// 4-byte asynchronous global -> shared copy (through L1)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// The keep-scale of element idx of mask mask_id, or 1 with dropout off.
struct Drop {
  Dropout d;
  uint32_t mask_id;
  int on;
};

__device__ __forceinline__ float drop_scale(const Drop& dr, uint64_t idx) {
  return dr.on ? keep_scale(dr.d, dr.mask_id, idx) : 1.f;
}

inline Drop make_drop(int seed_lo, int seed_hi, float rate, int mask_id) {
  Drop dr;
  dr.d = make_dropout(seed_lo, seed_hi, rate);
  dr.mask_id = static_cast<uint32_t>(mask_id);
  dr.on = rate > 0.f;
  return dr;
}

struct GemmEpi {
  const float* bias = nullptr;  // [N]
  int act = 0;                  // applied to acc + bias
  float* pre = nullptr;         // acc + bias before act (row stride ldpre)
  int ldpre = 0;
  const float* gin = nullptr;   // times act'(gin[m, n]) (row stride ldg)
  int ldg = 0, gact = 0;
  Drop drop = {};               // times keep(mask_id, m N + n)
  const float* R = nullptr;     // plus R[m, n] (row stride ldr)
  int ldr = 0;
};

struct GemmArgs {
  const float* A;
  int lda;
  const float* B;
  int ldb;
  float* C;
  int ldc;
  int M, N, K;
  int ksplit;         // rows of K a split (blockIdx.z)
  size_t cstride;     // C's elements a split
  float* colsum;      // or null: the column sums of A(m, .) over a split
  size_t sstride;     // colsum's elements a split
  GemmEpi e;
};

// C[m, n] = epi(sum_k A(m, k) B(n, k)), A(m, k) = A[m lda + k] (A_MN:
// A[k lda + m]) and B(n, k) = B[n ldb + k] (B_MN: B[k ldb + n]).  Thread
// (tx, ty) computes rows ty + 16 i and columns tx + 16 j of the block's tile;
// the k slices land in shared memory as [row][k] (rows of kBK + 4 floats),
// whichever layout they come from.
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kLinThreads) gemm_f32_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[kStages][kBM * kLd];
  __shared__ __align__(16) float Bs[kStages][kBN * kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * g.ksplit;
  const int ke = min(g.K, kb + g.ksplit);
  const int nk = (ke - kb + kBK - 1) / kBK;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // K-contiguous operand: this thread's 16-byte piece of a slice is row
  // lr, columns lk .. lk + 3 (ke - kb is a multiple of 4 there)
  const int lr = tid / 4, lk = (tid % 4) * 4;
  // M/N-contiguous operand: element (tid % 64, tid / 64 + 4 i), i < 4
  const int er = tid % 64, ek = tid / 64;
  auto load_op = [&](float* s, const float* src, int ld, int r0, int R,
                     int k0, bool mn) {
    if (!mn) {
      const int r = r0 + lr, k = k0 + lk;
      float* d = s + lr * kLd + lk;
      if (r < R && k < ke)
        cp_async16(d, src + (size_t)r * ld + k);
      else
        *reinterpret_cast<float4*>(d) = zero4;
    } else {
      const int r = r0 + er;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = ek + 4 * i, k = k0 + kk;
        float* d = s + er * kLd + kk;
        if (r < R && k < ke)
          cp_async4(d, src + (size_t)k * ld + r);
        else
          *d = 0.f;
      }
    }
  };
  auto load = [&](int stage, int kt) {
    const int k0 = kb + kt * kBK;
    load_op(As[stage], g.A, g.lda, m0, g.M, k0, A_MN);
    load_op(Bs[stage], g.B, g.ldb, n0, g.N, k0, B_MN);
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float csum = 0.f;  // colsum: row tid of the tile (tid < kBM)
  const bool do_colsum = g.colsum && blockIdx.x == 0 && tid < kBM;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // slice kt has landed; every thread is done with the slot refilled next
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages,
                                    kt + kStages - 1);
    cp_async_commit();
    const float* as = As[kt % kStages];
    const float* bs = Bs[kt % kStages];
    if (do_colsum) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) csum += as[tid * kLd + kk];
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&as[(ty + 16 * i) * kLd + kk]);
        b[i] = *reinterpret_cast<const float4*>(&bs[(tx + 16 * i) * kLd + kk]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = acc[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          acc[i][j] = fmaf(a[i].w, b[j].w, t);
        }
    }
  }
  if (do_colsum && m0 + tid < g.M)
    g.colsum[blockIdx.z * g.sstride + m0 + tid] = csum;
  float* C = g.C + blockIdx.z * g.cstride;
  const GemmEpi& e = g.e;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= g.N) continue;
      float v = acc[i][j] + (e.bias ? __ldg(e.bias + n) : 0.f);
      if (e.pre) e.pre[(size_t)m * e.ldpre + n] = v;
      v = act_f32(v, e.act);
      if (e.gin) v *= act_grad_f32(e.gin[(size_t)m * e.ldg + n], e.gact);
      if (e.drop.on)
        v *= keep_scale(e.drop.d, e.drop.mask_id, (uint64_t)m * g.N + n);
      if (e.R) v += e.R[(size_t)m * e.ldr + n];
      C[(size_t)m * g.ldc + n] = v;
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches the GEMM for the layouts (A_MN, B_MN); splits = ceil(K /
// ksplit) blocks along z.  Returns the launch's error.
inline int gemm_f32(GemmArgs g, bool a_mn, bool b_mn, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || g.K < 1 || g.ksplit < 1 || g.e.act < 0 ||
      g.e.act > 2 || (g.e.gin && (g.e.gact < 1 || g.e.gact > 2)))
    return cudaErrorInvalidValue;
  // the K-contiguous operands' 16-byte pieces
  if ((!a_mn && (g.K % 4 || g.lda % 4 || !aligned16(g.A))) ||
      (!b_mn && (g.K % 4 || g.ldb % 4 || !aligned16(g.B))) ||
      ((!a_mn || !b_mn) && g.ksplit % 4))
    return cudaErrorInvalidValue;
  const int splits = (g.K + g.ksplit - 1) / g.ksplit;
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (!a_mn && !b_mn)
    gemm_f32_kernel<false, false><<<grid, kLinThreads, 0, stream>>>(g);
  else if (!a_mn && b_mn)
    gemm_f32_kernel<false, true><<<grid, kLinThreads, 0, stream>>>(g);
  else if (a_mn && b_mn)
    gemm_f32_kernel<true, true><<<grid, kLinThreads, 0, stream>>>(g);
  else
    gemm_f32_kernel<true, false><<<grid, kLinThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// out[row] = post(LN(src[row / src_div] * row_scale[row]) * w + b), where
// post is, with ss, SiLU(y (1 + ss[s, :D]) + ss[s, D:]) for s = row / ss_div
// (s = 0 where ss_div is 0), and the identity without.
__global__ void __launch_bounds__(256) f32_rownorm_kernel(
    const float* __restrict__ src, int lds, int src_div,
    const float* __restrict__ row_scale, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ ss, int ss_div,
    float* __restrict__ out, int ldo, int M, int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;  // whole warps leave together
  const float* x = src + (size_t)(row / src_div) * lds;
  const float sc = row_scale ? row_scale[row] : 1.f;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += x[c] * sc;
  const float mean = warp_sum(s) / D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = x[c] * sc - mean;
    q += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) / D + kLnEps);
  const float* srow =
      ss ? ss + (size_t)(ss_div ? row / ss_div : 0) * 2 * D : nullptr;
  float* o = out + (size_t)row * ldo;
  for (int c = lane; c < D; c += 32) {
    float y = (x[c] * sc - mean) * rstd * w[c] + b[c];
    if (srow) {
      y = y * (1.f + srow[c]) + srow[D + c];
      y = y / (1.f + expf(-y));
    }
    o[c] = y;
  }
}

inline int rownorm_f32(const float* src, int lds, int src_div,
                       const float* row_scale, const float* w, const float* b,
                       const float* ss, int ss_div, float* out, int ldo, int M,
                       int D, cudaStream_t stream) {
  if (M < 1 || D < 1 || src_div < 1 || ss_div < 0)
    return cudaErrorInvalidValue;
  f32_rownorm_kernel<<<(M + 7) / 8, 256, 0, stream>>>(
      src, lds, src_div, row_scale, w, b, ss, ss_div, out, ldo, M, D);
  return cudaGetLastError();
}

struct AttnF32 {
  const float *q, *k1, *v1, *valid1, *k2, *v2;
  float* out;
  float* lse;  // [B Sq, H] or null
  int B, Sq, n1, n2, H, Dh, ldq, ldk1, ldk2, ldo, qtiles;
  float scale;
  Drop drop;  // on the probabilities, element ((b H + h) Sq + i) n + j
};

// Whether sample b has a valid key (the second source's are always valid):
// every thread of the block gets the answer.
__device__ __forceinline__ bool sample_has_valid_key(const float* valid,
                                                     int b, int n1, int n2) {
  if (!valid || n2 > 0) return __syncthreads_or(1);
  int any = 0;
  for (int j = threadIdx.x; j < n1; j += blockDim.x)
    any |= valid[(size_t)b * n1 + j] > 0.5f;
  return __syncthreads_or(any);
}

// The logit of key j (raw score s) of a sample: -inf past the keys, 0 for
// every key of a sample without a valid key (uniform attention), -1e9 for
// a masked key, else s times the scale.
__device__ __forceinline__ float key_logit(float s, int kj, int n,
                                           bool any_valid, bool valid,
                                           float scale) {
  if (kj >= n) return -INFINITY;
  if (!any_valid) return 0.f;
  return valid ? s * scale : kNegInf;
}

__host__ __device__ inline size_t attn_smem_floats(int Dh) {
  return (size_t)(kQT + 2 * kKT) * (Dh + 4)  // q, k and v tiles, row-major
         + (size_t)kQT * (kKT + 4)           // scores
         + (size_t)kKT * (kQT + 4)           // probabilities, transposed
         + 3 * kQT;                          // running max, sum, rescale
}

// One block per (sample, head, 32-query tile); NC = ceil(Dh / 16) output
// columns a thread (columns tx + 16 j).  Key j of sample b is row b n1 + j
// of the first source for j < n1 (valid where valid1 > 0.5, or always
// without valid1), else row b n2 + j - n1 of the second (always valid).
// The q tile and each k / v tile come through cp.async in 16-byte pieces
// (rows of Dh + 4 floats: the score loop's 16-byte reads of 8 consecutive
// key rows fall in distinct banks); the scores are q k^T times the scale.
template <int NC>
__global__ void __launch_bounds__(kAttnThreads) f32_attention_kernel(
    AttnF32 a) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = a.Dh, ld = Dh + 4, nv = Dh / 4;
  float* Qs = smem;                              // [kQT][ld]
  float* Ks = Qs + kQT * ld;                     // [kKT][ld]
  float* Vs = Ks + kKT * ld;                     // [kKT][ld]
  float* Ss = Vs + kKT * ld;                     // [kQT][kKT + 4]
  float* Ps = Ss + kQT * (kKT + 4);              // [kKT][kQT + 4]
  float* m_run = Ps + kKT * (kQT + 4);           // [kQT]
  float* l_run = m_run + kQT;                    // [kQT]
  float* alpha = l_run + kQT;                    // [kQT]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int tile = blockIdx.x % a.qtiles;
  const int bh = blockIdx.x / a.qtiles;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = tile * kQT;
  const int n = a.n1 + a.n2;
  const int hoff = h * Dh;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool any_valid = sample_has_valid_key(a.valid1, b, a.n1, a.n2);

  for (int i = tid; i < kQT * nv; i += kAttnThreads) {
    const int r = i / nv, c = (i % nv) * 4;
    const int qi = q0 + r;
    float* dst = Qs + r * ld + c;
    if (qi < a.Sq)
      cp_async16(dst, a.q + (size_t)(b * a.Sq + qi) * a.ldq + hoff + c);
    else
      *reinterpret_cast<float4*>(dst) = zero4;
  }
  if (tid < kQT) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  float o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kKT) {
    for (int i = tid; i < kKT * nv; i += kAttnThreads) {
      const int j = i / nv, c = (i % nv) * 4;
      const int kj = k0 + j;
      float* kd = Ks + j * ld + c;
      float* vd = Vs + j * ld + c;
      if (kj < a.n1) {
        const size_t r = ((size_t)b * a.n1 + kj) * a.ldk1 + hoff + c;
        cp_async16(kd, a.k1 + r);
        cp_async16(vd, a.v1 + r);
      } else if (kj < n) {
        const size_t r = ((size_t)b * a.n2 + (kj - a.n1)) * a.ldk2 + hoff + c;
        cp_async16(kd, a.k2 + r);
        cp_async16(vd, a.v2 + r);
      } else {
        *reinterpret_cast<float4*>(kd) = zero4;
        *reinterpret_cast<float4*>(vd) = zero4;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // scores of rows ty + 8 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dh; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 8 * i) * ld + d]);
        kv[i] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * i) * ld + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          s[i][j] = fmaf(qv[i].w, kv[j].w, t);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      bool valid = true;
      if (kj < a.n1 && a.valid1)
        valid = a.valid1[(size_t)b * a.n1 + kj] > 0.5f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ss[(ty + 8 * i) * (kKT + 4) + tx + 16 * j] =
            key_logit(s[i][j], kj, n, any_valid, valid, a.scale);
    }
    __syncthreads();
    // online softmax: warp w takes rows 8w .. 8w + 7, two keys a lane; the
    // row sum runs over the undropped probabilities
    for (int rr = 0; rr < kQT / 4; ++rr) {
      const int r = warp * (kQT / 4) + rr;
      const float s0 = Ss[r * (kKT + 4) + lane];
      const float s1 = Ss[r * (kKT + 4) + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mx);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      if (a.drop.on && q0 + r < a.Sq) {
        const uint64_t base =
            ((uint64_t)(b * a.H + h) * a.Sq + q0 + r) * n + k0;
        if (k0 + lane < n) p0 *= keep_scale(a.drop.d, a.drop.mask_id,
                                            base + lane);
        if (k0 + lane + 32 < n)
          p1 *= keep_scale(a.drop.d, a.drop.mask_id, base + lane + 32);
      }
      Ps[lane * (kQT + 4) + r] = p0;
      Ps[(lane + 32) * (kQT + 4) + r] = p1;
      __syncwarp();
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha[r] = al;
        l_run[r] = l_run[r] * al + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    // o of rows ty * 4 .. ty * 4 + 3 and columns tx + 16 c
    const int kn = min(kKT, n - k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) o[i][j] *= al;
    }
    for (int j = 0; j < kn; ++j) {
      const float4 pa =
          *reinterpret_cast<const float4*>(&Ps[j * (kQT + 4) + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < Dh ? Vs[j * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    if (qi >= a.Sq) continue;
    const float inv = 1.f / l_run[r];
    float* orow = a.out + (size_t)(b * a.Sq + qi) * a.ldo + hoff;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) orow[col] = o[i][c] * inv;
    }
    if (a.lse && tx == 0)
      a.lse[(size_t)(b * a.Sq + qi) * a.H + h] = m_run[r] + logf(l_run[r]);
  }
}

// Shared-memory grants of the attention kernel's instantiations (one per
// library: internal linkage).
static SmemGrant g_attn_grant[8];

template <int NC>
int launch_attention(const AttnF32& a, cudaStream_t stream) {
  const size_t bytes = attn_smem_floats(a.Dh) * sizeof(float);
  if (!allow_smem(f32_attention_kernel<NC>, bytes, g_attn_grant[NC - 1]))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)a.B * a.H * a.qtiles;
  f32_attention_kernel<NC><<<(unsigned)blocks, kAttnThreads, bytes, stream>>>(
      a);
  return cudaGetLastError();
}

// Checks the attention's shapes and pointers (16-byte pieces of every row:
// head widths, row strides and pointers in multiples of four floats) and
// launches it.
inline int attention_f32(AttnF32 a, cudaStream_t s) {
  a.qtiles = (a.Sq + kQT - 1) / kQT;
  if (a.B < 1 || a.Sq < 1 || a.n1 < 0 || a.n2 < 0 || a.n1 + a.n2 < 1 ||
      a.H < 1 || a.Dh < 4 || a.Dh > 128 || a.Dh % 4 || a.ldq % 4 ||
      a.ldk1 % 4 || a.ldk2 % 4 || !aligned16(a.q) || !aligned16(a.k1) ||
      !aligned16(a.v1) ||
      (a.n2 > 0 && (!a.k2 || !aligned16(a.k2) || !aligned16(a.v2))))
    return cudaErrorInvalidValue;
  if ((long long)a.B * a.H * a.qtiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch ((a.Dh + 15) / 16) {
    case 1: return launch_attention<1>(a, s);
    case 2: return launch_attention<2>(a, s);
    case 3: return launch_attention<3>(a, s);
    case 4: return launch_attention<4>(a, s);
    case 5: return launch_attention<5>(a, s);
    case 6: return launch_attention<6>(a, s);
    case 7: return launch_attention<7>(a, s);
    default: return launch_attention<8>(a, s);
  }
}

}  // namespace f32
}  // namespace ladiff
