// The float32 counterparts of K1 (fused_md_layer), K2 (fused_decoder_layer),
// kernel 5 (fused_postnorm_ffn) and kernel 10 (pallas_masked_attention):
// replaces the same four TPU kernels as their bf16 versions
// (ladiff_tpu/ops/pallas_md_layer.py:198, pallas_decoder_layer.py:234,
// pallas_postnorm_ffn.py:64, pallas_attention.py:52), at the type of every
// published configuration (TRAIN.MIXED_PRECISION false).  Each of the four
// is a short chain of these three kernels behind its wrapper
// (ladiff_torch/ops/f32_layer.py):
//
//   f32_linear_kernel     C = act(A W^T + b) (+ R): a 64 x 64 output tile
//                         per block of 256 threads, 4 x 4 outputs a thread,
//                         A and W through a 4-slot cp.async ring of 16-deep
//                         k slices in float32 shared memory, FFMA with
//                         float32 accumulators; bias, ReLU or exact-erf GELU
//                         and a residual in the epilogue.
//   f32_rownorm_kernel    one warp a row: LayerNorm (eps 1e-5, two passes
//                         over the row) of an optionally row-scaled source
//                         row, then optionally AdaLN (x (1 + scale) +
//                         shift) and SiLU: the MD layer's stylization.
//   f32_attention_kernel  masked softmax attention: one block of 128
//                         threads per (sample, head, 32-query tile), keys in
//                         64-key tiles brought to shared memory by cp.async,
//                         both products as 4 x 4 FFMA tiles a thread, an
//                         online softmax on the score tile; keys from one
//                         or two sources (the
//                         MD layer's latent keys under their mask and its
//                         always-valid text and time keys), a masked key's
//                         logit set to -1e9 as the plain versions do, so a
//                         sample without a valid key attends uniformly.
//
// What bounds them on the H100: at the shapes of the published paths every
// product is float32 at 4 bytes an element; the FFMA pipes' 67 TFLOP/s are
// the ceiling of this design (three-term TF32 on the tensor cores, ~165
// TFLOP/s, is the faster design left for later).  No product uses bf16
// operands, TF32 or a library call.
#include "common.cuh"

using namespace ladiff;

LADIFF_ERROR_STRING_FN

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kStages = 4, kLinThreads = 256;
constexpr int kLd = kBK + 4;  // row stride of a k slice in shared memory
constexpr int kQT = 32, kKT = 64, kAttnThreads = 128;

__device__ __forceinline__ float act_f32(float v, int act) {
  if (act == 1) return v > 0.f ? v : 0.f;
  if (act == 2) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

// C[m, n] = act(sum_k A[m, k] W[n, k] + bias[n]) + R[m, n]
// act: 0 none, 1 ReLU, 2 exact-erf GELU; bias and R may be null.  A block
// computes a 64 x 64 tile of C, thread (tx, ty) the rows ty + 16 i and the
// columns tx + 16 j.  The 16-deep k slices of A and W come through cp.async
// into a ring of kStages row-major slices (rows of kBK + 4 floats: the 16-
// byte reads of 8 consecutive W rows fall in distinct banks), so the loads
// of the next slices overlap this one's products.
__global__ void __launch_bounds__(kLinThreads) f32_linear_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ R, int ldr,
    float* __restrict__ C, int ldc, int M, int N, int K, int act) {
  __shared__ __align__(16) float As[kStages][kBM * kLd];
  __shared__ __align__(16) float Ws[kStages][kBN * kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // this thread's 16-byte piece of each k slice: row lr, columns lk .. lk + 3
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const int am = m0 + lr, wn = n0 + lr;
  const float* arow = A + (size_t)(am < M ? am : 0) * lda + lk;
  const float* wrow = W + (size_t)(wn < N ? wn : 0) * K + lk;
  const int nk = (K + kBK - 1) / kBK;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int stage, int kt) {
    const bool in_k = kt * kBK + lk < K;  // K % 4 == 0: the whole piece
    float* ad = &As[stage][lr * kLd + lk];
    float* wd = &Ws[stage][lr * kLd + lk];
    if (am < M && in_k)
      cp_async16(ad, arow + kt * kBK);
    else
      *reinterpret_cast<float4*>(ad) = zero4;
    if (wn < N && in_k)
      cp_async16(wd, wrow + kt * kBK);
    else
      *reinterpret_cast<float4*>(wd) = zero4;
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
    const float* ws = Ws[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&as[(ty + 16 * i) * kLd + kk]);
        b[i] = *reinterpret_cast<const float4*>(&ws[(tx + 16 * i) * kLd + kk]);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j] + (bias ? __ldg(bias + n) : 0.f);
      v = act_f32(v, act);
      if (R) v += R[(size_t)m * ldr + n];
      C[(size_t)m * ldc + n] = v;
    }
  }
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

struct AttnF32 {
  const float *q, *k1, *v1, *valid1, *k2, *v2;
  float* out;
  int B, Sq, n1, n2, H, Dh, ldq, ldk1, ldk2, ldo, qtiles;
  float scale;
};

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
      bool exists = kj < n, valid = true;
      if (exists && kj < a.n1 && a.valid1)
        valid = a.valid1[(size_t)b * a.n1 + kj] > 0.5f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v =
            !exists ? -INFINITY : (valid ? s[i][j] * a.scale : kNegInf);
        Ss[(ty + 8 * i) * (kKT + 4) + tx + 16 * j] = v;
      }
    }
    __syncthreads();
    // online softmax: warp w takes rows 8w .. 8w + 7, two keys a lane
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
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
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
  }
}

// Shared-memory grants of the attention kernel's instantiations (one per
// library: internal linkage).
SmemGrant g_attn_grant[8];

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

}  // namespace

// ptrs: A (row stride lda), W [N, K], bias [N] or null, R (row stride ldr)
// or null, C (row stride ldc); all float32.  ints: M, N, K, lda, ldr, ldc,
// act (0 none, 1 ReLU, 2 exact-erf GELU).
extern "C" int f32_linear(const void** p, const int* n, const float*,
                          void* stream_ptr) {
  const int M = n[0], N = n[1], K = n[2];
  // 16-byte pieces of A's and W's rows
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (M < 1 || N < 1 || K < 1 || n[6] < 0 || n[6] > 2 || K % 4 || n[3] % 4 ||
      !aligned(p[0]) || !aligned(p[1]))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  f32_linear_kernel<<<grid, kLinThreads, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(p[0]), n[3], static_cast<const float*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), n[4],
      static_cast<float*>(const_cast<void*>(p[4])), n[5], M, N, K, n[6]);
  return cudaGetLastError();
}

// ptrs: src (row stride lds), row_scale [M] or null, w [D], b [D], ss
// [rows, 2D] or null, out (row stride ldo); all float32.  ints: M, D, lds,
// src_div, ss_div, ldo.
extern "C" int f32_rownorm(const void** p, const int* n, const float*,
                           void* stream_ptr) {
  const int M = n[0], D = n[1];
  if (M < 1 || D < 1 || n[3] < 1 || n[4] < 0) return cudaErrorInvalidValue;
  f32_rownorm_kernel<<<(M + 7) / 8, 256, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(p[0]), n[2], n[3],
      static_cast<const float*>(p[1]), static_cast<const float*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<const float*>(p[4]), n[4],
      static_cast<float*>(const_cast<void*>(p[5])), n[5], M, D);
  return cudaGetLastError();
}

// ptrs: q (row stride ldq), k1, v1 (row stride ldk1), valid1 [B n1] or
// null, k2, v2 (row stride ldk2) or null, out (row stride ldo); all
// float32.  ints: B, Sq, n1, n2, H, Dh, ldq, ldk1, ldk2, ldo.  floats: the
// logit scale.
extern "C" int f32_attention(const void** p, const int* n, const float* f,
                             void* stream_ptr) {
  AttnF32 a;
  a.q = static_cast<const float*>(p[0]);
  a.k1 = static_cast<const float*>(p[1]);
  a.v1 = static_cast<const float*>(p[2]);
  a.valid1 = static_cast<const float*>(p[3]);
  a.k2 = static_cast<const float*>(p[4]);
  a.v2 = static_cast<const float*>(p[5]);
  a.out = static_cast<float*>(const_cast<void*>(p[6]));
  a.B = n[0]; a.Sq = n[1]; a.n1 = n[2]; a.n2 = n[3]; a.H = n[4];
  a.Dh = n[5]; a.ldq = n[6]; a.ldk1 = n[7]; a.ldk2 = n[8]; a.ldo = n[9];
  a.scale = f[0];
  a.qtiles = (a.Sq + kQT - 1) / kQT;
  // 16-byte pieces of every row: head widths, row strides and the
  // pointers in multiples of four floats
  const auto aligned = [](const float* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (a.B < 1 || a.Sq < 1 || a.n1 < 0 || a.n2 < 0 || a.n1 + a.n2 < 1 ||
      a.H < 1 || a.Dh < 4 || a.Dh > 128 || a.Dh % 4 || a.ldq % 4 ||
      a.ldk1 % 4 || a.ldk2 % 4 || !aligned(a.q) || !aligned(a.k1) ||
      !aligned(a.v1) || (a.n2 > 0 && (!a.k2 || !aligned(a.k2) ||
                                      !aligned(a.v2))))
    return cudaErrorInvalidValue;
  if ((long long)a.B * a.H * a.qtiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
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
