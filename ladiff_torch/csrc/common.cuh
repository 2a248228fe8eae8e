// Building blocks shared by the port's hand-written Hopper kernels: loads,
// warp and quad sums, the dropout generator, a warp's row LayerNorm, the
// shared-memory grants; and block_gemm, the first port's product of a
// 32-row block (kernel 7's): WMMA 16x16x16 bf16 tiles with f32
// accumulation, the A operand (activations) in shared memory, the B operand
// a torch Linear weight [out, in] streamed through a cp.async stage.  Row
// blocks are 32 rows (two 16-row tiles) and 256 threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace ladiff {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kRows = 32;      // rows of a row block
constexpr int kThreads = 256;  // threads of a row block (8 warps)
constexpr int kChunk = 256;    // output columns per GEMM call
constexpr float kNegInf = -1e9f;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
// Read-only global loads (ld.global.nc): the compiler may hoist them above
// the shared-memory stores around them, which it cannot do for plain loads
// through generic pointers.
__device__ __forceinline__ bf16 ldg(const bf16* p) { return __ldg(p); }
__device__ __forceinline__ float ldgf(const bf16* p) { return tof(__ldg(p)); }
__device__ __forceinline__ float ldgf(const float* p) { return __ldg(p); }
__device__ __forceinline__ bf16 tob(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }
__device__ __forceinline__ float quick_gelu(float v) {
  return v / (1.f + __expf(-1.702f * v));
}
// The derivative of the FFN activation at a (act: 0 relu, 1 erf GELU).
__device__ __forceinline__ float act_grad(float a, int act) {
  if (!act) return a > 0.f ? 1.f : 0.f;
  const float cdf = 0.5f * (1.f + erff(a * 0.70710678118654752f));
  const float pdf = 0.39894228040143268f * expf(-0.5f * a * a);
  return cdf + a * pdf;
}

// Asynchronous 16-byte global -> shared copies (bypassing L1, so the small
// vectors that the epilogues read stay cached there).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Weight tiles of block_gemm: kStages stages of [kNB out-features][kKT + 8]
// bf16, streamed from global memory while the tensor cores work on the
// previous stage.  Every kernel that calls block_gemm reserves
// kWStageBytes of shared memory for them.
constexpr int kNB = 128;  // output columns per pass: one 16-wide tile per warp
constexpr int kKT = 32;   // k per stage
constexpr int kLDW = kKT + 8;
constexpr int kStages = 3;
constexpr size_t kWStageBytes = (size_t)kStages * kNB * kLDW * 2;

// C[32 x N] (f32, smem, ldc) = A[32 x K] (bf16, smem, lda) @ W^T, where W
// points at row n0 of a torch Linear weight (row stride ldw = in features,
// 16-byte aligned rows).  With `accumulate` the tile starts from C's
// current contents.  N a multiple of 16, K a multiple of kKT; lda a
// multiple of 8, ldc of 4.  All threads of the block call it; it starts and
// ends with __syncthreads.  Per pass of kNB columns, warp w owns column
// tile w and both 16-row tiles; the block streams W through `ws` in a
// kStages-deep cp.async pipeline, one __syncthreads per k-step.
__device__ __forceinline__ void block_gemm(const bf16* A, int lda,
                                           const bf16* W, int ldw, int K,
                                           int N, float* C, int ldc,
                                           bool accumulate, bf16* ws) {
  const int warp = threadIdx.x >> 5;
  const int nk = K / kKT;
  constexpr int kVec = kKT / 8;  // 16-byte vectors per row and stage
  for (int n0 = 0; n0 < N; n0 += kNB) {
    const int nb = N - n0 < kNB ? N - n0 : kNB;
    const bool active = warp * 16 < nb;
    __syncthreads();  // the previous users of ws and C are done
    auto load_stage = [&](int kt) {
      if (kt < nk) {
        bf16* dst = ws + (kt % kStages) * kNB * kLDW;
        const bf16* src = W + (size_t)n0 * ldw + kt * kKT;
        for (int v = threadIdx.x; v < nb * kVec; v += blockDim.x) {
          const int n = v / kVec, kv = v % kVec;
          cp_async16(dst + n * kLDW + kv * 8, src + (size_t)n * ldw + kv * 8);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) load_stage(s);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
    float* c0 = C + n0 + warp * 16;
    if (active && accumulate) {
      wmma::load_matrix_sync(acc0, c0, ldc, wmma::mem_row_major);
      wmma::load_matrix_sync(acc1, c0 + 16 * ldc, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc0, 0.f);
      wmma::fill_fragment(acc1, 0.f);
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage kt landed for all; stage kt-1 is consumed
      load_stage(kt + kStages - 1);
      if (active) {
        const bf16* wt = ws + (kt % kStages) * kNB * kLDW + warp * 16 * kLDW;
#pragma unroll
        for (int kk = 0; kk < kKT; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              a0, a1;
          const int k = kt * kKT + kk;
          wmma::load_matrix_sync(b, wt + kk, kLDW);
          wmma::load_matrix_sync(a0, A + k, lda);
          wmma::load_matrix_sync(a1, A + 16 * lda + k, lda);
          wmma::mma_sync(acc0, a0, b, acc0);
          wmma::mma_sync(acc1, a1, b, acc1);
        }
      }
    }
    cp_async_wait<0>();
    if (active) {
      wmma::store_matrix_sync(c0, acc0, ldc, wmma::mem_row_major);
      wmma::store_matrix_sync(c0 + 16 * ldc, acc1, ldc, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

// Dropout that a backward can regenerate: element `idx` of mask `mask_id`
// is one 32-bit word of Philox-4x32-10 keyed by the call's 64-bit seed at
// counter (idx / 4, mask_id, 0), word idx % 4.  The element is kept when
// bits < keep * 2^32 and scaled by 1 / keep.  The value depends on nothing
// but (seed, mask_id, idx), so any grid reproduces it.
struct Dropout {
  uint32_t key0, key1;  // the 64-bit seed
  uint32_t thresh;      // keep * 2^32
  float inv_keep;       // 1 / keep
};

inline Dropout make_dropout(int seed_lo, int seed_hi, float rate) {
  Dropout d;
  d.key0 = static_cast<uint32_t>(seed_lo);
  d.key1 = static_cast<uint32_t>(seed_hi);
  const double keep = 1.0 - static_cast<double>(rate);
  const double t = keep * 4294967296.0;
  d.thresh = t >= 4294967295.0 ? 4294967295u : static_cast<uint32_t>(t);
  d.inv_keep = static_cast<float>(1.0 / keep);
  return d;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// The keep-mask value (0 or 1 / keep) of element idx of mask mask_id.
__device__ __forceinline__ float keep_scale(const Dropout& d,
                                            uint32_t mask_id, uint64_t idx) {
  const uint64_t q = idx >> 2;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                 mask_id, 0u),
      d.key0, d.key1);
  const uint32_t w = idx & 3;
  const uint32_t bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  return bits < d.thresh ? d.inv_keep : 0.f;
}

// The keep-mask values of elements idx and idx + 1 of mask mask_id
// (keep_scale, one Philox block where both fall in it).
__device__ __forceinline__ void keep_scale2(const Dropout& d,
                                            uint32_t mask_id, uint64_t idx,
                                            float& k0, float& k1) {
  const uint64_t q = idx >> 2;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                 mask_id, 0u),
      d.key0, d.key1);
  const uint32_t w = idx & 3;
  const uint32_t b0 = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  const uint32_t b1 = w == 0 ? r.y : w == 1 ? r.z : w == 2 ? r.w : 0u;
  k0 = b0 < d.thresh ? d.inv_keep : 0.f;
  k1 = w == 3 ? keep_scale(d, mask_id, idx + 1)
              : (b1 < d.thresh ? d.inv_keep : 0.f);
}

// The sum over the four lanes of a quad (lanes 4 i .. 4 i + 3), to each.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// LayerNorm of one row held by a warp: v[i] is element lane + 32 i of a row
// of length D (D / 32 <= kMaxPer; the loops unroll so v stays in
// registers).  Two-pass mean / variance in f32, then
// v <- (v - mean) * rstd * g + b.
constexpr int kMaxPer = 24;  // D <= 768
__device__ __forceinline__ void warp_layernorm(float* v, int D,
                                               const bf16* g, const bf16* b) {
  const int lane = threadIdx.x & 31;
  const int per = D / 32;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i)
    if (i < per) s += v[i];
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i)
    if (i < per) q += (v[i] - mean) * (v[i] - mean);
  const float rstd = rsqrtf(warp_sum(q) / D + kLnEps);
  // The column is clamped before the guard: the compiler may issue the
  // read-only loads of the unrolled iterations i >= per speculatively, and
  // they must then stay inside g and b.
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int c = min(lane + 32 * i, D - 1);
    if (i < per) v[i] = (v[i] - mean) * rstd * ldgf(g + c) + ldgf(b + c);
  }
}

// The dynamic shared memory one kernel has been allowed on each device: the
// attribute is set per device, so a process that uses two cards sets it on
// both.
constexpr int kMaxDevices = 64;
struct SmemGrant {
  size_t bytes[kMaxDevices] = {};
};

// Lets `kernel` use `bytes` of dynamic shared memory on the current device
// (once per device and size); returns false when the card cannot give that
// much to one block.
template <typename Kern>
inline bool allow_smem(Kern kernel, size_t bytes, SmemGrant& grant) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return false;
  if (bytes <= grant.bytes[dev]) return true;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)optin) return false;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return false;
  grant.bytes[dev] = bytes;
  return true;
}

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

}  // namespace ladiff

// Every library exports this next to its entry points.
#define LADIFF_ERROR_STRING_FN                                         \
  extern "C" const char* ladiff_error_string(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));         \
  }
