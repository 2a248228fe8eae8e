// Building blocks shared by the port's hand-written Hopper kernels: loads,
// warp and quad sums, the dropout generator, a warp's row LayerNorm, the
// shared-memory grants.
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
