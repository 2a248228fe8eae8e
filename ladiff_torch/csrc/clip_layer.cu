// Kernels K3 and K4: the two halves of a CLIP text layer around its causal
// attention core (replace ladiff_tpu/ops/pallas_clip_layer.py fused_ln_qkv
// and fused_proj_mlp), as a row LayerNorm pass and launches of the sm_90a
// GEMM block of gemm_sm90.cuh.  The wrappers in
// ladiff_torch/ops/clip_layer.py chain them: K3 is LN1 then one GEMM over
// Wq, Wk and Wv; K4 is Wo (+ bo + x, kept in f32), LN2, fc1 with
// quick-GELU, fc2 (+ b2 + h).  See that module for the bound and design.
#include <type_traits>

#include "gemm_sm90.cuh"

using namespace ladiff;

namespace {

constexpr int kLnRows = 8;  // rows of a LayerNorm block: one warp each

// V consecutive elements of a row as floats (one 16-byte load where V
// elements are 16 bytes).
template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  if constexpr (V == 8 || V == 4) {
    using U = typename std::conditional<V == 8, uint4, uint2>::type;
    const U u = __ldg(reinterpret_cast<const U*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = ldgf(p + e);
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = ldgf(p + e);
  }
}

// y = bf16(LN(x)) by rows, in f32; x bf16 (K3's x) or f32 (K4's h).  A
// warp per row; lane l holds the V-element vectors l, l + 32, ... (V = 1,
// or 16 bytes of x where D is a multiple of 32 V): two-pass mean and
// variance as warp_layernorm has them.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kLnRows)
ln_rows_kernel(const T* x, const bf16* g, const bf16* b, bf16* y, int M,
               int D) {
  constexpr int kVecs = kMaxPer / V;  // vectors a lane may hold (D <= 768)
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, per = D / (32 * V);
  if (row >= M) return;  // the whole warp: the sums shuffle
  const T* xr = x + (size_t)row * D;
  float v[kVecs][V];
  float s = 0.f;
  // vectors clamped before the guard: unrolled iterations past per may
  // load speculatively
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if (i < per) {
      load_vec<V>(xr + min(lane + 32 * i, D / V - 1) * V, v[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[i][e];
    }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if (i < per)
#pragma unroll
      for (int e = 0; e < V; ++e) q += (v[i][e] - mean) * (v[i][e] - mean);
  const float rstd = rsqrtf(warp_sum(q) / D + kLnEps);
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if (i < per) {
      const int c = min(lane + 32 * i, D / V - 1) * V;
      float gv[V], bv[V];
      load_vec<V>(g + c, gv);
      load_vec<V>(b + c, bv);
      __align__(16) bf16 o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = tob((v[i][e] - mean) * rstd * gv[e] + bv[e]);
      if constexpr (V == 8)
        *reinterpret_cast<uint4*>(y + (size_t)row * D + c) =
            *reinterpret_cast<const uint4*>(o);
      else if constexpr (V == 4)
        *reinterpret_cast<uint2*>(y + (size_t)row * D + c) =
            *reinterpret_cast<const uint2*>(o);
      else
        y[(size_t)row * D + c] = o[0];
    }
}

template <typename T, int V>
cudaError_t ln_rows(const void* const* p, int M, int D, cudaStream_t s) {
  ln_rows_kernel<T, V><<<(M + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(
      static_cast<const T*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]),
      static_cast<bf16*>(const_cast<void*>(p[3])), M, D);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t gemm_bn(int BN, const bf16* A, const bf16* const* w,
                    const sm90::GemmArgs& g, int ctas, cudaStream_t s) {
  switch (BN) {
    case 128: return sm90::gemm_sm90<128, EPI>(A, w, g, ctas, s);
    case 192: return sm90::gemm_sm90<192, EPI>(A, w, g, ctas, s);
    case 256: return sm90::gemm_sm90<256, EPI>(A, w, g, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x, ln_w, ln_b, y.  ints: M, D, x is f32 (0 bf16, 1 f32).
extern "C" int clip_ln_rows(const void** p, const int* n, const float*,
                            void* stream) {
  const int M = n[0], D = n[1];
  if (M <= 0 || D % 32 || D > 32 * kMaxPer) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n[2])
    return D % 128 ? ln_rows<float, 1>(p, M, D, s)
                   : ln_rows<float, 4>(p, M, D, s);
  return D % 256 ? ln_rows<bf16, 1>(p, M, D, s) : ln_rows<bf16, 8>(p, M, D, s);
}

// Clusters of the GEMM block resident at once (0 when the query fails).
extern "C" int clip_gemm_cluster_slots() {
  return sm90::gemm_sm90_cluster_slots();
}

// out[i] = epilogue(A w[i]^T + bias[i]) for i < mats.
// ptrs: A, w0, w1, w2, bias0, bias1, bias2, out0, out1, out2, resid (null
// where unused, w1.. and bias1.. too where mats is 1).
// ints: M, N, K, mats, epilogue (sm90::Epilogue), BN, ctas (a multiple
// of the cluster size).
// floats: scale (kEpiBias, weight 0).  The probe epilogue (kEpiProbe)
// takes out0 as one float that the warps' sums are added to.
extern "C" int clip_gemm(const void** p, const int* n, const float* f,
                         void* stream) {
  sm90::GemmArgs g = {};
  g.M = n[0];
  g.N = n[1];
  g.K = n[2];
  g.mats = n[3];
  const int epi = n[4], BN = n[5], ctas = n[6];
  if (g.M <= 0 || g.N <= 0 || g.N % 8 || g.K <= 0 || g.K % 8 ||
      (g.mats != 1 && g.mats != 3) || ctas <= 0)
    return cudaErrorInvalidValue;
  g.scale = f[0];
  g.splits = 1;
  const bf16* w[3];
  for (int i = 0; i < 3; ++i) {
    w[i] = static_cast<const bf16*>(p[1 + i]);
    g.bias[i] = static_cast<const bf16*>(p[4 + i]);
    g.out[i] = const_cast<void*>(p[7 + i]);
    if (i < g.mats && (!w[i] || !g.bias[i] || !g.out[i]))
      return cudaErrorInvalidValue;
  }
  g.resid = p[10];
  if ((epi == sm90::kEpiResidF32 || epi == sm90::kEpiResidBf16) && !g.resid)
    return cudaErrorInvalidValue;
  if (epi != sm90::kEpiBias && epi != sm90::kEpiProbe && g.mats != 1)
    return cudaErrorInvalidValue;
  const bf16* A = static_cast<const bf16*>(p[0]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case sm90::kEpiBias: return gemm_bn<sm90::kEpiBias>(BN, A, w, g, ctas, s);
    case sm90::kEpiResidF32:
      return gemm_bn<sm90::kEpiResidF32>(BN, A, w, g, ctas, s);
    case sm90::kEpiGelu: return gemm_bn<sm90::kEpiGelu>(BN, A, w, g, ctas, s);
    case sm90::kEpiResidBf16:
      return gemm_bn<sm90::kEpiResidBf16>(BN, A, w, g, ctas, s);
    case sm90::kEpiProbe:
      return gemm_bn<sm90::kEpiProbe>(BN, A, w, g, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}
