// The products of the training self-attention on the sm90 GEMM block
// (gemm_sm90.cuh): kernel 8's (train_attention.cu) and kernel 12's q / k /
// v and dx (train_layer.cu).  Each launch takes the geometry the host chose
// (ops/train_attention.py attention_gemm_geometry): the tile width BN, the
// CTAs, and for a weight gradient the K ranges.
//   qkv  = x Wqkv^T + bqkv                    kEpiBias, both K-major
//   out  = x + (ctx Wout^T + bout) * rm       kEpiAdd, kEpiAddDrop (mask 1)
//   dctx = dattn Wout; delta = dctx . ctx     kEpiDctx, Wout MN-major
//   dx   = add + dqkv Wqkv                    kEpiAdd, Wqkv MN-major
//   dW   = dy^T x                             kEpiPart, both MN-major: f32
//          partials of K ranges, then reduce_kernel sums them in range order
#pragma once

#include "gemm_sm90.cuh"
#include "train_common.cuh"

using namespace ladiff;

namespace {

struct GemmGeo {
  int bn, ctas, splits, ksplit;
};

// A product's geometry from the host's ints: bn, ctas (then splits, ksplit
// for a weight gradient).
inline GemmGeo gemm_geo(const int* n, bool split = false) {
  return {n[0], n[1], split ? n[2] : 1, split ? n[3] : 0};
}

inline sm90::GemmArgs gemm_args(int M, int N, int K, const bf16* bias,
                                void* out, const void* resid) {
  sm90::GemmArgs g = {};
  g.M = M;
  g.N = N;
  g.K = K;
  g.mats = 1;
  g.scale = 1.f;
  g.bias[0] = bias;
  g.out[0] = out;
  g.resid = resid;
  return g;
}

// One launch at the geometry's tile width: 128 or 256, and 192 for the
// q / k / v product (N = 3D).
template <int EPI, bool kAMN, bool kBMN>
static inline cudaError_t gemm_at(const GemmGeo& geo, const bf16* A,
                                  const bf16* w, sm90::GemmArgs g,
                                  cudaStream_t s) {
  g.splits = geo.splits;
  g.ksplit = geo.ksplit;
  const bf16* ws[1] = {w};
  switch (geo.bn) {
    case 128:
      return sm90::gemm_sm90<128, EPI, kAMN, kBMN>(A, ws, g, geo.ctas, s);
    case 256:
      return sm90::gemm_sm90<256, EPI, kAMN, kBMN>(A, ws, g, geo.ctas, s);
    case 192:
      if constexpr (EPI == sm90::kEpiBias)
        return sm90::gemm_sm90<192, EPI, kAMN, kBMN>(A, ws, g, geo.ctas, s);
      else
        return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// qkv [M, 3D] = x Wqkv^T + bqkv
static inline cudaError_t qkv_product(const GemmGeo& geo, const bf16* x,
                                      const bf16* in_w, const bf16* in_b,
                                      bf16* qkv, int M, int D,
                                      cudaStream_t s) {
  return gemm_at<sm90::kEpiBias, false, false>(
      geo, x, in_w, gemm_args(M, 3 * D, D, in_b, qkv, nullptr), s);
}

// dx [M, D] = add + dqkv Wqkv: the backward of qkv = x Wqkv^T
static inline cudaError_t dx_product(const GemmGeo& geo, const bf16* dqkv,
                                     const bf16* in_w, const bf16* add,
                                     bf16* dx, int M, int D,
                                     cudaStream_t s) {
  return gemm_at<sm90::kEpiAdd, false, true>(
      geo, dqkv, in_w, gemm_args(M, D, 3 * D, nullptr, dx, add), s);
}

// out [N1, N2] (f32) = dy^T x over `rows` rows (dy [rows, N1], x [rows,
// N2], bf16): the weight gradient of y = x W^T in the torch layout, through
// geo.splits partials in `part`.
static inline cudaError_t weight_grad_sm90(const GemmGeo& geo,
                                           const bf16* dy, int N1,
                                           const bf16* x, int N2, int rows,
                                           float* part, float* out,
                                           cudaStream_t s) {
  const cudaError_t err = gemm_at<sm90::kEpiPart, true, true>(
      geo, dy, x, gemm_args(N1, N2, rows, nullptr, part, nullptr), s);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, geo.splits, (size_t)N1 * N2, N1 * N2,
                                 out, s);
}

}  // namespace
