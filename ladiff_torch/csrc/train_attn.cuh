// Kernel 8's attention launches (the self-attention segment of a
// transformer layer in training), shared by train_attention.cu and the
// whole-layer training kernels 12 and 13 (train_layer.cu,
// train_decoder_layer.cu), which run the tiled attention forward and
// backward through them.  The products around them are train_gemm.cuh's.
// See ladiff_torch/ops/train_attention.py for the math and the dropout
// contract (mask 0: the probabilities, element ((b H + h) S + i) S + j).
//   attn_fwd_kernel    flash_tile.cuh's register-resident tile: 64 queries
//                      per block, key tiles through a cp.async ring, online
//                      softmax, probability dropout; writes ctx [M, D] and
//                      the log-sum-exp [M, H]
//   attn_bwd_kernel    probabilities recomputed from q, k and the
//                      log-sum-exp in registers; query side (dq) or key
//                      side (dk, dv); wholly masked key tiles skipped
#pragma once

#include "flash_tile.cuh"
#include "train_common.cuh"

using namespace ladiff;

namespace {

constexpr int kMaxDh = 64;  // head widths 16, 32, 48, 64

// Self-attention of one (sample, head, 64-query tile) over the sample's S
// rows (flash_tile.cuh), with dropout on the probabilities (mask 0, element
// ((b H + h) S + i) S + j): ctx = (softmax(s) * mask) v, the row sum over
// the undropped probabilities; writes the natural log-sum-exp of each row.
// Keys >= S do not exist; keys with kvalid <= 0.5 are masked (the JAX
// package's -1e9: a sample without a valid key attends uniformly).
template <int kD, bool kDrop>
__global__ void __launch_bounds__(kFThreads)
attn_fwd_kernel(const bf16* qkv, const float* kvalid, bf16* ctx, float* lse,
                int S, int D, int H, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t base = (size_t)b * S;
  FlashFwd f;
  f.q = qkv + base * 3 * D + h * kD;
  f.k = f.q + D;
  f.v = f.q + 2 * D;
  f.kvalid = kvalid + base;
  f.out = ctx + base * D + h * kD;
  f.lse = lse + base * H + h;
  f.ld = 3 * D; f.ldo = D; f.lds = H; f.T = S;
  f.q0 = blockIdx.x * kFT;
  f.mbase = ((uint64_t)b * H + h) * S;
  flash_fwd_tile<kD, kDrop>(f, drop, smem);
}

// Attention backward for one (sample, head, own 64-row tile)
// (flash_tile.cuh): with kKeySide false the block owns queries and writes
// dq; with kKeySide true it owns keys and writes dk and dv.  Probabilities
// are recomputed from q, k and the log-sum-exp; delta = dctx . ctx per row
// and head.  Two launches, no atomics.
template <int kD, bool kKeySide, bool kDrop>
__global__ void __launch_bounds__(kFThreads)
attn_bwd_kernel(const bf16* qkv, const bf16* dctx, const float* kvalid,
                const float* lse, const float* delta, bf16* dqkv, int S,
                int D, int H, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t base = (size_t)b * S;
  FlashBwd f;
  f.q = qkv + base * 3 * D + h * kD;
  f.k = f.q + D;
  f.v = f.q + 2 * D;
  f.dctx = dctx + base * D + h * kD;
  f.kvalid = kvalid + base;
  f.lse = lse + base * H + h;
  f.delta = delta + base * H + h;
  f.dq = dqkv + base * 3 * D + h * kD;
  f.dk = f.dq + D;
  f.dv = f.dq + 2 * D;
  f.ld = 3 * D; f.ldg = D; f.lds = H; f.ldd = 3 * D; f.T = S;
  f.o0 = blockIdx.x * kFT;
  f.mbase = ((uint64_t)b * H + h) * S;
  flash_bwd_tile<kD, kKeySide, kDrop>(f, drop, smem);
}

// The launches at head width kD.  Internal linkage: each library keeps its
// own shared-memory grants (see attn_tile.cuh).
template <int kD>
static inline cudaError_t attn_fwd_d(const bf16* qkv, const float* kvalid,
                                     bf16* ctx, float* lse, int B, int S,
                                     int D, int H, const Dropout& drop,
                                     bool on, cudaStream_t stream) {
  static SmemGrant g0, g1;
  const size_t bytes = flash_smem_bytes<kD>(S);
  const dim3 grid((S + kFT - 1) / kFT, H, B);
  if (on) {
    if (!allow_smem(attn_fwd_kernel<kD, true>, bytes, g1))
      return cudaErrorInvalidValue;
    attn_fwd_kernel<kD, true><<<grid, kFThreads, bytes, stream>>>(
        qkv, kvalid, ctx, lse, S, D, H, drop);
  } else {
    if (!allow_smem(attn_fwd_kernel<kD, false>, bytes, g0))
      return cudaErrorInvalidValue;
    attn_fwd_kernel<kD, false><<<grid, kFThreads, bytes, stream>>>(
        qkv, kvalid, ctx, lse, S, D, H, drop);
  }
  return cudaGetLastError();
}

template <int kD, bool kKeySide, bool kDrop>
static inline cudaError_t attn_bwd_side(const bf16* qkv, const bf16* dctx,
                                        const float* kvalid, const float* lse,
                                        const float* delta, bf16* dqkv, int B,
                                        int S, int D, int H,
                                        const Dropout& drop,
                                        cudaStream_t stream) {
  static SmemGrant grant;
  const size_t bytes = flash_smem_bytes<kD>(S);
  if (!allow_smem(attn_bwd_kernel<kD, kKeySide, kDrop>, bytes, grant))
    return cudaErrorInvalidValue;
  attn_bwd_kernel<kD, kKeySide, kDrop>
      <<<dim3((S + kFT - 1) / kFT, H, B), kFThreads, bytes, stream>>>(
          qkv, dctx, kvalid, lse, delta, dqkv, S, D, H, drop);
  return cudaGetLastError();
}

template <int kD>
static inline cudaError_t attn_bwd_d(const bf16* qkv, const bf16* dctx,
                                     const float* kvalid, const float* lse,
                                     const float* delta, bf16* dqkv, int B,
                                     int S, int D, int H, const Dropout& drop,
                                     bool on, cudaStream_t stream) {
  cudaError_t err;
  if (on) {
    if ((err = attn_bwd_side<kD, false, true>(qkv, dctx, kvalid, lse, delta,
                                              dqkv, B, S, D, H, drop,
                                              stream)) != cudaSuccess)
      return err;
    return attn_bwd_side<kD, true, true>(qkv, dctx, kvalid, lse, delta, dqkv,
                                         B, S, D, H, drop, stream);
  }
  if ((err = attn_bwd_side<kD, false, false>(qkv, dctx, kvalid, lse, delta,
                                             dqkv, B, S, D, H, drop,
                                             stream)) != cudaSuccess)
    return err;
  return attn_bwd_side<kD, true, false>(qkv, dctx, kvalid, lse, delta, dqkv,
                                        B, S, D, H, drop, stream);
}

// The forward's tiled attention launch: ctx [M, D] and lse [M, H] from the
// packed qkv [M, 3D]; `on`: dropout at drop's rate.
static inline cudaError_t launch_attn_fwd(const bf16* qkv,
                                          const float* kvalid, bf16* ctx,
                                          float* lse, int B, int S, int D,
                                          int H, const Dropout& drop, bool on,
                                          cudaStream_t stream) {
  switch (D / H) {
    case 16: return attn_fwd_d<16>(qkv, kvalid, ctx, lse, B, S, D, H, drop, on, stream);
    case 32: return attn_fwd_d<32>(qkv, kvalid, ctx, lse, B, S, D, H, drop, on, stream);
    case 48: return attn_fwd_d<48>(qkv, kvalid, ctx, lse, B, S, D, H, drop, on, stream);
    case 64: return attn_fwd_d<64>(qkv, kvalid, ctx, lse, B, S, D, H, drop, on, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's two tiled launches: dq, then dk and dv, into dqkv [M, 3D].
static inline cudaError_t launch_attn_bwd(const bf16* qkv, const bf16* dctx,
                                          const float* kvalid,
                                          const float* lse,
                                          const float* delta, bf16* dqkv,
                                          int B, int S, int D, int H,
                                          const Dropout& drop, bool on,
                                          cudaStream_t stream) {
  switch (D / H) {
    case 16: return attn_bwd_d<16>(qkv, dctx, kvalid, lse, delta, dqkv, B, S, D, H, drop, on, stream);
    case 32: return attn_bwd_d<32>(qkv, dctx, kvalid, lse, delta, dqkv, B, S, D, H, drop, on, stream);
    case 48: return attn_bwd_d<48>(qkv, dctx, kvalid, lse, delta, dqkv, B, S, D, H, drop, on, stream);
    case 64: return attn_bwd_d<64>(qkv, dctx, kvalid, lse, delta, dqkv, B, S, D, H, drop, on, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline bool shape_ok(int B, int S, int D, int H) {
  if (B < 1 || S < 1 || H < 1 || D % 64 || D > kChunk || D % H) return false;
  const int Dh = D / H;
  return Dh % 16 == 0 && Dh >= 16 && Dh <= kMaxDh;
}

}  // namespace
