// Kernel 8's launches (the self-attention segment of a transformer layer in
// training), shared by train_attention.cu and the whole-layer training
// kernels 12 and 13 (train_layer.cu, train_decoder_layer.cu), which run the
// tiled attention forward and backward through them (and kernel 12 its
// projections).
// See ladiff_torch/ops/train_attention.py for the math and the dropout
// contract (mask 0: the probabilities, element ((b H + h) S + i) S + j).
//   linear_kernel      out = A W^T + b
//   attn_fwd_kernel    flash_tile.cuh's register-resident tile: 64 queries
//                      per block, key tiles through a cp.async ring, online
//                      softmax, probability dropout; writes ctx [M, D] and
//                      the log-sum-exp [M, H]
//   out_proj_kernel    out = x + (ctx Wout^T + bout) * residual mask (mask 1)
//   dctx_kernel        dattn = dout * residual mask; dctx = dattn Wout;
//                      delta = dctx . ctx per row and head
//   attn_bwd_kernel    probabilities recomputed from q, k and the
//                      log-sum-exp in registers; query side (dq) or key
//                      side (dk, dv); wholly masked key tiles skipped
//   linear_nn_kernel   out = add + A W  (dx = dout + dqkv Wqkv)
#pragma once

#include "flash_tile.cuh"
#include "train_common.cuh"

using namespace ladiff;

namespace {

constexpr int kMaxDh = 64;  // head widths 16, 32, 48, 64

inline size_t row_gemm_bytes(int K) {
  return align128(kRows * (K + 8) * sizeof(bf16)) +
         kRows * (kChunk + 4) * sizeof(float) + kWStageBytes;
}

struct RowBuffers {
  bf16* xb;
  float* cf;
  bf16* ws;
};

__device__ __forceinline__ RowBuffers row_buffers(unsigned char* smem, int K) {
  RowBuffers b;
  b.xb = reinterpret_cast<bf16*>(smem);
  b.cf = reinterpret_cast<float*>(smem +
                                  align128(kRows * (K + 8) * sizeof(bf16)));
  b.ws = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(b.cf) +
                                 kRows * (kChunk + 4) * sizeof(float));
  return b;
}

// out[M, N] = A[M, K] W^T + b (W a torch Linear weight [N, K]); one block
// per 32 rows x 256 output columns.
__global__ void __launch_bounds__(kThreads)
linear_kernel(const bf16* A, int M, int K, const bf16* W, const bf16* bias,
              int N, bf16* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowBuffers s = row_buffers(smem, K);
  const int ld = K + 8, ldc = kChunk + 4;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));
  const int n0 = blockIdx.y * kChunk;
  const int nc = min(kChunk, N - n0);
  load_rows(A, row0, nrow, K, s.xb, ld);
  __syncthreads();
  block_gemm(s.xb, ld, W + (size_t)n0 * K, K, K, nc, s.cf, ldc, false, s.ws);
  for (int i = threadIdx.x; i < nrow * nc; i += blockDim.x) {
    const int row = i / nc, c = i % nc;
    out[(row0 + row) * N + n0 + c] =
        tob(s.cf[row * ldc + c] + ldgf(bias + n0 + c));
  }
}

// out = x + (ctx Wout^T + bout) * residual mask (mask 1), per 32 rows.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
out_proj_kernel(const bf16* ctx, const bf16* x, int M, int D, const bf16* W,
                const bf16* bias, Dropout drop, bf16* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowBuffers s = row_buffers(smem, D);
  const int ld = D + 8, ldc = kChunk + 4;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));
  load_rows(ctx, row0, nrow, D, s.xb, ld);
  __syncthreads();
  block_gemm(s.xb, ld, W, D, D, D, s.cf, ldc, false, s.ws);
  for (int i = threadIdx.x; i < nrow * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float v = s.cf[row * ldc + c] + ldgf(bias + c);
    if (kDrop) v *= keep_scale(drop, 1u, (row0 + row) * D + c);
    out[row0 * D + i] = tob(ldgf(x + row0 * D + i) + v);
  }
}

// dattn = bf16(dout * residual mask); dctx = bf16(dattn Wout);
// delta[row, h] = sum_d dctx[row, h, d] * ctx[row, h, d].  Per 32 rows.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
dctx_kernel(const bf16* dout, const bf16* ctx, int M, int D, int H,
            const bf16* W, Dropout drop, bf16* dattn, bf16* dctx,
            float* delta) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowBuffers s = row_buffers(smem, D);
  const int ld = D + 8, ldc = kChunk + 4, Dh = D / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float v = 0.f;
    if (row < nrow) {
      v = ldgf(dout + row0 * D + i);
      if (kDrop) v *= keep_scale(drop, 1u, (row0 + row) * D + c);
    }
    const bf16 b = tob(v);
    s.xb[row * ld + c] = b;
    if (row < nrow) dattn[row0 * D + i] = b;
  }
  __syncthreads();
  block_gemm_nn(s.xb, ld, W, D, D, D, s.cf, ldc, false, s.ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const bf16 b = tob(s.cf[row * ldc + c]);
    s.xb[row * ld + c] = b;
    if (row < nrow) dctx[row0 * D + i] = b;
  }
  __syncthreads();
  for (int p = warp; p < nrow * H; p += blockDim.x >> 5) {
    const int row = p / H, h = p % H;
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32)
      acc += tof(s.xb[row * ld + h * Dh + d]) *
             ldgf(ctx + (row0 + row) * D + h * Dh + d);
    acc = warp_sum(acc);
    if (lane == 0) delta[(row0 + row) * H + h] = acc;
  }
}

// out = add + A W for A [M, K] and W [K, N] row-major (a torch Linear
// weight [out, in] used from its "out" side, or a band of its rows: the
// backward of y = x W^T), N <= 256; add [M, N] may be null.  Per 32 rows.
__global__ void __launch_bounds__(kThreads)
linear_nn_kernel(const bf16* A, int M, int K, const bf16* W, int N,
                 const bf16* add, bf16* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowBuffers s = row_buffers(smem, K);
  const int ld = K + 8, ldc = kChunk + 4;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));
  load_rows(A, row0, nrow, K, s.xb, ld);
  __syncthreads();
  block_gemm_nn(s.xb, ld, W, N, K, N, s.cf, ldc, false, s.ws);
  for (int i = threadIdx.x; i < nrow * N; i += blockDim.x) {
    float v = s.cf[(i / N) * ldc + i % N];
    if (add) v += ldgf(add + row0 * N + i);
    out[row0 * N + i] = tob(v);
  }
}

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
