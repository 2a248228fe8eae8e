// Launches shared by the training kernels (train_ffn.cu, train_attention.cu):
// gradients that sum over all rows of a batch.  CUDA blocks run concurrently,
// so nothing accumulates from block to block as on a sequential TPU grid;
// each launch writes float32 partials of disjoint row ranges ("splits") to a
// workspace and reduce_kernel sums them in a fixed order: deterministic, no
// atomics.
#pragma once

#include "common.cuh"

namespace ladiff {

constexpr int kWgTile = 64;     // output tile of wgrad_kernel (both sides)
constexpr int kWgK = 32;        // rows per step
constexpr int kWgThreads = 128; // 4 warps x 16 output rows

// Rows per split: a multiple of 32 that covers M in `split` ranges.
inline int split_rows(int M, int split) {
  return ((M + split - 1) / split + 31) / 32 * 32;
}

// part[s][N1][N2] = A[rows of split s, 0:N1]^T @ B[same rows, 0:N2]: the
// weight gradient of y = x W^T in the torch layout [out, in] with A = dy and
// B = x.  A [M, lda] and B [M, ldb] bf16 row-major with 16-byte aligned
// rows; N1 and N2 multiples of 64.  One block per 64 x 64 output tile and
// split; warp w owns output rows 16 w .. 16 w + 15.
__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel(const bf16* A, int lda, const bf16* B, int ldb, int M, int N1,
             int N2, int rows_per_split, float* part) {
  constexpr int kLd = kWgTile + 8;
  __shared__ __align__(128) bf16 As[kWgK * kLd];
  __shared__ __align__(128) bf16 Bs[kWgK * kLd];
  const int i0 = blockIdx.x * kWgTile, j0 = blockIdx.y * kWgTile;
  const int s = blockIdx.z;
  const int m_begin = s * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kWgTile / 16];
#pragma unroll
  for (int j = 0; j < kWgTile / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  constexpr int kVec = kWgTile / 8;  // 16-byte vectors per tile row
  for (int m0 = m_begin; m0 < m_end; m0 += kWgK) {
    __syncthreads();  // the previous step's fragments are loaded
    for (int v = threadIdx.x; v < kWgK * kVec; v += blockDim.x) {
      const int k = v / kVec, c = (v % kVec) * 8;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (m0 + k < m_end) {
        a = __ldg(reinterpret_cast<const uint4*>(
            A + (size_t)(m0 + k) * lda + i0 + c));
        b = __ldg(reinterpret_cast<const uint4*>(
            B + (size_t)(m0 + k) * ldb + j0 + c));
      }
      *reinterpret_cast<uint4*>(As + k * kLd + c) = a;
      *reinterpret_cast<uint4*>(Bs + k * kLd + c) = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWgK; kk += 16) {
      // A^T tile: element (i, k) lives at As[k][i], a column-major fragment
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, As + kk * kLd + warp * 16, kLd);
#pragma unroll
      for (int j = 0; j < kWgTile / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * kLd + j * 16, kLd);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  float* out = part + ((size_t)s * N1 + i0 + warp * 16) * N2 + j0;
#pragma unroll
  for (int j = 0; j < kWgTile / 16; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], N2, wmma::mem_row_major);
}

// part[s][N] = column sums of A[rows of split s, 0:N] (bf16, row stride
// lda; N and lda multiples of 8, A 16-byte aligned): a bias gradient.  One
// block per 64 columns and split: 8 threads cover a row's 64 columns in
// 16-byte loads, 32 rows at a time; the 32 row lanes' sums are added in
// lane order.
__global__ void __launch_bounds__(256)
colsum_kernel(const bf16* A, int lda, int M, int N, int rows_per_split,
              float* part) {
  __shared__ float red[32][64 + 1];
  const int cg = threadIdx.x & 7, rl = threadIdx.x >> 3;
  const int c0 = blockIdx.x * 64 + cg * 8;
  const int s = blockIdx.y;
  const int m_begin = s * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c0 < N)
    for (int m = m_begin + rl; m < m_end; m += 32) {
      const uint4 u =
          __ldg(reinterpret_cast<const uint4*>(A + (size_t)m * lda + c0));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        sum[2 * e] += f.x;
        sum[2 * e + 1] += f.y;
      }
    }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[rl][cg * 8 + e] = sum[e];
  __syncthreads();
  const int col = blockIdx.x * 64 + threadIdx.x;
  if (threadIdx.x < 64 && col < N) {
    float t = 0.f;
    for (int r = 0; r < 32; ++r) t += red[r][threadIdx.x];
    part[(size_t)s * N + col] = t;
  }
}

// out[i] = sum over s < S of part[s * stride + i], i < n, in the order
// s = 0, 1, ...
__global__ void reduce_kernel(const float* part, int S, size_t stride, int n,
                              float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += part[s * stride + i];
  out[i] = sum;
}

inline cudaError_t reduce_partials(const float* part, int S, size_t stride,
                                   int n, float* out, cudaStream_t stream) {
  reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, S, stride, n, out);
  return cudaGetLastError();
}

// out[N1, N2] (f32) = A^T B over all M rows, through `part` (split * N1 * N2
// floats).
inline cudaError_t weight_grad(const bf16* A, int lda, int N1, const bf16* B,
                               int ldb, int N2, int M, int split, float* part,
                               float* out, cudaStream_t stream) {
  if (N1 % kWgTile || N2 % kWgTile || lda % 8 || ldb % 8)
    return cudaErrorInvalidValue;
  const int rows = split_rows(M, split);
  wgrad_kernel<<<dim3(N1 / kWgTile, N2 / kWgTile, split), kWgThreads, 0,
                 stream>>>(A, lda, B, ldb, M, N1, N2, rows, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = N1 * N2;
  return reduce_partials(part, split, n, n, out, stream);
}

// out[N] (f32) = column sums of A [M, N] over all rows, through `part`
// (split * N floats).
inline cudaError_t bias_grad(const bf16* A, int lda, int N, int M, int split,
                             float* part, float* out, cudaStream_t stream) {
  if (N % 8 || lda % 8 || reinterpret_cast<uintptr_t>(A) % 16)
    return cudaErrorInvalidValue;
  const int rows = split_rows(M, split);
  colsum_kernel<<<dim3((N + 63) / 64, split), 256, 0, stream>>>(
      A, lda, M, N, rows, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, split, N, N, out, stream);
}

// out[i] = the keep-mask value of element i of mask mask_id, i < n.
__global__ void fill_mask_kernel(float* out, unsigned long long n, Dropout d,
                                 uint32_t mask_id) {
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i =
           (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = keep_scale(d, mask_id, i);
}

inline cudaError_t fill_mask(float* out, unsigned long long n, Dropout d,
                             uint32_t mask_id, cudaStream_t stream) {
  const unsigned long long blocks = (n + 255) / 256;
  fill_mask_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0,
                     stream>>>(out, n, d, mask_id);
  return cudaGetLastError();
}

}  // namespace ladiff
