// Kernel 8's launches (the self-attention segment of a transformer layer in
// training), shared by train_attention.cu and the whole-layer training
// kernels 12 and 13 (train_layer.cu, train_decoder_layer.cu), which run the
// projections and the tiled attention forward and backward through them.
// See ladiff_torch/ops/train_attention.py for the math and the dropout
// contract (mask 0: the probabilities, element ((b H + h) S + i) S + j).
//   linear_kernel      out = A W^T + b
//   attn_fwd_kernel    64-query x 64-key tiles, online softmax, probability
//                      dropout; writes ctx [M, D] and the log-sum-exp [M, H]
//   out_proj_kernel    out = x + (ctx Wout^T + bout) * residual mask (mask 1)
//   dctx_kernel        dattn = dout * residual mask; dctx = dattn Wout;
//                      delta = dctx . ctx per row and head
//   attn_bwd_kernel    probabilities recomputed from q, k and the
//                      log-sum-exp; query side (dq) or key side (dk, dv)
//   linear_nn_kernel   out = add + A W  (dx = dout + dqkv Wqkv)
#pragma once

#include "train_common.cuh"

using namespace ladiff;

namespace {

constexpr int kTile = 64;          // query / key tile
constexpr int kAttnThreads = 128;  // 4 warps x 16 rows
constexpr int kMaxND = 4;          // head width <= 64: 16-column tiles

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

struct AttnLayout {
  size_t q, k, v, s, p, o, vec, total;
  int ldq, lds, ldp, ldo;
};

inline AttnLayout attn_layout(int Dh) {
  AttnLayout L;
  L.ldq = Dh + 8;
  L.lds = kTile + 4;
  L.ldp = kTile + 8;
  L.ldo = Dh + 4;
  const size_t qb = kTile * L.ldq * sizeof(bf16);
  L.q = 0;
  L.k = align128(L.q + qb);
  L.v = align128(L.k + qb);
  L.s = align128(L.v + qb);
  L.p = align128(L.s + kTile * L.lds * sizeof(float));
  L.o = align128(L.p + kTile * L.ldp * sizeof(bf16));
  L.vec = align128(L.o + kTile * L.ldo * sizeof(float));
  L.total = align128(L.vec + 4 * kTile * sizeof(float));
  return L;
}

// Self-attention of one (sample, head, 64-query tile) over the sample's S
// rows in 64-key tiles, with dropout on the probabilities (mask 0, element
// ((b H + h) S + i) S + j): ctx = (softmax(s) * mask) v.  The row sum of the
// online softmax runs over the undropped probabilities.  Keys >= S do not
// exist (-inf); keys with kvalid <= 0.5 get the additive -1e9.
template <bool kDrop>
__global__ void __launch_bounds__(kAttnThreads)
attn_fwd_kernel(const bf16* qkv, const float* kvalid, bf16* ctx, float* lse,
                int S, int D, int H, Dropout drop, AttnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = D / H, D3 = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Sm = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.p);
  float* O = reinterpret_cast<float*>(smem + L.o);
  float* mrow = reinterpret_cast<float*>(smem + L.vec);
  float* lrow = mrow + kTile;
  float* alpha = lrow + kTile;
  float* kbias = alpha + kTile;
  const size_t base = (size_t)b * S;
  const uint64_t mbase = ((uint64_t)b * H + h) * S;

  for (int i = tid; i < kTile * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh, t = q0 + r;
    Qs[r * L.ldq + d] =
        t < S ? ldg(qkv + (base + t) * D3 + h * Dh + d) : tob(0.f);
    O[r * L.ldo + d] = 0.f;
  }
  for (int i = tid; i < kTile; i += blockDim.x) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
  }
  const float scale = rsqrtf((float)Dh);
  const bf16* Qw = Qs + warp * 16 * L.ldq;
  float* Sw = Sm + warp * 16 * L.lds;
  bf16* Pw = P + warp * 16 * L.ldp;
  float* Ow = O + warp * 16 * L.ldo;
  const int r0 = warp * 16;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    for (int i = tid; i < kTile * Dh; i += blockDim.x) {
      const int r = i / Dh, d = i % Dh, t = k0 + r;
      const size_t off = (base + t) * D3 + h * Dh + d;
      Ks[r * L.ldq + d] = t < S ? ldg(qkv + off + D) : tob(0.f);
      Vs[r * L.ldq + d] = t < S ? ldg(qkv + off + 2 * D) : tob(0.f);
    }
    for (int i = tid; i < kTile; i += blockDim.x) {
      const int t = k0 + i;
      kbias[i] = t < S ? (ldgf(kvalid + base + t) > 0.5f ? 0.f : kNegInf)
                       : -INFINITY;
    }
    __syncthreads();

    // S_w = Q_w K^T  (16 x 64)
    for (int nt = 0; nt < kTile / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kd = 0; kd < Dh; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qw + kd, L.ldq);
        wmma::load_matrix_sync(fb, Ks + nt * 16 * L.ldq + kd, L.ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + nt * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    // online softmax over this tile, one row at a time
    for (int rr = 0; rr < 16; ++rr) {
      const float s0 = Sw[rr * L.lds + lane] * scale + kbias[lane];
      const float s1 = Sw[rr * L.lds + lane + 32] * scale + kbias[lane + 32];
      const float mold = mrow[r0 + rr];
      const float mnew = fmaxf(mold, warp_max(fmaxf(s0, s1)));
      float p0 = __expf(s0 - mnew), p1 = __expf(s1 - mnew);
      const float sum = warp_sum(p0 + p1);
      const float al = __expf(mold - mnew);
      if (kDrop) {
        const uint64_t e = (mbase + q0 + r0 + rr) * S + k0 + lane;
        p0 *= keep_scale(drop, 0u, e);
        p1 *= keep_scale(drop, 0u, e + 32);
      }
      Pw[rr * L.ldp + lane] = tob(p0);
      Pw[rr * L.ldp + lane + 32] = tob(p1);
      __syncwarp();
      if (lane == 0) {
        mrow[r0 + rr] = mnew;
        lrow[r0 + rr] = lrow[r0 + rr] * al + sum;
        alpha[r0 + rr] = al;
      }
    }
    __syncwarp();
    // S_w <- P_w V  (16 x Dh), then O_w <- O_w * alpha + S_w
    for (int nt = 0; nt < Dh / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < kTile; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pw + kk, L.ldp);
        wmma::load_matrix_sync(fb, Vs + kk * L.ldq + nt * 16, L.ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + nt * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * Dh; i += 32) {
      const int rr = i / Dh, d = i % Dh;
      Ow[rr * L.ldo + d] =
          Ow[rr * L.ldo + d] * alpha[r0 + rr] + Sw[rr * L.lds + d];
    }
    __syncwarp();
  }
  __syncthreads();
  for (int i = tid; i < kTile * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh, t = q0 + r;
    if (t < S)
      ctx[(base + t) * D + h * Dh + d] = tob(O[r * L.ldo + d] / lrow[r]);
  }
  for (int i = tid; i < kTile; i += blockDim.x)
    if (q0 + i < S) lse[(base + q0 + i) * H + h] = mrow[i] + logf(lrow[i]);
}

struct BwdLayout {
  size_t xo, yo, xt, yt, s, da, p, a, vec, total;
  int ldq, lds, ldp;
};

inline BwdLayout bwd_layout(int Dh) {
  BwdLayout L;
  L.ldq = Dh + 8;
  L.lds = kTile + 4;
  L.ldp = kTile + 8;
  const size_t tb = kTile * L.ldq * sizeof(bf16);
  const size_t sb = kTile * L.lds * sizeof(float);
  const size_t pb = kTile * L.ldp * sizeof(bf16);
  L.xo = 0;
  L.yo = align128(L.xo + tb);
  L.xt = align128(L.yo + tb);
  L.yt = align128(L.xt + tb);
  L.s = align128(L.yt + tb);
  L.da = align128(L.s + sb);
  L.p = align128(L.da + sb);
  L.a = align128(L.p + pb);
  L.vec = align128(L.a + pb);
  L.total = align128(L.vec + 6 * kTile * sizeof(float));
  return L;
}

// C_w (16 x 64, f32, ldc) = A_w (16 x Dh) @ B^T, B a 64 x Dh tile.
__device__ __forceinline__ void warp_abt(const bf16* Aw, const bf16* B,
                                         int ldq, int Dh, float* Cw,
                                         int ldc) {
  for (int nt = 0; nt < kTile / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kd = 0; kd < Dh; kd += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Aw + kd, ldq);
      wmma::load_matrix_sync(fb, B + nt * 16 * ldq + kd, ldq);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(Cw + nt * 16, acc, ldc, wmma::mem_row_major);
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// acc[nt] += P_w (16 x 64, bf16, ldp) @ B (64 x Dh tile, ldq), nt < Dh / 16.
__device__ __forceinline__ void warp_pb(const bf16* Pw, int ldp,
                                        const bf16* B, int ldq, int nd,
                                        AccFrag* acc) {
#pragma unroll
  for (int nt = 0; nt < kMaxND; ++nt)
    if (nt < nd)
      for (int kk = 0; kk < kTile; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pw + kk, ldp);
        wmma::load_matrix_sync(fb, B + kk * ldq + nt * 16, ldq);
        wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
      }
}

// dst[o, 0:Dh] (bf16, row stride D3) = acc * scale for the warp's 16 own
// rows o = o0 + rr < S, staged through Sw.
__device__ __forceinline__ void warp_store(AccFrag* acc, int nd, float scale,
                                           float* Sw, int lds, bf16* dst,
                                           int D3, int o0, int S) {
  const int lane = threadIdx.x & 31, Dh = nd * 16;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < kMaxND; ++nt)
    if (nt < nd) {
      for (int e = 0; e < acc[nt].num_elements; ++e) acc[nt].x[e] *= scale;
      wmma::store_matrix_sync(Sw + nt * 16, acc[nt], lds,
                              wmma::mem_row_major);
    }
  __syncwarp();
  for (int i = lane; i < 16 * Dh; i += 32) {
    const int rr = i / Dh, d = i % Dh;
    if (o0 + rr < S) dst[(size_t)(o0 + rr) * D3 + d] = tob(Sw[rr * lds + d]);
  }
  __syncwarp();
}

// Attention backward for one (sample, head, own tile).  With kKeySide false
// the block owns 64 queries and loops over key tiles: dq.  With kKeySide
// true it owns 64 keys and loops over query tiles: dk and dv.  Either way
// each warp owns 16 rows of the own tile and recomputes, per tile pair,
//   p  = exp(q k^T * scale + key bias - lse_q)
//   ds = p * ((dctx v^T) * mask - delta_q),   a = p * mask
// and accumulates in registers
//   dq += ds k         (query side)
//   dk += ds^T q, dv += a^T dctx   (key side; the tiles are held transposed)
template <bool kKeySide, bool kDrop>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_kernel(const bf16* qkv, const bf16* dctx, const float* kvalid,
                const float* lse, const float* delta, bf16* dqkv, int S,
                int D, int H, Dropout drop, BwdLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = D / H, D3 = 3 * D, nd = Dh / 16;
  const int b = blockIdx.z, h = blockIdx.y, o0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Xo = reinterpret_cast<bf16*>(smem + L.xo);  // own q (or k)
  bf16* Yo = reinterpret_cast<bf16*>(smem + L.yo);  // own dctx (or v)
  bf16* Xt = reinterpret_cast<bf16*>(smem + L.xt);  // other k (or q)
  bf16* Yt = reinterpret_cast<bf16*>(smem + L.yt);  // other v (or dctx)
  float* Sm = reinterpret_cast<float*>(smem + L.s);
  float* dA = reinterpret_cast<float*>(smem + L.da);
  bf16* P = reinterpret_cast<bf16*>(smem + L.p);
  bf16* A = reinterpret_cast<bf16*>(smem + L.a);
  float* olse = reinterpret_cast<float*>(smem + L.vec);  // own: query side
  float* odelta = olse + kTile;
  float* obias = odelta + kTile;                         // own: key side
  float* tlse = obias + kTile;                           // other tile's
  float* tdelta = tlse + kTile;
  float* tbias = tdelta + kTile;
  const size_t base = (size_t)b * S;
  const uint64_t mbase = ((uint64_t)b * H + h) * S;
  const bf16* qp = qkv + base * D3 + h * Dh;             // q of row 0
  const bf16* gp = dctx + base * D + h * Dh;             // dctx of row 0
  const int xo_off = kKeySide ? D : 0;                   // own x: k or q
  const int xt_off = kKeySide ? 0 : D;                   // other x: q or k

  for (int i = tid; i < kTile * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh, t = o0 + r;
    bf16 xv = tob(0.f), yv = tob(0.f);
    if (t < S) {
      xv = ldg(qp + (size_t)t * D3 + xo_off + d);
      yv = kKeySide ? ldg(qp + (size_t)t * D3 + 2 * D + d)
                    : ldg(gp + (size_t)t * D + d);
    }
    Xo[r * L.ldq + d] = xv;
    Yo[r * L.ldq + d] = yv;
  }
  for (int i = tid; i < kTile; i += blockDim.x) {
    const int t = o0 + i;
    const bool in = t < S;
    olse[i] = in ? ldgf(lse + (base + t) * H + h) : 0.f;
    odelta[i] = in ? ldgf(delta + (base + t) * H + h) : 0.f;
    obias[i] = in ? (ldgf(kvalid + base + t) > 0.5f ? 0.f : kNegInf)
                  : -INFINITY;
  }
  const float scale = rsqrtf((float)Dh);
  const int r0 = warp * 16;
  const bf16* Xw = Xo + r0 * L.ldq;
  const bf16* Yw = Yo + r0 * L.ldq;
  float* Sw = Sm + r0 * L.lds;
  float* dAw = dA + r0 * L.lds;
  bf16* Pw = P + r0 * L.ldp;
  bf16* Aw = A + r0 * L.ldp;
  AccFrag acc1[kMaxND], acc2[kMaxND];
#pragma unroll
  for (int nt = 0; nt < kMaxND; ++nt) {
    wmma::fill_fragment(acc1[nt], 0.f);
    wmma::fill_fragment(acc2[nt], 0.f);
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    __syncthreads();  // the previous other tile is consumed
    for (int i = tid; i < kTile * Dh; i += blockDim.x) {
      const int r = i / Dh, d = i % Dh, t = t0 + r;
      bf16 xv = tob(0.f), yv = tob(0.f);
      if (t < S) {
        xv = ldg(qp + (size_t)t * D3 + xt_off + d);
        yv = kKeySide ? ldg(gp + (size_t)t * D + d)
                      : ldg(qp + (size_t)t * D3 + 2 * D + d);
      }
      Xt[r * L.ldq + d] = xv;
      Yt[r * L.ldq + d] = yv;
    }
    for (int i = tid; i < kTile; i += blockDim.x) {
      const int t = t0 + i;
      const bool in = t < S;
      tlse[i] = in ? ldgf(lse + (base + t) * H + h) : 0.f;
      tdelta[i] = in ? ldgf(delta + (base + t) * H + h) : 0.f;
      tbias[i] = in ? (ldgf(kvalid + base + t) > 0.5f ? 0.f : kNegInf)
                    : -INFINITY;
    }
    __syncthreads();

    warp_abt(Xw, Xt, L.ldq, Dh, Sw, L.lds);    // scores (transposed on the
    warp_abt(Yw, Yt, L.ldq, Dh, dAw, L.lds);   // key side), and dctx v^T
    __syncwarp();
    for (int e = lane; e < 16 * kTile; e += 32) {
      const int rr = e / kTile, cc = e % kTile;
      const int o = o0 + r0 + rr, t = t0 + cc;
      const int qi = kKeySide ? t : o, kj = kKeySide ? o : t;
      const float lse_q = kKeySide ? tlse[cc] : olse[r0 + rr];
      const float delta_q = kKeySide ? tdelta[cc] : odelta[r0 + rr];
      const float bias_k = kKeySide ? obias[r0 + rr] : tbias[cc];
      float p = 0.f;
      if (qi < S && kj < S)
        p = __expf(Sw[rr * L.lds + cc] * scale + bias_k - lse_q);
      float m = 1.f;
      if (kDrop) m = keep_scale(drop, 0u, (mbase + qi) * S + kj);
      const float ds = p * (dAw[rr * L.lds + cc] * m - delta_q);
      Pw[rr * L.ldp + cc] = tob(ds);
      if (kKeySide) Aw[rr * L.ldp + cc] = tob(p * m);
    }
    __syncwarp();
    warp_pb(Pw, L.ldp, Xt, L.ldq, nd, acc1);
    if (kKeySide) warp_pb(Aw, L.ldp, Yt, L.ldq, nd, acc2);
  }
  // dq (query side) or dk (key side) carry the 1 / sqrt(Dh) of the scores
  bf16* dst = dqkv + base * D3 + h * Dh;
  warp_store(acc1, nd, scale, Sw, L.lds, dst + (kKeySide ? D : 0), D3,
             o0 + r0, S);
  if (kKeySide)
    warp_store(acc2, nd, 1.f, Sw, L.lds, dst + 2 * D, D3, o0 + r0, S);
}

inline bool shape_ok(int B, int S, int D, int H) {
  if (B < 1 || S < 1 || H < 1 || D % 64 || D > kChunk || D % H) return false;
  const int Dh = D / H;
  return Dh % 16 == 0 && Dh >= 16 && Dh <= 16 * kMaxND;
}

// The whole-layer kernels' row-block pieces around the attention (kernels
// 12 and 13; 256 threads, 32 rows, smem buffers of the caller's layout).

// r[32 x D] (smem f32) = x + (ctx W^T + b) * keep-mask mask_id for the
// block's rows, zero rows past the end; uses xb, cf, ws.
template <bool kDrop>
__device__ __forceinline__ void out_proj_rows(const bf16* ctx, const bf16* x,
                                              const bf16* W, const bf16* bias,
                                              const Dropout& drop,
                                              uint32_t mask_id, int D,
                                              bf16* xb, float* cf, float* r,
                                              bf16* ws, size_t row0,
                                              int nrow) {
  const int ld = D + 8, ldc = kChunk + 4;
  load_rows(ctx, row0, nrow, D, xb, ld);
  __syncthreads();
  block_gemm(xb, ld, W, D, D, D, cf, ldc, false, ws);
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float v = cf[row * ldc + c] + ldgf(bias + c);
    if (kDrop) v *= keep_scale(drop, mask_id, (row0 + row) * D + c);
    r[i] = row < nrow ? ldgf(x + row0 * D + i) + v : 0.f;
  }
  __syncthreads();
}

// dctx = bf16(dattn Wout) for the block's rows (dattn in xb), to scratch
// and dyb; delta[row, h] = dctx . ctx over the head's columns.
__device__ __forceinline__ void dctx_rows(const bf16* xb, bf16* dyb,
                                          float* cf, bf16* ws,
                                          const bf16* out_w,
                                          const bf16* ctx, bf16* dctx,
                                          float* delta, int D, int H,
                                          size_t row0, int nrow) {
  const int ld = D + 8, ldc = kChunk + 4, Dh = D / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  block_gemm_nn(xb, ld, out_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const bf16 b = tob(cf[row * ldc + c]);
    dyb[row * ld + c] = b;
    if (row < nrow) dctx[(row0 + row) * D + c] = b;
  }
  __syncthreads();
  for (int p = warp; p < nrow * H; p += blockDim.x >> 5) {
    const int row = p / H, h = p % H;
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32)
      acc += tof(dyb[row * ld + h * Dh + d]) *
             ldgf(ctx + (row0 + row) * D + h * Dh + d);
    acc = warp_sum(acc);
    if (lane == 0) delta[(row0 + row) * H + h] = acc;
  }
  __syncthreads();
}

// dattn = bf16(dr * m_res) into xb and scratch, and dr (bf16) to scratch,
// from r = dr (f32) for the block's rows: the residual dropout's backward.
template <bool kDrop>
__device__ __forceinline__ void dattn_rows(const float* r, bf16* xb,
                                           bf16* dr, bf16* dattn, int D,
                                           const Dropout& drop,
                                           uint32_t mask_id, size_t row0,
                                           int nrow) {
  const int ld = D + 8;
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float v = row < nrow ? r[i] : 0.f;
    if (row < nrow) dr[(row0 + row) * D + c] = tob(v);
    if (kDrop) v *= keep_scale(drop, mask_id, (row0 + row) * D + c);
    const bf16 b = tob(v);
    xb[row * ld + c] = b;
    if (row < nrow) dattn[(row0 + row) * D + c] = b;
  }
  __syncthreads();
}

}  // namespace
