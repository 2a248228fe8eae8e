// Kernel 8: the self-attention segment of a transformer layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_attention.py
// train_self_attention).  See ladiff_torch/ops/train_attention.py for the
// math, the dropout contract, what is saved and the weight-gradient scheme.
//
// Forward, a fixed sequence of launches:
//   linear_kernel      qkv = x Wqkv^T + bqkv                    [M, 3D]
//   attn_fwd_kernel    64-query x 64-key tiles, online softmax, probability
//                      dropout; writes ctx [M, D] and the log-sum-exp [M, H]
//   out_proj_kernel    out = x + (ctx Wout^T + bout) * residual mask
// Backward:
//   dctx_kernel        dattn = dout * residual mask; dctx = dattn Wout;
//                      delta = dctx . ctx per row and head
//   attn_bwd_kernel x2 probabilities recomputed from q, k and the log-sum-exp;
//                      one launch owns query tiles (dq), one owns key tiles
//                      (dk, dv)
//   dx_kernel          dx = dout + dqkv Wqkv
//   wgrad / colsum + reduce   dWqkv = dqkv^T x, dbqkv, dWout = dattn^T ctx,
//                      dbout
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

// dx = dout + dqkv Wqkv (Wqkv [3D, D] from its "out" side).  Per 32 rows.
__global__ void __launch_bounds__(kThreads)
dx_kernel(const bf16* dqkv, const bf16* dout, int M, int D, const bf16* W,
          bf16* dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = 3 * D;
  const RowBuffers s = row_buffers(smem, K);
  const int ld = K + 8, ldc = kChunk + 4;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));
  load_rows(dqkv, row0, nrow, K, s.xb, ld);
  __syncthreads();
  block_gemm_nn(s.xb, ld, W, D, K, D, s.cf, ldc, false, s.ws);
  for (int i = threadIdx.x; i < nrow * D; i += blockDim.x)
    dx[row0 * D + i] = tob(ldgf(dout + row0 * D + i) +
                           s.cf[(i / D) * ldc + i % D]);
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

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D] bf16, kvalid [M] f32, in_w [3D, D], in_b, out_w [D, D],
// out_b (bf16), then what the backward reuses: qkv [M, 3D], ctx [M, D]
// (bf16), lse [M, H] (f32), and out [M, D] (bf16).  ints: B, S, D, H, seed
// lo, seed hi.  floats: rate.
extern "C" int train_attention_forward(const void** p, const int* n,
                                       const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int B = n[0], S = n[1], D = n[2], H = n[3];
  if (!shape_ok(B, S, D, H)) return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[4], n[5], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = reinterpret_cast<const float*>(p[1]);
  bf16* qkv = const_cast<bf16*>(w[6]);
  bf16* ctx = const_cast<bf16*>(w[7]);
  float* lse = reinterpret_cast<float*>(const_cast<void*>(p[8]));
  bf16* out = const_cast<bf16*>(w[9]);

  const size_t rb = row_gemm_bytes(D);
  const AttnLayout La = attn_layout(D / H);
  static SmemGrant g_lin, g_att0, g_att1, g_out0, g_out1;
  if (!allow_smem(linear_kernel, rb, g_lin) ||
      !allow_smem(attn_fwd_kernel<false>, La.total, g_att0) ||
      !allow_smem(attn_fwd_kernel<true>, La.total, g_att1) ||
      !allow_smem(out_proj_kernel<false>, rb, g_out0) ||
      !allow_smem(out_proj_kernel<true>, rb, g_out1))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  linear_kernel<<<dim3(blocks, (3 * D + kChunk - 1) / kChunk), kThreads, rb,
                  stream>>>(x, M, D, w[2], w[3], 3 * D, qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 agrid((S + kTile - 1) / kTile, H, B);
  if (on)
    attn_fwd_kernel<true><<<agrid, kAttnThreads, La.total, stream>>>(
        qkv, kvalid, ctx, lse, S, D, H, drop, La);
  else
    attn_fwd_kernel<false><<<agrid, kAttnThreads, La.total, stream>>>(
        qkv, kvalid, ctx, lse, S, D, H, drop, La);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (on)
    out_proj_kernel<true><<<blocks, kThreads, rb, stream>>>(
        ctx, x, M, D, w[4], w[5], drop, out);
  else
    out_proj_kernel<false><<<blocks, kThreads, rb, stream>>>(
        ctx, x, M, D, w[4], w[5], drop, out);
  return cudaGetLastError();
}

// ptrs: x [M, D] bf16, kvalid [M] f32, dout [M, D] bf16; in_w, in_b, out_w,
// out_b (bf16); the forward's qkv, ctx (bf16), lse (f32); scratch dattn
// [M, D], dctx [M, D] (bf16), delta [M, H] (f32), dqkv [M, 3D] (bf16), wpart
// [split, 3 D D] (f32); dx [M, D] (bf16); d_in_w [3D, D], d_in_b, d_out_w
// [D, D], d_out_b (f32).  ints: B, S, D, H, seed lo, seed hi, split.
// floats: rate.
extern "C" int train_attention_backward(const void** p, const int* n,
                                        const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  auto fptr = [&](int i) {
    return reinterpret_cast<float*>(const_cast<void*>(p[i]));
  };
  const int B = n[0], S = n[1], D = n[2], H = n[3], split = n[6];
  if (!shape_ok(B, S, D, H) || split < 1) return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[4], n[5], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = fptr(1);
  const bf16* dout = w[2];
  const bf16 *in_w = w[3], *out_w = w[5];
  const bf16 *qkv = w[7], *ctx = w[8];
  const float* lse = fptr(9);
  bf16* dattn = const_cast<bf16*>(w[10]);
  bf16* dctx = const_cast<bf16*>(w[11]);
  float* delta = fptr(12);
  bf16* dqkv = const_cast<bf16*>(w[13]);
  float* wpart = fptr(14);
  bf16* dx = const_cast<bf16*>(w[15]);
  float *d_in_w = fptr(16), *d_in_b = fptr(17), *d_out_w = fptr(18),
        *d_out_b = fptr(19);

  const size_t rb = row_gemm_bytes(D), rb3 = row_gemm_bytes(3 * D);
  const BwdLayout Lb = bwd_layout(D / H);
  static SmemGrant g_dc0, g_dc1, g_q0, g_q1, g_k0, g_k1, g_dx;
  if (!allow_smem(dctx_kernel<false>, rb, g_dc0) ||
      !allow_smem(dctx_kernel<true>, rb, g_dc1) ||
      !allow_smem(attn_bwd_kernel<false, false>, Lb.total, g_q0) ||
      !allow_smem(attn_bwd_kernel<false, true>, Lb.total, g_q1) ||
      !allow_smem(attn_bwd_kernel<true, false>, Lb.total, g_k0) ||
      !allow_smem(attn_bwd_kernel<true, true>, Lb.total, g_k1) ||
      !allow_smem(dx_kernel, rb3, g_dx))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  if (on)
    dctx_kernel<true><<<blocks, kThreads, rb, stream>>>(
        dout, ctx, M, D, H, out_w, drop, dattn, dctx, delta);
  else
    dctx_kernel<false><<<blocks, kThreads, rb, stream>>>(
        dout, ctx, M, D, H, out_w, drop, dattn, dctx, delta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 agrid((S + kTile - 1) / kTile, H, B);
  if (on) {
    attn_bwd_kernel<false, true><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, dctx, kvalid, lse, delta, dqkv, S, D, H, drop, Lb);
    attn_bwd_kernel<true, true><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, dctx, kvalid, lse, delta, dqkv, S, D, H, drop, Lb);
  } else {
    attn_bwd_kernel<false, false><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, dctx, kvalid, lse, delta, dqkv, S, D, H, drop, Lb);
    attn_bwd_kernel<true, false><<<agrid, kAttnThreads, Lb.total, stream>>>(
        qkv, dctx, kvalid, lse, delta, dqkv, S, D, H, drop, Lb);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dx_kernel<<<blocks, kThreads, rb3, stream>>>(dqkv, dout, M, D, in_w, dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = weight_grad(dqkv, 3 * D, 3 * D, x, D, D, M, split, wpart, d_in_w,
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(dqkv, 3 * D, 3 * D, M, split, wpart, d_in_b,
                       stream)) != cudaSuccess) return err;
  if ((err = weight_grad(dattn, D, D, ctx, D, D, M, split, wpart, d_out_w,
                         stream)) != cudaSuccess) return err;
  return bias_grad(dattn, D, D, M, split, wpart, d_out_b, stream);
}

// ptrs: pm [B, H, S, S], rm [M, D] (f32): the keep-masks of a seed.  ints:
// B, S, D, H, seed lo, seed hi.  floats: rate.
extern "C" int train_attention_masks(const void** p, const int* n,
                                     const float* f, void* stream_ptr) {
  float* pm = reinterpret_cast<float*>(const_cast<void*>(p[0]));
  float* rm = reinterpret_cast<float*>(const_cast<void*>(p[1]));
  const unsigned long long B = n[0], S = n[1], D = n[2], H = n[3];
  const Dropout d = make_dropout(n[4], n[5], f[0]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = fill_mask(pm, B * H * S * S, d, 0u, stream);
  if (err != cudaSuccess) return err;
  return fill_mask(rm, B * S * D, d, 1u, stream);
}
