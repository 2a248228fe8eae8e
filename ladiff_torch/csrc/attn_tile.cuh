// Masked multi-head self-attention as query-tile x key-tile online softmax,
// shared by kernel K2 (decoder_layer.cu: q, k, v are the thirds of one packed
// [B*T, 3D] projection) and kernel 10 (masked_attention.cu: three separate
// [B, T, D] tensors).  The caller gives the three base pointers and their
// common row stride; scores never leave shared memory and are never larger
// than one 64 x 64 tile.
#pragma once

#include "common.cuh"

namespace ladiff {

constexpr int kTile = 64;         // query / key tile
constexpr int kAttnThreads = 128; // 4 warps x 16 query rows

struct AttnLayout {
  size_t q, k, v, s, p, o, vec, total;
  int ldq, lds, ldp, ldo;
};

inline AttnLayout attn_layout(int Dh) {
  AttnLayout L;
  L.ldq = Dh + 8;
  L.lds = (Dh > kTile ? Dh : kTile) + 4;
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

// Row t of sample b, head h starts at ptr + (b * T + t) * ld + h * Dh, for
// q, k and v alike (ld, Dh multiples of 8 and 16-byte aligned pointers: rows
// move as 16-byte vectors); the context goes to out with row stride ldo.
// kvalid [B * T] f32 marks the keys that may be attended to (> 0.5); null
// means every key is valid.
struct AttnArgs {
  const bf16 *q, *k, *v;
  const float* kvalid;
  bf16* out;
  int T, Dh, ld, ldo;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copies 64 rows x Dh of one head from global memory (rows t0 .. t0 + 63 of
// the sample that starts at row `base`; rows >= T become zero rows) into a
// shared tile with row stride lds.
__device__ __forceinline__ void load_head_tile(const bf16* src, size_t base,
                                               int t0, int T, int ld, int Dh,
                                               bf16* dst, int lds) {
  const int nv = Dh / 8;
  for (int i = threadIdx.x; i < kTile * nv; i += blockDim.x) {
    const int r = i / nv, c = (i % nv) * 8, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T)
      val = __ldg(reinterpret_cast<const uint4*>(src + (base + t) * ld + c));
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

// Self-attention of one (sample, head, 64-query tile) over the sample's T
// rows in 64-key tiles.  Keys >= T do not exist (-inf); keys with
// kvalid <= 0.5 get the additive -1e9 of the JAX package.  Grid: (query
// tiles, heads, samples).
__global__ void __launch_bounds__(kAttnThreads)
attn_tile_kernel(AttnArgs a, AttnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = a.T, Dh = a.Dh;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.p);
  float* O = reinterpret_cast<float*>(smem + L.o);
  float* mrow = reinterpret_cast<float*>(smem + L.vec);
  float* lrow = mrow + kTile;
  float* alpha = lrow + kTile;
  float* kbias = alpha + kTile;
  const size_t base = (size_t)b * T;
  const int hoff = h * Dh;

  load_head_tile(a.q + hoff, base, q0, T, a.ld, Dh, Qs, L.ldq);
  for (int i = tid; i < kTile * Dh; i += blockDim.x)
    O[(i / Dh) * L.ldo + i % Dh] = 0.f;
  for (int i = tid; i < kTile; i += blockDim.x) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
  }
  const float scale = rsqrtf((float)Dh);
  const bf16* Qw = Qs + warp * 16 * L.ldq;
  float* Sw = S + warp * 16 * L.lds;
  bf16* Pw = P + warp * 16 * L.ldp;
  float* Ow = O + warp * 16 * L.ldo;
  const int r0 = warp * 16;

  for (int k0 = 0; k0 < T; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_head_tile(a.k + hoff, base, k0, T, a.ld, Dh, Ks, L.ldq);
    load_head_tile(a.v + hoff, base, k0, T, a.ld, Dh, Vs, L.ldq);
    for (int i = tid; i < kTile; i += blockDim.x) {
      const int t = k0 + i;
      const bool valid = !a.kvalid || t >= T || ldgf(a.kvalid + base + t) > 0.5f;
      kbias[i] = t < T ? (valid ? 0.f : kNegInf) : -INFINITY;
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
      const float p0 = __expf(s0 - mnew), p1 = __expf(s1 - mnew);
      const float sum = warp_sum(p0 + p1);
      const float al = __expf(mold - mnew);
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
      Ow[rr * L.ldo + d] = Ow[rr * L.ldo + d] * alpha[r0 + rr] + Sw[rr * L.lds + d];
    }
    __syncwarp();
  }
  __syncthreads();
  for (int i = tid; i < kTile * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh, t = q0 + r;
    if (t < T) a.out[(base + t) * a.ldo + hoff + d] = tob(O[r * L.ldo + d] / lrow[r]);
  }
}

// Launches attn_tile_kernel for B samples and H heads on `stream`.  Internal
// linkage: the shared-memory grant below belongs to this library's copy of
// the kernel, and the local static of an extern inline function would be one
// object for every library of the process that includes this header.
static inline cudaError_t launch_attn_tiles(const AttnArgs& a, int B, int H,
                                     cudaStream_t stream) {
  static SmemGrant grant;
  const AttnLayout L = attn_layout(a.Dh);
  if (a.Dh % 16 || a.Dh > 128 || a.ld % 8 || a.T < 1 ||
      !allow_smem(attn_tile_kernel, L.total, grant))
    return cudaErrorInvalidValue;
  attn_tile_kernel<<<dim3((a.T + kTile - 1) / kTile, H, B), kAttnThreads,
                     L.total, stream>>>(a, L);
  return cudaGetLastError();
}

}  // namespace ladiff
