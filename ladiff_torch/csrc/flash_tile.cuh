// Register-resident attention tiles for Hopper, FlashAttention-2 style,
// shared by kernel 10 and K2's self-attention (attn_tile.cuh) and by the
// training attention of kernels 8, 12 and 13 (train_attn.cuh).
//
// One block of 4 warps owns 64 rows of one (sample, head); each warp owns 16
// of them.  Products are mma.sync.m16n8k16 bf16 -> f32 with their operands
// brought from shared memory by ldmatrix (.trans where the tile is the
// product's k-major operand).  The warp's own rows (q, or k and v on a
// backward's key side) are loaded once into registers; the other side's
// tiles stream through a two-stage cp.async ring (16-byte vectors, one
// commit group per tile), so the next tile's load overlaps this tile's
// products.  Scores, probabilities and the output accumulator never leave
// registers: the online softmax runs on the accumulators with quad shuffles
// and exp2 (scale * log2 e folded into the scores), P becomes bf16
// A-fragments in registers, and O is rescaled there and written once.
//
// Masking.  Keys at or past T do not exist.  A key whose validity is <= 0.5
// is masked: its probability is exactly 0 once a valid key sets the row
// maximum (the JAX package's -1e9), so a 64-key tile without a valid key is
// skipped, but only when the sample has a valid key.  Validity is read per
// key (the encoder stream's valid keys are not a prefix).  A sample without
// any valid key attends uniformly over its T keys, as the JAX package's
// -1e9 on every logit gives.  Padded query rows are computed like any other.
#pragma once

#include "common.cuh"

namespace ladiff {

constexpr int kFT = 64;          // query / key tile
constexpr int kFThreads = 128;   // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l & 7 of matrix
// l >> 3.  Without .trans lane l gets row l / 4, columns 2 (l % 4) and +1 of
// each; with .trans the same of the transposed matrices.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A 16-byte copy that writes zeros instead when `pred` is false (gmem must
// still be a valid address; nothing is read from it).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// Rows t0 .. t0 + 63 of one head (row t at src + t * ld, kD values) into a
// shared tile [64][kD + 8]; rows >= T become zero rows.  Only starts the
// cp.async copies (the caller commits them).
template <int kD>
__device__ __forceinline__ void tile_load(const bf16* src, int ld, int t0,
                                          int T, bf16* dst) {
  constexpr int kV = kD / 8, kLd = kD + 8;
  for (int i = threadIdx.x; i < kFT * kV; i += kFThreads) {
    const int r = i / kV, c = (i % kV) * 8, t = t0 + r;
    const bool in = t < T;
    cp_async16_zfill(dst + r * kLd + c, src + (size_t)(in ? t : 0) * ld + c,
                     in);
  }
}

// vbits[w] bit i: key 32 w + i exists (< T) and is valid (kvalid null: all
// are).  nwords = 2 x the key tiles.  Returns, to every thread, whether the
// sample has a valid key.
__device__ __forceinline__ bool key_bits(const float* kvalid, int T,
                                         uint32_t* vbits, int nwords) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int any = 0;
  for (int w = warp; w < nwords; w += kFThreads / 32) {
    const int t = 32 * w + lane;
    const bool v = t < T && (!kvalid || ldgf(kvalid + t) > 0.5f);
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) vbits[w] = bits;
    any |= bits != 0u;
  }
  return __syncthreads_or(any) != 0;
}

__device__ __forceinline__ bool bit_of(const uint32_t* vbits, int key) {
  return (vbits[key >> 5] >> (key & 31)) & 1u;
}

// Shared memory of a tile launch: the two-stage ring of two [64][kD + 8]
// tiles, two 64-float vectors per stage (the backward's key side), then the
// key-validity words.
template <int kD>
constexpr size_t flash_ring_bytes() {
  return (size_t)4 * kFT * (kD + 8) * sizeof(bf16) + 4 * kFT * sizeof(float);
}
template <int kD>
inline size_t flash_smem_bytes(int T) {
  const int ntiles = (T + kFT - 1) / kFT;
  return flash_ring_bytes<kD>() + (size_t)2 * ntiles * sizeof(uint32_t);
}

struct FlashRing {
  bf16* tile[2][2];   // [stage][0: k or q, 1: v or dctx]
  float* vec[2][2];   // [stage][0: lse * log2 e, 1: delta]
  uint32_t* vbits;
};

template <int kD>
__device__ __forceinline__ FlashRing flash_ring(unsigned char* smem) {
  constexpr int kEl = kFT * (kD + 8);
  FlashRing r;
  bf16* t = reinterpret_cast<bf16*>(smem);
  float* v = reinterpret_cast<float*>(t + 4 * kEl);
  for (int s = 0; s < 2; ++s)
    for (int j = 0; j < 2; ++j) {
      r.tile[s][j] = t + (2 * s + j) * kEl;
      r.vec[s][j] = v + (2 * s + j) * kFT;
    }
  r.vbits = reinterpret_cast<uint32_t*>(v + 4 * kFT);
  return r;
}

// One (sample, head, 64-query tile) of the forward.  Pointers are at row 0
// of the sample and at the head's first column.
struct FlashFwd {
  const bf16 *q, *k, *v;   // rows of stride ld
  const float* kvalid;     // the sample's T key validities, or null
  bf16* out;               // rows of stride ldo
  float* lse;              // the natural log-sum-exp of row t at lse[t lds],
                           // or null
  int ld, ldo, lds, T, q0;
  uint64_t mbase;          // (b H + h) T: row i's dropout elements start at
                           // (mbase + i) T
};

// out = softmax(q k^T / sqrt(kD) over the valid keys) v, with dropout mask 0
// on the probabilities (the row sum runs over the undropped ones) when
// kDrop.  All threads of the block call it.
template <int kD, bool kDrop>
__device__ __forceinline__ void flash_fwd_tile(const FlashFwd& a,
                                               const Dropout& drop,
                                               unsigned char* smem) {
  constexpr int kLd = kD + 8, kNK = kD / 16, kNO = kD / 8;
  const FlashRing R = flash_ring<kD>(smem);
  const int T = a.T, ntiles = (T + kFT - 1) / kFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  // q into stage 1's first slot; it moves to registers before that stage
  // is first filled
  tile_load<kD>(a.q, a.ld, a.q0, T, R.tile[1][0]);
  cp_async_commit();
  const bool uniform = !key_bits(a.kvalid, T, R.vbits, 2 * ntiles);
  auto visit = [&](int j) {
    return uniform || (R.vbits[2 * j] | R.vbits[2 * j + 1]) != 0u;
  };
  auto next = [&](int j) {
    while (j < ntiles && !visit(j)) ++j;
    return j;
  };
  int cur = next(0);
  if (cur < ntiles) {
    tile_load<kD>(a.k, a.ld, cur * kFT, T, R.tile[0][0]);
    tile_load<kD>(a.v, a.ld, cur * kFT, T, R.tile[0][1]);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kNK][4];
#pragma unroll
  for (int kc = 0; kc < kNK; ++kc)
    ldsm4(qf[kc], R.tile[1][0] + (warp * 16 + (lane & 15)) * kLd + kc * 16 +
                      (lane >> 4) * 8);
  __syncthreads();

  float o[kNO][4];
#pragma unroll
  for (int d = 0; d < kNO; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = rsqrtf((float)kD) * kLog2e;
  const int i0 = a.q0 + warp * 16 + g;  // the thread's rows i0, i0 + 8
  int stage = 0;
  while (cur < ntiles) {
    const int nxt = next(cur + 1);
    if (nxt < ntiles) {
      tile_load<kD>(a.k, a.ld, nxt * kFT, T, R.tile[stage ^ 1][0]);
      tile_load<kD>(a.v, a.ld, nxt * kFT, T, R.tile[stage ^ 1][1]);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile cur has landed for every thread
    const bf16* Ks = R.tile[stage][0];
    const bf16* Vs = R.tile[stage][1];
    const int k0 = cur * kFT;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kNK; ++kc)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                     kc * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[kc], b[0], b[1]);
        mma16816(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    float mx0 = -INFINITY, mx1 = -INFINITY;
    const uint32_t w0 = R.vbits[2 * cur], w1 = R.vbits[2 * cur + 1];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (n & 3) * 8 + 2 * tq + (e & 1);
        // vbits hold no key >= T, so a set bit also says the key exists
        const bool keep = uniform ? k0 + (n >> 2) * 32 + c < T
                                  : (((n < 4 ? w0 : w1) >> c) & 1u);
        const float v = keep ? (uniform ? 0.f : s[n][e] * sl2) : -INFINITY;
        s[n][e] = v;
        if (e < 2) mx0 = fmaxf(mx0, v);
        else mx1 = fmaxf(mx1, v);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p0 = ex2(s[n][0] - mn0), p1 = ex2(s[n][1] - mn0);
      float p2 = ex2(s[n][2] - mn1), p3 = ex2(s[n][3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      if (kDrop) {
        const int j = k0 + n * 8 + 2 * tq;
        float d0, d1, d2, d3;
        keep_scale2(drop, 0u, (a.mbase + i0) * T + j, d0, d1);
        keep_scale2(drop, 0u, (a.mbase + i0 + 8) * T + j, d2, d3);
        p0 *= d0; p1 *= d1; p2 *= d2; p3 *= d3;
      }
      pa[n >> 1][2 * (n & 1)] = pack_bf16(p0, p1);
      pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int d = 0; d < kNO; ++d) {
      o[d][0] *= al0; o[d][1] *= al0;
      o[d][2] *= al1; o[d][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b[4];
        ldsm4t(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                      dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pa[kk], b[0], b[1]);
        mma16816(o[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    __syncthreads();  // every thread is done with this stage
    cur = nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int d = 0; d < kNO; ++d) {
    const int c = d * 8 + 2 * tq;
    if (i0 < T)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)i0 * a.ldo + c) =
          __floats2bfloat162_rn(o[d][0] * inv0, o[d][1] * inv0);
    if (i0 + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)(i0 + 8) * a.ldo +
                                         c) =
          __floats2bfloat162_rn(o[d][2] * inv1, o[d][3] * inv1);
  }
  if (a.lse && tq == 0) {
    if (i0 < T) a.lse[(size_t)i0 * a.lds] = (m0 + __log2f(l0)) * kLn2;
    if (i0 + 8 < T) a.lse[(size_t)(i0 + 8) * a.lds] = (m1 + __log2f(l1)) * kLn2;
  }
}

// One (sample, head, own 64-row tile) of the attention backward.  With
// kKeySide false the block owns 64 queries and walks the key tiles: dq.
// With kKeySide true it owns 64 keys and walks the query tiles: dk and dv.
// Per tile pair it recomputes p = exp(q k^T / sqrt(kD) - lse_q) on the
// valid keys and
//   ds = p * ((dctx v^T) * mask - delta_q),   a = p * mask
//   dq += ds k / sqrt(kD)  |  dk += ds^T q / sqrt(kD), dv += a^T dctx
// 16 columns at a time, everything in registers.  Pointers are at row 0 of
// the sample and the head's first column.
struct FlashBwd {
  const bf16 *q, *k, *v;   // rows of stride ld
  const bf16* dctx;        // rows of stride ldg
  const float *kvalid, *lse, *delta;  // lse, delta of row t at [t lds]
  bf16 *dq, *dk, *dv;      // rows of stride ldd
  int ld, ldg, lds, ldd, T, o0;
  uint64_t mbase;
};

template <int kD, bool kKeySide, bool kDrop>
__device__ __forceinline__ void flash_bwd_tile(const FlashBwd& a,
                                               const Dropout& drop,
                                               unsigned char* smem) {
  constexpr int kLd = kD + 8, kNK = kD / 16, kNO = kD / 8;
  const FlashRing R = flash_ring<kD>(smem);
  const int T = a.T, ntiles = (T + kFT - 1) / kFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = a.o0 + warp * 16 + g;  // the thread's own rows r0, r0 + 8
  const float scale = rsqrtf((float)kD), sl2 = scale * kLog2e;

  // own tiles (q and dctx, or k and v) into stage 1, then registers
  tile_load<kD>(kKeySide ? a.k : a.q, a.ld, a.o0, T, R.tile[1][0]);
  if (kKeySide) tile_load<kD>(a.v, a.ld, a.o0, T, R.tile[1][1]);
  else tile_load<kD>(a.dctx, a.ldg, a.o0, T, R.tile[1][1]);
  cp_async_commit();
  const bool uniform = !key_bits(a.kvalid, T, R.vbits, 2 * ntiles);
  bf16* dst1 = kKeySide ? a.dk : a.dq;
  auto own_tile_valid = [&]() {
    const int t = a.o0 / kFT;
    return uniform || (R.vbits[2 * t] | R.vbits[2 * t + 1]) != 0u;
  };
  auto visit = [&](int j) {
    return kKeySide || uniform || (R.vbits[2 * j] | R.vbits[2 * j + 1]) != 0u;
  };
  auto next = [&](int j) {
    while (j < ntiles && !visit(j)) ++j;
    return j;
  };
  if (kKeySide && !own_tile_valid()) {
    // no valid key here, and the sample has one: every p of these keys is 0
    cp_async_wait<0>();
    for (int i = threadIdx.x; i < kFT * kD / 2; i += kFThreads) {
      const int r = i / (kD / 2), c = (i % (kD / 2)) * 2, t = a.o0 + r;
      if (t < T) {
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(a.dk + (size_t)t * a.ldd + c) = z;
        *reinterpret_cast<__nv_bfloat162*>(a.dv + (size_t)t * a.ldd + c) = z;
      }
    }
    return;
  }
  // the other side's tiles (k and v, or q and dctx with their lse, delta)
  auto load_other = [&](int j, int st) {
    if (kKeySide) {
      tile_load<kD>(a.q, a.ld, j * kFT, T, R.tile[st][0]);
      tile_load<kD>(a.dctx, a.ldg, j * kFT, T, R.tile[st][1]);
      for (int i = threadIdx.x; i < kFT; i += kFThreads) {
        const int t = j * kFT + i;
        R.vec[st][0][i] = t < T ? ldgf(a.lse + (size_t)t * a.lds) * kLog2e
                                : INFINITY;
        R.vec[st][1][i] = t < T ? ldgf(a.delta + (size_t)t * a.lds) : 0.f;
      }
    } else {
      tile_load<kD>(a.k, a.ld, j * kFT, T, R.tile[st][0]);
      tile_load<kD>(a.v, a.ld, j * kFT, T, R.tile[st][1]);
    }
  };
  int cur = next(0);
  if (cur < ntiles) load_other(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t xf[kNK][4], yf[kNK][4];  // own q, dctx (or k, v) as A fragments
#pragma unroll
  for (int kc = 0; kc < kNK; ++kc) {
    const int off = (warp * 16 + (lane & 15)) * kLd + kc * 16 + (lane >> 4) * 8;
    ldsm4(xf[kc], R.tile[1][0] + off);
    ldsm4(yf[kc], R.tile[1][1] + off);
  }
  __syncthreads();
  // query side: the own rows' lse (log2 units) and delta
  float lse0 = 0.f, lse1 = 0.f, del0 = 0.f, del1 = 0.f;
  // key side: whether the own keys may be attended to
  bool ok0 = false, ok1 = false;
  if (kKeySide) {
    ok0 = r0 < T && (uniform || bit_of(R.vbits, r0));
    ok1 = r0 + 8 < T && (uniform || bit_of(R.vbits, r0 + 8));
  } else {
    lse0 = r0 < T ? ldgf(a.lse + (size_t)r0 * a.lds) * kLog2e : INFINITY;
    lse1 = r0 + 8 < T ? ldgf(a.lse + (size_t)(r0 + 8) * a.lds) * kLog2e
                      : INFINITY;
    del0 = r0 < T ? ldgf(a.delta + (size_t)r0 * a.lds) : 0.f;
    del1 = r0 + 8 < T ? ldgf(a.delta + (size_t)(r0 + 8) * a.lds) : 0.f;
  }
  float acc1[kNO][4], acc2[kNO][4];  // dq (or dk), dv
#pragma unroll
  for (int d = 0; d < kNO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[d][e] = acc2[d][e] = 0.f;

  int stage = 0;
  while (cur < ntiles) {
    const int nxt = next(cur + 1);
    if (nxt < ntiles) load_other(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile cur (and its vectors) landed for every thread
    const bf16* Xs = R.tile[stage][0];  // k (or q)
    const bf16* Ys = R.tile[stage][1];  // v (or dctx)
    const float* tl = R.vec[stage][0];
    const float* td = R.vec[stage][1];
    const int t0 = cur * kFT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 columns of the other tile
      const uint32_t wk = kKeySide ? 0u : R.vbits[2 * cur + (kk >> 1)];
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][e] = dp[h][e] = 0.f;
      const int roff = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < kNK; ++kc) {
        uint32_t b[4];
        ldsm4(b, Xs + roff + kc * 16);
        mma16816(s[0], xf[kc], b[0], b[1]);
        mma16816(s[1], xf[kc], b[2], b[3]);
        ldsm4(b, Ys + roff + kc * 16);
        mma16816(dp[0], yf[kc], b[0], b[1]);
        mma16816(dp[1], yf[kc], b[2], b[3]);
      }
      uint32_t dsa[4], pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[4], pm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + kk * 16 + h * 8 + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r0 + 8;
          float p, del;
          if (kKeySide) {  // row: a key, col: a query
            const bool ok = e < 2 ? ok0 : ok1;
            const float sv = uniform ? 0.f : s[h][e] * sl2;
            p = ok ? ex2(sv - tl[col - t0]) : 0.f;
            del = td[col - t0];
          } else {         // row: a query, col: a key
            const bool ok = uniform ? col < T
                                    : ((wk >> (col & 31)) & 1u);
            const float sv = uniform ? 0.f : s[h][e] * sl2;
            p = ok ? ex2(sv - (e < 2 ? lse0 : lse1)) : 0.f;
            del = e < 2 ? del0 : del1;
          }
          float m = 1.f;
          if (kDrop && p != 0.f) {
            const uint64_t qi = kKeySide ? col : row;
            const uint64_t kj = kKeySide ? row : col;
            m = keep_scale(drop, 0u, (a.mbase + qi) * T + kj);
          }
          ds[e] = p * (dp[h][e] * m - del);
          pm[e] = p * m;
        }
        dsa[2 * h] = pack_bf16(ds[0], ds[1]);
        dsa[2 * h + 1] = pack_bf16(ds[2], ds[3]);
        pa[2 * h] = pack_bf16(pm[0], pm[1]);
        pa[2 * h + 1] = pack_bf16(pm[2], pm[3]);
      }
      // acc1 += ds x (k or q rows kk*16..), acc2 += a x dctx rows (key side)
      const int toff = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                       (lane >> 4) * 8;
#pragma unroll
      for (int dpi = 0; dpi < kD / 16; ++dpi) {
        uint32_t b[4];
        ldsm4t(b, Xs + toff + dpi * 16);
        mma16816(acc1[2 * dpi], dsa, b[0], b[1]);
        mma16816(acc1[2 * dpi + 1], dsa, b[2], b[3]);
        if (kKeySide) {
          ldsm4t(b, Ys + toff + dpi * 16);
          mma16816(acc2[2 * dpi], pa, b[0], b[1]);
          mma16816(acc2[2 * dpi + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
    cur = nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int d = 0; d < kNO; ++d) {
    const int c = d * 8 + 2 * tq;
    if (r0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dst1 + (size_t)r0 * a.ldd + c) =
          __floats2bfloat162_rn(acc1[d][0] * scale, acc1[d][1] * scale);
      if (kKeySide)
        *reinterpret_cast<__nv_bfloat162*>(a.dv + (size_t)r0 * a.ldd + c) =
            __floats2bfloat162_rn(acc2[d][0], acc2[d][1]);
    }
    if (r0 + 8 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dst1 + (size_t)(r0 + 8) * a.ldd +
                                         c) =
          __floats2bfloat162_rn(acc1[d][2] * scale, acc1[d][3] * scale);
      if (kKeySide)
        *reinterpret_cast<__nv_bfloat162*>(a.dv + (size_t)(r0 + 8) * a.ldd +
                                           c) =
            __floats2bfloat162_rn(acc2[d][2], acc2[d][3]);
    }
  }
}

}  // namespace ladiff
