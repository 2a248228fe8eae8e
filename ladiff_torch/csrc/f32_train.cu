// The float32 counterparts of the training kernels 8 (train_self_attention),
// 9 (train_postnorm_ffn), 12 (train_encoder_layer) and 13
// (train_decoder_layer), forward and backward: replaces the same four TPU
// kernels as their bf16 versions (ladiff_tpu/ops/pallas_train_attention.py
// :388, pallas_train_ffn.py:209, pallas_train_layer.py:207,
// pallas_train_decoder_layer.py:410) at the type of every published
// configuration (TRAIN.MIXED_PRECISION false).  Each of the four is a chain
// of these kernels behind its wrapper (ladiff_torch/ops/f32_train.py):
//
//   f32t_gemm             f32_tile.cuh's GEMM in its three layouts: A W^T
//                         (the forward products), dY W (dx: the weight read
//                         as [K, N]) and dY^T X split over K into float32
//                         partials with the column sums of dY (the weight
//                         and bias gradients); epilogues add bias,
//                         activation, the activation's derivative, dropout
//                         and a residual
//   f32t_rownorm          a row LayerNorm (f32_tile.cuh)
//   f32t_attention        the attention forward of f32_tile.cuh with the
//                         probability dropout and each row's log-sum-exp
//   f32t_attention_bwd_q  the attention backward's query side: one block
//                         per (sample, head, 32-query tile) walks the key
//                         tiles, recomputes P from q, k and the
//                         log-sum-exp, dP from dO and v, dS = P (dP keep -
//                         delta), and accumulates dq = scale dS k
//   f32t_attention_bwd_kv the key side: one block per (sample, head,
//                         64-key tile) walks the query tiles and accumulates
//                         dk = scale dS^T q and dv = (P keep)^T dO; the two
//                         sides write disjoint rows, so no atomics
//   f32t_rowdot           delta = dctx . ctx per row and head (the identity
//                         survives the probability dropout: sum_j dp_j p_j
//                         = dO . O with O = (p * keep) V)
//   f32t_lnbwd            a LayerNorm's backward, one warp a row, rows in
//                         fixed ranges a block; the per-block column sums
//                         of dy xhat and dy (the weight and bias gradients)
//                         go to partials; optionally also dx times a
//                         dropout keep-scale
//   f32t_keep_mul         y = x * keep (a residual dropout's backward)
//   f32t_reduce           sums partials over their splits in split order
//
// Gradients are deterministic: every cross-block sum goes through partials
// and a fixed-order reduction, no atomicAdd.  Dropout draws Philox-4x32-10
// keyed by (seed, mask id, element) exactly as the bf16 kernels do
// (common.cuh keep_scale), so a seed gives the same masks in both types.
//
// What bounds them on the H100: the products, float32 FFMA at ~67 TFLOP/s
// in this design (PERF.md section 6 gives each chain's time against its
// bound at 165 TFLOP/s, the three-term TF32 rate).
#include "f32_tile.cuh"

using namespace ladiff;
using namespace ladiff::f32;

LADIFF_ERROR_STRING_FN

namespace {

constexpr int kLnPer = 8;  // the LayerNorm backward's D <= 256

struct AttnBwd {
  const float *q, *k, *v, *valid, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  int B, Sq, Nk, H, Dh, ldq, ldk, ldd, lddq, lddk, tiles;
  float scale;
  Drop drop;
};

__host__ __device__ inline size_t bwd_smem_floats(int Dh) {
  return (size_t)(2 * kQT + 2 * kKT) * (Dh + 4)  // q, dO, k, v tiles
         + (size_t)2 * kQT * (kKT + 4)           // P, dS (or dS^T)
         + 2 * kQT;                              // lse, delta
}

// Copies `rows` rows of Dh floats (row stride ld_src, starting at row r0 of
// sample b's `count` rows, column hoff) into a shared tile of row stride
// ld; rows past `count` are zero.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int ld_src, int b, int count, int r0,
                                          int rows, int hoff, int Dh) {
  const int nv = Dh / 4;
  for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
    const int r = i / nv, c = (i % nv) * 4;
    float* d = dst + r * ld + c;
    if (r0 + r < count)
      cp_async16(d, src + ((size_t)b * count + r0 + r) * ld_src + hoff + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// s = q k^T and dp = dO v^T of rows ty + 8 i and keys tx + 16 j.
__device__ __forceinline__ void score_tiles(const float* Qs, const float* Os,
                                            const float* Ks, const float* Vs,
                                            int ld, int Dh, int tx, int ty,
                                            float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < Dh; d += 4) {
    float4 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 8 * i) * ld + d]);
      ov[i] = *reinterpret_cast<const float4*>(&Os[(ty + 8 * i) * ld + d]);
      kv[i] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * i) * ld + d]);
      vv[i] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * i) * ld + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(qv[i].x, kv[j].x, t);
        t = fmaf(qv[i].y, kv[j].y, t);
        t = fmaf(qv[i].z, kv[j].z, t);
        s[i][j] = fmaf(qv[i].w, kv[j].w, t);
        float u = dp[i][j];
        u = fmaf(ov[i].x, vv[j].x, u);
        u = fmaf(ov[i].y, vv[j].y, u);
        u = fmaf(ov[i].z, vv[j].z, u);
        dp[i][j] = fmaf(ov[i].w, vv[j].w, u);
      }
  }
}

// P keep and dS = P (dP keep - delta) of query row q0 + r and key k0 + kc
// (P recomputed from the saved log-sum-exp; 0 past the rows or keys).
__device__ __forceinline__ void prob_grad(const AttnBwd& a, int b, int h,
                                          bool any_valid, int q0, int r,
                                          int k0, int kc, float s, float dp,
                                          const float* lse_s,
                                          const float* del_s, float& pk,
                                          float& ds) {
  const int qi = q0 + r, kj = k0 + kc;
  pk = ds = 0.f;
  if (qi >= a.Sq || kj >= a.Nk) return;
  const bool valid = !a.valid || a.valid[(size_t)b * a.Nk + kj] > 0.5f;
  const float p =
      expf(key_logit(s, kj, a.Nk, any_valid, valid, a.scale) - lse_s[r]);
  if (p == 0.f) return;
  const float keep =
      a.drop.on ? keep_scale(a.drop.d, a.drop.mask_id,
                             ((uint64_t)(b * a.H + h) * a.Sq + qi) * a.Nk + kj)
                : 1.f;
  pk = p * keep;
  ds = p * (dp * keep - del_s[r]);
}

// Query side: one block per (sample, head, 32-query tile); dq of rows
// ty * 4 + i and columns tx + 16 c.
template <int NC>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_q_kernel(AttnBwd a) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = a.Dh, ld = Dh + 4;
  float* Qs = smem;                      // [kQT][ld]
  float* Os = Qs + kQT * ld;             // [kQT][ld]
  float* Ks = Os + kQT * ld;             // [kKT][ld]
  float* Vs = Ks + kKT * ld;             // [kKT][ld]
  float* dSt = Vs + kKT * ld;            // [kKT][kQT + 4]
  float* lse_s = dSt + 2 * kQT * (kKT + 4);
  float* del_s = lse_s + kQT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tile = blockIdx.x % a.tiles, bh = blockIdx.x / a.tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = tile * kQT, hoff = h * Dh;
  const bool any_valid = sample_has_valid_key(a.valid, b, a.Nk, 0);
  load_rows(Qs, ld, a.q, a.ldq, b, a.Sq, q0, kQT, hoff, Dh);
  load_rows(Os, ld, a.dout, a.ldd, b, a.Sq, q0, kQT, hoff, Dh);
  if (tid < kQT) {
    const int qi = q0 + tid;
    const size_t row = ((size_t)b * a.Sq + qi) * a.H + h;
    lse_s[tid] = qi < a.Sq ? a.lse[row] : 0.f;
    del_s[tid] = qi < a.Sq ? a.delta[row] : 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < a.Nk; k0 += kKT) {
    load_rows(Ks, ld, a.k, a.ldk, b, a.Nk, k0, kKT, hoff, Dh);
    load_rows(Vs, ld, a.v, a.ldk, b, a.Nk, k0, kKT, hoff, Dh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tiles(Qs, Os, Ks, Vs, ld, Dh, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pk, ds;
        prob_grad(a, b, h, any_valid, q0, ty + 8 * i, k0, tx + 16 * j,
                  s[i][j], dp[i][j], lse_s, del_s, pk, ds);
        dSt[(tx + 16 * j) * (kQT + 4) + ty + 8 * i] = ds;
      }
    __syncthreads();
    const int kn = min(kKT, a.Nk - k0);
    for (int j = 0; j < kn; ++j) {
      const float4 d4 =
          *reinterpret_cast<const float4*>(&dSt[j * (kQT + 4) + ty * 4]);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < Dh ? Ks[j * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dv[i], kv, acc[i][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    float* row = a.dq + ((size_t)b * a.Sq + qi) * a.lddq + hoff;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) row[col] = acc[i][c] * a.scale;
    }
  }
}

// Key side: one block per (sample, head, 64-key tile); dk, dv of keys
// ty * 8 + i and columns tx + 16 c.  Every key tile walks every query tile,
// a sample without a valid key included (its probabilities are uniform,
// not 0).
template <int NC>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_kv_kernel(AttnBwd a) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = a.Dh, ld = Dh + 4;
  float* Qs = smem;                      // [kQT][ld]
  float* Os = Qs + kQT * ld;             // [kQT][ld]
  float* Ks = Os + kQT * ld;             // [kKT][ld]
  float* Vs = Ks + kKT * ld;             // [kKT][ld]
  float* Ps = Vs + kKT * ld;             // [kQT][kKT + 4]
  float* dSs = Ps + kQT * (kKT + 4);     // [kQT][kKT + 4]
  float* lse_s = dSs + kQT * (kKT + 4);
  float* del_s = lse_s + kQT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tile = blockIdx.x % a.tiles, bh = blockIdx.x / a.tiles;
  const int h = bh % a.H, b = bh / a.H;
  const int k0 = tile * kKT, hoff = h * Dh;
  const bool any_valid = sample_has_valid_key(a.valid, b, a.Nk, 0);
  load_rows(Ks, ld, a.k, a.ldk, b, a.Nk, k0, kKT, hoff, Dh);
  load_rows(Vs, ld, a.v, a.ldk, b, a.Nk, k0, kKT, hoff, Dh);
  float dk[8][NC], dv[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  for (int q0 = 0; q0 < a.Sq; q0 += kQT) {
    load_rows(Qs, ld, a.q, a.ldq, b, a.Sq, q0, kQT, hoff, Dh);
    load_rows(Os, ld, a.dout, a.ldd, b, a.Sq, q0, kQT, hoff, Dh);
    if (tid < kQT) {
      const int qi = q0 + tid;
      const size_t row = ((size_t)b * a.Sq + qi) * a.H + h;
      lse_s[tid] = qi < a.Sq ? a.lse[row] : 0.f;
      del_s[tid] = qi < a.Sq ? a.delta[row] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tiles(Qs, Os, Ks, Vs, ld, Dh, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pk, ds;
        const int r = ty + 8 * i, kc = tx + 16 * j;
        prob_grad(a, b, h, any_valid, q0, r, k0, kc, s[i][j], dp[i][j],
                  lse_s, del_s, pk, ds);
        Ps[r * (kKT + 4) + kc] = pk;
        dSs[r * (kKT + 4) + kc] = ds;
      }
    __syncthreads();
    const int qn = min(kQT, a.Sq - q0);
    for (int r = 0; r < qn; ++r) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(&Ps[r * (kKT + 4) + ty * 8]);
      const float4 p1 =
          *reinterpret_cast<const float4*>(&Ps[r * (kKT + 4) + ty * 8 + 4]);
      const float4 d0 =
          *reinterpret_cast<const float4*>(&dSs[r * (kKT + 4) + ty * 8]);
      const float4 d1 =
          *reinterpret_cast<const float4*>(&dSs[r * (kKT + 4) + ty * 8 + 4]);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float sv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float qv = col < Dh ? Qs[r * ld + col] : 0.f;
        const float ov = col < Dh ? Os[r * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kj = k0 + ty * 8 + i;
    if (kj >= a.Nk) continue;
    const size_t row = ((size_t)b * a.Nk + kj) * a.lddk + hoff;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) {
        a.dk[row + col] = dk[i][c] * a.scale;
        a.dv[row + col] = dv[i][c];
      }
    }
  }
}

SmemGrant g_bwd_grant[2][4];

template <int NC>
int launch_bwd(const AttnBwd& a, bool key_side, cudaStream_t stream) {
  const size_t bytes = bwd_smem_floats(a.Dh) * sizeof(float);
  const long long blocks = (long long)a.B * a.H * a.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (key_side) {
    if (!allow_smem(attn_bwd_kv_kernel<NC>, bytes, g_bwd_grant[1][NC - 1]))
      return cudaErrorInvalidValue;
    attn_bwd_kv_kernel<NC><<<(unsigned)blocks, kAttnThreads, bytes, stream>>>(
        a);
  } else {
    if (!allow_smem(attn_bwd_q_kernel<NC>, bytes, g_bwd_grant[0][NC - 1]))
      return cudaErrorInvalidValue;
    attn_bwd_q_kernel<NC><<<(unsigned)blocks, kAttnThreads, bytes, stream>>>(
        a);
  }
  return cudaGetLastError();
}

// dx = rstd (g w - mean(g w) - xhat mean(g w xhat)) of the LayerNorm of x
// (eps 1e-5), one warp a row; block z takes rows [z rpb, (z + 1) rpb) and
// writes the column sums of g xhat and g over them, summed over its warps
// in warp order, to part[z ldpart + c] (c < D: the weight's, then the
// bias's).  With dxk also dxk = dx * keep(mask_id, row D + c).
__global__ void __launch_bounds__(256) lnbwd_kernel(
    const float* __restrict__ x, int ldx, const float* __restrict__ w,
    const float* __restrict__ g, int ldg, float* __restrict__ dx, int lddx,
    float* __restrict__ dxk, Drop drop, float* __restrict__ part, int ldpart,
    int M, int D, int rpb) {
  __shared__ float red[8][2 * kLnPer * 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = D / 32;
  float pw[kLnPer], pb[kLnPer];
#pragma unroll
  for (int i = 0; i < kLnPer; ++i) pw[i] = pb[i] = 0.f;
  const int r0 = blockIdx.x * rpb, r1 = min(M, r0 + rpb);
  for (int row = r0 + warp; row < r1; row += 8) {
    const float* xr = x + (size_t)row * ldx;
    const float* gr = g + (size_t)row * ldg;
    float xv[kLnPer], gv[kLnPer];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPer; ++i)
      if (i < per) {
        xv[i] = xr[lane + 32 * i];
        gv[i] = gr[lane + 32 * i];
        s += xv[i];
      }
    const float mean = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPer; ++i)
      if (i < per) q += (xv[i] - mean) * (xv[i] - mean);
    const float rstd = rsqrtf(warp_sum(q) / D + kLnEps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPer; ++i)
      if (i < per) {
        xv[i] = (xv[i] - mean) * rstd;  // xhat
        const float gw = gv[i] * w[lane + 32 * i];
        sg += gw;
        sgx += gw * xv[i];
        pw[i] += gv[i] * xv[i];
        pb[i] += gv[i];
      }
    const float mg = warp_sum(sg) / D, mgx = warp_sum(sgx) / D;
    float* dr = dx + (size_t)row * lddx;
#pragma unroll
    for (int i = 0; i < kLnPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        const float v = rstd * (gv[i] * w[c] - mg - xv[i] * mgx);
        dr[c] = v;
        if (dxk)
          dxk[(size_t)row * lddx + c] =
              v * drop_scale(drop, (uint64_t)row * D + c);
      }
  }
#pragma unroll
  for (int i = 0; i < kLnPer; ++i)
    if (i < per) {
      red[warp][lane + 32 * i] = pw[i];
      red[warp][D + lane + 32 * i] = pb[i];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) t += red[wi][c];
    part[(size_t)blockIdx.x * ldpart + c] = t;
  }
}

__global__ void keep_mul_kernel(const float* __restrict__ in,
                                float* __restrict__ out, size_t n, Drop drop) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i] * drop_scale(drop, i);
}

// out[row H + h] = sum over head h's columns of a[row] b[row], one warp a
// row.
__global__ void rowdot_kernel(const float* __restrict__ a, int lda,
                              const float* __restrict__ b, int ldb,
                              float* __restrict__ out, int M, int H, int Dh) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  for (int h = 0; h < H; ++h) {
    float s = 0.f;
    for (int c = lane; c < Dh; c += 32)
      s += a[(size_t)row * lda + h * Dh + c] * b[(size_t)row * ldb + h * Dh + c];
    s = warp_sum(s);
    if (lane == 0) out[(size_t)row * H + h] = s;
  }
}

// Element i of the sum over splits z of part[z ld + i], in split order,
// written to the output segment it falls in (n0, n1, n2, n3 elements).
__global__ void reduce_kernel(const float* __restrict__ part, int splits,
                              size_t ld, int n0, int n1, int n2, int n3,
                              float* o0, float* o1, float* o2, float* o3) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n0 + n1 + n2 + n3) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * ld + i];
  if (i < n0)
    o0[i] = s;
  else if (i < n0 + n1)
    o1[i - n0] = s;
  else if (i < n0 + n1 + n2)
    o2[i - n0 - n1] = s;
  else
    o3[i - n0 - n1 - n2] = s;
}

float* fp(const void* p) { return static_cast<float*>(const_cast<void*>(p)); }
const float* cfp(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// ptrs: A, B, C, bias, pre, gin, R, colsum (float32; all but A, B and C may
// be null).  ints: M, N, K, lda, ldb, ldc, a_mn, b_mn, act, ldpre, ldg,
// gact, ldr, mask id, seed lo, seed hi, ksplit, cstride, sstride.  floats:
// rate (dropout on where > 0).
extern "C" int f32t_gemm(const void** p, const int* n, const float* f,
                         void* stream_ptr) {
  GemmArgs g = {};
  g.A = cfp(p[0]);
  g.B = cfp(p[1]);
  g.C = fp(p[2]);
  g.e.bias = cfp(p[3]);
  g.e.pre = fp(p[4]);
  g.e.gin = cfp(p[5]);
  g.e.R = cfp(p[6]);
  g.colsum = fp(p[7]);
  g.M = n[0]; g.N = n[1]; g.K = n[2];
  g.lda = n[3]; g.ldb = n[4]; g.ldc = n[5];
  g.e.act = n[8]; g.e.ldpre = n[9]; g.e.ldg = n[10]; g.e.gact = n[11];
  g.e.ldr = n[12];
  g.e.drop = make_drop(n[14], n[15], f[0], n[13]);
  g.ksplit = n[16];
  g.cstride = (size_t)n[17];
  g.sstride = (size_t)n[18];
  return gemm_f32(g, n[6] != 0, n[7] != 0,
                  static_cast<cudaStream_t>(stream_ptr));
}

// ptrs: src (row stride lds), w [D], b [D], out (row stride ldo).  ints: M,
// D, lds, ldo.
extern "C" int f32t_rownorm(const void** p, const int* n, const float*,
                            void* stream_ptr) {
  return rownorm_f32(cfp(p[0]), n[2], 1, nullptr, cfp(p[1]), cfp(p[2]),
                     nullptr, 0, fp(p[3]), n[3], n[0], n[1],
                     static_cast<cudaStream_t>(stream_ptr));
}

// ptrs: q (row stride ldq), k, v (row stride ldk), valid [B Nk] or null,
// out (row stride ldo), lse [B Sq, H].  ints: B, Sq, Nk, H, Dh, ldq, ldk,
// ldo, mask id, seed lo, seed hi.  floats: the logit scale, rate.
extern "C" int f32t_attention(const void** p, const int* n, const float* f,
                              void* stream_ptr) {
  AttnF32 a = {};
  a.q = cfp(p[0]);
  a.k1 = cfp(p[1]);
  a.v1 = cfp(p[2]);
  a.valid1 = cfp(p[3]);
  a.out = fp(p[4]);
  a.lse = fp(p[5]);
  a.B = n[0]; a.Sq = n[1]; a.n1 = n[2]; a.H = n[3]; a.Dh = n[4];
  a.ldq = n[5]; a.ldk1 = n[6]; a.ldo = n[7];
  a.drop = make_drop(n[9], n[10], f[1], n[8]);
  a.scale = f[0];
  if (!a.lse) return cudaErrorInvalidValue;
  return attention_f32(a, static_cast<cudaStream_t>(stream_ptr));
}

// ptrs: q (row stride ldq), k, v (row stride ldk), valid [B Nk] or null,
// dout (row stride ldd), lse, delta [B Sq, H], dq (row stride lddq), dk,
// dv (row stride lddk).  ints: B, Sq, Nk, H, Dh, ldq, ldk, ldd, lddq,
// lddk, mask id, seed lo, seed hi, side (0: the query side writes dq, 1:
// the key side writes dk and dv).  floats: the logit scale, rate.
extern "C" int f32t_attention_bwd(const void** p, const int* n,
                                  const float* f, void* stream_ptr) {
  AttnBwd a = {};
  a.q = cfp(p[0]);
  a.k = cfp(p[1]);
  a.v = cfp(p[2]);
  a.valid = cfp(p[3]);
  a.dout = cfp(p[4]);
  a.lse = cfp(p[5]);
  a.delta = cfp(p[6]);
  a.dq = fp(p[7]);
  a.dk = fp(p[8]);
  a.dv = fp(p[9]);
  a.B = n[0]; a.Sq = n[1]; a.Nk = n[2]; a.H = n[3]; a.Dh = n[4];
  a.ldq = n[5]; a.ldk = n[6]; a.ldd = n[7]; a.lddq = n[8]; a.lddk = n[9];
  a.drop = make_drop(n[11], n[12], f[1], n[10]);
  a.scale = f[0];
  const bool key_side = n[13] != 0;
  a.tiles = key_side ? (a.Nk + kKT - 1) / kKT : (a.Sq + kQT - 1) / kQT;
  if (a.B < 1 || a.Sq < 1 || a.Nk < 1 || a.H < 1 || a.Dh < 4 || a.Dh > 64 ||
      a.Dh % 4 || a.ldq % 4 || a.ldk % 4 || a.ldd % 4 || !aligned16(a.q) ||
      !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout) || !a.lse ||
      !a.delta || (key_side ? !a.dk || !a.dv : !a.dq))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch ((a.Dh + 15) / 16) {
    case 1: return launch_bwd<1>(a, key_side, s);
    case 2: return launch_bwd<2>(a, key_side, s);
    case 3: return launch_bwd<3>(a, key_side, s);
    default: return launch_bwd<4>(a, key_side, s);
  }
}

// ptrs: a (row stride lda), b (row stride ldb), out [M, H].  ints: M, H, Dh,
// lda, ldb.
extern "C" int f32t_rowdot(const void** p, const int* n, const float*,
                           void* stream_ptr) {
  const int M = n[0], H = n[1], Dh = n[2];
  if (M < 1 || H < 1 || Dh < 1) return cudaErrorInvalidValue;
  rowdot_kernel<<<(M + 7) / 8, 256, 0,
                  static_cast<cudaStream_t>(stream_ptr)>>>(
      cfp(p[0]), n[3], cfp(p[1]), n[4], fp(p[2]), M, H, Dh);
  return cudaGetLastError();
}

// ptrs: x (row stride ldx), w [D], g (row stride ldg), dx (row stride
// lddx), dxk (row stride lddx) or null, part (row stride ldpart).  ints:
// M, D, ldx, ldg, lddx, ldpart, rows a block, mask id, seed lo, seed hi.
// floats: rate.
extern "C" int f32t_lnbwd(const void** p, const int* n, const float* f,
                          void* stream_ptr) {
  const int M = n[0], D = n[1], rpb = n[6];
  if (M < 1 || D < 32 || D % 32 || D > 32 * kLnPer || rpb < 1 ||
      n[5] < 2 * D)
    return cudaErrorInvalidValue;
  lnbwd_kernel<<<(M + rpb - 1) / rpb, 256, 0,
                 static_cast<cudaStream_t>(stream_ptr)>>>(
      cfp(p[0]), n[2], cfp(p[1]), cfp(p[2]), n[3], fp(p[3]), n[4], fp(p[4]),
      make_drop(n[8], n[9], f[0], n[7]), fp(p[5]), n[5], M, D, rpb);
  return cudaGetLastError();
}

// ptrs: in, out (n contiguous floats).  ints: n, mask id, seed lo, seed hi.
// floats: rate.
extern "C" int f32t_keep_mul(const void** p, const int* n, const float* f,
                             void* stream_ptr) {
  if (n[0] < 1) return cudaErrorInvalidValue;
  keep_mul_kernel<<<(n[0] + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream_ptr)>>>(
      cfp(p[0]), fp(p[1]), (size_t)n[0], make_drop(n[2], n[3], f[0], n[1]));
  return cudaGetLastError();
}

// ptrs: part, out0 .. out3 (null where the segment is empty).  ints:
// splits, ld (a split's elements), n0 .. n3.
extern "C" int f32t_reduce(const void** p, const int* n, const float*,
                           void* stream_ptr) {
  const int total = n[2] + n[3] + n[4] + n[5];
  if (n[0] < 1 || total < 1 || n[1] < total) return cudaErrorInvalidValue;
  reduce_kernel<<<(total + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream_ptr)>>>(
      cfp(p[0]), n[0], (size_t)n[1], n[2], n[3], n[4], n[5], fp(p[1]),
      fp(p[2]), fp(p[3]), fp(p[4]));
  return cudaGetLastError();
}
