// Kernel 13: one whole post-norm transformer decoder layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_decoder_layer.py
// train_decoder_layer).  See ladiff_torch/ops/train_decoder_layer.py for the
// math, the dropout contract, what is saved and the gradient schemes.
//
// Forward, a fixed sequence of launches:
//   linear_kernel x2     qkv = x Wqkv^T + bqkv; the memory's k, v (rows D..3D
//                        of the cross-attention in-projection), once per
//                        sample                                 (kernel 8's)
//   attn_fwd_kernel      tiled online-softmax self-attention, probability
//                        dropout (mask 0); ctx, log-sum-exp      (kernel 8's)
//   dec_tail_fwd_kernel  per 32-row block, from ctx to the layer's output:
//                        out-projection, residual dropout (mask 1), LN1; the
//                        cross-attention into the sample's <= 8 memory rows
//                        (probability dropout, mask 2; cross_attend_rows of
//                        common.cuh, K2's too), its out-projection
//                        and residual dropout (mask 3), LN2; the FFN (masks
//                        4, 5) and LN3 (ffn_tail.cuh); r1, t1, r2 and h stay
//                        in shared memory
// Backward:
//   dec_tail_bwd_kernel  per 32-row block, from dout to dctx: the forward
//                        again, the tail's backward (ffn_bwd.cuh), LN2's
//                        backward, the cross-attention's backward (dq; the
//                        block's sums of dk, dv per memory row), LN1's
//                        backward, the self-attention out-projection's
//                        backward
//   reduce_kernel        LayerNorm gradients over the blocks
//   kv_reduce_kernel     dk, dv per sample: the partial sums of the blocks
//                        that hold its rows, in block order (no atomics)
//   linear_nn_kernel x2  dmem = [dk dv] Wkv; dx = dr1 + dqkv Wqkv
//   attn_bwd_kernel x2   dq; dk, dv of the self-attention        (kernel 8's)
//   wgrad / colsum       the 14 weight and bias gradients
#include "ffn_bwd.cuh"
#include "train_attn.cuh"

namespace {

constexpr uint32_t kMaskSaRes = 1u, kMaskCaProb = 2u, kMaskCaRes = 3u,
                   kMaskHid = 4u, kMaskOut = 5u;
constexpr int kMaxMem = 8;  // memory rows per sample

struct DecTail {
  const bf16 *x, *ctx, *memkv;  // memkv [B*L, 2D]: the memory's k | v
  const float* mvalid;          // [B*L]
  const bf16 *sa_out_w, *sa_out_b, *ln1_w, *ln1_b, *ca_in_w, *ca_in_b;
  const bf16 *ca_out_w, *ca_out_b, *ln2_w, *ln2_b, *w1, *b1, *w2, *b2;
  const bf16 *ln3_w, *ln3_b;
  const bf16* dout;
  bf16* out;
  // backward scratch: r1, r2 (f32); t1, q, cc, h, gd, da, dy, dco, dq, dr,
  // dattn, dctx (bf16); delta [M, H], lnpart [blocks, 6 D], kvpart
  // [blocks, 2, L, 2 D] (f32)
  float *r1, *r2;
  bf16 *t1, *q, *cc, *h, *gd, *da, *dy, *dco, *dq, *dr, *dattn, *dctx;
  float *delta, *lnpart, *kvpart;
  int M, T, L, D, H, F, act;
  Dropout drop;
};

// The backward's probability of memory row j = lane (< L) for one query
// row and head, over the sample's valid rows (invalid ones get the additive
// -1e9), and its keep-mask value in *keep; lanes >= L return 0.  The
// forward's context comes from cross_attend_rows (common.cuh, shared with
// K2), which draws the same mask elements.
template <bool kDrop>
__device__ __forceinline__ float cross_prob(const DecTail& a, const bf16* q,
                                            size_t grow, int h, float scale,
                                            float* keep) {
  const int D = a.D, Dh = D / a.H, L = a.L, lane = threadIdx.x & 31;
  const size_t b = grow / a.T, t = grow % a.T;
  float s = -INFINITY;
  if (lane < L) {
    const bf16* k = a.memkv + (b * L + lane) * 2 * D + h * Dh;
    float acc = 0.f;
    for (int d = 0; d < Dh; ++d) acc += tof(q[d]) * ldgf(k + d);
    s = acc * scale + (ldgf(a.mvalid + b * L + lane) > 0.5f ? 0.f : kNegInf);
  }
  const float m = warp_max(s);
  const float e = lane < L ? __expf(s - m) : 0.f;
  const float p = e / warp_sum(e);
  *keep = 1.f;
  if (kDrop && lane < L)
    *keep = keep_scale(a.drop, kMaskCaProb,
                       (((uint64_t)b * a.H + h) * a.T + t) * L + lane);
  return p;
}

// The cross-attention's backward for the block's rows, one warp per (row,
// head): with dcc (f32, the gradient of cc) and q (bf16 in qb), the
// probabilities again, ds_j = p_j (dcc . v_j m_j - sum_k p_k dcc . v_k m_k);
// dq = scale sum_j ds_j k_j (bf16) into dqb and scratch; ds_j and
// a_j = p_j m_j into ps, pa [32][H][8] for the memory rows' sums.
template <bool kDrop>
__device__ __forceinline__ void cross_attend_bwd_rows(
    const DecTail& a, const bf16* qb, int ld, const float* dcc, int ldc,
    bf16* dqb, float* ps, float* pa, size_t row0, int nrow) {
  const int D = a.D, H = a.H, Dh = D / H, L = a.L;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)Dh);
  for (int p = threadIdx.x >> 5; p < kRows * H; p += blockDim.x >> 5) {
    const int row = p / H, h = p % H;
    const int e0 = (row * H + h) * kMaxMem;
    bf16* dq = dqb + row * ld + h * Dh;
    if (row >= nrow) {
      for (int d = lane; d < Dh; d += 32) dq[d] = tob(0.f);
      if (lane < kMaxMem) ps[e0 + lane] = pa[e0 + lane] = 0.f;
      continue;
    }
    float keep;
    const float pj = cross_prob<kDrop>(a, qb + row * ld + h * Dh, row0 + row,
                                       h, scale, &keep);
    const bf16* kv = a.memkv + ((row0 + row) / a.T) * L * 2 * D + h * Dh;
    const float* g = dcc + row * ldc + h * Dh;
    float dA = 0.f;
    if (lane < L)
      for (int d = 0; d < Dh; ++d)
        dA += g[d] * ldgf(kv + (size_t)lane * 2 * D + D + d);
    const float dp = dA * keep;
    const float ds = pj * (dp - warp_sum(pj * dp));
    if (lane < kMaxMem) {
      ps[e0 + lane] = lane < L ? ds : 0.f;
      pa[e0 + lane] = lane < L ? pj * keep : 0.f;
    }
    for (int d0 = 0; d0 < Dh; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) {
        const float w = __shfl_sync(0xffffffffu, ds, j);
        if (d < Dh) acc += w * ldgf(kv + (size_t)j * 2 * D + d);
      }
      if (d < Dh) {
        const bf16 b = tob(acc * scale);
        dq[d] = b;
        a.dq[(row0 + row) * D + h * Dh + d] = b;
      }
    }
  }
}

// The block's sums over its rows of each sample (at most two: T >= 32) of
// dk_j = scale sum ds_j q and dv_j = sum a_j dcc, in row order, to
// kvpart[block][slot][j][0:D | D:2D]; a slot without rows gets zeros.
__device__ __forceinline__ void kv_partials(const DecTail& a, const bf16* qb,
                                            int ld, const float* dcc,
                                            int ldc, const float* ps,
                                            const float* pa, size_t row0,
                                            int nrow) {
  const int D = a.D, H = a.H, Dh = D / H, L = a.L;
  const float scale = rsqrtf((float)Dh);
  const long long s0 = (long long)row0 / a.T;
  for (int slot = 0; slot < 2; ++slot) {
    const long long b = s0 + slot;
    const int lo = (int)max(0LL, b * a.T - (long long)row0);
    const int hi = (int)min((long long)nrow, (b + 1) * a.T - (long long)row0);
    float* out = a.kvpart + ((size_t)blockIdx.x * 2 + slot) * L * 2 * D;
    for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
      const int j = i / D, c = i % D, h = c / Dh;
      float sk = 0.f, sv = 0.f;
      for (int row = lo; row < hi; ++row) {
        const int e = (row * H + h) * kMaxMem + j;
        sk += ps[e] * tof(qb[row * ld + c]);
        sv += pa[e] * dcc[row * ldc + c];
      }
      out[(size_t)j * 2 * D + c] = sk * scale;
      out[(size_t)j * 2 * D + D + c] = sv;
    }
  }
}

// dkv[b * L + j][c] = the sum of kvpart over the blocks that hold rows of
// sample b, in block order.
__global__ void kv_reduce_kernel(const float* part, int B, int T, int L,
                                 int D, bf16* dkv) {
  const long long per = (long long)L * 2 * D;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * per) return;
  const long long b = idx / per, rem = idx % per;
  const long long first = b * T / kRows, last = ((b + 1) * T - 1) / kRows;
  float s = 0.f;
  for (long long blk = first; blk <= last; ++blk) {
    const long long slot = b - blk * kRows / T;
    s += part[(blk * 2 + slot) * per + rem];
  }
  dkv[idx] = tob(s);
}

// Rows < nrow of a smem tile (bf16, row stride ld) to global [*, D].
__device__ __forceinline__ void store_rows(const bf16* src, int ld, bf16* dst,
                                           size_t row0, int nrow, int D) {
  for (int i = threadIdx.x; i < nrow * D; i += blockDim.x)
    dst[row0 * D + i] = src[(i / D) * ld + i % D];
}

FfnArgs tail_args(const DecTail& a) {
  FfnArgs f;
  f.x = nullptr;
  f.ln1_w = a.ln2_w; f.ln1_b = a.ln2_b; f.w1 = a.w1; f.b1 = a.b1;
  f.w2 = a.w2; f.b2 = a.b2; f.ln2_w = a.ln3_w; f.ln2_b = a.ln3_b;
  f.out = a.out;
  f.M = a.M; f.D = a.D; f.F = a.F; f.act = a.act;
  f.drop = a.drop;
  return f;
}

// hid_min of the layouts: q and cc rows in the forward; ps and pa in the
// backward.
inline size_t tail_hid_min(int D, int H) {
  const size_t rows = 2 * align128(kRows * (D + 8) * sizeof(bf16));
  const size_t probs = 2 * (size_t)kRows * H * kMaxMem * sizeof(float);
  return rows > probs ? rows : probs;
}

// From r1 = x + drop(ctx Wso^T + bso) in r (f32) to r2 = t1 + drop(cc Wco^T
// + bco) in r, leaving t1 (bf16) in xb until the q product, q and cc (bf16)
// in qb, cc; with `keep` the block also writes t1, q and cc to scratch.
template <bool kDrop, bool kKeep>
__device__ __forceinline__ void cross_block_rows(const DecTail& a, bf16* xb,
                                                 float* cf, float* r,
                                                 bf16* qb, bf16* cc,
                                                 bf16* ws, size_t row0,
                                                 int nrow) {
  const int D = a.D, ld = D + 8, ldc = kChunk + 4;
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln1_w, a.ln1_b);
  __syncthreads();
  if (kKeep) store_rows(xb, ld, a.t1, row0, nrow, D);
  block_gemm(xb, ld, a.ca_in_w, D, D, D, cf, ldc, false, ws);
  store_biased(cf, ldc, a.ca_in_b, D, qb, ld);
  __syncthreads();
  if (kKeep) store_rows(qb, ld, a.q, row0, nrow, D);
  cross_attend_rows<kDrop>(qb, ld, a.memkv, a.mvalid, row0, nrow, a.T, a.L,
                           D, a.H, a.drop, kMaskCaProb, cc);
  __syncthreads();
  if (kKeep) store_rows(cc, ld, a.cc, row0, nrow, D);
  block_gemm(cc, ld, a.ca_out_w, D, D, D, cf, ldc, false, ws);
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float v = cf[row * ldc + c] + ldgf(a.ca_out_b + c);
    if (kDrop) v *= keep_scale(a.drop, kMaskCaRes, (row0 + row) * D + c);
    r[i] += v;
  }
  __syncthreads();
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
dec_tail_fwd_kernel(DecTail a, FfnArgs f, FfnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* r = reinterpret_cast<float*>(smem + L.r);
  bf16* qb = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* cc = reinterpret_cast<bf16*>(
      smem + L.hid + align128(kRows * (D + 8) * sizeof(bf16)));
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(a.M - row0));
  out_proj_rows<kDrop>(a.ctx, a.x, a.sa_out_w, a.sa_out_b, a.drop,
                       kMaskSaRes, D, xb, cf, r, ws, row0, nrow);
  cross_block_rows<kDrop, false>(a, xb, cf, r, qb, cc, ws, row0, nrow);
  ffn_tail_rows<kDrop>(f, L, smem, row0, nrow, kMaskHid, kMaskOut);
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
dec_tail_bwd_kernel(DecTail a, FfnBwdLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8, ldc = kChunk + 4;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  bf16* dyb = reinterpret_cast<bf16*>(smem + L.dyb);
  float* cf = reinterpret_cast<float*>(smem + L.cf);
  float* r = reinterpret_cast<float*>(smem + L.r);
  bf16* qb = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* cc = reinterpret_cast<bf16*>(
      smem + L.hid + align128(kRows * (D + 8) * sizeof(bf16)));
  float* ps = reinterpret_cast<float*>(smem + L.hid);
  float* pa = ps + kRows * a.H * kMaxMem;
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(a.M - row0));
  float* lnpart = a.lnpart + (size_t)blockIdx.x * 6 * D;

  // the forward again, keeping r1 and r2 (f32) for the LayerNorms'
  // backward and t1, q, cc, h (bf16) for the weight gradients
  out_proj_rows<kDrop>(a.ctx, a.x, a.sa_out_w, a.sa_out_b, a.drop,
                       kMaskSaRes, D, xb, cf, r, ws, row0, nrow);
  for (int i = tid; i < nrow * D; i += blockDim.x) a.r1[row0 * D + i] = r[i];
  __syncthreads();
  cross_block_rows<kDrop, true>(a, xb, cf, r, qb, cc, ws, row0, nrow);
  for (int i = tid; i < nrow * D; i += blockDim.x) a.r2[row0 * D + i] = r[i];
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln2_w, a.ln2_b);
  __syncthreads();
  store_rows(xb, ld, a.h, row0, nrow, D);
  __syncthreads();

  // the FFN tail's backward (LN3): r <- dh
  FfnBwdArgs fb;
  fb.dout = a.dout;
  fb.w1 = a.w1; fb.b1 = a.b1; fb.w2 = a.w2; fb.b2 = a.b2; fb.lnb_w = a.ln3_w;
  fb.gd = a.gd; fb.da = a.da; fb.dy = a.dy;
  fb.M = a.M; fb.D = D; fb.F = a.F; fb.act = a.act;
  fb.mask_hid = kMaskHid; fb.mask_out = kMaskOut;
  fb.drop = a.drop;
  ffn_tail_backward_rows<kDrop>(fb, L, smem, row0, nrow, lnpart + 4 * D);

  // LN2's backward: r <- dr2; dco = dr2 * m3 (bf16) in xb and scratch
  block_ln_bwd_rows(a.r2, row0, nrow, r, D, a.ln2_w, cf, lnpart + 2 * D);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    float v = row < nrow ? r[i] : 0.f;
    if (kDrop) v *= keep_scale(a.drop, kMaskCaRes, (row0 + row) * D + c);
    const bf16 b = tob(v);
    xb[row * ld + c] = b;
    if (row < nrow) a.dco[(row0 + row) * D + c] = b;
  }
  __syncthreads();
  // dcc = dco Wco (f32, cf); q back into xb (plain loads: this block's rows)
  block_gemm_nn(xb, ld, a.ca_out_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    xb[row * ld + c] = row < nrow ? a.q[(row0 + row) * D + c] : tob(0.f);
  }
  __syncthreads();
  cross_attend_bwd_rows<kDrop>(a, xb, ld, cf, ldc, dyb, ps, pa, row0, nrow);
  __syncthreads();
  kv_partials(a, xb, ld, cf, ldc, ps, pa, row0, nrow);
  // dt1 = dr2 + dq Wq
  block_gemm_nn(dyb, ld, a.ca_in_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x)
    r[i] += cf[(i / D) * ldc + i % D];
  __syncthreads();
  // LN1's backward: r <- dr1; the self-attention's residual dropout and
  // out-projection backward
  block_ln_bwd_rows(a.r1, row0, nrow, r, D, a.ln1_w, cf, lnpart);
  dattn_rows<kDrop>(r, xb, a.dr, a.dattn, D, a.drop, kMaskSaRes, row0, nrow);
  dctx_rows(xb, dyb, cf, ws, a.sa_out_w, a.ctx, a.dctx, a.delta, D, a.H,
            row0, nrow);
}

inline bool dec_shape_ok(int B, int T, int L, int D, int H, int F) {
  return shape_ok(B, T, D, H) && T >= kRows && L >= 1 && L <= kMaxMem &&
         F % kBC == 0 && F >= kBC && F <= 1024;
}

void fill_params(DecTail& a, const bf16** q) {
  a.sa_out_w = q[2]; a.sa_out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.ca_in_w = q[6]; a.ca_in_b = q[7]; a.ca_out_w = q[8]; a.ca_out_b = q[9];
  a.ln2_w = q[10]; a.ln2_b = q[11]; a.w1 = q[12]; a.b1 = q[13];
  a.w2 = q[14]; a.b2 = q[15]; a.ln3_w = q[16]; a.ln3_b = q[17];
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D] bf16, kvalid [M] f32, mem [B*L, D] bf16, mvalid [B*L] f32,
// the 18 parameters (bf16: sa_in_w [3D, D], sa_in_b, sa_out_w, sa_out_b,
// ln1_w, ln1_b, ca_in_w [3D, D], ca_in_b, ca_out_w, ca_out_b, ln2_w, ln2_b,
// w1 [F, D], b1, w2 [D, F], b2, ln3_w, ln3_b), then what the backward
// reuses: qkv [M, 3D], ctx [M, D] (bf16), lse [M, H] (f32), memkv
// [B*L, 2D] (bf16); out [M, D] (bf16).  ints: B, T, L, D, H, F, act, seed
// lo, seed hi.  floats: rate.
extern "C" int train_decoder_layer_forward(const void** p, const int* n,
                                           const float* f,
                                           void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int B = n[0], T = n[1], Lm = n[2], D = n[3], H = n[4], F = n[5];
  if (!dec_shape_ok(B, T, Lm, D, H, F)) return cudaErrorInvalidValue;
  const int M = B * T, ML = B * Lm;
  const Dropout drop = make_dropout(n[7], n[8], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = reinterpret_cast<const float*>(p[1]);
  const bf16** q = w + 4;
  bf16* qkv = const_cast<bf16*>(w[22]);
  bf16* ctx = const_cast<bf16*>(w[23]);
  float* lse = reinterpret_cast<float*>(const_cast<void*>(p[24]));
  bf16* memkv = const_cast<bf16*>(w[25]);
  DecTail a = {};
  a.x = x; a.ctx = ctx; a.memkv = memkv;
  a.mvalid = reinterpret_cast<const float*>(p[3]);
  fill_params(a, q);
  a.out = const_cast<bf16*>(w[26]);
  a.M = M; a.T = T; a.L = Lm; a.D = D; a.H = H; a.F = F; a.act = n[6];
  a.drop = drop;
  const FfnArgs fa = tail_args(a);

  const size_t rb = row_gemm_bytes(D);
  const FfnLayout Lt = ffn_layout(D, F, tail_hid_min(D, H));
  static SmemGrant g_lin, g_t0, g_t1;
  if (!allow_smem(linear_kernel, rb, g_lin) ||
      !allow_smem(dec_tail_fwd_kernel<false>, Lt.total, g_t0) ||
      !allow_smem(dec_tail_fwd_kernel<true>, Lt.total, g_t1))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  linear_kernel<<<dim3(blocks, (3 * D + kChunk - 1) / kChunk), kThreads, rb,
                  stream>>>(x, M, D, q[0], q[1], 3 * D, qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  linear_kernel<<<dim3((ML + kRows - 1) / kRows,
                       (2 * D + kChunk - 1) / kChunk),
                  kThreads, rb, stream>>>(w[2], ML, D, q[6] + (size_t)D * D,
                                          q[7] + D, 2 * D, memkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_attn_fwd(qkv, kvalid, ctx, lse, B, T, D, H, drop, on,
                             stream)) != cudaSuccess)
    return err;
  if (on)
    dec_tail_fwd_kernel<true><<<blocks, kThreads, Lt.total, stream>>>(a, fa,
                                                                      Lt);
  else
    dec_tail_fwd_kernel<false><<<blocks, kThreads, Lt.total, stream>>>(a, fa,
                                                                       Lt);
  return cudaGetLastError();
}

// ptrs: x [M, D] bf16, kvalid [M] f32, mem [B*L, D] bf16, mvalid [B*L] f32,
// dout [M, D] bf16; the 18 parameters (bf16, the forward's order); the
// forward's qkv, ctx (bf16), lse (f32), memkv (bf16); scratch r1, r2
// [M, D] (f32), t1, q, cc, h [M, D], gd, da [M, F], dy, dco, dq, dr, dattn,
// dctx [M, D] (bf16), delta [M, H] (f32), dqkv [M, 3D] (bf16), kvpart
// [blocks, 2, L, 2D] (f32), dkv [B*L, 2D] (bf16), lnpart [blocks, 6 D],
// wpart [max(split, split_mem), max(3 D D, F D)] (f32); dx [M, D], dmem
// [B*L, D] (bf16); the 18 parameter gradients (f32, the forward's order).
// ints: B, T, L, D, H, F, act, seed lo, seed hi, split, split_mem.
// floats: rate.
extern "C" int train_decoder_layer_backward(const void** p, const int* n,
                                            const float* f,
                                            void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  auto fptr = [&](int i) {
    return reinterpret_cast<float*>(const_cast<void*>(p[i]));
  };
  auto bptr = [&](int i) { return const_cast<bf16*>(w[i]); };
  const int B = n[0], T = n[1], Lm = n[2], D = n[3], H = n[4], F = n[5];
  const int split = n[9], split_mem = n[10];
  if (!dec_shape_ok(B, T, Lm, D, H, F) || split < 1 || split_mem < 1)
    return cudaErrorInvalidValue;
  const int M = B * T, ML = B * Lm;
  const Dropout drop = make_dropout(n[7], n[8], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = fptr(1);
  const bf16* mem = w[2];
  const bf16** q = w + 5;
  const bf16 *qkv = w[23], *ctx = w[24];
  const float* lse = fptr(25);
  DecTail a = {};
  a.x = x; a.ctx = ctx; a.memkv = w[26]; a.mvalid = fptr(3); a.dout = w[4];
  fill_params(a, q);
  a.r1 = fptr(27); a.r2 = fptr(28);
  a.t1 = bptr(29); a.q = bptr(30); a.cc = bptr(31); a.h = bptr(32);
  a.gd = bptr(33); a.da = bptr(34); a.dy = bptr(35); a.dco = bptr(36);
  a.dq = bptr(37); a.dr = bptr(38); a.dattn = bptr(39); a.dctx = bptr(40);
  a.delta = fptr(41);
  bf16* dqkv = bptr(42);
  a.kvpart = fptr(43);
  bf16* dkv = bptr(44);
  a.lnpart = fptr(45);
  float* wpart = fptr(46);
  bf16* dx = bptr(47);
  bf16* dmem = bptr(48);
  float* g[18];
  for (int i = 0; i < 18; ++i) g[i] = fptr(49 + i);
  a.M = M; a.T = T; a.L = Lm; a.D = D; a.H = H; a.F = F; a.act = n[6];
  a.drop = drop;

  const size_t rb2 = row_gemm_bytes(2 * D), rb3 = row_gemm_bytes(3 * D);
  const FfnBwdLayout Lt = ffn_bwd_layout(D, F, tail_hid_min(D, H));
  static SmemGrant g_t0, g_t1, g_nn;
  if (!allow_smem(dec_tail_bwd_kernel<false>, Lt.total, g_t0) ||
      !allow_smem(dec_tail_bwd_kernel<true>, Lt.total, g_t1) ||
      !allow_smem(linear_nn_kernel, rb3 > rb2 ? rb3 : rb2, g_nn))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  if (on)
    dec_tail_bwd_kernel<true><<<blocks, kThreads, Lt.total, stream>>>(a, Lt);
  else
    dec_tail_bwd_kernel<false><<<blocks, kThreads, Lt.total, stream>>>(a, Lt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // LayerNorm gradients: ln1, ln2, ln3 = g[4, 5], g[10, 11], g[16, 17]
  float* ln_out[6] = {g[4], g[5], g[10], g[11], g[16], g[17]};
  for (int k = 0; k < 6; ++k)
    if ((err = reduce_partials(a.lnpart + k * D, blocks, (size_t)6 * D, D,
                               ln_out[k], stream)) != cudaSuccess)
      return err;
  // the memory's gradient: dk, dv per sample, then through Wk, Wv
  const long long nkv = (long long)ML * 2 * D;
  kv_reduce_kernel<<<(unsigned)((nkv + 255) / 256), 256, 0, stream>>>(
      a.kvpart, B, T, Lm, D, dkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  linear_nn_kernel<<<(ML + kRows - 1) / kRows, kThreads, rb2, stream>>>(
      dkv, ML, 2 * D, q[6] + (size_t)D * D, D, nullptr, dmem);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the self-attention
  if ((err = launch_attn_bwd(qkv, a.dctx, kvalid, lse, a.delta, dqkv, B, T, D,
                             H, drop, on, stream)) != cudaSuccess)
    return err;
  linear_nn_kernel<<<blocks, kThreads, rb3, stream>>>(dqkv, M, 3 * D, q[0], D,
                                                      a.dr, dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // weight and bias gradients
  struct WG { const bf16* A; int N1; const bf16* Bm; int N2; int rows, sp;
              float* out; };
  const WG wg[7] = {
      {dqkv, 3 * D, x, D, M, split, g[0]},
      {a.dattn, D, ctx, D, M, split, g[2]},
      {a.dq, D, a.t1, D, M, split, g[6]},
      {dkv, 2 * D, mem, D, ML, split_mem, g[6] + (size_t)D * D},
      {a.dco, D, a.cc, D, M, split, g[8]},
      {a.da, F, a.h, D, M, split, g[12]},
      {a.dy, D, a.gd, F, M, split, g[14]}};
  float* bias_out[7] = {g[1], g[3], g[7], g[7] + D, g[9], g[13], g[15]};
  for (int k = 0; k < 7; ++k) {
    if ((err = weight_grad(wg[k].A, wg[k].N1, wg[k].N1, wg[k].Bm, wg[k].N2,
                           wg[k].N2, wg[k].rows, wg[k].sp, wpart, wg[k].out,
                           stream)) != cudaSuccess)
      return err;
    if ((err = bias_grad(wg[k].A, wg[k].N1, wg[k].N1, wg[k].rows, wg[k].sp,
                         wpart, bias_out[k], stream)) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

// ptrs: pm1 [B, H, T, T], rm1 [M, D], pm2 [B, H, T, L], rm2 [M, D], m1
// [M, F], m2 [M, D] (f32): the six keep-masks of a seed.  ints: B, T, L, D,
// H, F, seed lo, seed hi.  floats: rate.
extern "C" int train_decoder_layer_masks(const void** p, const int* n,
                                         const float* f, void* stream_ptr) {
  const unsigned long long B = n[0], T = n[1], Lm = n[2], D = n[3], H = n[4],
                           F = n[5];
  const Dropout d = make_dropout(n[6], n[7], f[0]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned long long M = B * T;
  const unsigned long long sizes[6] = {B * H * T * T, M * D, B * H * T * Lm,
                                       M * D,         M * F, M * D};
  for (uint32_t k = 0; k < 6; ++k) {
    cudaError_t err = fill_mask(
        reinterpret_cast<float*>(const_cast<void*>(p[k])), sizes[k], d, k,
        stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
