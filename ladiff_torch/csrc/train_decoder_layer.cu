// Kernel 13: one whole post-norm transformer decoder layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_decoder_layer.py
// train_decoder_layer).  See ladiff_torch/ops/train_decoder_layer.py for the
// math, the dropout contract, what is saved and the gradient schemes.
//
// Forward, a fixed sequence of launches:
//   linear64_kernel x2   qkv = x Wqkv^T + bqkv; the memory's k, v (rows
//                        D..3D of the cross-attention in-projection), once
//                        per sample                             (tail64.cuh)
//   attn_fwd_kernel      register-resident flash tile, probability dropout
//                        (mask 0); ctx, log-sum-exp  (flash_tile.cuh, 8's)
//   dec_tail_fwd_kernel  per 64-row block, from ctx to the layer's output:
//                        dec_tail64.cuh's body (K2's), masks 1 to 5
// Backward:
//   dec_tail_bwd_ffn_kernel    per 64-row block: the forward body again up
//                        to h = LN2(r2), keeping r1, r2, t1, q, cc and h;
//                        the FFN segment's backward (tail64.cuh's
//                        ffn_ln_bwd, kernel 12's: LN3, the FFN chunk by
//                        chunk); LN2's backward; dr2 (f32) over r2
//   dec_tail_bwd_cross_kernel  per 64-row block, from dr2 to dctx: mask 3
//                        and the cross-attention out-projection's backward;
//                        the cross-attention's backward (dq; each memory
//                        row's dk, dv summed over the block's rows of each
//                        sample it holds); the q projection's backward;
//                        LN1's backward; mask 1 and the self-attention
//                        out-projection's backward (dr, dattn, dctx, delta)
//   reduce_kernel        LayerNorm gradients over the blocks
//   kv_reduce_kernel     dk, dv per sample: the partial sums of the blocks
//                        that hold its rows, in block order (no atomics)
//   linear64_kernel      dmem = [dk dv] Wkv
//   attn_bwd_kernel x2   dq; dk, dv of the self-attention   (8's)
//   linear64_kernel      dx = dr1 + dqkv Wqkv
//   wgrad / colsum       the 14 weight and bias gradients
//
// What bounds it on the H100: ~25 GFLOP forward and ~49 GFLOP backward at
// 64 x 196 rows against tens of MB: the tensor cores, and the weight bytes
// each block streams from L2.  The tails and projections run tail64.cuh's
// 64-row blocks of 16 warps (mma.sync register accumulators, a three-stage
// cp.async weight ring), so each byte of weight serves 64 rows; the
// residuals and LayerNorms stay in the accumulator registers.
#include "dec_tail64.cuh"
#include "train_attn.cuh"

namespace {

// The backward's tensors beyond the forward body's.  r2 takes dr2 (f32)
// from dec_tail_bwd_ffn_kernel; kvpart [blocks, slots, L, 2D] (f32): each
// block's sums of dk, dv per memory row over its rows of each of the <=
// `slots` samples it holds; lnpart [blocks, 6 D].
struct DecBwd {
  DecTail64 f;
  bf16 *dco, *dq, *dr, *dattn, *dctx;
  float *delta, *lnpart, *kvpart;
  int slots;
};

// Per 64-row block: the forward body again (keeping r1, r2, t1, q, cc, h),
// the FFN segment's backward, LN2's backward: dr2 (f32) over r2; LN3's and
// LN2's gradient sums to lnpart[4D:6D], [2D:4D].
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
dec_tail_bwd_ffn_kernel(DecBwd a) {
  constexpr int D = 32 * NT;
  const DecTail64& f = a.f;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem m = tail_smem(smem, D, true);
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(f.M - row0));
  float* lnpart = a.lnpart + (size_t)blockIdx.x * 6 * D;
  float h[kTMT][NT][4], mean2[kTMT][2], rstd2[kTMT][2];
  dec_front<NT, kDrop, true>(h, mean2, rstd2, f, m, row0, nrow);
  ffn_ln_bwd<NT, kDrop>(h, f.ffn, f.drop, m, row0, nrow, lnpart + 4 * D);
  // LN2's backward from the kept r2: h <- dr2
  float y[kTMT][NT][4];
  load_rows_f32(y, f.r2, row0, nrow);
  tail_ln_bwd_rows(y, h, mean2, rstd2, f.ln2_w, m, lnpart + 2 * D);
  store_rows_f32(h, f.r2, row0, nrow);
}

// dec_tail_bwd_cross_kernel's shared memory: xa [64][D + 8] bf16, then one
// region that is the weight ring during the products and, between them, q
// [64][D + 8] (bf16), dcc [64][D + 4] (f32) and the probabilities' terms ps,
// pa [64][H][8] (f32); then the row and column exchanges.  dctx (xb) takes
// the region's start after the last product.
__host__ __device__ inline size_t cross_region_bytes(int D, int H) {
  const size_t rows = (size_t)kTRows * (D + 8) * sizeof(bf16) +
                      (size_t)kTRows * (D + 4) * sizeof(float) +
                      2 * (size_t)kTRows * H * kMaxMem * sizeof(float);
  return rows > kTRingBytes ? rows : kTRingBytes;
}

inline size_t cross_smem_bytes(int D, int H) {
  return (size_t)kTRows * (D + 8) * sizeof(bf16) + cross_region_bytes(D, H) +
         2 * kTRows * 4 * sizeof(float) + (size_t)kTRowWarps * 2 * D * sizeof(float);
}

struct CrossSmem {
  TailSmem t;
  bf16* qs;
  float *dcc, *ps, *pa;
};

__device__ __forceinline__ CrossSmem cross_smem(unsigned char* smem, int D,
                                                int H) {
  CrossSmem m;
  m.t.xa = reinterpret_cast<bf16*>(smem);
  unsigned char* region = smem + (size_t)kTRows * (D + 8) * sizeof(bf16);
  m.t.ring = m.t.xb = m.qs = reinterpret_cast<bf16*>(region);
  m.t.hid = nullptr;
  m.dcc = reinterpret_cast<float*>(m.qs + kTRows * (D + 8));
  m.ps = m.dcc + kTRows * (D + 4);
  m.pa = m.ps + kTRows * H * kMaxMem;
  m.t.red = reinterpret_cast<float*>(region + cross_region_bytes(D, H));
  m.t.colbuf = m.t.red + 2 * kTRows * 4;
  return m;
}

// The cross-attention's backward for the block's rows, one warp per (row,
// head): with dcc (f32) and q (bf16) in shared memory, the probabilities
// again; ds_j = p_j (dcc . v_j m_j - sum_k p_k dcc . v_k m_k);
// dq = scale sum_j ds_j k_j (bf16) into xa and the scratch; ds_j and
// a_j = p_j m_j into ps, pa for the memory rows' sums.
template <bool kDrop>
__device__ __forceinline__ void cross_bwd64(const DecBwd& a,
                                            const CrossSmem& m, size_t row0,
                                            int nrow) {
  const DecTail64& f = a.f;
  const int D = f.D, H = f.H, Dh = D / H, L = f.L;
  const int lane = threadIdx.x & 31, j = lane >> 2, g = lane & 3;
  const float scale = rsqrtf((float)Dh);
  for (int p = threadIdx.x >> 5; p < kTRows * H; p += kTThreads / 32) {
    const int row = p / H, h = p % H;
    const int e0 = (row * H + h) * kMaxMem;
    bf16* dq = m.t.xa + row * (D + 8) + h * Dh;
    if (row >= nrow) {
      for (int d = 2 * lane; d < Dh; d += 64) st2(dq + d, 0.f, 0.f);
      if (lane < kMaxMem) m.ps[e0 + lane] = m.pa[e0 + lane] = 0.f;
      continue;
    }
    const size_t grow = row0 + row;
    float keep;
    const float pr = cross_prob64<kDrop>(f, m.qs + row * (D + 8) + h * Dh,
                                         grow, h, &keep);
    const bf16* kv = f.memkv + (grow / f.T) * L * 2 * D + h * Dh;
    float dA = 0.f;
    if (j < L)
      dA = quarter_dot(m.dcc + row * (D + 4) + h * Dh,
                       kv + (size_t)j * 2 * D + D, Dh, g);
    const float dp = quad_sum(dA) * keep;
    const float ds = pr * (dp - quads_sum(pr * dp));
    float w[kMaxMem];
#pragma unroll
    for (int k = 0; k < kMaxMem; ++k)
      w[k] = __shfl_sync(0xffffffffu, ds, 4 * k);
    for (int d = 2 * lane; d < Dh; d += 64) {
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxMem; ++k)
        if (k < L) {
          const float2 kk = ldg2(kv + (size_t)k * 2 * D + d);
          c0 += w[k] * kk.x;
          c1 += w[k] * kk.y;
        }
      c0 *= scale;
      c1 *= scale;
      st2(dq + d, c0, c1);
      st2(a.dq + grow * D + h * Dh + d, c0, c1);
    }
    if (g == 0) {
      m.ps[e0 + j] = ds;
      m.pa[e0 + j] = pr * keep;
    }
  }
}

// The block's sums over its rows of each sample it holds of
// dk_j = scale sum ds_j q and dv_j = sum a_j dcc, in row order, to
// kvpart[block][slot][j][0:D | D:2D].
__device__ __forceinline__ void kv_partials64(const DecBwd& a,
                                              const CrossSmem& m,
                                              size_t row0, int nrow) {
  const DecTail64& f = a.f;
  const int D = f.D, H = f.H, Dh = D / H, L = f.L;
  const float scale = rsqrtf((float)Dh);
  const long long s0 = (long long)row0 / f.T;
  for (int slot = 0; slot < a.slots; ++slot) {
    const long long b = s0 + slot;
    const int lo = (int)max(0LL, b * f.T - (long long)row0);
    const int hi = (int)min((long long)nrow, (b + 1) * f.T - (long long)row0);
    if (lo >= hi) continue;
    float* out = a.kvpart + ((size_t)blockIdx.x * a.slots + slot) * L * 2 * D;
    for (int i = threadIdx.x; i < L * D; i += kTThreads) {
      const int j = i / D, c = i % D, h = c / Dh;
      float sk = 0.f, sv = 0.f;
      for (int row = lo; row < hi; ++row) {
        const int e = (row * H + h) * kMaxMem + j;
        sk += m.ps[e] * tof(m.qs[row * (D + 8) + c]);
        sv += m.pa[e] * m.dcc[row * (D + 4) + c];
      }
      out[(size_t)j * 2 * D + c] = sk * scale;
      out[(size_t)j * 2 * D + D + c] = sv;
    }
  }
}

// Per 64-row block, from dr2 (over r2) to dctx: dco = dr2 * m3 (to the
// scratch), dcc = dco Wco; the cross-attention's backward (dq, the memory
// rows' partial sums); dt1 = dr2 + dq Wq; LN1's backward from the kept r1
// (its gradient sums to lnpart[0:2D]); dr, dattn, dctx and delta.
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
dec_tail_bwd_cross_kernel(DecBwd a) {
  constexpr int D = 32 * NT;
  const DecTail64& f = a.f;
  extern __shared__ __align__(128) unsigned char smem[];
  const CrossSmem m = cross_smem(smem, D, f.H);
  const TailLane t = tail_lane();
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(f.M - row0));
  // d = dr2; dco = dr2 * m3 (bf16) into xa and the scratch
  float d[kTMT][NT][4], y[kTMT][NT][4];
  load_rows_f32(d, f.r2, row0, nrow);
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float k0 = 1.f, k1 = 1.f;
        if (kDrop)
          keep_scale2(f.drop, kMaskCaRes,
                      (row0 + trow(t, mt, hf)) * D + tcol<NT>(t, nt), k0, k1);
        y[mt][nt][2 * hf] = d[mt][nt][2 * hf] * k0;
        y[mt][nt][2 * hf + 1] = d[mt][nt][2 * hf + 1] * k1;
      }
  store_rows(y, m.t.xa, D + 8, a.dco, row0, nrow);
  // dcc = dco Wco (f32) and q (bf16) into the region
  tail_zero(y);
  tail_gemm<NT, true>(y, m.t.xa, D + 8, f.ca_out_w, D, D, m.t.ring);
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(m.dcc + trow(t, mt, hf) * (D + 4) +
                                   tcol<NT>(t, nt)) =
            make_float2(y[mt][nt][2 * hf], y[mt][nt][2 * hf + 1]);
  load_rows64<D>(f.q, row0, nrow, m.qs);
  cp_async_wait<0>();
  __syncthreads();
  cross_bwd64<kDrop>(a, m, row0, nrow);
  __syncthreads();
  kv_partials64(a, m, row0, nrow);
  // dt1 = dr2 + dq Wq (the product starts with a barrier: the region's
  // readers are done before the ring reuses it)
  tail_gemm<NT, true>(d, m.t.xa, D + 8, f.ca_in_w, D, D, m.t.ring);
  // LN1's backward from the kept r1: d <- dr1
  float mean1[kTMT][2], rstd1[kTMT][2];
  load_rows_f32(y, f.r1, row0, nrow);
  tail_normalize(y, D, m.t.red, mean1, rstd1);  // y <- xhat1
  float gw[NT][2], gb[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) gw[nt][0] = gw[nt][1] = gb[nt][0] = gb[nt][1] = 0.f;
  tail_ln_bwd(y, d, rstd1, f.ln1_w, D, m.t.red, gw, gb);
  tail_col_sums(gw, gb, D, m.t.colbuf,
                a.lnpart + (size_t)blockIdx.x * 6 * D);
  // mask 1 and the self-attention out-projection's backward
  attn_out_bwd<NT, kDrop>(d, f.ctx, f.sa_out_w, f.drop, kMaskSaRes, a.dr,
                          a.dattn, a.dctx, a.delta, f.H, m.t, row0, nrow);
}

// dkv[b * L + j][c] = the sum of kvpart over the blocks that hold rows of
// sample b, in block order.
__global__ void kv_reduce_kernel(const float* part, int B, int T, int L,
                                 int D, int slots, bf16* dkv) {
  const long long per = (long long)L * 2 * D;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * per) return;
  const long long b = idx / per, rem = idx % per;
  const long long first = b * T / kTRows, last = ((b + 1) * T - 1) / kTRows;
  float s = 0.f;
  for (long long blk = first; blk <= last; ++blk) {
    const long long slot = b - blk * kTRows / T;
    s += part[(blk * slots + slot) * per + rem];
  }
  dkv[idx] = tob(s);
}

template <int NT, bool kDrop>
static inline cudaError_t bwd_tails_d(const DecBwd& a, cudaStream_t stream) {
  static SmemGrant g_ffn, g_cross;
  constexpr int D = 32 * NT;
  const size_t b_ffn = tail_smem_bytes(D, true, true);
  const size_t b_cross = cross_smem_bytes(D, a.f.H);
  if (!allow_smem(dec_tail_bwd_ffn_kernel<NT, kDrop>, b_ffn, g_ffn) ||
      !allow_smem(dec_tail_bwd_cross_kernel<NT, kDrop>, b_cross, g_cross))
    return cudaErrorInvalidValue;
  const int blocks = (a.f.M + kTRows - 1) / kTRows;
  dec_tail_bwd_ffn_kernel<NT, kDrop>
      <<<blocks, kTThreads, b_ffn, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dec_tail_bwd_cross_kernel<NT, kDrop>
      <<<blocks, kTThreads, b_cross, stream>>>(a);
  return cudaGetLastError();
}

template <bool kDrop>
static inline cudaError_t launch_bwd_tails(const DecBwd& a,
                                           cudaStream_t stream) {
  switch (a.f.D) {
    case 64: return bwd_tails_d<2, kDrop>(a, stream);
    case 128: return bwd_tails_d<4, kDrop>(a, stream);
    case 192: return bwd_tails_d<6, kDrop>(a, stream);
    case 256: return bwd_tails_d<8, kDrop>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline bool dec_shape_ok(int B, int T, int L, int D, int H, int F) {
  return shape_ok(B, T, D, H) && T >= kRows && L >= 1 && L <= kMaxMem &&
         F % kTFC == 0 && F >= kTFC && F <= 1024;
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
  DecTail64 a = {};
  a.x = x; a.ctx = ctx; a.memkv = memkv;
  a.mvalid = reinterpret_cast<const float*>(p[3]);
  dec_fill_params(a, q, F, n[6]);
  a.out = const_cast<bf16*>(w[26]);
  a.M = M; a.T = T; a.L = Lm; a.D = D; a.H = H;
  a.drop = drop;

  cudaError_t err;
  if ((err = launch_linear64<false>(x, M, D, q[0], D, q[1], nullptr, 3 * D,
                                    qkv, stream)) != cudaSuccess)
    return err;
  if ((err = launch_linear64<false>(w[2], ML, D, q[6] + (size_t)D * D, D,
                                    q[7] + D, nullptr, 2 * D, memkv,
                                    stream)) != cudaSuccess)
    return err;
  if ((err = launch_attn_fwd(qkv, kvalid, ctx, lse, B, T, D, H, drop, on,
                             stream)) != cudaSuccess)
    return err;
  return on ? launch_dec_tail_fwd<true>(a, stream)
            : launch_dec_tail_fwd<false>(a, stream);
}

// ptrs: x [M, D] bf16, kvalid [M] f32, mem [B*L, D] bf16, mvalid [B*L] f32,
// dout [M, D] bf16; the 18 parameters (bf16, the forward's order); the
// forward's qkv, ctx (bf16), lse (f32), memkv (bf16); scratch r1, r2
// [M, D] (f32), t1, q, cc, h [M, D], gd, da [M, F], dy, dco, dq, dr, dattn,
// dctx [M, D] (bf16), delta [M, H] (f32), dqkv [M, 3D] (bf16), kvpart
// [blocks, slots, L, 2D] (f32), dkv [B*L, 2D] (bf16), lnpart [blocks, 6 D],
// wpart [max(split, split_mem), max(3 D D, F D)] (f32); dx [M, D], dmem
// [B*L, D] (bf16); the 18 parameter gradients (f32, the forward's order).
// Blocks of 64 rows.  ints: B, T, L, D, H, F, act, seed lo, seed hi, split,
// split_mem, slots.  floats: rate.
extern "C" int train_decoder_layer_backward(const void** p, const int* n,
                                            const float* f,
                                            void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  auto fptr = [&](int i) {
    return reinterpret_cast<float*>(const_cast<void*>(p[i]));
  };
  auto bptr = [&](int i) { return const_cast<bf16*>(w[i]); };
  const int B = n[0], T = n[1], Lm = n[2], D = n[3], H = n[4], F = n[5];
  const int split = n[9], split_mem = n[10], slots = n[11];
  if (!dec_shape_ok(B, T, Lm, D, H, F) || split < 1 || split_mem < 1 ||
      slots < 1 + (T + 62) / T)
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
  DecBwd a = {};
  a.f.x = x; a.f.ctx = ctx; a.f.memkv = w[26]; a.f.mvalid = fptr(3);
  dec_fill_params(a.f, q, F, n[6]);
  a.f.ffn.dout = w[4];
  a.f.r1 = fptr(27); a.f.r2 = fptr(28);
  a.f.t1 = bptr(29); a.f.q = bptr(30); a.f.cc = bptr(31); a.f.h = bptr(32);
  a.f.ffn.gd = bptr(33); a.f.ffn.da = bptr(34); a.f.ffn.dy = bptr(35);
  a.dco = bptr(36); a.dq = bptr(37); a.dr = bptr(38); a.dattn = bptr(39);
  a.dctx = bptr(40);
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
  a.f.M = M; a.f.T = T; a.f.L = Lm; a.f.D = D; a.f.H = H;
  a.f.drop = drop;
  a.slots = slots;

  const int blocks = (M + kTRows - 1) / kTRows;
  cudaError_t err;
  if ((err = on ? launch_bwd_tails<true>(a, stream)
                : launch_bwd_tails<false>(a, stream)) != cudaSuccess)
    return err;
  // LayerNorm gradients: ln1, ln2, ln3 = g[4, 5], g[10, 11], g[16, 17]
  float* ln_out[6] = {g[4], g[5], g[10], g[11], g[16], g[17]};
  for (int k = 0; k < 6; ++k)
    if ((err = reduce_partials(a.lnpart + k * D, blocks, (size_t)6 * D, D,
                               ln_out[k], stream)) != cudaSuccess)
      return err;
  // the memory's gradient: dk, dv per sample, then through Wk, Wv
  const long long nkv = (long long)ML * 2 * D;
  kv_reduce_kernel<<<(unsigned)((nkv + 255) / 256), 256, 0, stream>>>(
      a.kvpart, B, T, Lm, D, slots, dkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_linear64<true>(dkv, ML, 2 * D, q[6] + (size_t)D * D, D,
                                   nullptr, nullptr, D, dmem, stream)) !=
      cudaSuccess)
    return err;
  // the self-attention
  if ((err = launch_attn_bwd(qkv, a.dctx, kvalid, lse, a.delta, dqkv, B, T, D,
                             H, drop, on, stream)) != cudaSuccess)
    return err;
  if ((err = launch_linear64<true>(dqkv, M, 3 * D, q[0], D, nullptr, a.dr, D,
                                   dx, stream)) != cudaSuccess)
    return err;
  // weight and bias gradients
  struct WG { const bf16* A; int N1; const bf16* Bm; int N2; int rows, sp;
              float* out; };
  const WG wg[7] = {
      {dqkv, 3 * D, x, D, M, split, g[0]},
      {a.dattn, D, ctx, D, M, split, g[2]},
      {a.dq, D, a.f.t1, D, M, split, g[6]},
      {dkv, 2 * D, mem, D, ML, split_mem, g[6] + (size_t)D * D},
      {a.dco, D, a.f.cc, D, M, split, g[8]},
      {a.f.ffn.da, F, a.f.h, D, M, split, g[12]},
      {a.f.ffn.dy, D, a.f.ffn.gd, F, M, split, g[14]}};
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
