// The post-norm FFN tail of a transformer layer on tail64.cuh's 64-row
// blocks, shared by kernel 5 (postnorm_ffn.cu, inference) and kernel 9
// (train_ffn.cu, forward with dropout and backward):
//   h = LN1(x);  gd = act(h W1^T + b1) * m1;  out = LN2(h + (gd W2^T + b2) * m2)
// Rounding points as in the TPU kernels: h and gd (and in the backward da
// and dy) are rounded to bf16 before their products, everything else is
// float32.  Dropout: mask 0 on [M, F], mask 1 on [M, D].
//
// Forward, ffn_tail_fwd_kernel: per 64-row block, the x rows as the f32
// residual sum in the accumulator layout, LN1 on the registers (h to xa),
// the FFN in 128-column hidden chunks, the residual, LN2, the store: the
// FFN segment of kernel 12's tail (ffn_seg_forward) without its
// out-projection.  A launch whose blocks cannot fill the card runs each
// block on a cluster of C CTAs (C 2 or 4, F / C a multiple of 128; the
// geometry comes from ops/postnorm_ffn.py ffn_geometry): CTA c computes LN1
// of all D columns, the hidden columns [c F / C, (c + 1) F / C) and its
// partial of y over them.  The partials are reduce-scattered through
// distributed shared memory: CTA c owns the D / C output columns of its
// warps with column quarter wc, wc C / 4 == c, receives the other CTAs'
// partials of them and adds all C in rank order, so the result does not
// depend on timing.  LN2's row statistics over the D columns are each CTA's
// (mean, M2) over its columns, combined in rank order (Chan's formula); each
// CTA stores its columns.
//
// Backward, ffn_tail_bwd_kernel (one CTA per block): LN1 again from x (mean
// and rstd kept), h to xa and the scratch; the FFN segment's backward
// (ffn_ln_bwd: gd, dy, da to the scratch, LN2's gradient sums, dh); LN1's
// backward from x reloaded, dx, LN1's gradient sums; and the column sums of
// da and dy (the bias gradients) beside them in the block's partials.
#pragma once

#include "cluster.cuh"
#include "tail64.cuh"

namespace ladiff {

constexpr uint32_t kFfnMaskHid = 0u, kFfnMaskOut = 1u;

struct FfnTail {
  const bf16* x;
  const bf16 *ln1_w, *ln1_b;
  FfnSeg ffn;  // w1, b1, w2, b2, ln2; the backward's dout, gd, da, dy
  bf16* out;   // the forward's output, the backward's dx
  bf16* h;     // backward scratch [M, D]
  float* part; // backward: per block [ln1_w, ln1_b, ln2_w, ln2_b (D each),
               // b1 (F), b2 (D)]
  int M, C;
  Dropout drop;
};

// Partials of one backward block: 5 D + F floats.
__host__ __device__ inline int ffn_part_stride(int D, int F) {
  return 5 * D + F;
}

// The x rows row0 .. row0 + 63 of [M, D] (bf16) as f32 in the accumulator
// layout, zero rows past the end.
template <int NT>
__device__ __forceinline__ void load_rows_bf16(float (&v)[kTMT][NT][4],
                                               const bf16* g, size_t row0,
                                               int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = trow(t, mt, hf);
        const float2 r = row < nrow ? ldg2(g + (row0 + row) * D + tcol<NT>(t, nt))
                                    : make_float2(0.f, 0.f);
        v[mt][nt][2 * hf] = r.x;
        v[mt][nt][2 * hf + 1] = r.y;
      }
}

// Shared memory of a forward CTA: tail64's (xa, the hidden chunk, the ring,
// the row exchange), and on a cluster of C > 1 the received partials
// ((C - 1) x 64 x D / C floats) and the LayerNorm partials (C x 64 float2).
inline size_t ffn_fwd_smem_bytes(int D, int C) {
  const size_t base = tail_smem_bytes(D, false, false);
  if (C <= 1) return base;
  return base + (size_t)(C - 1) * kTRows * (D / C) * sizeof(float) +
         (size_t)C * kTRows * sizeof(float2);
}

// The backward CTA's: tail64's with xb and the column exchange, and the
// bias sums' row-warp buffer (kTRowWarps x (F + D) floats).
inline size_t ffn_bwd_smem_bytes(int D, int F) {
  return tail_smem_bytes(D, true, true) +
         (size_t)kTRowWarps * (F + D) * sizeof(float);
}

// The cluster's forward from LN1's output h (registers, all D columns; its
// bf16 copy in xa): CTA c of C computes the hidden columns of its share,
// reduce-scatters y, and the owners of each column finish the tail.
template <int NT, bool kDrop>
__device__ __forceinline__ void ffn_tail_cluster(float (&h)[kTMT][NT][4],
                                                 const FfnTail& a,
                                                 const TailSmem& m,
                                                 size_t row0, int nrow) {
  constexpr int D = 32 * NT;
  const TailLane t = tail_lane();
  const int C = a.C, c = cluster_rank(), W = D / C;
  const int Fc = a.ffn.F / C;
  float* recv = m.colbuf;  // [C - 1][64][W]
  float2* stats = reinterpret_cast<float2*>(recv + (C - 1) * kTRows * W);
  float y[kTMT][NT][4];
  ffn_forward<NT, kDrop>(y, a.ffn, a.drop, m, row0, nrow, nullptr, c * Fc,
                         (c + 1) * Fc);
  // the warps of column quarter wc hold CTA p's columns
  const int p = t.wc * C / 4;
  const bool own = p == c;
  cluster_wait();  // (arrived at the start) every CTA of the cluster runs
  if (!own) {
    const uint32_t slot =
        smem_addr(recv + (c < p ? c : c - 1) * kTRows * W);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int idx = trow(t, mt, hf) * W + tcol<NT>(t, nt) - p * W;
          st_peer(peer_addr(slot + idx * 4, p), y[mt][nt][2 * hf],
                  y[mt][nt][2 * hf + 1]);
        }
  }
  cluster_sync();
  float s[kTMT][2] = {}, z[kTMT][2] = {};
  if (own) {
    // y in rank order, then the residual sum of the CTA's columns
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int idx = trow(t, mt, hf) * W + tcol<NT>(t, nt) - c * W;
          float2 v = make_float2(0.f, 0.f);
          for (int r = 0; r < C; ++r) {
            float2 q;
            if (r == c) {
              q = make_float2(y[mt][nt][2 * hf], y[mt][nt][2 * hf + 1]);
            } else {
              q = *reinterpret_cast<const float2*>(
                  recv + (r < c ? r : r - 1) * kTRows * W + idx);
            }
            v.x += q.x;
            v.y += q.y;
          }
          y[mt][nt][2 * hf] = v.x;
          y[mt][nt][2 * hf + 1] = v.y;
        }
    residual_add<NT, kDrop>(h, y, a.ffn.b2, a.drop, kFfnMaskOut, row0);
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e >> 1] += h[mt][nt][e];
  }
  // LN2: each CTA's (mean, M2) over its W columns of each row, to every
  // CTA's stats[c][row]
  tail_row_sum2(s, z, m.red);
  float mean[kTMT][2], q[kTMT][2] = {};
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) mean[mt][hf] = s[mt][hf] / W;
  if (own) {
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = h[mt][nt][e] - mean[mt][e >> 1];
          q[mt][e >> 1] += d * d;
        }
  }
  tail_row_sum2(q, z, m.red);
  if (own && t.wc == c * 4 / C && t.tq == 0) {
#pragma unroll
    for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t at = smem_addr(stats + c * kTRows + trow(t, mt, hf));
        for (int d = 0; d < C; ++d)
          st_peer(peer_addr(at, d), mean[mt][hf], q[mt][hf]);
      }
  }
  cluster_sync();  // the last access to a peer's shared memory
  if (!own) return;
  float rstd[kTMT][2];
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2* st = stats + trow(t, mt, hf);
      float mu = 0.f;
      for (int r = 0; r < C; ++r) mu += st[r * kTRows].x;
      mu /= C;
      float m2 = 0.f;
      for (int r = 0; r < C; ++r) {
        const float d = st[r * kTRows].x - mu;
        m2 += st[r * kTRows].y + W * d * d;
      }
      mean[mt][hf] = mu;
      rstd[mt][hf] = rsqrtf(m2 / D + kLnEps);
    }
#pragma unroll
  for (int mt = 0; mt < kTMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[mt][nt][e] = (h[mt][nt][e] - mean[mt][e >> 1]) * rstd[mt][e >> 1];
  tail_affine(h, a.ffn.ln_w, a.ffn.ln_b);
  store_rows(h, nullptr, 0, a.out, row0, nrow);
}

// Per 64-row block (on a cluster of a.C CTAs where kCl), from x to the
// tail's output.
template <int NT, bool kDrop, bool kCl>
__global__ void __launch_bounds__(kTThreads)
ffn_tail_fwd_kernel(const __grid_constant__ FfnTail a) {
  constexpr int D = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  if (kCl) cluster_arrive();  // this CTA runs (waited on before DSMEM use)
  const TailSmem m = tail_smem(smem, D, false);
  const size_t row0 = (size_t)(blockIdx.x / (kCl ? a.C : 1)) * kTRows;
  const int nrow = min(kTRows, (int)(a.M - row0));
  float h[kTMT][NT][4], mean[kTMT][2], rstd[kTMT][2];
  load_rows_bf16(h, a.x, row0, nrow);
  tail_normalize(h, D, m.red, mean, rstd);
  tail_affine(h, a.ln1_w, a.ln1_b);
  store_rows(h, m.xa, D + 8, nullptr, row0, nrow);
  if (kCl)
    ffn_tail_cluster<NT, kDrop>(h, a, m, row0, nrow);
  else
    ffn_seg_forward<NT, kDrop>(h, a.ffn, a.drop, kFfnMaskOut, m, row0, nrow,
                               a.out);
}

// Per 64-row block, from dout to dx: see the file's head.
template <int NT, bool kDrop>
__global__ void __launch_bounds__(kTThreads)
ffn_tail_bwd_kernel(const __grid_constant__ FfnTail a) {
  constexpr int D = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem m = tail_smem(smem, D, true);
  float* bbuf = m.colbuf + kTRowWarps * 2 * D;
  const size_t row0 = (size_t)blockIdx.x * kTRows;
  const int nrow = min(kTRows, (int)(a.M - row0));
  float* part = a.part + (size_t)blockIdx.x * ffn_part_stride(D, a.ffn.F);
  float h[kTMT][NT][4], mean1[kTMT][2], rstd1[kTMT][2];
  load_rows_bf16(h, a.x, row0, nrow);
  tail_normalize(h, D, m.red, mean1, rstd1);
  tail_affine(h, a.ln1_w, a.ln1_b);
  store_rows(h, m.xa, D + 8, a.h, row0, nrow);
  ffn_ln_bwd<NT, kDrop, true>(h, a.ffn, a.drop, m, row0, nrow, part + 2 * D,
                              bbuf, part + 4 * D);
  float y[kTMT][NT][4];
  load_rows_bf16(y, a.x, row0, nrow);
  tail_ln_bwd_rows(y, h, mean1, rstd1, a.ln1_w, m, part);
  store_rows(h, nullptr, 0, a.out, row0, nrow);
}

// The shapes the tail takes (ops/postnorm_ffn.py postnorm_ffn_supported and
// ffn_geometry): D 64, 128, 192 or 256, F a multiple of 128 up to 1024,
// ReLU or GELU, C 1, 2 or 4 with F / C a multiple of 128.
inline bool ffn_tail_valid(int M, int D, int F, int act, int C) {
  return M >= 1 && D % 64 == 0 && D >= 64 && D <= 256 && F % kTFC == 0 &&
         F >= kTFC && F <= 1024 && (act == 0 || act == 1) &&
         (C == 1 || C == 2 || C == 4) && F % (kTFC * C) == 0;
}

// Internal linkage: each library keeps its own kernels and shared-memory
// grants (see attn_tile.cuh).
template <int NT, bool kDrop, bool kCl>
static inline cudaError_t ffn_fwd_nt(const FfnTail& a, cudaStream_t stream) {
  static SmemGrant grant;
  const size_t bytes = ffn_fwd_smem_bytes(32 * NT, kCl ? a.C : 1);
  auto kernel = ffn_tail_fwd_kernel<NT, kDrop, kCl>;
  if (!allow_smem(kernel, bytes, grant)) return cudaErrorInvalidValue;
  const int blocks = (a.M + kTRows - 1) / kTRows;
  if (!kCl) {
    kernel<<<blocks, kTThreads, bytes, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * a.C);
  cfg.blockDim = dim3(kTThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int NT, bool kDrop>
static inline cudaError_t ffn_fwd_c(const FfnTail& a, cudaStream_t stream) {
  return a.C > 1 ? ffn_fwd_nt<NT, kDrop, true>(a, stream)
                 : ffn_fwd_nt<NT, kDrop, false>(a, stream);
}

// The forward launch at width D on a.C CTAs a block.
template <bool kDrop>
static inline cudaError_t launch_ffn_fwd(const FfnTail& a, int D,
                                         cudaStream_t stream) {
  if (!ffn_tail_valid(a.M, D, a.ffn.F, a.ffn.act, a.C))
    return cudaErrorInvalidValue;
  switch (D) {
    case 64: return ffn_fwd_c<2, kDrop>(a, stream);
    case 128: return ffn_fwd_c<4, kDrop>(a, stream);
    case 192: return ffn_fwd_c<6, kDrop>(a, stream);
    default: return ffn_fwd_c<8, kDrop>(a, stream);
  }
}

// CTAs of the single-CTA forward at width D that fit on the current card at
// once (0 when the query fails): the slots ffn_geometry fills.
template <int NT>
static inline int ffn_fwd_slots_nt() {
  static SmemGrant grant;
  const size_t bytes = ffn_fwd_smem_bytes(32 * NT, 1);
  auto kernel = ffn_tail_fwd_kernel<NT, false, false>;
  int dev = 0, sms = 0, per = 0;
  if (!allow_smem(kernel, bytes, grant) || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kTThreads,
                                                    bytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * per;
}

static inline int ffn_fwd_slots(int D) {
  switch (D) {
    case 64: return ffn_fwd_slots_nt<2>();
    case 128: return ffn_fwd_slots_nt<4>();
    case 192: return ffn_fwd_slots_nt<6>();
    case 256: return ffn_fwd_slots_nt<8>();
    default: return 0;
  }
}

}  // namespace ladiff
