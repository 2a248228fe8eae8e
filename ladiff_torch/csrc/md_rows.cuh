// The MD layer's per-row AdaLN segment on 32-row blocks: the one-token
// cross-attention's rows (ca_rows, kernel 7's stylize.cu).  See
// ladiff_torch/ops/stylize.py.
#pragma once

#include "common.cuh"

namespace ladiff {

// AdaLN -> SiLU of one row held by a warp (v: its LayerNorm output, element
// lane + 32 i in v[i]), (scale, shift) from ss [2D], into the bf16 row dst.
// Here and in ca_rows below the column is clamped before the guard,
// as in warp_layernorm: the compiler may issue the read-only loads of the
// unrolled iterations i >= per speculatively, and they must stay inside the
// row (a shared AdaLN row is a tensor of its own, 2D elements long).
__device__ __forceinline__ void adaln_silu_row(const float* v, const bf16* ss,
                                               int D, bf16* dst) {
  const int lane = threadIdx.x & 31, per = D / 32;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int c = min(lane + 32 * i, D - 1);
    if (i < per)
      dst[c] = tob(silu(v[i] * (1.f + ldgf(ss + c)) + ldgf(ss + D + c)));
  }
}

// Rows r = 0..31 of a block are rows row0 + r of a stream of T-row samples;
// the sample of a row is clamped to `last` (padding rows).  ss points at the
// AdaLN (scale, shift) row of sample 0, ss_stride elements between samples
// (0: one row shared by all).  One warp per row; no barrier.

// The one-token cross-attention's rows: the text value row of the row's
// sample (value: sample 0's) x the row's mask (mask: row 0's, read for the
// first nrow rows, 0 beyond) -> LayerNorm -> AdaLN -> SiLU into xb.
__device__ __forceinline__ void ca_rows(bf16* xb, int ld, int D, int T,
                                        int row0, int nrow, int last,
                                        const float* mask, const bf16* value,
                                        const bf16* ss, int ss_stride,
                                        const bf16* ln_w, const bf16* ln_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, per = D / 32;
  for (int row = warp; row < kRows; row += nwarps) {
    const int s = min((row0 + row) / T, last);
    const float mk = row < nrow ? ldgf(mask + row) : 0.f;
    const bf16* val = value + (size_t)s * D;
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int c = min(lane + 32 * i, D - 1);
      if (i < per) v[i] = ldgf(val + c) * mk;
    }
    warp_layernorm(v, D, ln_w, ln_b);
    adaln_silu_row(v, ss + (size_t)s * ss_stride, D, xb + row * ld);
  }
}

}  // namespace ladiff
