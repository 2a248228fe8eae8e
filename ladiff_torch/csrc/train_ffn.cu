// Kernel 9: the post-norm FFN tail of a transformer layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_ffn.py
// train_postnorm_ffn).  See ladiff_torch/ops/train_ffn.py for the math, the
// dropout contract, what is saved and the weight-gradient scheme.
//
// Forward: ffn_tail64.cuh's body with dropout, one 64-row block per CTA or
// per cluster of C CTAs (kernel 5's, which is this forward at rate 0).
// Backward, a fixed sequence of launches:
//   ffn_tail_bwd_kernel   per 64-row block: LN1, the FFN and LN2 again from
//                         x, then ds, dy, da, dh and dx; writes h, gd, da,
//                         dy (bf16) to scratch, and the block's partials of
//                         the LayerNorm and bias gradients
//   reduce_kernel x 6     the LayerNorm and bias gradients over the blocks
//   wgrad + reduce x 2    dW1 = da^T h, dW2 = dy^T gd
#include "ffn_tail64.cuh"
#include "train_common.cuh"

using namespace ladiff;

namespace {

// x and the 8 parameters (bf16, the forward's order) from w; ints M, D, F,
// act, seed lo, seed hi at n.
void fill_ffn_tail(FfnTail& a, const bf16** w, const int* n, float rate) {
  a.x = w[0];
  a.ln1_w = w[1]; a.ln1_b = w[2];
  a.ffn.w1 = w[3]; a.ffn.b1 = w[4]; a.ffn.w2 = w[5]; a.ffn.b2 = w[6];
  a.ffn.ln_w = w[7]; a.ffn.ln_b = w[8];
  a.M = n[0];
  a.ffn.F = n[2]; a.ffn.act = n[3];
  a.ffn.mask_hid = kFfnMaskHid; a.ffn.mask_out = kFfnMaskOut;
  a.drop = make_dropout(n[4], n[5], rate);
}

template <int NT, bool kDrop>
static inline cudaError_t ffn_bwd_nt(const FfnTail& a, cudaStream_t stream) {
  static SmemGrant grant;
  const size_t bytes = ffn_bwd_smem_bytes(32 * NT, a.ffn.F);
  if (!allow_smem(ffn_tail_bwd_kernel<NT, kDrop>, bytes, grant))
    return cudaErrorInvalidValue;
  ffn_tail_bwd_kernel<NT, kDrop>
      <<<(a.M + kTRows - 1) / kTRows, kTThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool kDrop>
static inline cudaError_t launch_ffn_bwd(const FfnTail& a, int D,
                                         cudaStream_t stream) {
  switch (D) {
    case 64: return ffn_bwd_nt<2, kDrop>(a, stream);
    case 128: return ffn_bwd_nt<4, kDrop>(a, stream);
    case 192: return ffn_bwd_nt<6, kDrop>(a, stream);
    default: return ffn_bwd_nt<8, kDrop>(a, stream);
  }
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D], ln1_w, ln1_b, w1 [F, D], b1, w2 [D, F], b2, ln2_w, ln2_b,
// out [M, D] (all bf16).  ints: M, D, F, act, seed lo, seed hi, C (CTAs a
// block: ops/postnorm_ffn.py ffn_geometry).  floats: rate.
extern "C" int train_ffn_forward(const void** p, const int* n, const float* f,
                                 void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  FfnTail a = {};
  fill_ffn_tail(a, w, n, f[0]);
  a.out = const_cast<bf16*>(w[9]);
  a.C = n[6];
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return f[0] > 0.f ? launch_ffn_fwd<true>(a, n[1], stream)
                    : launch_ffn_fwd<false>(a, n[1], stream);
}

// CTAs of the forward at width D that fit on the current card at once.
extern "C" int train_ffn_slots(int D) { return ffn_fwd_slots(D); }

// ptrs: x, dout [M, D]; the 8 parameters (bf16, forward's order); dx [M, D];
// scratch h [M, D], gd [M, F], da [M, F], dy [M, D] (bf16); part [blocks,
// 5 D + F], wpart [split, F D] (f32); then the 8 parameter gradients (f32,
// forward's order).  ints: M, D, F, act, seed lo, seed hi, split.  floats:
// rate.
extern "C" int train_ffn_backward(const void** p, const int* n,
                                  const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  auto fptr = [&](int i) {
    return reinterpret_cast<float*>(const_cast<void*>(p[i]));
  };
  auto bptr = [&](int i) { return const_cast<bf16*>(w[i]); };
  FfnTail a = {};
  const bf16* wq[9] = {w[0], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9]};
  fill_ffn_tail(a, wq, n, f[0]);
  a.ffn.dout = w[1];
  a.out = bptr(10);
  a.h = bptr(11); a.ffn.gd = bptr(12); a.ffn.da = bptr(13);
  a.ffn.dy = bptr(14);
  a.part = fptr(15);
  float* wpart = fptr(16);
  float* g[8];
  for (int i = 0; i < 8; ++i) g[i] = fptr(17 + i);
  a.C = 1;
  const int M = a.M, D = n[1], F = a.ffn.F, split = n[6];
  if (!ffn_tail_valid(M, D, F, a.ffn.act, 1) || split < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = f[0] > 0.f ? launch_ffn_bwd<true>(a, D, stream)
                               : launch_ffn_bwd<false>(a, D, stream);
  if (err != cudaSuccess) return err;
  // the block partials [ln1_w, ln1_b, ln2_w, ln2_b, b1, b2] in the
  // gradients' order g[0], g[1], g[6], g[7], g[3], g[5]
  const int blocks = (M + kTRows - 1) / kTRows;
  const size_t stride = ffn_part_stride(D, F);
  const int off[6] = {0, D, 2 * D, 3 * D, 4 * D, 4 * D + F};
  const int len[6] = {D, D, D, D, F, D};
  float* out[6] = {g[0], g[1], g[6], g[7], g[3], g[5]};
  for (int k = 0; k < 6; ++k)
    if ((err = reduce_partials(a.part + off[k], blocks, stride, len[k],
                               out[k], stream)) != cudaSuccess)
      return err;
  if ((err = weight_grad(a.ffn.da, F, F, a.h, D, D, M, split, wpart, g[2],
                         stream)) != cudaSuccess)
    return err;
  return weight_grad(a.ffn.dy, D, D, a.ffn.gd, F, F, M, split, wpart, g[4],
                     stream);
}

// ptrs: m1 [M, F], m2 [M, D] (f32): the keep-masks of a seed.  ints: M, D,
// F, seed lo, seed hi.  floats: rate.
extern "C" int train_ffn_masks(const void** p, const int* n, const float* f,
                               void* stream_ptr) {
  float* m1 = reinterpret_cast<float*>(const_cast<void*>(p[0]));
  float* m2 = reinterpret_cast<float*>(const_cast<void*>(p[1]));
  const unsigned long long M = n[0], D = n[1], F = n[2];
  const Dropout d = make_dropout(n[3], n[4], f[0]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = fill_mask(m1, M * F, d, kFfnMaskHid, stream);
  if (err != cudaSuccess) return err;
  return fill_mask(m2, M * D, d, kFfnMaskOut, stream);
}
