// Kernel 5: the post-norm FFN tail of a transformer layer at inference
// (replaces ladiff_tpu/ops/pallas_postnorm_ffn.py fused_postnorm_ffn).  See
// ladiff_torch/ops/postnorm_ffn.py for the math and the bound; the body is
// ffn_tail64.cuh's forward without dropout: one 64-row block per CTA, or
// per cluster of C CTAs that split the hidden width where the blocks cannot
// fill the card.
#include "ffn_tail64.cuh"

using namespace ladiff;

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D], ln1_w, ln1_b, w1 [F, D], b1, w2 [D, F], b2, ln2_w, ln2_b,
// out [M, D] (all bf16).  ints: M, D, F, act (0 relu, 1 gelu), C (CTAs a
// block: ops/postnorm_ffn.py ffn_geometry).
extern "C" int postnorm_ffn_forward(const void** p, const int* n,
                                    const float*, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  FfnTail a = {};
  a.x = w[0];
  a.ln1_w = w[1]; a.ln1_b = w[2];
  a.ffn.w1 = w[3]; a.ffn.b1 = w[4]; a.ffn.w2 = w[5]; a.ffn.b2 = w[6];
  a.ffn.ln_w = w[7]; a.ffn.ln_b = w[8];
  a.out = const_cast<bf16*>(w[9]);
  a.M = n[0];
  a.ffn.F = n[2]; a.ffn.act = n[3];
  a.ffn.mask_hid = kFfnMaskHid; a.ffn.mask_out = kFfnMaskOut;
  a.C = n[4];
  a.drop = make_dropout(0, 0, 0.f);
  return launch_ffn_fwd<false>(a, n[1], static_cast<cudaStream_t>(stream_ptr));
}

// CTAs of the forward at width D that fit on the current card at once.
extern "C" int postnorm_ffn_slots(int D) { return ffn_fwd_slots(D); }
