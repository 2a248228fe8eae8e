// Kernel 10: masked multi-head self-attention of projected q, k, v (replaces
// ladiff_tpu/ops/pallas_attention.py pallas_masked_attention).  See
// ladiff_torch/ops/attention_kernel.py for the math and the bound.  One
// launch of attn_tile_kernel (attn_tile.cuh over flash_tile.cuh): one block
// per (sample, head, 64-query tile), q in registers, k and v tiles through a
// two-stage cp.async ring, both products mma.sync bf16 with f32 register
// accumulators, an online softmax on the registers, key tiles without a
// valid key skipped; the scores never leave registers.
#include "attn_tile.cuh"

using namespace ladiff;

LADIFF_ERROR_STRING_FN

// ptrs: q, k, v [B, S, D] (bf16, contiguous), kvalid [B, S] (f32, > 0.5 =
// the key may be attended to) or null, then the output [B, S, D].
// ints: B, S, D, H.
extern "C" int masked_attention_forward(const void** p, const int* n,
                                        const float*, void* stream_ptr) {
  const int B = n[0], S = n[1], D = n[2], H = n[3];
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || D % H)
    return cudaErrorInvalidValue;
  AttnArgs a;
  a.q = static_cast<const bf16*>(p[0]);
  a.k = static_cast<const bf16*>(p[1]);
  a.v = static_cast<const bf16*>(p[2]);
  a.kvalid = static_cast<const float*>(p[3]);
  a.out = static_cast<bf16*>(const_cast<void*>(p[4]));
  a.T = S; a.Dh = D / H; a.ld = D; a.ldo = D;
  return launch_attn_tiles(a, B, H, static_cast<cudaStream_t>(stream_ptr));
}
