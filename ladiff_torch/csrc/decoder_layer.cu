// Kernel K2: one whole post-norm transformer decoder layer (replaces
// ladiff_tpu/ops/pallas_decoder_layer.py fused_decoder_layer).  See
// ladiff_torch/ops/decoder_layer.py for the math, the bound and why it is a
// fixed sequence of four launches:
//   linear64_kernel x2   q/k/v of the frame rows; k/v of the memory rows
//                        (tail64.cuh)
//   attn_tile_kernel     register-resident 64-query flash tile, key tiles
//                        through a cp.async ring, online softmax in
//                        registers (attn_tile.cuh, shared with kernel 10)
//   dec_tail_fwd_kernel  out-proj + LN1, cross-attention, out-proj + LN2,
//                        FFN, LN3, per 64-row block (dec_tail64.cuh, shared
//                        with kernel 13)
#include "attn_tile.cuh"
#include "dec_tail64.cuh"

using namespace ladiff;

LADIFF_ERROR_STRING_FN

// ptrs: x, kvalid, mem, mvalid, 18 weights (ops/decoder_layer.py
// _PARAM_ORDER), then the scratch qkv [B*T, 3D], kv2 [B*L, 2D], ctx
// [B*T, D] and the output [B*T, D].  ints: B, T, L, D, H, F, act.
extern "C" int decoder_layer_forward(const void** p, const int* n,
                                     const float*, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int B = n[0], T = n[1], Lm = n[2], D = n[3], H = n[4], F = n[5];
  if (B < 1 || T < 1 || D % 64 || D > 256 || D % H || (D / H) % 16 ||
      D / H > 128 || F % kTFC || F < kTFC || Lm < 1 || Lm > kMaxMem)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = reinterpret_cast<const float*>(p[1]);
  const bf16* mem = w[2];
  const bf16** q = w + 4;
  bf16* qkv = const_cast<bf16*>(w[22]);
  bf16* kv2 = const_cast<bf16*>(w[23]);
  bf16* ctx = const_cast<bf16*>(w[24]);
  const int M = B * T, ML = B * Lm;
  cudaError_t err;
  if ((err = launch_linear64<false>(x, M, D, q[0], D, q[1], nullptr, 3 * D,
                                    qkv, stream)) != cudaSuccess)
    return err;
  // memory k/v: rows D..3D of the cross-attention in-projection
  if ((err = launch_linear64<false>(mem, ML, D, q[6] + (size_t)D * D, D,
                                    q[7] + D, nullptr, 2 * D, kv2,
                                    stream)) != cudaSuccess)
    return err;
  // q, k, v: the thirds of the packed projection, row stride 3D
  AttnArgs at;
  at.q = qkv; at.k = qkv + D; at.v = qkv + 2 * D;
  at.kvalid = kvalid; at.out = ctx;
  at.T = T; at.Dh = D / H; at.ld = 3 * D; at.ldo = D;
  if ((err = launch_attn_tiles(at, B, H, stream)) != cudaSuccess) return err;
  DecTail64 a = {};
  a.x = x; a.ctx = ctx; a.memkv = kv2;
  a.mvalid = reinterpret_cast<const float*>(p[3]);
  dec_fill_params(a, q, F, n[6]);
  a.out = const_cast<bf16*>(w[25]);
  a.M = M; a.T = T; a.L = Lm; a.D = D; a.H = H;
  return launch_dec_tail_fwd<false>(a, stream);
}
