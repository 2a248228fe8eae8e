// Thread-block cluster primitives on the H100 (sm_90): the CTA's rank, the
// cluster barrier (split into arrive and wait), and stores into a peer
// CTA's shared memory (distributed shared memory, DSMEM).  Shared by the
// MD layer body (md_body_cluster.cuh: K1, kernel 11) and the FFN tail's
// cluster split (ffn_tail64.cuh: kernels 5 and 9).
#pragma once

#include <cstdint>

namespace ladiff {

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The address of shared-memory address a of this CTA in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer(uint32_t a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_peer(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               ::"r"(a), "f"(x), "f"(y) : "memory");
}

}  // namespace ladiff
