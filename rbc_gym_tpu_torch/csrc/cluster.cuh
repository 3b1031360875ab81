// Thread-block clusters as __device__ code, for K1's cluster instance
// (rbc2d.cu). csrc/host_shim.h stands in for these on the host, where a
// cluster's CTAs run together as host fibers.
#pragma once

#ifndef RBC_HOST_BUILD
#include <cooperative_groups.h>

// This CTA's rank in its cluster, and the cluster's CTAs.
__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}
__device__ __forceinline__ int cluster_size() {
  return (int)cooperative_groups::this_cluster().num_blocks();
}
// The address of *p, in this CTA's shared memory, in CTA rank's (distributed
// shared memory: a generic pointer the other SM's loads go through).
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}
// Every thread of the cluster meets here: what any of them wrote before is
// seen by all after (release, then acquire, at cluster scope). It is also a
// barrier of the CTA's own threads.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// The CTA's dynamic shared memory (on the host, each CTA's own buffer).
__device__ __forceinline__ float* cta_shared(float* s) { return s; }
#endif
