// Host stand-ins for the CUDA keywords and intrinsics the kernels of
// rbc2d.cu and rbc3d.cu use, so that their device code (everything above
// each file's `extern "C"` launchers) compiles with a host C++20 compiler
// and runs on the CPU: tests/test_torch_kernels2d_host.py and
// tests/test_torch_kernels3d_host.py build it with `g++ -std=c++20 -pthread`
// and hold it against the plain PyTorch versions.
//
// A test runs a block either on one host thread (blockDim.x = 1, for the
// kernels whose phases are strided loops between barriers, and the
// one-thread-per-point ones) or as one host fiber per CUDA thread
// (run_fibers below: every fiber of a block, or of a cluster, takes turns on
// the calling OS thread, switching only where it waits at a barrier), with
// `block_barrier` and `warp_barriers` set: then
// - __syncthreads is the block's HostBarrier;
// - a cp.async copy (__pipeline_memcpy_async) lands at once, which its
//   __pipeline_wait_prior and the barrier after it guarantee on the card;
// - a warp shuffle posts each lane's value and meets the other lanes of its
//   warp at the warp's barrier, reads its source lane's, and meets them
//   again; __syncwarp meets them once;
// - K1's TF32 tensor-core product (rbc2d.cu's to_tf32 and mma_tf32, which
//   this file replaces: RBC_HOST_BUILD) rounds as cvt.rna.tf32.f32 does, and
//   its m16n8k8 mma is warp-collective like a shuffle: each lane posts its
//   A and B fragments, meets its warp, sums its four results in float32
//   over the whole 16 x 8 A and 8 x 8 B in the PTX fragment layout, and
//   meets the warp again;
// - K1's cluster instance runs its c CTAs together, c x 512 host threads,
//   each CTA with its own shared memory, block barrier, warp barriers and
//   shuffle slots (a thread knows its CTA by `host_cta`): cluster_map
//   takes an address in the thread's CTA to the same offset in another
//   CTA's buffer, and cluster_barrier is one HostBarrier of all c x 512
//   threads;
// - K1's wgmma instances (on the chip 96x64, 64x64 and 128x32, on a cluster
//   64 and 96 columns of 64 levels a CTA, at 1 and 3 TF32 passes): a
//   warpgroup's m64nNk8 wgmma (N = 16, 24 or 32) is collective over its 128
//   host threads like the mma above, meeting at the warpgroup's own
//   HostBarrier (warpgroup_barrier is that barrier too; a CTA's four its
//   own): each thread posts its A fragment, B is read from the shared memory
//   the descriptor names (its start, leading and stride byte offsets
//   decoded, relative to the CTA's shared memory: host_cta_smem in a
//   cluster, else host_smem_base), and each thread sums its N / 2 results;
//   the wgmma's fence, commit and wait are empty, since it completes as it
//   is issued. A bulk copy lands at once (a memcpy by its issuing thread)
//   and then completes its mbarrier's phase, a counter the waiting threads
//   spin on.
// A fiber's CUDA thread state (threadIdx and the cluster's thread_locals
// below) is its own: the scheduler saves it when the fiber waits and puts
// it back when the fiber resumes. Fibers replace one OS thread per CUDA
// thread, whose barriers (futex wake-ups of 512 threads and more on a few
// cores) took most of a host test's time; the arithmetic and the order of
// every thread's operations are the same.
#pragma once
#define RBC_HOST_BUILD 1
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <sys/mman.h>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__
#define __constant__
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
// ---- host fibers ---------------------------------------------------------
// host_fiber_switch(save, load) saves the callee-saved registers on this
// stack, stores the stack pointer at *save and resumes the stack at load
// (x86-64 System V).
extern "C" void host_fiber_switch(void** save, void* load);
asm(R"(
  .text
  .globl host_fiber_switch
  .type host_fiber_switch, @function
host_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size host_fiber_switch, .-host_fiber_switch
)");
struct HostBarrier;
// a fiber's CUDA thread: its stack, its state while it waits, its body
struct HostFiber {
  void* sp = nullptr;
  bool done = false;
  dim3 tid;
  unsigned cta = 0;
  HostBarrier* cta_bar = nullptr;
  float* smem = nullptr;
  const void* body = nullptr;
  void (*call)(const void* body, int i) = nullptr;
  int index = 0;
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim;
inline thread_local unsigned host_cta = 0;
inline thread_local HostBarrier* cta_barrier = nullptr;
inline thread_local float* host_cta_smem = nullptr;
inline std::vector<HostFiber> host_fibers;
inline HostFiber* host_fiber = nullptr;  // the running fiber (nullptr: the scheduler)
inline void* host_scheduler_sp = nullptr;
// the running fiber waits: back to the scheduler, which resumes the next one
inline void host_yield() {
  HostFiber* f = host_fiber;
  host_fiber_switch(&f->sp, host_scheduler_sp);
}
[[noreturn]] inline void host_fiber_main() {
  HostFiber* f = host_fiber;
  f->call(f->body, f->index);
  f->done = true;
  host_fiber_switch(&f->sp, host_scheduler_sp);
  std::abort();  // a finished fiber is never resumed
}
// Run body(i) for i in [0, n) as n fibers on this thread, round robin from
// one wait to the next, until all have returned. A body sets its threadIdx
// (and in a cluster host_cta, cta_barrier, host_cta_smem) first.
template <class Body>
inline void run_fibers(int n, const Body& body) {
  constexpr size_t kStack = 1 << 20;  // reserved, not committed, a fiber
  static std::vector<char*> stacks;
  while ((int)stacks.size() < n) {
    void* m = mmap(nullptr, kStack, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (m == MAP_FAILED) std::abort();
    mprotect(m, 4096, PROT_NONE);  // a guard page under each stack
    stacks.push_back((char*)m);
  }
  host_fibers.assign(n, HostFiber{});
  for (int i = 0; i < n; ++i) {
    HostFiber& f = host_fibers[i];
    f.body = &body;
    f.call = [](const void* b, int k) { (*(const Body*)b)(k); };
    f.index = i;
    // the first switch pops six registers and returns into host_fiber_main
    // with the stack as a call leaves it (16-byte aligned before the call)
    uint64_t* sp = (uint64_t*)(stacks[i] + kStack);
    *--sp = 0;
    *--sp = (uint64_t)&host_fiber_main;
    for (int r = 0; r < 6; ++r) *--sp = 0;
    f.sp = sp;
  }
  for (int live = n; live > 0;) {
    live = 0;
    for (HostFiber& f : host_fibers) {
      if (f.done) continue;
      threadIdx = f.tid;
      host_cta = f.cta;
      cta_barrier = f.cta_bar;
      host_cta_smem = f.smem;
      host_fiber = &f;
      host_fiber_switch(&host_scheduler_sp, f.sp);
      host_fiber = nullptr;
      f.tid = threadIdx;
      f.cta = host_cta;
      f.cta_bar = cta_barrier;
      f.smem = host_cta_smem;
      live += !f.done;
    }
  }
  host_fibers.clear();
  threadIdx = dim3{};
  host_cta = 0;
  cta_barrier = nullptr;
  host_cta_smem = nullptr;
}
// n fibers meet here: the last to arrive goes on, the others wait (each
// fiber that waits yields until the barrier's generation has moved)
struct HostBarrier {
  int n, arrived = 0;
  unsigned gen = 0;
  explicit HostBarrier(int count) : n(count) {}
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++arrived == n) {
      arrived = 0;
      ++gen;
      return;
    }
    while (gen == g) host_yield();
  }
};
// the barrier of the block's threads (none when a block runs on one thread)
inline HostBarrier* block_barrier = nullptr;
// a cluster's CTAs (kMaxHostCtas at most): this thread's CTA, its block
// barrier and shared memory (nullptr outside a cluster: then block_barrier
// and the host program's smem), every CTA's shared memory, and the cluster's barrier
constexpr unsigned kMaxHostCtas = 8;
inline float* host_cluster_smem[kMaxHostCtas];
inline unsigned host_cluster_ctas = 1;
inline HostBarrier* host_cluster_barrier = nullptr;
inline void __syncthreads() {
  if (cta_barrier) {
    cta_barrier->arrive_and_wait();
  } else if (block_barrier) {
    block_barrier->arrive_and_wait();
  }
}
inline int cluster_rank() { return (int)host_cta; }
inline int cluster_size() { return (int)host_cluster_ctas; }
template <class T>
inline T* cluster_map(T* p, int rank) {
  return (T*)(host_cluster_smem[rank] + ((const float*)p - host_cluster_smem[host_cta]));
}
inline void cluster_barrier() { host_cluster_barrier->arrive_and_wait(); }
inline float* cta_shared(float* s) { return host_cta_smem ? host_cta_smem : s; }
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
// each CTA's warps' barriers and its threads' shuffle slots, at host_cta * 32
// and host_cta * 1024
inline HostBarrier* warp_barriers[kMaxHostCtas * 32];
inline double shuffle_slots[kMaxHostCtas * 1024];
template <class T>
inline T shuffle(T v, unsigned src) {
  HostBarrier& bar = *warp_barriers[host_cta * 32 + threadIdx.x / 32];
  double* slots = shuffle_slots + host_cta * 1024;
  slots[threadIdx.x] = (double)v;
  bar.arrive_and_wait();
  const T out = (T)slots[src];
  bar.arrive_and_wait();
  return out;
}
// the lanes of this thread's warp meet (K1's off-chip march orders its
// warp's carries and ring of columns in shared memory by it)
inline void __syncwarp(unsigned = 0xffffffffu) {
  if (HostBarrier* bar = warp_barriers[host_cta * 32 + threadIdx.x / 32]) bar->arrive_and_wait();
}
inline unsigned __activemask() { return 0xffffffffu; }
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return shuffle(v, threadIdx.x - threadIdx.x % width + (unsigned)src % width);
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
  const unsigned lane = threadIdx.x % width;
  return shuffle(v, lane + delta < (unsigned)width ? threadIdx.x + delta : threadIdx.x);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  const unsigned lane = threadIdx.x % width;
  return shuffle(v, lane >= delta ? threadIdx.x - delta : threadIdx.x);
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}
// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
inline unsigned to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
inline float mma_slots_all[kMaxHostCtas * 1024][6];  // each thread's a0..a3, b0, b1
inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  HostBarrier& bar = *warp_barriers[host_cta * 32 + threadIdx.x / 32];
  float (*mma_slots)[6] = mma_slots_all + host_cta * 1024;
  for (int i = 0; i < 4; ++i) mma_slots[threadIdx.x][i] = __uint_as_float(a[i]);
  for (int i = 0; i < 2; ++i) mma_slots[threadIdx.x][4 + i] = __uint_as_float(b[i]);
  bar.arrive_and_wait();
  const unsigned base = threadIdx.x - threadIdx.x % 32, g = threadIdx.x % 32 / 4,
                 t = threadIdx.x % 4;
  // A[m][k] is lane 4 (m % 8) + k % 4's a[(m >= 8) + 2 (k >= 4)]; B[k][n] is
  // lane 4 n + k % 4's b[k >= 4]; d[i] is D[g + 8 (i >= 2)][2 t + i % 2]
  for (int i = 0; i < 4; ++i) {
    const unsigned m = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    float sum = d[i];
    for (unsigned k = 0; k < 8; ++k)
      sum += mma_slots[base + 4 * (m % 8) + k % 4][(m >= 8) + 2 * (k >= 4)] *
             mma_slots[base + 4 * n + k % 4][4 + (k >= 4)];
    d[i] = sum;
  }
  bar.arrive_and_wait();
}
// the on-chip K1 block's shared memory, against which shared addresses are
// taken outside a cluster (in a cluster the CTA's own), and each CTA's
// warpgroups' barriers, at host_cta * 4
inline float* host_smem_base = nullptr;
inline HostBarrier* wg_barriers[kMaxHostCtas * 4];
inline const char* host_shared_base() {
  return (const char*)(host_cta_smem ? host_cta_smem : host_smem_base);
}
inline unsigned smem_u32(const void* p) {
  return (unsigned)((const char*)p - host_shared_base());
}
inline void warpgroup_barrier() {
  wg_barriers[host_cta * 4 + threadIdx.x / 128]->arrive_and_wait();
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
inline void fence_operand(float&) {}
inline void fence_proxy_async() {}
inline void fence_mbar_init() {}
inline void mbar_init(uint64_t* bar, unsigned) { __atomic_store_n(bar, 0, __ATOMIC_SEQ_CST); }
inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  __atomic_fetch_add(bar, 1, __ATOMIC_SEQ_CST);  // the phase completes
}
// the phase of this parity has completed when the count of completed
// phases has the other parity
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  while ((__atomic_load_n(bar, __ATOMIC_SEQ_CST) & 1u) == parity) host_yield();
}
inline float wgmma_slots[kMaxHostCtas * 1024][4];  // each thread's a0..a3
template <int N>
inline void wgmma_tf32(float (&d)[N / 2], const unsigned (&a)[4], uint64_t desc) {
  HostBarrier& bar = *wg_barriers[host_cta * 4 + threadIdx.x / 128];
  float (*slots)[4] = wgmma_slots + host_cta * 1024;
  for (int i = 0; i < 4; ++i) slots[threadIdx.x][i] = __uint_as_float(a[i]);
  bar.arrive_and_wait();
  if (desc >> 46 != 0) std::abort();  // no swizzle, no base offset
  const unsigned base = threadIdx.x - threadIdx.x % 128, w = threadIdx.x % 128 / 32,
                 g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const unsigned start = (desc & 0x3fffu) << 4, lbo = ((desc >> 16) & 0x3fffu) << 4,
                 sbo = ((desc >> 32) & 0x3fffu) << 4;
  const char* sm = host_shared_base();
  // A[m][k] is thread 32 (m / 16) + 4 (m % 8) + k % 4's a[(m % 16 >= 8) + 2 (k >= 4)];
  // B[k][n] is at core matrix (n / 8, k / 4), row n % 8, column k % 4
  for (int v = 0; v < N / 2; ++v) {
    const unsigned m = 16 * w + g + 8 * ((v >> 1) & 1), n = 8 * (v >> 2) + 2 * t + (v & 1);
    float sum = d[v];
    for (unsigned k = 0; k < 8; ++k) {
      float b;
      std::memcpy(&b, sm + start + n / 8 * sbo + k / 4 * lbo + n % 8 * 16 + k % 4 * 4, 4);
      const float a_mk = slots[base + 32 * (m / 16) + 4 * (m % 8) + k % 4]
                              [(m % 16 >= 8) + 2 * (k >= 4)];
      sum += a_mk * b;
    }
    d[v] = sum;
  }
  bar.arrive_and_wait();
}
