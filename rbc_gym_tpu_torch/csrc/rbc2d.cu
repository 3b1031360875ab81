// Hopper kernels of the 2D RBC env step, bound through a plain C ABI.
//
// K1 env_step_2d_kernel replaces rbc_gym_tpu/ops/pallas2d.py:_env_step_kernel
// (reached from make_env_step_fused_2d, pl.pallas_call at :486): a whole env
// step, n_substeps x 3 low-storage RK3 stages, each doing the hydrostatic
// pressure pHY', the UB5 tendencies, the RK update, the divergence, the
// spectral Poisson solve and the velocity correction.
//   Bound: operations. The TPU kernel's spectral solve (F.rhs, a dense
//   per-mode inverse, G.p_hat) is 2 (2 nx^2 nz + nx nz^2) FLOP per stage
//   per env, about 3.1 MFLOP at 96x64 and 0.47 GFLOP per env step; the
//   fields move through device memory once per env step, about 170 KB an
//   env in and out.
//   What held its first design (179 ms an env step at 1024 envs on an H100
//   80GB HBM3 at 700 W, 5.7 % of the bound): products that issued a load
//   for every FMA, the 1.57 MB stack of vertical inverses streamed from L2
//   every stage, the state and 172 KB of scratch per env in global memory,
//   runtime division in every index, IEEE division in every difference,
//   every face flux computed twice, a z ladder that split warps, and a
//   serial pHY' phase on 96 of 256 threads. This design takes 41 ms
//   there, 25 % of the bound (PERF.md, section 6).
//   Design: one 512-thread block per env holds the whole env step on the
//   chip. Shared memory holds two copies of u, w, b (a stage reads one and
//   writes the other, so the RK update needs no pass of its own), two
//   (nx, nz) slabs for pHY', the divergence and the solve, and the z
//   transforms. Warp v owns the x columns [v xs, (v + 1) xs) (xs = nx / 16:
//   6 at 96x64), lane l the levels k = l + 32 s, s < 2, and each thread
//   keeps the previous stage's tendencies of its points in registers for
//   the whole kernel. Per stage, with a barrier after each phase:
//   1. pHY' of each column by a float64 suffix scan across the lanes of
//      its warp (no serial phase; each value rounds once);
//   2. each warp marches along its columns: the x flux of each field is
//      carried in a register to the next column (each x-face flux once,
//      one extra per strip), the z-face flux comes from the neighbouring
//      lane by a shuffle (each once), the z ladder is branch-free (orders
//      fixed per level, taps clamped into the column), and the RK update
//      goes straight into the other copy of the state;
//   3. the divergence of the updated velocities, over dt_stage, into a slab;
//   4. the solve as four register-tiled float32 products, each thread
//      computing its own xs x 2 points from one broadcast row of the left
//      factor and two columns of the right per contraction index:
//      r_hat = F . rhs, then the vertical solve in the DCT-II basis that
//      diagonalises every mode's D2z + lambda I (inv = S diag(d) C, the
//      pseudo-inverse of the mean mode by d = 0; 32 KB of transforms in
//      shared memory in place of the 1.57 MB stack): (r_hat C^T) * d, then
//      times S^T, then p = G . p_hat, which each thread keeps for its own
//      points;
//   5. the correction of the thread's own u, w by grad p.
//   The spacings and the z transforms' constants are taken in double on
//   the host. nx, nz are template parameters for 96x64 (no runtime / or %);
//   a runtime instance takes the other grids with 4 <= nx <= 128, 2 <= nz <=
//   64 whose shared memory fits. Shared memory, in floats:
//   2 (2 nx nz + nx (nz + 1)) + 2 nx nz + 2 nz^2 + nx, 230,528 bytes at
//   96x64: one block an SM, 1024 envs in 7.76 waves over 132 SMs. FP32 FMA
//   on the CUDA cores; no tensor cores, no TF32.
//   The grids it cannot hold run on a thread-block cluster where one
//   takes them: env_step_2d_cluster_kernel, c = env_step_2d_cluster_size
//   CTAs of 512 threads an env (the smallest of 2, 4, 8 that divides nx
//   and whose nxl = nx / c columns the on-chip layout takes: 128x64 and
//   192x64 on two, 256x64 on four). Off the chip the state and every
//   intermediate made 330 KB an env at 128x64, through L2 and HBM at each
//   of 150 stages a step (243.69 ms at 1024 envs there, 6.5 % of the
//   bound); the cluster keeps the env step in c SMs' shared memory. CTA r
//   holds the columns [r nxl, (r + 1) nxl) in K1's layout over nxl
//   columns (its shared memory on_chip_smem_floats(nxl, nz): 164,608
//   bytes at 128x64), with its own z transforms and g_prev in registers,
//   and reads only what crosses a slice from its neighbours' shared
//   memory (distributed shared memory, cluster_map): the march's x halos
//   (three columns of u, w, b each side, one of pHY'; nxl >= 4, so only
//   the next CTA's, periodic from CTA c - 1 to 0), copied into a halo in
//   the divergence slab before the march; the divergence's u[i + 1] and
//   the correction's p[i - 1], read in place; and for the two
//   x-contracting products (r_hat = F . rhs, p = G . p_hat: a CTA the rows
//   of its columns) the other CTAs' slabs, copied three at a time into the
//   state copy that is dead after the march. The z products are local. F
//   and G are read through L1 and L2 as on the chip. Per stage five
//   cluster barriers (barrier.cluster.arrive.release / wait.acquire), each
//   where a CTA next reads what its neighbours wrote: after pHY' (their
//   corrected state and pHY'), after the march (u*), after the divergence,
//   after p_hat and after p; one more before a CTA exits. The other
//   barriers stay its own (one after the halo copy, one after each copy of
//   slabs and each product), and nothing a neighbour may still read is
//   overwritten before the next cluster barrier: pHY' goes to the slab no
//   neighbour reads then, the halo to the one whose p they have read. The
//   TF32 instances keep their slabs plain (unswizzled) and take the x
//   products as one 16 x 32 tile a warp summed over the slabs (nxl <=
//   128, nz <= 64: at most 16 tiles). Compile-time 64 and 96 columns of 64
//   levels a CTA at float32, a runtime-size instance otherwise.
//   Every other grid with nx >= 3 runs the off-chip instance,
//   env_step_2d_global_kernel: the state in the output tensors, the
//   tendencies of this and the previous stage and pHY' in per-env global
//   scratch, the two (nx, nz) slabs in shared memory where 8 nx nz bytes
//   fit a block (127x64, 128x224), and each phase a loop over points
//   between barriers (pHY' by the same warp scan, a chunk of 32 levels at a
//   time from the top; the tendencies by ub5.cuh's tendencies_block; the
//   same DCT-form solve, one 32-column tile of each product after another).
//   On the finer grids (256x128, 512x256, 2048x64) its instance with
//   kGlobalSlabs puts the slabs in the same per-env scratch after the rest
//   and takes no shared memory; only the slab pointers differ, the phases
//   and products are the same code. Simple first: every product then reads
//   its slab operand through L1 and L2 (a block's two slabs are 256 KB at
//   256x128, so beyond L2 at a full fleet they come from HBM); keeping them
//   on the chip across a cluster, as the cluster instance does for nz <= 64,
//   is the next pass.
//   The split-product branch of the TPU kernel (pallas2d.py:270-304, dot3:
//   each solve product as three one-pass bf16 dots over hi and lo parts;
//   the 2D solver's poisson_precision "bf16x3") and its one-pass DEFAULT
//   products ("default") are instances of the same three kernels with a
//   compile-time pass count, kPasses: 3 (the launcher's passes, from the
//   wrapper's precision "high") or 1 ("default"); 0 is the float32 solve
//   above, which these instances leave as it was. Each of the solve's four
//   products runs on the tensor cores as warp-level
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 tiles over the (nx, nz) slab
//   (mma_product): a warp takes a 16 x 32 tile of the result, four m16n8k8
//   tiles side by side sharing the A fragment, and walks the contraction 8
//   deep at a time. Operands are split in registers as they are loaded
//   (tf32_operands): at 3 passes hi is the value with its low 13 mantissa
//   bits cleared (TF32-exact, ops/poisson.tf32_split) and lo = x - hi
//   rounded to TF32, and a product is hi . lo + lo . hi + hi . hi (the
//   dropped lo . lo is under 2^-20 of it); at 1 pass each operand is
//   rounded once (cvt.rna.tf32.f32). Every operand reaches the mma
//   TF32-exact, its low 13 bits zero, so nothing depends on what the
//   tensor core does with raw float32 bits. The constants are read as they
//   are (no second copy), and the shared memory is the float32 instance's.
//   The fragments' layout is not the thread-owns-columns one, so each
//   product writes its slab, and the correction reads its points from the
//   slab after the barrier. Where nz is a multiple of 32 the slabs and the
//   z transforms are stored with their columns XOR-swizzled by the row
//   (slab_swizzle), so that neither a fragment's rows nor its columns fall
//   on one bank; elsewhere they are stored plain. Fragments beyond the edge
//   of a grid that is not a multiple of the tile are zero. Simple first:
//   mma.sync from shared memory and L2, no wgmma, TMA or pipelining.
//   At 96x64 the two TF32 instances run their solve on wgmma instead
//   (k1_wgmma; 37.6 -> 30.3 ms at 3 passes and 32.2 -> 23.9 at 1, at 1024
//   envs on an H100 80GB HBM3 at 700 W, PERF.md section 6). What held the
//   mma.sync solve there (by ablation 21.0 and 15.1 ms of those 37.6 and
//   32.2): three warps of a sub-partition walking their tiles' K serially,
//   F and G read element by element from L2, every constant split again
//   at every load, and a block barrier after each product. Design: each
//   product is computed transposed, P^T = R^T L^T, nz = 64 rows (one wgmma
//   M) by 96 modes or columns, warpgroup g of four the 24 of [24 g, 24 g +
//   24) in m64n24k8 steps, A from registers, B from shared memory (see
//   wg_product). F's and G's rows arrive by one bulk copy a stage into the
//   state copy the march has just read (at 3 passes F's hi and lo there,
//   and G's after product 3 warpgroup by warpgroup, where r_hat and t were);
//   every constant comes packed on the host, TF32-exact (ops/poisson.py
//   k1_tf32_constants), so the kernel splits and rounds only the slabs.
//   Products 1 to 3 are local to a warpgroup's modes, so only the
//   warpgroup meets between them; the block meets before products 1 and 4
//   and before the correction. Shared memory 197,800 bytes at 3 passes and
//   222,376 at 1; the float32 instance is untouched.
//
// K2 tendencies_2d_march_kernel replaces ops/pallas2d.py:_tendency_kernel
// (reached from make_tendencies_2d, pl.pallas_call at :562): gu, gw, gb of
// one RK3 stage, for the single-substep API (Solver2D.substep).
//   Bound: bytes. The Pallas kernel reads u, w, b, p_hy and bottom and
//   writes gu, gw, gb; here K2 takes b and computes pHY' itself, so the
//   single substep calls no pHY' between its stages: u, w, b, bottom in and
//   gu, gw, gb out, about 149 KB an env at 96x64 against some 180 FLOP a
//   point.
//   What held its first design (one 256-thread block per env over
//   tendencies_block; 0.41 ms at 1024 envs on 96x64 on an H100 80GB HBM3 at
//   700 W, 13 % of the Pallas kernel's bytes bound): a runtime division in
//   every index and IEEE division in every difference, every face flux
//   computed by both of its cells, every tap a load from global memory,
//   gw in a second pass over u and w, a branching z ladder, runtime nx and
//   nz, and a pHY' tensor made by PyTorch before each launch.
//   Design: K1's phases 1 and 2 (pHY' and the x march) with each point's g
//   stored to global memory in place of K1's RK update. It is a copy of
//   K1's code: one template shared by both changed K1's compiled code
//   (PERF.md, section 6), so K1's source stays as it was. One 512-thread
//   block per env in K1's layout (warp v owns the x columns [v xs, (v + 1)
//   xs), lane l the levels l + 32 s) copies b, then u, w and bottom, into
//   shared memory by 16-byte cp.async copies (b in a commit group of its
//   own), computes pHY' into a shared slab by K1's float64 lane scan while
//   u and w are in flight, and marches each warp along its columns: each
//   x-face flux once (carried in a register), each z-face flux once
//   (passed by shuffle), the z ladder branch-free, the spacings as
//   reciprocals from the host; each g goes from a register to global
//   memory, consecutive lanes to consecutive k. Shared memory, in floats:
//   3 nx nz + nx (nz + 1) + nx (b, pHY', u, w, bottom), 99,072 bytes at
//   96x64: two blocks an SM. nx, nz are template parameters for 96x64; a
//   runtime instance takes every other grid with 4 <= nx <= 128 and 2 <=
//   nz <= 64 (K1's layout; its shared memory always fits).
//   Every other grid runs the general instance, tendencies_2d_general_kernel:
//   pHY' into per-env global scratch by K1's off-chip chunked warp scan,
//   then ub5.cuh's tendencies_block (a thread a point) with the host's
//   reciprocals.
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "ub5.cuh"

namespace {

// RK3 coefficients of the reference's :RungeKutta3 (pallas2d.py:214-215).
__constant__ float kGamma[3] = {8.0f / 15.0f, 5.0f / 12.0f, 3.0f / 4.0f};
__constant__ float kZeta[3] = {0.0f, -17.0f / 60.0f, -5.0f / 12.0f};

// ---- K1 ---------------------------------------------------------------------

constexpr int kK1Threads = 512;
constexpr int kK1Warps = kK1Threads / 32;
constexpr int kK1Levels = 2;              // z levels a lane owns: k = lane + 32 s
constexpr int kK1MaxNz = 32 * kK1Levels;  // 64
constexpr int kK1MaxCols = 8;             // x columns a warp owns, runtime instance
constexpr int kK1MinNx = 3;               // x stencils wrap once: taps i - 3 .. i + 3
constexpr size_t kSmemPerBlock = 232448;  // an H100 block's shared memory
constexpr unsigned kFull = 0xffffffffu;

// K1's scalars: reciprocals of the spacings and their squares and of each
// stage's dt_stage, taken once on the host in double precision. K2 takes
// them too (its n_substeps and dt unused).
struct K1Params {
  int nx, nz, n_substeps;
  float dt, idx, idz, idx2, idz2, dz, nu, kappa, min_b;
  float dts[3], idts[3];  // (gamma + zeta) dt of each stage, and its reciprocal
  // a difference over dx or dz, a second difference over dx^2 or dz^2
  // (ub5.cuh's per-point tendencies)
  __device__ __forceinline__ float ddx(float d) const { return d * idx; }
  __device__ __forceinline__ float ddz(float d) const { return d * idz; }
  __device__ __forceinline__ float d2x(float d) const { return d * idx2; }
  __device__ __forceinline__ float d2z(float d) const { return d * idz2; }
};

K1Params k1_params(int nx, int nz, int n_substeps, float dt, float dx, float dz, float nu,
                   float kappa, float min_b) {
  K1Params P{nx, nz, n_substeps, dt, (float)(1.0 / dx), (float)(1.0 / dz),
             (float)(1.0 / ((double)dx * dx)), (float)(1.0 / ((double)dz * dz)), dz, nu,
             kappa, min_b, {}, {}};
  const double gamma[3] = {8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0};
  const double zeta[3] = {0.0, -17.0 / 60.0, -5.0 / 12.0};
  for (int m = 0; m < 3; ++m) {
    const double dts = (gamma[m] + zeta[m]) * (double)dt;
    P.dts[m] = (float)dts;
    P.idts[m] = (float)(1.0 / dts);
  }
  return P;
}

// ---- the TF32 tensor-core products of K1's split-product instances -----------

#ifndef RBC_HOST_BUILD  // csrc/host_shim.h stands in for these on the host
// x rounded to TF32 (to nearest, ties away from zero), in a b32 register.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a . b for one m16n8k8 tile of the warp: a (16 x 8, row-major) and b
// (8 x 8, column-major) TF32 in the PTX fragment layout (lane = 4 g + t:
// a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; b = B[t][g],
// B[t + 4][g]; d = D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- Hopper's warpgroup products, bulk copies and barriers (K1's TF32
// instances at 96x64) ------------------------------------------------------------

// The shared-memory address of *p.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// The 128 threads of this thread's warpgroup meet (named barrier 1 + warpgroup).
__device__ __forceinline__ void warpgroup_barrier() {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + (int)(threadIdx.x >> 7)) : "memory");
}
// Registers written before this are seen by the wgmma issued after it.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// d += a . b for the warpgroup's 64 x 24 tile, 8 deep, TF32 in, float32 out:
// a (64 x 8) in registers (warp w of the group rows 16 w .. 16 w + 15, in
// mma.m16n8k8's A layout: lane 4 g + t holds A[g][t], A[g + 8][t], A[g][t +
// 4], A[g + 8][t + 4]), b (8 x 24) in shared memory, K-major, through its
// descriptor; d[4 j + i] is D[16 w + g + 8 (i >> 1)][8 j + 2 t + (i & 1)].
__device__ __forceinline__ void wgmma_m64n24k8(float (&d)[12], const unsigned (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// Keeps the compiler from moving a register's reads and writes across it
// (the accumulators of an asynchronous wgmma).
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
// An mbarrier in shared memory that expects `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Orders this thread's generic accesses of shared memory before the async
// proxy's (bulk copies, wgmma operand reads) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory that completes the phase of `bar` (one
// arrival, expecting those bytes).
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                                              uint64_t* bar) {
  const unsigned b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
// Wait until the phase of `bar` of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}
#endif

// The TF32 operands of N float32 values for kPasses passes: at 3, hi (the
// value with its low 13 mantissa bits cleared) and lo (the rest, rounded to
// TF32); at 1, the value rounded to TF32, in hi.
template <int kPasses, int N>
__device__ __forceinline__ void tf32_operands(const float (&x)[N], unsigned (&hi)[N],
                                              unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kPasses == 3) {
      hi[i] = __float_as_uint(x[i]) & 0xffffe000u;
      lo[i] = to_tf32(x[i] - __uint_as_float(hi[i]));
    } else {
      hi[i] = to_tf32(x[i]);
    }
  }
}

// The column of element (row, col) of a slab or z transform stored
// swizzled: col XOR a function of the row's low three bits, a multiple of 4
// under 32, so that the 8 rows x 4 columns of an A fragment and the 4 rows
// x 8 columns of a B fragment each fall on 32 banks (rows of nz % 32 == 0).
__host__ __device__ __forceinline__ int slab_swizzle(int row) {
  return ((row & 3) << 3) | (row & 4);
}

// dst = L . R for the (M, N) result, K deep, on the tensor cores in kPasses
// TF32 passes a product: warp v takes the 16 x 32 tiles v, v + 16, ...,
// each four m16n8k8 tiles sharing their A fragment. ld_l(r, k) and ld_r(k,
// c) read the operands and st(r, c, v) takes each result; with kEdge they
// are not called outside [0, M) x [0, K), [0, K) x [0, N) and [0, M) x [0,
// N), the operands there being zero.
template <int kPasses, bool kEdge, class LdL, class LdR, class St>
__device__ __forceinline__ void mma_product(int M, int N, int K, LdL ld_l, LdR ld_r, St st) {
  constexpr int NT = 4;  // m16n8k8 tiles side by side
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = (N + 8 * NT - 1) / (8 * NT), tiles = (M + 15) / 16 * tiles_n;
  auto l = [&](int r, int k) { return !kEdge || (r < M && k < K) ? ld_l(r, k) : 0.0f; };
  auto rr = [&](int k, int c) { return !kEdge || (k < K && c < N) ? ld_r(k, c) : 0.0f; };
  for (int tile = warp; tile < tiles; tile += kK1Warps) {
    const int m0 = tile / tiles_n * 16, n0 = tile % tiles_n * (8 * NT);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float a[4] = {l(m0 + g, k0 + t), l(m0 + g + 8, k0 + t), l(m0 + g, k0 + t + 4),
                          l(m0 + g + 8, k0 + t + 4)};
      unsigned ah[4], al[4];
      tf32_operands<kPasses>(a, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + 8 * j + g;
        const float b[2] = {rr(k0 + t, c), rr(k0 + t + 4, c)};
        unsigned bh[2], bl[2];
        tf32_operands<kPasses>(b, bh, bl);
        if constexpr (kPasses == 3) {
          mma_tf32(acc[j], ah, bl);
          mma_tf32(acc[j], al, bh);
        }
        mma_tf32(acc[j], ah, bh);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + g + 8 * (i >> 1), c = n0 + 8 * j + 2 * t + (i & 1);
        if (!kEdge || (r < M && c < N)) st(r, c, acc[j][i]);
      }
    }
  }
}

// ---- K1's TF32 instances at 96x64: the solve on wgmma ---------------------------
//
// Each product P = L . R is computed transposed, P^T = R^T L^T, a 64 x 96
// result (nz = 64 rows, one wgmma M): warpgroup g of the block's four takes
// the 24 modes or columns [24 g, 24 g + 24) as its N, in m64n24k8 steps
// over the contraction. A (64 x K) comes from registers: the slabs rhs^T and
// p_hat^T from shared memory, the z transforms ct^T and st^T from global
// memory, both stored in the fragment order (k1_afrag_index) so that a
// lane's four values are one 16-byte load. B^T (24 x K a warpgroup) lies in
// shared memory in the K-major core-matrix layout without swizzle
// (k1_bcore_index): F's and G's rows, staged by bulk copies, and r_hat and
// t, which the products before them write.

__host__ __device__ constexpr bool k1_wgmma(int nx, int nz, int passes) {
  return passes > 0 && nx == 96 && nz == 64;
}
constexpr int kWgN = 24;  // a warpgroup's N: 96 modes or columns over four warpgroups
constexpr int kWgRows = kWgN * 96;  // one part of a warpgroup's rows of F or G
constexpr int kWgModes = kWgN * 64;  // one part of a warpgroup's modes of r_hat or t

// Element (row, k) of a 64-row A operand in the fragment order: k-step s = k
// / 8, warp w = row / 16 of the group, lane 4 g + t's four values at slot 4 g
// + (t ^ (g / 2 % 4)) (so that the divergence's and product 3's stores of
// one level or column spread over the banks), register i.
__host__ __device__ constexpr int k1_afrag_slot(int lane) {
  return (lane & ~3) | ((lane & 3) ^ ((lane >> 3) & 3));
}
__host__ __device__ constexpr int k1_afrag_index(int row, int k) {
  return (((k >> 3) * 4 + (row >> 4)) * 32 + k1_afrag_slot(4 * (row & 7) + (k & 3))) * 4 +
         ((row >> 3) & 1) + 2 * ((k >> 2) & 1);
}
// Element (n, k) of a B^T operand with rows of K: 8 x 4 core matrices of 128
// contiguous bytes, K-adjacent ones 128 bytes apart, N-adjacent ones 32 K.
__host__ __device__ constexpr int k1_bcore_index(int n, int k, int K) {
  return (n >> 3) * 8 * K + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}
// The descriptor of a K-major B operand without swizzle at shared address
// `addr`: core matrices 128 bytes apart along K (leading byte offset) and
// `sbo` bytes apart along N (stride byte offset).
__host__ __device__ constexpr uint64_t k1_bdesc(unsigned addr, unsigned sbo) {
  return (uint64_t)((addr >> 4) & 0x3fffu) | ((uint64_t)(128u >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fffu) << 32);
}

// The packed constants of the instance with `passes` (ops/poisson.py
// k1_tf32_constants), in floats, each value TF32-exact as the products take
// it (at 3 passes hi and lo, at 1 the value rounded): first F's and G's rows
// of each warpgroup, in the order the state copy receives them ([g][F_g |
// G_g] at 1 pass; [g][F_g hi | F_g lo] and then [g][G_g hi | G_g lo] at 3);
// then ct^T and st^T in the fragment order (a lane's values of a k-step, hi
// then lo; lanes in their own order) and dinv in the order of product 2's
// accumulators ([g][w][lane][12]).
__host__ __device__ constexpr int k1_tf32_parts(int passes) { return passes == 3 ? 2 : 1; }
__host__ __device__ constexpr int k1_tf32_ct(int passes) {
  return 4 * 2 * kWgRows * k1_tf32_parts(passes);
}
__host__ __device__ constexpr int k1_tf32_st(int passes) {
  return k1_tf32_ct(passes) + 64 * 64 * k1_tf32_parts(passes);
}
__host__ __device__ constexpr int k1_tf32_dinv(int passes) {
  return k1_tf32_st(passes) + 64 * 64 * k1_tf32_parts(passes);
}
__host__ __device__ constexpr int k1_tf32_floats(int passes) {
  return k1_tf32_dinv(passes) + 96 * 64;
}

// Shared memory of the wgmma instances, bytes: two state copies, the slabs
// s1 (pHY', rhs, p) and s2 (p_hat), at 1 pass a slab of r_hat and t (at 3
// passes they take the state copy F leaves), the bottom profile and five
// mbarriers.
constexpr size_t k1_wgmma_smem_bytes(int passes) {
  return sizeof(float) * (2 * (2 * 96 * 64 + 96 * 65) + (passes == 3 ? 2 : 3) * 96 * 64 + 96) +
         5 * sizeof(uint64_t);
}

// acc = A . B for the warpgroup's 64 x 24 tile, KS k-steps deep, in
// kPasses TF32 passes on wgmma: ld_a(s, hi, lo) gives the lane's A fragment
// of k-step s, b is the warpgroup's B^T (its lo part b_lo floats on at 3
// passes). At most two k-steps are in flight, so at most two of A's
// fragments live in registers. The accumulators are ready when it returns.
template <int kPasses, int KS, class LdA>
__device__ __forceinline__ void wg_product(float (&acc)[12], LdA ld_a, const float* b, int b_lo) {
  constexpr unsigned kSbo = 256 * KS;  // bytes between B^T's 8-row groups: 8 rows of 8 KS floats
  const unsigned bh = smem_u32(b), bl = bh + 4 * b_lo;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    acc[i] = 0.0f;
    fence_operand(acc[i]);
  }
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    unsigned ah[4], al[4];
    ld_a(s, ah, al);
    wgmma_fence();
    const uint64_t dh = k1_bdesc(bh + 256 * s, kSbo);  // k-step s: two core matrices on
    if constexpr (kPasses == 3) {
      wgmma_m64n24k8(acc, ah, k1_bdesc(bl + 256 * s, kSbo));
      wgmma_m64n24k8(acc, al, dh);
    }
    wgmma_m64n24k8(acc, ah, dh);
    wgmma_commit();
    wgmma_wait<1>();  // k-step s - 1 is done: its A registers are free again
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 12; ++i) fence_operand(acc[i]);
}

// x columns a K1 warp owns.
__host__ __device__ constexpr int k1_cols(int nx) { return (nx + kK1Warps - 1) / kK1Warps; }

// Shared memory of the on-chip instance, in floats: two copies of u, b
// (nx, nz) and w (nx, nz + 1), two (nx, nz) slabs, the z analysis and
// synthesis (nz, nz) and the bottom profile (nx).
__host__ __device__ constexpr size_t on_chip_smem_floats(int nx, int nz) {
  return 2 * (2 * (size_t)nx * nz + (size_t)nx * (nz + 1)) + 2 * (size_t)nx * nz +
         2 * (size_t)nz * nz + nx;
}

// Whether the on-chip instance takes the grid: its warps' columns, its
// lanes' levels and its shared memory.
bool env_step_2d_on_chip(int nx, int nz) {
  return nx >= 4 && k1_cols(nx) <= kK1MaxCols && nz >= 2 && nz <= kK1MaxNz &&
         sizeof(float) * on_chip_smem_floats(nx, nz) <= kSmemPerBlock;
}

constexpr int kK1MaxCluster = 8;  // CTAs of K1's cluster instance: the portable limit

// The CTAs of K1's cluster instance on a grid the on-chip instance cannot
// hold: the smallest c of 2, 4 and 8 that divides nx and whose slab of nx /
// c columns the on-chip layout takes (at least 4 columns, k1_cols <= 8, 2
// <= nz <= 64, its shared memory in a block); 0 on the chip's grids and
// where no c does (those run the off-chip instance).
int env_step_2d_cluster_size(int nx, int nz) {
  if (env_step_2d_on_chip(nx, nz)) return 0;
  for (int c = 2; c <= kK1MaxCluster; c *= 2) {
    const int nxl = nx / c;
    if (nx % c == 0 && nxl >= 4 && k1_cols(nxl) <= kK1MaxCols && nz >= 2 && nz <= kK1MaxNz &&
        sizeof(float) * on_chip_smem_floats(nxl, nz) <= kSmemPerBlock) {
      return c;
    }
  }
  return 0;
}

// Whether a CTA of K1's cluster instance also holds its rows of F and G
// (2 (nx / c) nx floats) beside its state: where they fit a block (128x64,
// not 192x64 or 256x64). Its float32 products then read them there, not
// through L1 and L2.
bool env_step_2d_cluster_fg(int nx, int nz) {
  const int c = env_step_2d_cluster_size(nx, nz);
  return c > 0 && sizeof(float) * (on_chip_smem_floats(nx / c, nz) + 2 * (size_t)(nx / c) * nx) <=
                      kSmemPerBlock;
}

// Whether K1 keeps its two (nx, nz) slabs in shared memory: on the chip and
// on a cluster always; the off-chip instance where 8 nx nz bytes fit a
// block (127x64, 128x224), else in global scratch (256x128, 2048x64).
bool env_step_2d_slabs_on_chip(int nx, int nz) {
  return env_step_2d_on_chip(nx, nz) || env_step_2d_cluster_size(nx, nz) > 0 ||
         sizeof(float) * 2 * (size_t)nx * nz <= kSmemPerBlock;
}

// Shared memory K1 needs per block, in floats: the on-chip instance's, a
// cluster CTA's (the on-chip layout over nx / c columns, and its rows of F
// and G where they fit), or the off-chip one's two (nx, nz) slabs where
// they fit (none where they go to global scratch).
size_t env_step_2d_smem_floats(int nx, int nz) {
  if (env_step_2d_on_chip(nx, nz)) return on_chip_smem_floats(nx, nz);
  const int c = env_step_2d_cluster_size(nx, nz);
  if (c == 0) return env_step_2d_slabs_on_chip(nx, nz) ? 2 * (size_t)nx * nz : 0;
  return on_chip_smem_floats(nx / c, nz) +
         (env_step_2d_cluster_fg(nx, nz) ? 2 * (size_t)(nx / c) * nx : 0);
}

// Global scratch per env, in floats: none on the chip or a cluster; off
// them, gu, gw, gb of this stage and of the previous one, and pHY', then
// the two slabs where they do not fit a block.
size_t env_step_2d_scratch_floats(int nx, int nz) {
  if (env_step_2d_on_chip(nx, nz) || env_step_2d_cluster_size(nx, nz) > 0) return 0;
  return (env_step_2d_slabs_on_chip(nx, nz) ? 5 : 7) * (size_t)nx * nz +
         2 * (size_t)nx * (nz + 1);
}

// K1 indexes an env's fields and scratch with 32-bit offsets: they stay
// under 9 nx (nz + 1) floats.
bool env_step_2d_offsets_fit(int nx, int nz) {
  return 9 * (size_t)nx * (nz + 1) <= (size_t)INT_MAX;
}

struct State2D {
  float* u;  // (nx, nz)
  float* w;  // (nx, nz + 1)
  float* b;  // (nx, nz)
};

// acc[r][s] = sum_{k < K} L[row_r][k] R[k][col_s] for the thread's rows
// row_r = min(row0 + r, nrow - 1) and columns col_s = min(col0 + lane +
// 32 s, ldr - 1): L is row-major with rows of K (a warp reads one row value, a
// broadcast), R row-major with rows of ldr (a warp reads 32 consecutive
// values). kVec reads L four values at a time (K % 4 == 0, rows 16-byte
// aligned), so a thread loads XS + 4 NS values for 4 XS NS FMA.
template <int XS, int NS, bool kVec>
__device__ __forceinline__ void tile_product(const float* L, const float* R, int K, int ldr,
                                             int row0, int nrow, int col0, int lane,
                                             float (&acc)[XS][NS]) {
  int row[XS], col[NS];
#pragma unroll
  for (int r = 0; r < XS; ++r) row[r] = min(row0 + r, nrow - 1) * K;
#pragma unroll
  for (int s = 0; s < NS; ++s) col[s] = min(col0 + lane + 32 * s, ldr - 1);
#pragma unroll
  for (int r = 0; r < XS; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[r][s] = 0.0f;
  if constexpr (kVec) {
#pragma unroll 4
    for (int k = 0; k < K; k += 4) {
      float4 a[XS];
#pragma unroll
      for (int r = 0; r < XS; ++r) a[r] = *reinterpret_cast<const float4*>(L + row[r] + k);
      const float* rk = R + k * ldr;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) bv[s] = rk[kk * ldr + col[s]];
#pragma unroll
        for (int r = 0; r < XS; ++r) {
          const float av = kk == 0 ? a[r].x : (kk == 1 ? a[r].y : (kk == 2 ? a[r].z : a[r].w));
#pragma unroll
          for (int s = 0; s < NS; ++s) acc[r][s] = fmaf(av, bv[s], acc[r][s]);
        }
      }
    }
  } else {
    for (int k = 0; k < K; ++k) {
      float bv[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) bv[s] = R[k * ldr + col[s]];
#pragma unroll
      for (int r = 0; r < XS; ++r) {
        const float av = L[row[r] + k];
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[r][s] = fmaf(av, bv[s], acc[r][s]);
      }
    }
  }
}

// pHY' at this lane's levels k = k0 + lane + 32 s (s < NS) of one column
// bc of nz levels, into pc: pHY'[k] = -sum_{j >= k} inc[j], inc[j] = dz
// (b[j] + b[j+1]) / 2 for j < nz - 1 and dz min_b / 2 at the top, by a
// float64 suffix scan across the warp's lanes (each value rounds once).
// `above` holds the sum over the levels above these and gains theirs.
template <int NS>
__device__ __forceinline__ void phy_levels(const float* bc, float* pc, int k0, int nz, int lane,
                                           const K1Params& P, double& above) {
  double v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = k0 + lane + 32 * s;
    const double face = 0.5 * ((double)bc[min(k, nz - 1)] + (double)bc[min(k + 1, nz - 1)]);
    v[s] = k < nz - 1 ? (double)P.dz * face : (k == nz - 1 ? 0.5 * P.dz * P.min_b : 0.0);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const double t = __shfl_down_sync(kFull, v[s], off);
      if (lane + off < 32) v[s] += t;
    }
  }
#pragma unroll
  for (int s = NS - 1; s >= 0; --s) {
    const double total = __shfl_sync(kFull, v[s], 0);
    const int k = k0 + lane + 32 * s;
    if (k < nz) pc[k] = (float)-(v[s] + above);
    above += total;
  }
}

// The flux through face k + 1 of each of this lane's levels, from every
// lane's flux through face k: lane + 1's of the same level, lane 0's of the
// next level for lane 31, and 0 through the top wall (w = 0 there).
template <int NS>
__device__ __forceinline__ void flux_above(const float (&f)[NS], float (&out)[NS], int lane,
                                           int nz) {
  float r[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) r[s] = __shfl_sync(kFull, f[s], (lane + 1) & 31);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float next = s + 1 < NS ? r[(s + 1) % NS] : 0.0f;
    out[s] = lane + 32 * s + 1 >= nz ? 0.0f : (lane == 31 ? next : r[s]);
  }
}

// The flux through center k - 1 of each of this lane's levels, from every
// lane's flux through center k (level 0 of lane 0 is the bottom wall face,
// whose tendency is 0: its value is not used).
template <int NS>
__device__ __forceinline__ void flux_below(const float (&f)[NS], float (&out)[NS], int lane) {
  float r[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) r[s] = __shfl_sync(kFull, f[s], (lane + 31) & 31);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float prev = s > 0 ? r[(s + NS - 1) % NS] : 0.0f;
    out[s] = lane == 0 ? prev : r[s];
  }
}

template <int NX, int NZ, int kPasses = 0>
__global__ void __launch_bounds__(kK1Threads, 1)
env_step_2d_kernel(const float* __restrict__ u_in, const float* __restrict__ w_in,
                   const float* __restrict__ b_in, const float* __restrict__ bottom_in,
                   const float* __restrict__ fmat, const float* __restrict__ gmat,
                   const float* __restrict__ dct, const float* __restrict__ idct,
                   const float* __restrict__ dinv, float* __restrict__ u_out,
                   float* __restrict__ w_out, float* __restrict__ b_out,
                   float* __restrict__ p_out, K1Params P, const float* __restrict__ tf32) {
  constexpr int NS = kK1Levels;
  constexpr int XS = NX > 0 ? k1_cols(NX) : kK1MaxCols;
  constexpr bool kVec = NX > 0 && NX % 4 == 0 && NZ % 4 == 0;
  constexpr bool kWgmma = k1_wgmma(NX, NZ, kPasses);  // the solve on wgmma (tf32: its constants)
  extern __shared__ float smem[];
  const int nx = NX > 0 ? NX : P.nx, nz = NZ > 0 ? NZ : P.nz, nw = nz + 1;
  const int nc = nx * nz, nf = nx * nw;
  const size_t e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xs = k1_cols(nx), x0 = warp * xs, xn = min(xs, nx - x0);  // xn may be <= 0

  State2D X{smem, smem + nc, smem + nc + nf};
  State2D Y{X.b + nc, X.b + nc + nc, X.b + nc + nc + nf};
  float* s1 = Y.b + nc;       // pHY', then the divergence, R~ and p
  float* s2 = s1 + nc;        // r_hat and p_hat
  float* ct = s2 + nc;        // z analysis, (z, j)
  float* st = ct + nz * nz;   // z synthesis, (j, z)
  // bottom (nx); the wgmma instances keep no z transforms, and at 1 pass a
  // slab of r_hat and t, then their mbarriers: F's (and G's) copy, and at 3
  // passes each warpgroup's of G
  float* bot = kWgmma ? s2 + nc + (kPasses == 1 ? nc : 0) : st + nz * nz;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(bot + nx);
  // The wgmma instances' bulk copy of F's rows (hi, lo at 3 passes; G's too
  // at 1 pass) into the state copy x after the march, on mbar[0] (ablate_k1
  // drops the line that calls it)
  auto stage_fg = [&](float* x) {
    fence_proxy_async();
    bulk_copy_g2s(x, tf32, 4 * 4 * 2 * kWgRows, mbar);
  };

  for (int q = threadIdx.x; q < nc; q += kK1Threads) {
    X.u[q] = u_in[e * nc + q];
    X.b[q] = b_in[e * nc + q];
  }
  for (int q = threadIdx.x; q < nf; q += kK1Threads) X.w[q] = Y.w[q] = w_in[e * nf + q];
  // the TF32 instances' slabs and z transforms: (row, col) at row * nz +
  // (col ^ slab_swizzle(row)) where nz % 32 == 0, else plain
  const bool swz = kPasses > 0 && (NZ > 0 ? NZ % 32 == 0 : nz % 32 == 0);
  auto S = [&](int row, int col) { return row * nz + (swz ? col ^ slab_swizzle(row) : col); };
  if constexpr (kPasses == 0) {
    for (int q = threadIdx.x; q < nz * nz; q += kK1Threads) {
      ct[q] = dct[q];
      st[q] = idct[q];
    }
  } else if constexpr (kWgmma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 5; ++i) mbar_init(mbar + i, 1);
      fence_mbar_init();
    }
  } else {
    for (int q = threadIdx.x; q < nz * nz; q += kK1Threads) {
      const int r = q / nz, c = q - r * nz;
      ct[S(r, c)] = dct[q];
      st[S(r, c)] = idct[q];
    }
  }
  for (int q = threadIdx.x; q < nx; q += kK1Threads) bot[q] = bottom_in[e * nx + q];
  __syncthreads();

  auto wrap = [&](int i) { return i < 0 ? i + nx : (i >= nx ? i - nx : i); };
  int kl[NS], kc[NS];  // this lane's levels, and the same clamped into the column
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    kl[s] = lane + 32 * s;
    kc[s] = min(kl[s], nz - 1);
  }
  // z tap o of level s (offsets -3..3 as o = 0..6), clamped into a column of n
  auto tap = [&](int s, int o, int n) { return min(max(kl[s] + o - 3, 0), n - 1); };

  // x fluxes: u at center c (taps faces c-2..c+3); w, b at face c (taps c-3..c+2)
  auto xflux_u = [&](const State2D& S, int c, int k) {
    const float* u = S.u + k;
    const float a = u[wrap(c) * nz], b = u[wrap(c + 1) * nz];
    return ub5_upwind(u[wrap(c - 2) * nz], u[wrap(c - 1) * nz], a, b, u[wrap(c + 2) * nz],
                      u[wrap(c + 3) * nz], 0.5f * (a + b));
  };
  auto xflux_face = [&](const float* q, int ld, int c, float vel) {
    return ub5_upwind(q[wrap(c - 3) * ld], q[wrap(c - 2) * ld], q[wrap(c - 1) * ld],
                      q[wrap(c) * ld], q[wrap(c + 1) * ld], q[wrap(c + 2) * ld], vel);
  };
  auto xflux_w = [&](const State2D& S, int c, int s) {
    const float* uc = S.u + wrap(c) * nz;
    const float vel = 0.5f * (uc[max(kl[s] - 1, 0)] + uc[kc[s]]);
    return xflux_face(S.w + kc[s], nw, c, vel);
  };
  auto xflux_b = [&](const State2D& S, int c, int s) {
    return xflux_face(S.b + kc[s], nz, c, S.u[wrap(c) * nz + kc[s]]);
  };

  float gp[XS][NS][3] = {};  // the previous stage's gu, gw, gb of this thread's points
  float pt[XS][NS];     // the solve's tile: this thread's points
  unsigned phase = 0;   // the wgmma instances' mbarriers: the parity of this stage's phase
  for (int step = 0; step < P.n_substeps; ++step) {
    for (int stage = 0; stage < 3; ++stage) {
      const float gamma = kGamma[stage], zeta = kZeta[stage];
      const float dts = P.dts[stage], idts = P.idts[stage];
      const bool last = step == P.n_substeps - 1 && stage == 2;
      auto rk = [&](float f, float g, float g_prev) {
        return stage == 0 ? f + P.dt * (gamma * g) : f + P.dt * (gamma * g + zeta * g_prev);
      };

      // ---- 1. pHY' of this warp's columns: a float64 suffix scan along z ----
#pragma unroll
      for (int xi = 0; xi < XS; ++xi) {
        if (xi < xn) {
          double above = 0.0;
          phy_levels<NS>(X.b + (x0 + xi) * nz, s1 + (x0 + xi) * nz, 0, nz, lane, P, above);
        }
      }
      __syncthreads();

      // ---- 2. tendencies and the RK update, marching along x ------------------
      {
        float fu[NS], fw[NS], fb[NS];  // x fluxes entering the current column
        if (xn > 0) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            fu[s] = xflux_u(X, x0 - 1, kc[s]);
            fw[s] = xflux_w(X, x0, s);
            fb[s] = xflux_b(X, x0, s);
          }
        }
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
          if (xi < xn) {
            const int i = x0 + xi, im = wrap(i - 1), ip = wrap(i + 1);
            const float* uc = X.u + i * nz;
            const float* wc = X.w + i * nw;
            const float* bc = X.b + i * nz;
            const float* wm = X.w + im * nw;
            // z fluxes through face k of u (velocity w at the x-face) and b,
            // and through center k of w
            float zu[NS], zb[NS], zw[NS], zu_up[NS], zb_up[NS], zw_dn[NS];
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const ZOrders oc = z_orders(kl[s], nz), ow = z_orders(kl[s] + 1, nw);
              const int k = kc[s];
              zu[s] = z_upwind(uc[tap(s, 0, nz)], uc[tap(s, 1, nz)], uc[tap(s, 2, nz)], uc[k],
                               uc[tap(s, 4, nz)], uc[tap(s, 5, nz)], oc,
                               0.5f * (wm[k] + wc[k]));
              zb[s] = z_upwind(bc[tap(s, 0, nz)], bc[tap(s, 1, nz)], bc[tap(s, 2, nz)], bc[k],
                               bc[tap(s, 4, nz)], bc[tap(s, 5, nz)], oc, wc[k]);
              const float w0 = wc[k], w1 = wc[k + 1];
              zw[s] = z_upwind(wc[tap(s, 1, nw)], wc[tap(s, 2, nw)], w0, w1, wc[tap(s, 5, nw)],
                               wc[tap(s, 6, nw)], ow, 0.5f * (w0 + w1));
            }
            flux_above(zu, zu_up, lane, nz);
            flux_above(zb, zb_up, lane, nz);
            flux_below(zw, zw_dn, lane);
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const int kk = kl[s], k = kc[s];
              // ---- gu and u* at (face i, center k) ----
              {
                const float f_new = xflux_u(X, i, k);
                float adv = (f_new - fu[s]) * P.idx;
                fu[s] = f_new;
                adv += (zu_up[s] - zu[s]) * P.idz;
                const float dphy = (s1[i * nz + k] - s1[im * nz + k]) * P.idx;
                const float q = uc[k];
                const float qm = kk > 0 ? uc[max(kk - 1, 0)] : -uc[0];
                const float qp = kk < nz - 1 ? uc[min(kk + 1, nz - 1)] : -uc[nz - 1];
                const float lap = (X.u[ip * nz + k] - 2.0f * q + X.u[im * nz + k]) * P.idx2 +
                                  (qp - 2.0f * q + qm) * P.idz2;
                const float g = -adv - dphy + P.nu * lap;
                if (kk < nz) Y.u[i * nz + k] = rk(q, g, gp[xi][s][0]);
                gp[xi][s][0] = g;
              }
              // ---- gw and w* at (center i, face k); face 0 is a wall ----
              {
                const float f_new = xflux_w(X, i + 1, s);
                float adv = (f_new - fw[s]) * P.idx;
                fw[s] = f_new;
                adv += (zw[s] - zw_dn[s]) * P.idz;
                const float q = wc[k];
                const float lap = (X.w[ip * nw + k] - 2.0f * q + X.w[im * nw + k]) * P.idx2 +
                                  (wc[k + 1] - 2.0f * q + wc[max(k - 1, 0)]) * P.idz2;
                const float g = kk == 0 ? 0.0f : -adv + P.nu * lap;
                if (kk < nz) Y.w[i * nw + k] = rk(q, g, gp[xi][s][1]);
                gp[xi][s][1] = g;
              }
              // ---- gb and b' at (center i, center k) ----
              {
                const float f_new = xflux_b(X, i + 1, s);
                float adv = (f_new - fb[s]) * P.idx;
                fb[s] = f_new;
                adv += (zb_up[s] - zb[s]) * P.idz;
                const float q = bc[k];
                const float qm = kk > 0 ? bc[max(kk - 1, 0)] : 2.0f * bot[i] - bc[0];
                const float qp = kk < nz - 1 ? bc[min(kk + 1, nz - 1)] : 2.0f * P.min_b - bc[nz - 1];
                const float lap = (X.b[ip * nz + k] - 2.0f * q + X.b[im * nz + k]) * P.idx2 +
                                  (qp - 2.0f * q + qm) * P.idz2;
                const float g = -adv + P.kappa * lap;
                if (kk < nz) Y.b[i * nz + k] = rk(q, g, gp[xi][s][2]);
                gp[xi][s][2] = g;
              }
            }
          }
        }
      }
      __syncthreads();
      if constexpr (kWgmma) {  // F's rows (at 1 pass and G's) into the state copy just read
        if (threadIdx.x == 0) stage_fg(X.u);
      }

      // ---- 3. div(u*, w*) / dt_stage ------------------------------------------
#pragma unroll
      for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int i = x0 + xi, k = kl[s];
          if (xi < xn && k < nz) {
            const float div = (Y.u[wrap(i + 1) * nz + k] - Y.u[i * nz + k]) * P.idx +
                              (Y.w[i * nw + k + 1] - Y.w[i * nw + k]) * P.idz;
            if constexpr (kPasses == 0) {
              s1[i * nz + k] = div * idts;
            } else if constexpr (kWgmma) {  // rhs^T, product 1's A
              s1[k1_afrag_index(k, i)] = div * idts;
            } else {
              s1[S(i, k)] = div * idts;
            }
          }
        }
      }
      __syncthreads();

      if constexpr (kPasses == 0) {
        // ---- 4. the solve: four products, each from one slab into the other ---
        auto store = [&](float* dst) {
#pragma unroll
          for (int xi = 0; xi < XS; ++xi)
#pragma unroll
            for (int s = 0; s < NS; ++s)
              if (xi < xn && kl[s] < nz) dst[(x0 + xi) * nz + kl[s]] = pt[xi][s];
        };
        tile_product<XS, NS, kVec>(fmat, s1, nx, nz, x0, nx, 0, lane, pt);  // r_hat = F . rhs
        store(s2);
        __syncthreads();
        tile_product<XS, NS, kVec>(s2, ct, nz, nz, x0, nx, 0, lane, pt);  // r_hat C^T
#pragma unroll
        for (int xi = 0; xi < XS; ++xi)
#pragma unroll
          for (int s = 0; s < NS; ++s)
            pt[xi][s] *= __ldg(dinv + min(x0 + xi, nx - 1) * nz + kc[s]);
        store(s1);
        __syncthreads();
        tile_product<XS, NS, kVec>(s1, st, nz, nz, x0, nx, 0, lane, pt);  // p_hat = R~ S^T
        store(s2);
        __syncthreads();
        tile_product<XS, NS, kVec>(gmat, s2, nx, nz, x0, nx, 0, lane, pt);  // p = G . p_hat
        store(s1);
        if (last) {
#pragma unroll
          for (int xi = 0; xi < XS; ++xi)
#pragma unroll
            for (int s = 0; s < NS; ++s)
              if (xi < xn && kl[s] < nz) p_out[e * nc + (x0 + xi) * nz + kl[s]] = pt[xi][s];
        }
        __syncthreads();

        // ---- 5. correct this thread's u*, w* by grad p --------------------------
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              const float p = pt[xi][s];
              const float pm = xi > 0 ? pt[xi - 1][s] : s1[wrap(i - 1) * nz + k];
              Y.u[i * nz + k] -= dts * ((p - pm) * P.idx);
              if (k > 0) Y.w[i * nw + k] -= dts * ((p - s1[i * nz + k - 1]) * P.idz);
            }
          }
        }
        __syncthreads();
      } else if constexpr (kWgmma) {
        // ---- 4. the solve on the tensor cores: four products, slab to slab --
        // warpgroup wg, its warp wl; the lane's rows of a 64 x 24 tile are
        // 16 wl + g + 8 h, its columns 8 j + 2 t + e (acc[4 j + 2 h + e])
        const int wg = threadIdx.x >> 7, wl = warp & 3, g = lane >> 2, t = lane & 3;
        constexpr int H = k1_tf32_parts(kPasses);
        float* xg = X.u + wg * 2 * kWgRows;  // F's rows of its modes, then G's of its columns
        // its modes of r_hat, then t: at 3 passes where F's rows were
        float* rt = kPasses == 3 ? xg : s2 + nc + wg * kWgModes;
        auto row = [&](int i) { return 16 * wl + g + 8 * ((i >> 1) & 1); };
        auto col = [&](int i) { return 8 * (i >> 2) + 2 * t + (i & 1); };
        auto slab_a = [&](const float* a) {  // A from a slab, split here
          return [=](int s, unsigned (&hi)[4], unsigned (&lo)[4]) {
            const float4 v = *reinterpret_cast<const float4*>(
                a + ((s * 4 + wl) * 32 + k1_afrag_slot(lane)) * 4);
            const float x[4] = {v.x, v.y, v.z, v.w};
            tf32_operands<kPasses>(x, hi, lo);
          };
        };
        auto const_a = [&](int at) {  // A from the packed constants, TF32-exact
          return [=](int s, unsigned (&hi)[4], unsigned (&lo)[4]) {
            const float4* p =
                reinterpret_cast<const float4*>(tf32 + at) + ((s * 4 + wl) * 32 + lane) * H;
            const float4 v = __ldg(p);
            hi[0] = __float_as_uint(v.x), hi[1] = __float_as_uint(v.y);
            hi[2] = __float_as_uint(v.z), hi[3] = __float_as_uint(v.w);
            if constexpr (kPasses == 3) {
              const float4 l = __ldg(p + 1);
              lo[0] = __float_as_uint(l.x), lo[1] = __float_as_uint(l.y);
              lo[2] = __float_as_uint(l.z), lo[3] = __float_as_uint(l.w);
            }
          };
        };
        // r_hat or t, a B^T operand of the next product: TF32-exact parts
        auto store_b = [&](float* dst, int idx, float v) {
          if constexpr (kPasses == 3) {
            const unsigned hi = __float_as_uint(v) & 0xffffe000u;
            dst[idx] = __uint_as_float(hi);
            dst[idx + kWgModes] = __uint_as_float(to_tf32(v - __uint_as_float(hi)));
          } else {
            dst[idx] = __uint_as_float(to_tf32(v));
          }
        };
        float acc[12];
        mbar_wait(mbar, phase);  // F's rows have landed
        wg_product<kPasses, 12>(acc, slab_a(s1), xg, kWgRows);  // r_hat^T = rhs^T F^T
        if constexpr (kPasses == 3) warpgroup_barrier();  // F's rows read: r_hat takes them
#pragma unroll
        for (int i = 0; i < 12; ++i) store_b(rt, k1_bcore_index(col(i), row(i), 64), acc[i]);
        fence_proxy_async();
        warpgroup_barrier();
        // t^T = ct^T r_hat^T
        wg_product<kPasses, 8>(acc, const_a(k1_tf32_ct(kPasses)), rt, kWgModes);
        {
          const float4* d = reinterpret_cast<const float4*>(tf32 + k1_tf32_dinv(kPasses)) +
                            ((wg * 4 + wl) * 32 + lane) * 3;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float4 v = __ldg(d + q);
            acc[4 * q] *= v.x, acc[4 * q + 1] *= v.y, acc[4 * q + 2] *= v.z, acc[4 * q + 3] *= v.w;
          }
        }
        warpgroup_barrier();  // r_hat read: t takes its place
#pragma unroll
        for (int i = 0; i < 12; ++i) store_b(rt, k1_bcore_index(col(i), row(i), 64), acc[i]);
        fence_proxy_async();
        warpgroup_barrier();
        // p_hat^T = st^T t^T
        wg_product<kPasses, 8>(acc, const_a(k1_tf32_st(kPasses)), rt, kWgModes);
#pragma unroll
        for (int i = 0; i < 12; ++i) s2[k1_afrag_index(row(i), kWgN * wg + col(i))] = acc[i];
        if constexpr (kPasses == 3) {  // G's rows of its columns where t was
          warpgroup_barrier();
          if ((threadIdx.x & 127) == 0) {
            fence_proxy_async();
            bulk_copy_g2s(xg, tf32 + 4 * 2 * kWgRows + wg * 2 * kWgRows, 4 * 2 * kWgRows,
                          mbar + 1 + wg);
          }
        }
        __syncthreads();  // p_hat of every mode
        if constexpr (kPasses == 3) mbar_wait(mbar + 1 + wg, phase);
        wg_product<kPasses, 12>(acc, slab_a(s2), kPasses == 3 ? xg : xg + kWgRows,
                                kWgRows);  // p^T = p_hat^T G^T
#pragma unroll
        for (int i = 0; i < 12; ++i) s1[(kWgN * wg + col(i)) * nz + row(i)] = acc[i];
        __syncthreads();

        // ---- 5. correct this thread's u*, w* by grad p, read from the slab --
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              const float p = s1[i * nz + k];
              Y.u[i * nz + k] -= dts * ((p - s1[wrap(i - 1) * nz + k]) * P.idx);
              if (k > 0) Y.w[i * nw + k] -= dts * ((p - s1[i * nz + k - 1]) * P.idz);
              if (last) p_out[e * nc + i * nz + k] = p;
            }
          }
        }
        // the march never writes w's top wall face: zero it again in the copy
        // the constants took
        for (int q = threadIdx.x; q < nx; q += kK1Threads) X.w[q * nw + nz] = 0.0f;
        phase ^= 1;
        __syncthreads();
      } else {
        // ---- 4. the solve on the tensor cores: four products, slab to slab --
        constexpr bool kEdge = !(NX > 0 && NX % 16 == 0 && NZ % 32 == 0);
        auto slab = [&](const float* a) { return [=](int r, int c) { return a[S(r, c)]; }; };
        auto to_slab = [&](float* a) { return [=](int r, int c, float v) { a[S(r, c)] = v; }; };
        auto global = [](const float* a, int ld) {
          return [=](int r, int c) { return __ldg(a + r * ld + c); };
        };
        mma_product<kPasses, kEdge>(nx, nz, nx, global(fmat, nx), slab(s1),
                                    to_slab(s2));  // r_hat = F . rhs
        __syncthreads();
        mma_product<kPasses, kEdge>(nx, nz, nz, slab(s2), slab(ct),  // (r_hat C^T) * d
                                    [&](int r, int c, float v) {
                                      s1[S(r, c)] = v * __ldg(dinv + r * nz + c);
                                    });
        __syncthreads();
        mma_product<kPasses, kEdge>(nx, nz, nz, slab(s1), slab(st),
                                    to_slab(s2));  // p_hat = R~ S^T
        __syncthreads();
        mma_product<kPasses, kEdge>(nx, nz, nx, global(gmat, nx), slab(s2),
                                    to_slab(s1));  // p = G . p_hat
        __syncthreads();

        // ---- 5. correct this thread's u*, w* by grad p, read from the slab --
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              const float p = s1[S(i, k)];
              Y.u[i * nz + k] -= dts * ((p - s1[S(wrap(i - 1), k)]) * P.idx);
              if (k > 0) Y.w[i * nw + k] -= dts * ((p - s1[S(i, k - 1)]) * P.idz);
              if (last) p_out[e * nc + i * nz + k] = p;
            }
          }
        }
        __syncthreads();
      }
      const State2D t = X;
      X = Y;
      Y = t;
    }
  }

  for (int q = threadIdx.x; q < nc; q += kK1Threads) {
    u_out[e * nc + q] = X.u[q];
    b_out[e * nc + q] = X.b[q];
  }
  for (int q = threadIdx.x; q < nf; q += kK1Threads) w_out[e * nf + q] = X.w[q];
}

// The on-chip K1 instance for a grid and a pass count: specialised for the
// reference's 96x64, the runtime-size one for every other grid; the float32
// solve (0 passes) or the TF32 one (1 or 3).
decltype(&env_step_2d_kernel<0, 0>) env_step_kernel_for(int nx, int nz, int passes) {
  const bool ref = nx == 96 && nz == 64;
  if (passes == 3) return ref ? env_step_2d_kernel<96, 64, 3> : env_step_2d_kernel<0, 0, 3>;
  if (passes == 1) return ref ? env_step_2d_kernel<96, 64, 1> : env_step_2d_kernel<0, 0, 1>;
  return ref ? env_step_2d_kernel<96, 64> : env_step_2d_kernel<0, 0>;
}

// dst = L . R for the (nrow, ldr) result, one 4 x 32 tile a warp at a time,
// each element scaled by epi(value, row, col) on its way out.
template <class Epi>
__device__ __forceinline__ void block_product(const float* L, const float* R, int K, int ldr,
                                              int nrow, float* dst, Epi epi) {
  constexpr int XS = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_c = (ldr + 31) / 32, tiles = (nrow + XS - 1) / XS * tiles_c;
  for (int t = warp; t < tiles; t += kK1Warps) {
    const int r0 = t / tiles_c * XS, col = t % tiles_c * 32 + lane;
    float acc[XS][1];
    tile_product<XS, 1, false>(L, R, K, ldr, r0, nrow, col - lane, lane, acc);
#pragma unroll
    for (int r = 0; r < XS; ++r)
      if (r0 + r < nrow && col < ldr) dst[(r0 + r) * ldr + col] = epi(acc[r][0], r0 + r, col);
  }
}

// K1's off-chip instance (see the head of this file), for the grids the
// on-chip one cannot hold; kGlobalSlabs: its two slabs in per-env global
// scratch after the rest, where they do not fit a block.
template <int kPasses = 0, bool kGlobalSlabs = false>
__global__ void __launch_bounds__(kK1Threads)
env_step_2d_global_kernel(const float* __restrict__ u_in, const float* __restrict__ w_in,
                          const float* __restrict__ b_in, const float* __restrict__ bottom_in,
                          const float* __restrict__ fmat, const float* __restrict__ gmat,
                          const float* __restrict__ dct, const float* __restrict__ idct,
                          const float* __restrict__ dinv, float* u_all, float* w_all,
                          float* b_all, float* p_all, float* scratch, K1Params P,
                          RBCParams R) {
  extern __shared__ float smem[];
  const int nx = P.nx, nz = P.nz, nw = nz + 1;
  const int nc = nx * nz, nf = nx * nw;
  const size_t e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* u = u_all + e * nc;
  float* w = w_all + e * nf;
  float* b = b_all + e * nc;
  float* p = p_all + e * nc;
  const float* bottom = bottom_in + e * nx;
  float* gu = scratch + e * (size_t)((kGlobalSlabs ? 7 : 5) * nc + 2 * nf);  // env_step_2d_scratch_floats
  float* gw = gu + nc;
  float* gb = gw + nf;
  float* gu0 = gb + nc;  // the previous stage's
  float* gw0 = gu0 + nc;
  float* gb0 = gw0 + nf;
  float* p_hy = gb0 + nc;
  float* s1 = kGlobalSlabs ? p_hy + nc : smem;  // the divergence, then R~
  float* s2 = s1 + nc;                          // r_hat, then p_hat

  for (int q = threadIdx.x; q < nc; q += kK1Threads) {
    u[q] = u_in[e * nc + q];
    b[q] = b_in[e * nc + q];
  }
  for (int q = threadIdx.x; q < nf; q += kK1Threads) w[q] = w_in[e * nf + q];
  __syncthreads();

  for (int step = 0; step < P.n_substeps; ++step) {
    for (int stage = 0; stage < 3; ++stage) {
      const float gamma = kGamma[stage], zeta = kZeta[stage];
      const float dts = P.dts[stage], idts = P.idts[stage];
      auto rk = [&](float f, float g, float g_prev) {
        return stage == 0 ? f + P.dt * (gamma * g) : f + P.dt * (gamma * g + zeta * g_prev);
      };
      for (int i = warp; i < nx; i += kK1Warps) {
        double above = 0.0;
        for (int k0 = (nz - 1) / 32 * 32; k0 >= 0; k0 -= 32)
          phy_levels<1>(b + i * nz, p_hy + i * nz, k0, nz, lane, P, above);
      }
      __syncthreads();
      tendencies_block(u, w, b, p_hy, bottom, gu, gw, gb, R);
      __syncthreads();
      for (int q = threadIdx.x; q < nc; q += kK1Threads) {
        u[q] = rk(u[q], gu[q], gu0[q]);
        b[q] = rk(b[q], gb[q], gb0[q]);
        gu0[q] = gu[q];
        gb0[q] = gb[q];
      }
      for (int q = threadIdx.x; q < nf; q += kK1Threads) {
        w[q] = rk(w[q], gw[q], gw0[q]);
        gw0[q] = gw[q];
      }
      __syncthreads();
      for (int q = threadIdx.x; q < nc; q += kK1Threads) {
        const int i = q / nz, k = q - i * nz;
        const float div = (u[wrap_x(i + 1, nx) * nz + k] - u[q]) * P.idx +
                          (w[i * nw + k + 1] - w[i * nw + k]) * P.idz;
        s1[q] = div * idts;
      }
      __syncthreads();
      if constexpr (kPasses == 0) {
        auto as_is = [](float v, int, int) { return v; };
        block_product(fmat, s1, nx, nz, nx, s2, as_is);  // r_hat = F . rhs
        __syncthreads();
        block_product(s2, dct, nz, nz, nx, s1,  // (r_hat C^T) * d
                      [&](float v, int m, int j) { return v * __ldg(dinv + m * nz + j); });
        __syncthreads();
        block_product(s1, idct, nz, nz, nx, s2, as_is);  // p_hat = R~ S^T
        __syncthreads();
        block_product(gmat, s2, nx, nz, nx, p, as_is);  // p = G . p_hat
        __syncthreads();
      } else {  // the same products on the tensor cores, every slab plain
        auto rd = [](const float* a, int ld) {
          return [=](int r, int c) { return a[r * ld + c]; };
        };
        auto wr = [nz](float* a) { return [=](int r, int c, float v) { a[r * nz + c] = v; }; };
        mma_product<kPasses, true>(nx, nz, nx, rd(fmat, nx), rd(s1, nz), wr(s2));
        __syncthreads();
        mma_product<kPasses, true>(nx, nz, nz, rd(s2, nz), rd(dct, nz), [&](int r, int c, float v) {
          s1[r * nz + c] = v * __ldg(dinv + r * nz + c);
        });
        __syncthreads();
        mma_product<kPasses, true>(nx, nz, nz, rd(s1, nz), rd(idct, nz), wr(s2));
        __syncthreads();
        mma_product<kPasses, true>(nx, nz, nx, rd(gmat, nx), rd(s2, nz), wr(p));
        __syncthreads();
      }
      for (int q = threadIdx.x; q < nc; q += kK1Threads) {
        const int i = q / nz, k = q - i * nz;
        u[q] -= dts * ((p[q] - p[wrap_x(i - 1, nx) * nz + k]) * P.idx);
      }
      for (int q = threadIdx.x; q < nf; q += kK1Threads) {
        const int i = q / nw, k = q - i * nw;
        if (k > 0 && k < nz) w[q] -= dts * ((p[i * nz + k] - p[i * nz + k - 1]) * P.idz);
      }
      __syncthreads();
    }
  }
}

// The off-chip K1 instance for a pass count, its slabs in shared memory or
// (slabs = false) in global scratch.
decltype(&env_step_2d_global_kernel<0>) env_step_global_kernel_for(int passes, bool slabs) {
  if (passes == 3) return slabs ? env_step_2d_global_kernel<3> : env_step_2d_global_kernel<3, true>;
  if (passes == 1) return slabs ? env_step_2d_global_kernel<1> : env_step_2d_global_kernel<1, true>;
  return slabs ? env_step_2d_global_kernel<0> : env_step_2d_global_kernel<0, true>;
}

// ---- K1's cluster instance ----------------------------------------------------

// acc[r][s] += sum_{k < K} L[row_r][k] R[k][col_s], as tile_product (the
// rows and columns clamped alike, col0 = 0) with L's rows ldl apart and
// acc not cleared first, so that one sum can run over several slabs.
template <int XS, int NS, bool kVec>
__device__ __forceinline__ void tile_product_acc(const float* L, int ldl, const float* R, int K,
                                                 int ldr, int row0, int nrow, int lane,
                                                 float (&acc)[XS][NS]) {
  int row[XS], col[NS];
#pragma unroll
  for (int r = 0; r < XS; ++r) row[r] = min(row0 + r, nrow - 1) * ldl;
#pragma unroll
  for (int s = 0; s < NS; ++s) col[s] = min(lane + 32 * s, ldr - 1);
  if constexpr (kVec) {
#pragma unroll 4
    for (int k = 0; k < K; k += 4) {
      float4 a[XS];
#pragma unroll
      for (int r = 0; r < XS; ++r) a[r] = *reinterpret_cast<const float4*>(L + row[r] + k);
      const float* rk = R + k * ldr;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) bv[s] = rk[kk * ldr + col[s]];
#pragma unroll
        for (int r = 0; r < XS; ++r) {
          const float av = kk == 0 ? a[r].x : (kk == 1 ? a[r].y : (kk == 2 ? a[r].z : a[r].w));
#pragma unroll
          for (int s = 0; s < NS; ++s) acc[r][s] = fmaf(av, bv[s], acc[r][s]);
        }
      }
    }
  } else {
    for (int k = 0; k < K; ++k) {
      float bv[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) bv[s] = R[k * ldr + col[s]];
#pragma unroll
      for (int r = 0; r < XS; ++r) {
        const float av = L[row[r] + k];
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[r][s] = fmaf(av, bv[s], acc[r][s]);
      }
    }
  }
}

// acc += L . R over the 16 x 32 tile at (m0, n0), K deep, in kPasses TF32
// passes: mma_product's loop for one tile, its accumulator kept by the
// caller. ld_l and ld_r give 0 outside their operands.
template <int kPasses, class LdL, class LdR>
__device__ __forceinline__ void mma_tile(int m0, int n0, int K, LdL ld_l, LdR ld_r,
                                         float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float a[4] = {ld_l(m0 + g, k0 + t), ld_l(m0 + g + 8, k0 + t), ld_l(m0 + g, k0 + t + 4),
                        ld_l(m0 + g + 8, k0 + t + 4)};
    unsigned ah[4], al[4];
    tf32_operands<kPasses>(a, ah, al);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * j + g;
      const float b[2] = {ld_r(k0 + t, c), ld_r(k0 + t + 4, c)};
      unsigned bh[2], bl[2];
      tf32_operands<kPasses>(b, bh, bl);
      if constexpr (kPasses == 3) {
        mma_tf32(acc[j], ah, bl);
        mma_tf32(acc[j], al, bh);
      }
      mma_tf32(acc[j], ah, bh);
    }
  }
}

// Slabs of the other CTAs that K1's cluster instance copies into its dead
// state copy at a time (that copy holds 3 nc + nxl floats).
constexpr int kK1StagedSlabs = 3;

// K1's cluster instance (see the head of this file): one env on a cluster
// of c CTAs; CTA r holds the columns [r nxl, (r + 1) nxl), nxl = nx / c, in
// the on-chip layout. NXL, NZ are nxl and nz where compile-time.
template <int NXL, int NZ, int kPasses = 0>
__global__ void __launch_bounds__(kK1Threads, 1)
env_step_2d_cluster_kernel(const float* __restrict__ u_in, const float* __restrict__ w_in,
                           const float* __restrict__ b_in, const float* __restrict__ bottom_in,
                           const float* __restrict__ fmat, const float* __restrict__ gmat,
                           const float* __restrict__ dct, const float* __restrict__ idct,
                           const float* __restrict__ dinv, float* __restrict__ u_out,
                           float* __restrict__ w_out, float* __restrict__ b_out,
                           float* __restrict__ p_out, K1Params P, int fg_rows) {
  constexpr int NS = kK1Levels;
  constexpr int XS = NXL > 0 ? k1_cols(NXL) : kK1MaxCols;
  constexpr bool kVec = NXL > 0 && NXL % 4 == 0 && NZ % 4 == 0;
  extern __shared__ float smem[];
  float* const cta = cta_shared(smem);
  const int c = cluster_size(), r = cluster_rank();
  const int left = r > 0 ? r - 1 : c - 1, right = r + 1 < c ? r + 1 : 0;
  const int nx = P.nx, nz = NZ > 0 ? NZ : P.nz, nw = nz + 1;
  const int nxl = NXL > 0 ? NXL : nx / c;
  const int nc = nxl * nz, nf = nxl * nw;
  const size_t e = blockIdx.x / c;
  const int x_off = r * nxl;  // this CTA's first column
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xs = k1_cols(nxl), x0 = warp * xs, xn = min(xs, nxl - x0);  // xn may be <= 0

  State2D X{cta, cta + nc, cta + nc + nf};
  State2D Y{X.b + nc, X.b + nc + nc, X.b + nc + nc + nf};
  float* sa = Y.b + nc;       // the halo, then the divergence, then p
  float* sb = sa + nc;        // pHY', then r_hat, then p_hat
  float* ct = sb + nc;        // z analysis, (z, j)
  float* st = ct + nz * nz;   // z synthesis, (j, z)
  float* bot = st + nz * nz;  // bottom (nxl)
  // with fg_rows (env_step_2d_cluster_fg) this CTA's rows of F, then of G
  // (nxl x nx each), which the float32 products read here
  // (never where the CTA's slab is compile-time and F and G's rows cannot
  // fit beside it even at c = 2, as at 96 x 64: that code is left out)
  constexpr bool kMayHoldFG =
      NXL == 0 || sizeof(float) * (on_chip_smem_floats(NXL, NZ) + 4 * (size_t)NXL * NXL) <=
                      kSmemPerBlock;
  const bool fg = kPasses == 0 && kMayHoldFG && fg_rows;
  float* frows = bot + nxl;
  float* grows = frows + nxl * nx;
  // the march's x halo in sa: columns -3, -2, -1, nxl, nxl + 1, nxl + 2 of
  // u, w and b, and pHY' of column -1 (19 nz + 6 floats; nxl >= 49 on every
  // grid the cluster takes, so they fit)
  float* hu = sa;
  float* hw = hu + 6 * nz;
  float* hb = hw + 6 * nw;
  float* hp = hb + 6 * nz;

  {
    const size_t ec = e * (size_t)nx * nz + (size_t)x_off * nz;
    const size_t ef = e * (size_t)nx * nw + (size_t)x_off * nw;
    for (int q = threadIdx.x; q < nc; q += kK1Threads) {
      X.u[q] = u_in[ec + q];
      X.b[q] = b_in[ec + q];
    }
    for (int q = threadIdx.x; q < nf; q += kK1Threads) X.w[q] = Y.w[q] = w_in[ef + q];
    for (int q = threadIdx.x; q < nz * nz; q += kK1Threads) {
      ct[q] = dct[q];
      st[q] = idct[q];
    }
    for (int q = threadIdx.x; q < nxl; q += kK1Threads) bot[q] = bottom_in[e * nx + x_off + q];
    if (fg) {
      for (int q = threadIdx.x; q < nxl * nx; q += kK1Threads) {
        frows[q] = fmat[(size_t)x_off * nx + q];
        grows[q] = gmat[(size_t)x_off * nx + q];
      }
    }
  }
  __syncthreads();

  int kl[NS], kc[NS];  // this lane's levels, and the same clamped into the column
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    kl[s] = lane + 32 * s;
    kc[s] = min(kl[s], nz - 1);
  }
  auto tap = [&](int s, int o, int n) { return min(max(kl[s] + o - 3, 0), n - 1); };
  // column i (-3 <= i < nxl + 3) of a field of the state X: its own, or the halo's
  auto col = [&](const float* f, const float* h, int ld, int i) {
    return i < 0 ? h + (i + 3) * ld : (i >= nxl ? h + (i - nxl + 3) * ld : f + i * ld);
  };
  auto xflux_u = [&](int cc, int k) {
    auto u = [&](int i) { return col(X.u, hu, nz, i)[k]; };
    const float a = u(cc), b = u(cc + 1);
    return ub5_upwind(u(cc - 2), u(cc - 1), a, b, u(cc + 2), u(cc + 3), 0.5f * (a + b));
  };
  auto xflux_face = [&](const float* f, const float* h, int ld, int cc, int k, float vel) {
    auto q = [&](int i) { return col(f, h, ld, i)[k]; };
    return ub5_upwind(q(cc - 3), q(cc - 2), q(cc - 1), q(cc), q(cc + 1), q(cc + 2), vel);
  };
  auto xflux_w = [&](int cc, int s) {
    const float* uc = col(X.u, hu, nz, cc);
    const float vel = 0.5f * (uc[max(kl[s] - 1, 0)] + uc[kc[s]]);
    return xflux_face(X.w, hw, nw, cc, kc[s], vel);
  };
  auto xflux_b = [&](int cc, int s) {
    return xflux_face(X.b, hb, nz, cc, kc[s], col(X.u, hu, nz, cc)[kc[s]]);
  };
  // the halo from the neighbours' shared memory: two warps a run of columns
  auto halo_copy = [&] {
    const int run = warp >> 1;
    if (run < 7) {
      const float* src;
      float* dst;
      int n;
      switch (run) {
        case 0: src = X.u + (nxl - 3) * nz; dst = hu; n = 3 * nz; break;
        case 1: src = X.w + (nxl - 3) * nw; dst = hw; n = 3 * nw; break;
        case 2: src = X.b + (nxl - 3) * nz; dst = hb; n = 3 * nz; break;
        case 3: src = sb + (nxl - 1) * nz; dst = hp; n = nz; break;
        case 4: src = X.u; dst = hu + 3 * nz; n = 3 * nz; break;
        case 5: src = X.w; dst = hw + 3 * nw; n = 3 * nw; break;
        default: src = X.b; dst = hb + 3 * nz; n = 3 * nz; break;
      }
      src = cluster_map(src, run < 4 ? left : right);
      for (int q = (warp & 1) * 32 + lane; q < n; q += 64) dst[q] = src[q];
    }
  };
  // the slabs of CTAs r + q0 .. r + q0 + nq - 1 (mod c), copied into the
  // dead state copy D: slab at the same place in each CTA
  auto stage_slabs = [&](float* D, const float* slab, int q0, int nq) {
    for (int j = 0; j < nq; ++j) {
      const int q = (r + q0 + j) % c;
      const float* src = cluster_map(slab, q);
      float* dst = D + j * nc;
      if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && (nc & 3) == 0) {
#pragma unroll 4
        for (int i = 4 * threadIdx.x; i < nc; i += 4 * kK1Threads)
          *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
      } else {
        for (int i = threadIdx.x; i < nc; i += kK1Threads) dst[i] = src[i];
      }
    }
  };

  float gp[XS][NS][3] = {};  // the previous stage's gu, gw, gb of this thread's points
  float pt[XS][NS];          // the solve's tile: this thread's points
  for (int step = 0; step < P.n_substeps; ++step) {
    for (int stage = 0; stage < 3; ++stage) {
      const float gamma = kGamma[stage], zeta = kZeta[stage];
      const float dts = P.dts[stage], idts = P.idts[stage];
      const bool last = step == P.n_substeps - 1 && stage == 2;
      auto rk = [&](float f, float g, float g_prev) {
        return stage == 0 ? f + P.dt * (gamma * g) : f + P.dt * (gamma * g + zeta * g_prev);
      };
      float* D = X.u;  // the state copy that is dead after the march (3 nc + nxl floats)

      // ---- 1. pHY' of this warp's columns into sb ---------------------------
#pragma unroll
      for (int xi = 0; xi < XS; ++xi) {
        if (xi < xn) {
          double above = 0.0;
          phy_levels<NS>(X.b + (x0 + xi) * nz, sb + (x0 + xi) * nz, 0, nz, lane, P, above);
        }
      }
      cluster_barrier();  // (1) the neighbours' corrected state and pHY'
      halo_copy();
      __syncthreads();

      // ---- 2. tendencies and the RK update, marching along x ----------------
      {
        float fu[NS], fw[NS], fb[NS];  // x fluxes entering the current column
        if (xn > 0) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            fu[s] = xflux_u(x0 - 1, kc[s]);
            fw[s] = xflux_w(x0, s);
            fb[s] = xflux_b(x0, s);
          }
        }
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
          if (xi < xn) {
            const int i = x0 + xi, im = i - 1, ip = i + 1;
            const float* uc = X.u + i * nz;
            const float* wc = X.w + i * nw;
            const float* bc = X.b + i * nz;
            const float* wm = col(X.w, hw, nw, im);
            const float* phm = im < 0 ? hp : sb + im * nz;
            float zu[NS], zb[NS], zw[NS], zu_up[NS], zb_up[NS], zw_dn[NS];
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const ZOrders oc = z_orders(kl[s], nz), ow = z_orders(kl[s] + 1, nw);
              const int k = kc[s];
              zu[s] = z_upwind(uc[tap(s, 0, nz)], uc[tap(s, 1, nz)], uc[tap(s, 2, nz)], uc[k],
                               uc[tap(s, 4, nz)], uc[tap(s, 5, nz)], oc,
                               0.5f * (wm[k] + wc[k]));
              zb[s] = z_upwind(bc[tap(s, 0, nz)], bc[tap(s, 1, nz)], bc[tap(s, 2, nz)], bc[k],
                               bc[tap(s, 4, nz)], bc[tap(s, 5, nz)], oc, wc[k]);
              const float w0 = wc[k], w1 = wc[k + 1];
              zw[s] = z_upwind(wc[tap(s, 1, nw)], wc[tap(s, 2, nw)], w0, w1, wc[tap(s, 5, nw)],
                               wc[tap(s, 6, nw)], ow, 0.5f * (w0 + w1));
            }
            flux_above(zu, zu_up, lane, nz);
            flux_above(zb, zb_up, lane, nz);
            flux_below(zw, zw_dn, lane);
            const float* um = col(X.u, hu, nz, im);
            const float* up = col(X.u, hu, nz, ip);
            const float* wp = col(X.w, hw, nw, ip);
            const float* bm = col(X.b, hb, nz, im);
            const float* bp = col(X.b, hb, nz, ip);
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const int kk = kl[s], k = kc[s];
              // ---- gu and u* at (face i, center k) ----
              {
                const float f_new = xflux_u(i, k);
                float adv = (f_new - fu[s]) * P.idx;
                fu[s] = f_new;
                adv += (zu_up[s] - zu[s]) * P.idz;
                const float dphy = (sb[i * nz + k] - phm[k]) * P.idx;
                const float q = uc[k];
                const float qm = kk > 0 ? uc[max(kk - 1, 0)] : -uc[0];
                const float qp = kk < nz - 1 ? uc[min(kk + 1, nz - 1)] : -uc[nz - 1];
                const float lap =
                    (up[k] - 2.0f * q + um[k]) * P.idx2 + (qp - 2.0f * q + qm) * P.idz2;
                const float g = -adv - dphy + P.nu * lap;
                if (kk < nz) Y.u[i * nz + k] = rk(q, g, gp[xi][s][0]);
                gp[xi][s][0] = g;
              }
              // ---- gw and w* at (center i, face k); faces 0 and nz are walls ----
              {
                const float f_new = xflux_w(i + 1, s);
                float adv = (f_new - fw[s]) * P.idx;
                fw[s] = f_new;
                adv += (zw[s] - zw_dn[s]) * P.idz;
                const float q = wc[k];
                const float lap = (wp[k] - 2.0f * q + wm[k]) * P.idx2 +
                                  (wc[k + 1] - 2.0f * q + wc[max(k - 1, 0)]) * P.idz2;
                const float g = kk == 0 ? 0.0f : -adv + P.nu * lap;
                if (kk < nz) Y.w[i * nw + k] = rk(q, g, gp[xi][s][1]);
                if (kk == nz - 1) Y.w[i * nw + nz] = 0.0f;  // Y was D: its top face is lost
                gp[xi][s][1] = g;
              }
              // ---- gb and b' at (center i, center k) ----
              {
                const float f_new = xflux_b(i + 1, s);
                float adv = (f_new - fb[s]) * P.idx;
                fb[s] = f_new;
                adv += (zb_up[s] - zb[s]) * P.idz;
                const float q = bc[k];
                const float qm = kk > 0 ? bc[max(kk - 1, 0)] : 2.0f * bot[i] - bc[0];
                const float qp =
                    kk < nz - 1 ? bc[min(kk + 1, nz - 1)] : 2.0f * P.min_b - bc[nz - 1];
                const float lap =
                    (bp[k] - 2.0f * q + bm[k]) * P.idx2 + (qp - 2.0f * q + qm) * P.idz2;
                const float g = -adv + P.kappa * lap;
                if (kk < nz) Y.b[i * nz + k] = rk(q, g, gp[xi][s][2]);
                gp[xi][s][2] = g;
              }
            }
          }
        }
      }
      cluster_barrier();  // (2) the right neighbour's u*

      // ---- 3. div(u*, w*) / dt_stage into sa ----------------------------------
      {
        const float* u_right = cluster_map(Y.u, right);  // its column 0 is our nxl
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              float ue;
              if (i + 1 < nxl) {
                ue = Y.u[(i + 1) * nz + k];
              } else {
                ue = u_right[k];
              }
              const float div = (ue - Y.u[i * nz + k]) * P.idx +
                                (Y.w[i * nw + k + 1] - Y.w[i * nw + k]) * P.idz;
              sa[i * nz + k] = div * idts;
            }
          }
        }
      }
      cluster_barrier();  // (3) every CTA's divergence

      // ---- 4. the solve: the two x products over the cluster's slabs, the
      // other CTAs' copied into D kK1StagedSlabs at a time; the z products local
      if constexpr (kPasses == 0) {
        auto store = [&](float* dst) {
#pragma unroll
          for (int xi = 0; xi < XS; ++xi)
#pragma unroll
            for (int s = 0; s < NS; ++s)
              if (xi < xn && kl[s] < nz) dst[(x0 + xi) * nz + kl[s]] = pt[xi][s];
        };
        auto clear = [&] {
#pragma unroll
          for (int xi = 0; xi < XS; ++xi)
#pragma unroll
            for (int s = 0; s < NS; ++s) pt[xi][s] = 0.0f;
        };
        // pt = L[own rows, :] . (the cluster's slabs, in column order), L's
        // rows (nxl x nx) read from shared memory (rows) with in_smem, else
        // from global memory: each its own code, so that neither address
        // space's loads turn generic
        auto x_product_from = [&](auto in_smem, const float* L, const float* rows,
                                  const float* slab) {
          const float* Lr = decltype(in_smem)::value ? rows : L + (size_t)x_off * nx;
          clear();
          tile_product_acc<XS, NS, kVec>(Lr + x_off, nx, slab, nxl, nz, x0, nxl, lane, pt);
          for (int q0 = 1; q0 < c; q0 += kK1StagedSlabs) {
            const int nq = min(kK1StagedSlabs, c - q0);
            if (q0 > 1) __syncthreads();
            stage_slabs(D, slab, q0, nq);
            __syncthreads();
            for (int j = 0; j < nq; ++j) {
              const int q = (r + q0 + j) % c;
              tile_product_acc<XS, NS, kVec>(Lr + q * nxl, nx, D + j * nc, nxl, nz, x0, nxl,
                                             lane, pt);
            }
          }
        };
        auto x_product = [&](const float* L, const float* rows, const float* slab) {
          if (fg) {
            x_product_from(std::true_type{}, L, rows, slab);
          } else {
            x_product_from(std::false_type{}, L, rows, slab);
          }
        };
        x_product(fmat, frows, sa);  // r_hat = F . rhs
        store(sb);
        __syncthreads();
        clear();
        tile_product_acc<XS, NS, kVec>(sb, nz, ct, nz, nz, x0, nxl, lane, pt);  // r_hat C^T
#pragma unroll
        for (int xi = 0; xi < XS; ++xi)
#pragma unroll
          for (int s = 0; s < NS; ++s)
            pt[xi][s] *= __ldg(dinv + (x_off + min(x0 + xi, nxl - 1)) * nz + kc[s]);
        store(D);
        __syncthreads();
        clear();
        tile_product_acc<XS, NS, kVec>(D, nz, st, nz, nz, x0, nxl, lane, pt);  // p_hat = R~ S^T
        store(sb);
        cluster_barrier();  // (4) every CTA's p_hat
        x_product(gmat, grows, sb);  // p = G . p_hat
        store(sa);
        if (last) {
#pragma unroll
          for (int xi = 0; xi < XS; ++xi)
#pragma unroll
            for (int s = 0; s < NS; ++s)
              if (xi < xn && kl[s] < nz)
                p_out[e * nx * nz + (size_t)(x_off + x0 + xi) * nz + kl[s]] = pt[xi][s];
        }
        cluster_barrier();  // (5) every CTA's p

        // ---- 5. correct this thread's u*, w* by grad p ------------------------
        const float* p_left = cluster_map(sa, left) + (nxl - 1) * nz;  // our column -1
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              const float p = pt[xi][s];
              float pm;
              if (xi > 0) {
                pm = pt[xi > 0 ? xi - 1 : 0][s];
              } else if (i > 0) {
                pm = sa[(i - 1) * nz + k];
              } else {
                pm = p_left[k];
              }
              Y.u[i * nz + k] -= dts * ((p - pm) * P.idx);
              if (k > 0) Y.w[i * nw + k] -= dts * ((p - sa[i * nz + k - 1]) * P.idz);
            }
          }
        }
      } else {
        // ---- 4. the solve on the tensor cores, every slab plain -------------
        auto rd = [](const float* a, int ld) {
          return [=](int rr, int cc) { return a[rr * ld + cc]; };
        };
        auto wr = [nz](float* a) { return [=](int rr, int cc, float v) { a[rr * nz + cc] = v; }; };
        // out[own rows] = L[own rows, :] . (the cluster's slabs): a warp's one
        // 16 x 32 tile (nxl <= 128, nz <= 64: at most 16 tiles), summed over
        // the slabs in its registers
        auto x_product = [&](const float* L, const float* slab, float* out) {
          const float* Lr = L + (size_t)x_off * nx;
          const int tiles_n = (nz + 31) / 32, tiles = (nxl + 15) / 16 * tiles_n;
          const bool mine = warp < tiles;
          const int m0 = warp / tiles_n * 16, n0 = warp % tiles_n * 32;
          float acc[4][4] = {};
          auto chunk = [&](const float* Lq, const float* R) {
            if (mine) {
              mma_tile<kPasses>(
                  m0, n0, nxl,
                  [&](int rr, int k) {
                    return rr < nxl && k < nxl ? __ldg(Lq + rr * nx + k) : 0.0f;
                  },
                  [&](int k, int cc) { return k < nxl && cc < nz ? R[k * nz + cc] : 0.0f; }, acc);
            }
          };
          chunk(Lr + x_off, slab);
          for (int q0 = 1; q0 < c; q0 += kK1StagedSlabs) {
            const int nq = min(kK1StagedSlabs, c - q0);
            if (q0 > 1) __syncthreads();
            stage_slabs(D, slab, q0, nq);
            __syncthreads();
            for (int j = 0; j < nq; ++j) chunk(Lr + (r + q0 + j) % c * nxl, D + j * nc);
          }
          if (mine) {
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int rr = m0 + g + 8 * (i >> 1), cc = n0 + 8 * j + 2 * t + (i & 1);
                if (rr < nxl && cc < nz) out[rr * nz + cc] = acc[j][i];
              }
          }
        };
        x_product(fmat, sa, sb);  // r_hat = F . rhs
        __syncthreads();
        mma_product<kPasses, true>(nxl, nz, nz, rd(sb, nz), rd(ct, nz),  // (r_hat C^T) * d
                                   [&](int rr, int cc, float v) {
                                     D[rr * nz + cc] = v * __ldg(dinv + (x_off + rr) * nz + cc);
                                   });
        __syncthreads();
        mma_product<kPasses, true>(nxl, nz, nz, rd(D, nz), rd(st, nz), wr(sb));  // p_hat
        cluster_barrier();  // (4) every CTA's p_hat
        x_product(gmat, sb, sa);  // p = G . p_hat
        cluster_barrier();  // (5) every CTA's p

        // ---- 5. correct this thread's u*, w* by grad p, read from sa -----------
        const float* p_left = cluster_map(sa, left) + (nxl - 1) * nz;
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              const float p = sa[i * nz + k];
              float pm;
              if (i > 0) {
                pm = sa[(i - 1) * nz + k];
              } else {
                pm = p_left[k];
              }
              Y.u[i * nz + k] -= dts * ((p - pm) * P.idx);
              if (k > 0) Y.w[i * nw + k] -= dts * ((p - sa[i * nz + k - 1]) * P.idz);
              if (last) p_out[e * nx * nz + (size_t)(x_off + i) * nz + k] = p;
            }
          }
        }
      }
      const State2D t = X;
      X = Y;
      Y = t;
    }
  }
  cluster_barrier();  // no CTA leaves while a neighbour may still read its shared memory

  const size_t ec = e * (size_t)nx * nz + (size_t)x_off * nz;
  const size_t ef = e * (size_t)nx * nw + (size_t)x_off * nw;
  for (int q = threadIdx.x; q < nc; q += kK1Threads) {
    u_out[ec + q] = X.u[q];
    b_out[ec + q] = X.b[q];
  }
  for (int q = threadIdx.x; q < nf; q += kK1Threads) w_out[ef + q] = X.w[q];
}

// The cluster K1 instance for a grid's slab and a pass count: at float32
// specialised for 64 and 96 columns of 64 levels a CTA (128x64 and 256x64;
// 192x64), the runtime-size one for every other.
decltype(&env_step_2d_cluster_kernel<0, 0>) env_step_cluster_kernel_for(int nxl, int nz,
                                                                          int passes) {
  if (passes == 3) return env_step_2d_cluster_kernel<0, 0, 3>;
  if (passes == 1) return env_step_2d_cluster_kernel<0, 0, 1>;
  if (nz == 64 && nxl == 64) return env_step_2d_cluster_kernel<64, 64>;
  if (nz == 64 && nxl == 96) return env_step_2d_cluster_kernel<96, 64>;
  return env_step_2d_cluster_kernel<0, 0>;
}

// ---- K2 -----------------------------------------------------------------------

// Shared memory of K2's march, in floats: b, pHY', u (nx, nz), w (nx, nz + 1)
// and the bottom profile (nx).
size_t tendencies_march_smem_floats(int nx, int nz) {
  return 3 * (size_t)nx * nz + (size_t)nx * (nz + 1) + nx;
}

// Whether K2's march takes the grid: K1's warps' columns and lanes'
// levels, and its shared memory (at most 132,096 bytes, at 128x64).
bool tendencies_on_march(int nx, int nz) {
  return nx >= 4 && k1_cols(nx) <= kK1MaxCols && nz >= 2 && nz <= kK1MaxNz &&
         sizeof(float) * tendencies_march_smem_floats(nx, nz) <= kSmemPerBlock;
}

// Shared memory K2 needs per block, in floats: the march's, or none.
size_t tendencies_2d_smem_floats(int nx, int nz) {
  return tendencies_on_march(nx, nz) ? tendencies_march_smem_floats(nx, nz) : 0;
}

// Global scratch per env, in floats: none on the march; pHY' off it.
size_t tendencies_2d_scratch_floats(int nx, int nz) {
  return tendencies_on_march(nx, nz) ? 0 : (size_t)nx * nz;
}

// Copy n floats from global src to shared dst by cp.async: 16 bytes a copy
// where both are 16-byte aligned and n % 4 == 0, else 4 bytes.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    for (int q = 4 * threadIdx.x; q < n; q += 4 * kK1Threads)
      __pipeline_memcpy_async(dst + q, src + q, 16);
  } else {
    for (int q = threadIdx.x; q < n; q += kK1Threads)
      __pipeline_memcpy_async(dst + q, src + q, sizeof(float));
  }
}

// K2's march (see the head of this file): K1's phases 1 and 2 with each g
// stored. Two blocks an SM at 96x64 (at most 64 registers); one at runtime
// sizes, where 64 registers spill and the shared memory may not fit two.
template <int NX, int NZ>
__global__ void __launch_bounds__(kK1Threads, NX > 0 ? 2 : 1)
tendencies_2d_march_kernel(const float* __restrict__ u_in, const float* __restrict__ w_in,
                           const float* __restrict__ b_in, const float* __restrict__ bottom_in,
                           float* __restrict__ gu_out, float* __restrict__ gw_out,
                           float* __restrict__ gb_out, K1Params P) {
  constexpr int NS = kK1Levels;
  constexpr int XS = NX > 0 ? k1_cols(NX) : kK1MaxCols;
  extern __shared__ float smem[];
  const int nx = NX > 0 ? NX : P.nx, nz = NZ > 0 ? NZ : P.nz, nw = nz + 1;
  const int nc = nx * nz, nf = nx * nw;
  const size_t e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xs = k1_cols(nx), x0 = warp * xs, xn = min(xs, nx - x0);  // xn may be <= 0

  const State2D X{smem + 2 * nc, smem + 3 * nc, smem};  // u, w, b
  float* phy = smem + nc;
  float* bot = X.w + nf;
  copy_async(X.b, b_in + e * nc, nc);
  __pipeline_commit();
  copy_async(X.u, u_in + e * nc, nc);
  copy_async(X.w, w_in + e * nf, nf);
  copy_async(bot, bottom_in + e * nx, nx);
  __pipeline_commit();
  float* gu = gu_out + e * nc;
  float* gw = gw_out + e * nf;
  float* gb = gb_out + e * nc;
  for (int i = threadIdx.x; i < nx; i += kK1Threads) gw[i * nw + nz] = 0.0f;  // the top wall

  auto wrap = [&](int i) { return i < 0 ? i + nx : (i >= nx ? i - nx : i); };
  int kl[NS], kc[NS];  // this lane's levels, and the same clamped into the column
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    kl[s] = lane + 32 * s;
    kc[s] = min(kl[s], nz - 1);
  }
  // z tap o of level s (offsets -3..3 as o = 0..6), clamped into a column of n
  auto tap = [&](int s, int o, int n) { return min(max(kl[s] + o - 3, 0), n - 1); };

  // x fluxes: u at center c (taps faces c-2..c+3); w, b at face c (taps c-3..c+2)
  auto xflux_u = [&](int c, int k) {
    const float* u = X.u + k;
    const float a = u[wrap(c) * nz], b = u[wrap(c + 1) * nz];
    return ub5_upwind(u[wrap(c - 2) * nz], u[wrap(c - 1) * nz], a, b, u[wrap(c + 2) * nz],
                      u[wrap(c + 3) * nz], 0.5f * (a + b));
  };
  auto xflux_face = [&](const float* q, int ld, int c, float vel) {
    return ub5_upwind(q[wrap(c - 3) * ld], q[wrap(c - 2) * ld], q[wrap(c - 1) * ld],
                      q[wrap(c) * ld], q[wrap(c + 1) * ld], q[wrap(c + 2) * ld], vel);
  };
  auto xflux_w = [&](int c, int s) {
    const float* uc = X.u + wrap(c) * nz;
    const float vel = 0.5f * (uc[max(kl[s] - 1, 0)] + uc[kc[s]]);
    return xflux_face(X.w + kc[s], nw, c, vel);
  };
  auto xflux_b = [&](int c, int s) {
    return xflux_face(X.b + kc[s], nz, c, X.u[wrap(c) * nz + kc[s]]);
  };

  // ---- 1. pHY' of this warp's columns: a float64 suffix scan along z, on b
  // alone, while u and w are still in flight ----------------------------------
  __pipeline_wait_prior(1);  // this thread's copies of b; the barrier, every thread's
  __syncthreads();
#pragma unroll
  for (int xi = 0; xi < XS; ++xi) {
    if (xi < xn) {
      double above = 0.0;
      phy_levels<NS>(X.b + (x0 + xi) * nz, phy + (x0 + xi) * nz, 0, nz, lane, P, above);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- 2. tendencies, marching along x, each g from a register to memory ----
  float fu[NS], fw[NS], fb[NS];  // x fluxes entering the current column
  if (xn > 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      fu[s] = xflux_u(x0 - 1, kc[s]);
      fw[s] = xflux_w(x0, s);
      fb[s] = xflux_b(x0, s);
    }
  }
#pragma unroll
  for (int xi = 0; xi < XS; ++xi) {
    if (xi < xn) {
      const int i = x0 + xi, im = wrap(i - 1), ip = wrap(i + 1);
      const float* uc = X.u + i * nz;
      const float* wc = X.w + i * nw;
      const float* bc = X.b + i * nz;
      const float* wm = X.w + im * nw;
      // z fluxes through face k of u (velocity w at the x-face) and b,
      // and through center k of w
      float zu[NS], zb[NS], zw[NS], zu_up[NS], zb_up[NS], zw_dn[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const ZOrders oc = z_orders(kl[s], nz), ow = z_orders(kl[s] + 1, nw);
        const int k = kc[s];
        zu[s] = z_upwind(uc[tap(s, 0, nz)], uc[tap(s, 1, nz)], uc[tap(s, 2, nz)], uc[k],
                         uc[tap(s, 4, nz)], uc[tap(s, 5, nz)], oc, 0.5f * (wm[k] + wc[k]));
        zb[s] = z_upwind(bc[tap(s, 0, nz)], bc[tap(s, 1, nz)], bc[tap(s, 2, nz)], bc[k],
                         bc[tap(s, 4, nz)], bc[tap(s, 5, nz)], oc, wc[k]);
        const float w0 = wc[k], w1 = wc[k + 1];
        zw[s] = z_upwind(wc[tap(s, 1, nw)], wc[tap(s, 2, nw)], w0, w1, wc[tap(s, 5, nw)],
                         wc[tap(s, 6, nw)], ow, 0.5f * (w0 + w1));
      }
      flux_above(zu, zu_up, lane, nz);
      flux_above(zb, zb_up, lane, nz);
      flux_below(zw, zw_dn, lane);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int kk = kl[s], k = kc[s];
        if (kk >= nz) continue;  // a level past a short column: nothing to store
        // ---- gu at (face i, center k) ----
        {
          const float f_new = xflux_u(i, k);
          float adv = (f_new - fu[s]) * P.idx;
          fu[s] = f_new;
          adv += (zu_up[s] - zu[s]) * P.idz;
          const float dphy = (phy[i * nz + k] - phy[im * nz + k]) * P.idx;
          const float q = uc[k];
          const float qm = kk > 0 ? uc[max(kk - 1, 0)] : -uc[0];
          const float qp = kk < nz - 1 ? uc[min(kk + 1, nz - 1)] : -uc[nz - 1];
          const float lap = (X.u[ip * nz + k] - 2.0f * q + X.u[im * nz + k]) * P.idx2 +
                            (qp - 2.0f * q + qm) * P.idz2;
          gu[i * nz + k] = -adv - dphy + P.nu * lap;
        }
        // ---- gw at (center i, face k); face 0 is a wall ----
        {
          const float f_new = xflux_w(i + 1, s);
          float adv = (f_new - fw[s]) * P.idx;
          fw[s] = f_new;
          adv += (zw[s] - zw_dn[s]) * P.idz;
          const float q = wc[k];
          const float lap = (X.w[ip * nw + k] - 2.0f * q + X.w[im * nw + k]) * P.idx2 +
                            (wc[k + 1] - 2.0f * q + wc[max(k - 1, 0)]) * P.idz2;
          gw[i * nw + k] = kk == 0 ? 0.0f : -adv + P.nu * lap;
        }
        // ---- gb at (center i, center k) ----
        {
          const float f_new = xflux_b(i + 1, s);
          float adv = (f_new - fb[s]) * P.idx;
          fb[s] = f_new;
          adv += (zb_up[s] - zb[s]) * P.idz;
          const float q = bc[k];
          const float qm = kk > 0 ? bc[max(kk - 1, 0)] : 2.0f * bot[i] - bc[0];
          const float qp = kk < nz - 1 ? bc[min(kk + 1, nz - 1)] : 2.0f * P.min_b - bc[nz - 1];
          const float lap = (X.b[ip * nz + k] - 2.0f * q + X.b[im * nz + k]) * P.idx2 +
                            (qp - 2.0f * q + qm) * P.idz2;
          gb[i * nz + k] = -adv + P.kappa * lap;
        }
      }
    }
  }
}

// The instance of K2's march for a grid: specialised for the reference's
// 96x64, the runtime-size one for every other grid it takes.
decltype(&tendencies_2d_march_kernel<0, 0>) tendencies_kernel_for(int nx, int nz) {
  return nx == 96 && nz == 64 ? tendencies_2d_march_kernel<96, 64>
                              : tendencies_2d_march_kernel<0, 0>;
}

// K2's general instance (see the head of this file): a block per env, pHY'
// in phy_all (per-env scratch), then ub5.cuh's per-point code.
__global__ void __launch_bounds__(kK1Threads)
tendencies_2d_general_kernel(const float* __restrict__ u_in, const float* __restrict__ w_in,
                             const float* __restrict__ b_in,
                             const float* __restrict__ bottom_in, float* __restrict__ gu_out,
                             float* __restrict__ gw_out, float* __restrict__ gb_out,
                             float* __restrict__ phy_all, K1Params P) {
  const int nx = P.nx, nz = P.nz;
  const int nc = nx * nz, nf = nx * (nz + 1);
  const size_t e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* b = b_in + e * nc;
  float* phy = phy_all + e * nc;
  for (int i = warp; i < nx; i += kK1Warps) {
    double above = 0.0;
    for (int k0 = (nz - 1) / 32 * 32; k0 >= 0; k0 -= 32)
      phy_levels<1>(b + i * nz, phy + i * nz, k0, nz, lane, P, above);
  }
  __syncthreads();
  tendencies_block(u_in + e * nc, w_in + e * nf, b, phy, bottom_in + e * nx, gu_out + e * nc,
                   gw_out + e * nf, gb_out + e * nc, P);
}

}  // namespace

extern "C" {

int launch_env_step_2d(const float* u, const float* w, const float* b,
                       const float* bottom, const float* fmat, const float* gmat,
                       const float* dct, const float* idct, const float* dinv, float* u_out,
                       float* w_out, float* b_out, float* p_out, float* scratch, int n_env,
                       int nx, int nz, int n_substeps, float dt, float dx, float dz, float nu,
                       float kappa, float min_b, int passes, const float* tf32,
                       void* stream) {
  const bool on_chip = env_step_2d_on_chip(nx, nz);
  const int csize = env_step_2d_cluster_size(nx, nz);
  const bool wgmma = on_chip && k1_wgmma(nx, nz, passes);
  const size_t smem = wgmma ? k1_wgmma_smem_bytes(passes)
                            : sizeof(float) * env_step_2d_smem_floats(nx, nz);
  if (nx < kK1MinNx || nz < 1 || !env_step_2d_offsets_fit(nx, nz) || smem > kSmemPerBlock ||
      n_substeps < 1 || (!on_chip && csize == 0 && scratch == nullptr) ||
      (passes != 0 && passes != 1 && passes != 3) || (wgmma && tf32 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const K1Params P = k1_params(nx, nz, n_substeps, dt, dx, dz, nu, kappa, min_b);
  if (csize > 0) {  // the cluster instance: n_env clusters of csize CTAs
    auto* kernel = env_step_cluster_kernel_for(nx / csize, nz, passes);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)csize;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)(n_env * csize));
    config.blockDim = dim3(kK1Threads);
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    config.attrs = cluster;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, u, w, b, bottom, fmat, gmat, dct, idct, dinv, u_out,
                             w_out, b_out, p_out, P, (int)env_step_2d_cluster_fg(nx, nz));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (!on_chip) {
    auto* global = env_step_global_kernel_for(passes, env_step_2d_slabs_on_chip(nx, nz));
    cudaError_t err =
        cudaFuncSetAttribute(global, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const RBCParams R{nx, nz, dx, dz, nu, kappa, min_b};
    global<<<n_env, kK1Threads, smem, (cudaStream_t)stream>>>(
        u, w, b, bottom, fmat, gmat, dct, idct, dinv, u_out, w_out, b_out, p_out, scratch, P,
        R);
    return (int)cudaGetLastError();
  }
  auto* kernel = env_step_kernel_for(nx, nz, passes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_env, kK1Threads, smem, (cudaStream_t)stream>>>(
      u, w, b, bottom, fmat, gmat, dct, idct, dinv, u_out, w_out, b_out, p_out, P, tf32);
  return (int)cudaGetLastError();
}

// What the card gives the K1 instance its launcher picks for a grid and a
// pass count: out[0] the instance (0 on the chip, 1 the cluster, 2 off the
// chip with its slabs in shared memory, 3 off the chip with its slabs in
// global scratch), out[1] CTAs a cluster (1 off a cluster), out[2] blocks resident on
// an SM, out[3] clusters resident on the card at once
// (cudaOccupancyMaxActiveClusters; 0 off a cluster), out[4] registers a
// thread, out[5] local memory a thread (stack and spills), bytes, out[6]
// dynamic shared memory a block, bytes.
int env_step_2d_occupancy(int nx, int nz, int passes, int* out) {
  const bool on_chip = env_step_2d_on_chip(nx, nz);
  const int csize = env_step_2d_cluster_size(nx, nz);
  const size_t smem = on_chip && k1_wgmma(nx, nz, passes)
                          ? k1_wgmma_smem_bytes(passes)
                          : sizeof(float) * env_step_2d_smem_floats(nx, nz);
  const bool slabs = env_step_2d_slabs_on_chip(nx, nz);
  if (nx < kK1MinNx || nz < 1 || !env_step_2d_offsets_fit(nx, nz) || smem > kSmemPerBlock ||
      (passes != 0 && passes != 1 && passes != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* kernel = on_chip     ? (const void*)env_step_kernel_for(nx, nz, passes)
                       : csize > 0 ? (const void*)env_step_cluster_kernel_for(nx / csize, nz,
                                                                             passes)
                                   : (const void*)env_step_global_kernel_for(passes, slabs);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kK1Threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (csize > 0) {
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)csize;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)csize);
    config.blockDim = dim3(kK1Threads);
    config.dynamicSmemBytes = smem;
    config.attrs = cluster;
    config.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return (int)err;
  }
  const int rec[7] = {on_chip ? 0 : (csize > 0 ? 1 : (slabs ? 2 : 3)), csize > 0 ? csize : 1,
                      blocks, clusters,
                      attr.numRegs, (int)attr.localSizeBytes, (int)smem};
  for (int i = 0; i < 7; ++i) out[i] = rec[i];
  return 0;
}

int launch_tendencies_2d(const float* u, const float* w, const float* b, const float* bottom,
                         float* gu, float* gw, float* gb, float* scratch, int n_env, int nx,
                         int nz, float dx, float dz, float nu, float kappa, float min_b,
                         void* stream) {
  const bool on_march = tendencies_on_march(nx, nz);
  if (nx < kK1MinNx || nz < 1 || (size_t)nx * (nz + 1) > (size_t)INT_MAX ||
      (!on_march && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const K1Params P = k1_params(nx, nz, 1, 1.0f, dx, dz, nu, kappa, min_b);
  if (!on_march) {
    tendencies_2d_general_kernel<<<n_env, kK1Threads, 0, (cudaStream_t)stream>>>(
        u, w, b, bottom, gu, gw, gb, scratch, P);
    return (int)cudaGetLastError();
  }
  auto* kernel = tendencies_kernel_for(nx, nz);
  const size_t smem = sizeof(float) * tendencies_march_smem_floats(nx, nz);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_env, kK1Threads, smem, (cudaStream_t)stream>>>(u, w, b, bottom, gu, gw, gb, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
