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
//   the other grids with 4 <= nx <= 128, 2 <= nz <= 64 whose shared memory
//   fits run a runtime-size bucket (k1_bucket): an instance compiled for at
//   most XS columns a warp and NS levels a lane, nx and nz runtime and
//   masked inside. What held the one runtime-size instance it replaces (8
//   columns of two levels at stride nz; 78.4, 148.0 and 152.4 ms at 1024
//   envs on 64x64, 128x32 and 128x40, 5-7 % of the bound, on an H100 80GB
//   HBM3 at 700 W): rows and levels of the largest block computed on every
//   grid (64x64 uses 4 columns a warp, 128x32 one level a lane), and 1080
//   bytes a thread of local memory. Cut to the grid's block it still kept
//   424-1288 bytes: ptxas hoisted every column's and tap's address (a
//   runtime stride, the periodic wrap) and every row of F and G out of the
//   stage loop, about a hundred values, and spilled them. Design: a
//   bucket's columns lie 32, 48 or 64 floats apart (w's one more; the
//   levels past nz padding, never read) where that fits: one level a lane
//   at 32 (nz <= 32, 8 columns a warp), two at 48 (nz <= 48, 8) and at 64
//   (nz <= 64, 4 where nx <= 64); the rest at stride nz (8 columns of two).
//   The padded buckets hold three ghost columns each side of the state's
//   fields, copied from their periodic neighbours during pHY', so that the
//   march's x taps are affine in the column (no wrap). Every bucket
//   launders its column and level bases each column, and a product its
//   first row (opaque), so that the addresses are computed where they are
//   used: no bucket keeps more than 104 bytes a thread (PERF.md, section 6).
//   In float32 the previous stage's tendencies stay in the state copy the
//   march has read, not in registers: the march reads them where it writes
//   the point, holds its own gb in s2 and gu in s1 behind the march, and
//   stores them after it. A bucket's float32 products (bucket_product) read
//   L as float4 where nx and nz are multiples of 4, with R's four rows in
//   registers first (4 NS + 4 operands live). The fields come in and go out
//   column by column through the padding.
//   Times at 1024 envs: PERF.md, section 6, rows 1b and 1cb. Shared memory
//   of the compile-time instance, in floats:
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
//   neighbour reads then, the halo to the one whose p they have read.
//   Compile-time 64 and 96 columns of 64 levels a CTA (at TF32 the solve on
//   wgmma, below), a runtime-size bucket otherwise (k1_bucket): 8 columns a
//   warp of one level a lane where nz <= 32 in float32, else of two, at
//   stride nz, their column and level bases laundered each column as on the
//   chip; the runtime-size TF32 instances keep their slabs plain
//   (unswizzled) and take the x products as one 16 x 32 tile a warp summed
//   over the slabs (nxl <= 128, nz <= 64: at most 16 tiles).
//   Every other grid with nx >= 3 runs the off-chip instance,
//   env_step_2d_global_kernel (nz > 64, nz < 2, nx = 3, an nx no cluster
//   splits: 127x64, 128x224, 256x128, 512x256, 2048x64), one 512-thread
//   block an env.
//   What held its first design (159.9 ms at 1024 envs, 6 substeps, on
//   256x128, 8.4 % of the bound; 30.5 on 127x64; 203.7 at 64 envs on
//   512x256; H100 80GB HBM3 at 700 W, by ablation in that call: the four
//   products ~70, ~13 and ~155 ms of those, the phases before them ~54,
//   ~19 and ~0): products from L1 and L2 as 4 x 32 tiles a warp, five loads
//   for four FMA and every tile walking a whole strip of its right
//   operand; pHY', tendencies_block (a thread a point, each face flux
//   twice, IEEE division, every tap from global memory), the RK update, the
//   divergence and the correction each a pass over points between barriers,
//   some 40 field-sized passes a stage.
//   Design: per stage,
//   1. the march (g_march, its own registers): warp v takes strips of xw =
//      ceil(nx / 16) <= 16 columns, each chunk by chunk of 32 levels from
//      the top, lane l the level k0 + l, column by column: the columns of
//      u, w, b it needs (i - 3 .. i + 3, 40 levels from k0 - 3, clamped
//      into the column as the z ladder clamps its taps) in the warp's ring
//      of eight in shared memory, the next one loaded into registers while
//      a column is computed; pHY' by the float64 lane scan, its running sum
//      carried down the chunks; each x-face flux once, carried in a
//      register; each z-face flux once, from the next lane by shuffle (the
//      chunk above's carried in shared memory, lane 0's w flux below its
//      own); the RK update from the reciprocals into the other copy of the
//      state (the output tensors and a copy in scratch alternate so that the
//      last stage writes the outputs), g into scratch, the divergence of
//      column i - 1 once u*[i] is known;
//   2. the divergence of each strip's last column;
//   3. the four products (g_product, its own registers): tiles of the
//      result computed a GTile at a time from chunks of both operands that
//      cp.async stages into a ring of two in shared memory; float32 FMA on a
//      4 x 4 block a thread (128 x 64 tiles) or, where nz > 64, 8 x 8 (256 x
//      128), which halves the shared loads an FMA; the TF32 instances'
//      mma.sync fragments from the same tiles;
//   4. the correction, a warp a column.
//   The two slabs sit in shared memory after the ring, the carries and the
//   columns where nx nz <= 13,408 (127x64: 190,208 bytes, one block an
//   SM), else in per-env global scratch (kGlobalSlabs: 125,184 bytes); 128
//   registers. Times (H100 80GB HBM3, 700 W, 1024 envs, 6 substeps):
//   59.9 ms on 256x128 (22.4 % of the bound), 12.9 on 127x64, 41.4 at 64
//   envs on 512x256, "high" / "default" 60.6 / 53.0 on 256x128 (PERF.md,
//   section 6, rows 1g and 1o).
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
//   On 96x64, 64x64 and 128x32 the on-chip TF32 instances, and on a cluster
//   those of 64 and 96 columns of 64 levels a CTA (128x64, 256x64; 192x64),
//   run their solve on wgmma instead (k1_wgmma, k1_cluster_wgmma; the
//   section "K1's TF32 instances on wgmma" below). What held the mma.sync
//   solve (by ablation at 96x64 21.0 and 15.1 ms of 37.6 and 32.2 at 1024
//   envs on an H100 80GB HBM3 at 700 W): three warps of a sub-partition
//   walking their tiles' K serially, F and G read element by element from
//   L2, every constant split again at every load, and a block barrier after
//   each product; on a cluster besides, one 16 x 32 tile a warp (half the
//   block idle at 128x64), F and G's rows in shared memory only at float32,
//   and no compile-time instance (the runtime-size ones spilled 768 bytes a
//   thread). Design: each product transposed, P^T = R^T L^T, the levels as
//   wgmma's M (at nz = 32 two warps of a warpgroup hold zero rows, so that
//   one code takes every instance and F and G stay in shared memory as B),
//   a warpgroup a quarter of the block's columns as N (m64n16k8 at 64,
//   m64n24k8 at 96, m64n32k8 at 128), A from registers, B from shared
//   memory; F's and G's rows stream through a ring of two slots a warpgroup
//   by bulk copies on mbarriers, a chunk of columns (on a cluster one
//   source CTA's or half of it) at a time, the next in flight while one is
//   multiplied; A of a neighbour's chunk comes from its slab through
//   distributed shared memory (a staged copy of the slab, stage_slabs, was
//   within 3 % either way and needs room that 96 columns a CTA do not
//   have); every constant comes packed on the host, TF32-exact (ops/poisson.py
//   k1_tf32_constants), so the kernel splits and rounds only the slabs.
//   Products 1 to 3 are local to a warpgroup's modes, so only the
//   warpgroup meets between them; a cluster keeps its five barriers a stage.
//   A compile-time instance takes the march at one level a lane where nz
//   <= 32. Times at 1024 envs, "high" / "default" (float32 beside them):
//   128x64 64.1 / 54.5 ms (72.3; the runtime-size instances 163.2 /
//   151.4), 192x64 90.5 / 74.7 (134.3), 128x32 26.0 / 20.6 (146.4), 64x64
//   20.3 / 16.0 (78.3), 96x64 30.2 / 23.4 (PERF.md section 6, rows 1c, 1r,
//   1s, 1d). The float32 instances are untouched. The runtime-size on-chip
//   TF32 instance (every other grid) takes F and G packed on the host in
//   its A-fragment order and stages them through shared memory by cp.async
//   (staged_product); its z transforms are still split as they are loaded.
//   It runs the buckets' march at 8 columns a warp of two levels a lane,
//   stride nz (its column and level bases laundered each column).
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
// d += a . b for the warpgroup's 64 x N tile (N = 16, 24 or 32), 8 deep,
// TF32 in, float32 out: a (64 x 8) in registers (warp w of the group rows
// 16 w .. 16 w + 15, in mma.m16n8k8's A layout: lane 4 g + t holds A[g][t],
// A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]), b (8 x N) in shared memory,
// K-major, through its descriptor; d[4 j + i] is D[16 w + g + 8 (i >> 1)][8
// j + 2 t + (i & 1)].
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const unsigned (&a)[4],
                                           uint64_t desc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 24) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, "
        "1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else {
    static_assert(N == 32, "K1's warpgroups take 16, 24 or 32 modes or columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
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

// The runtime-size on-chip TF32 instance's x products take F and G packed
// on the host, TF32-exact, in mma_product's A-fragment order (ops/poisson.py
// k1_tf32_constants at a grid without a wgmma instance: [k-step][16-row
// tile][part][lane][4], zero past nx), and stage them by cp.async, a chunk
// of k-steps at a time, into a ring of two: in the state copy the march has
// just read (16-byte aligned from its start) where it holds two k-steps,
// else in a region of its own after the rest of the block's shared memory.
// Floats of one k-step of a packed F or G, and of that region.
__host__ __device__ constexpr int k1_rt_step(int nx, int passes) {
  return (nx + 15) / 16 * 128 * (passes == 3 ? 2 : 1);
}
__host__ __device__ constexpr int k1_rt_own_floats(int nx, int nz, int passes) {
  return 2 * k1_rt_step(nx, passes) + 3 <= 2 * nx * nz + nx * (nz + 1)
             ? 0
             : 2 * k1_rt_step(nx, passes);
}
// Floats of F's pack (G's follows it), and the instance's shared memory:
// the on-chip layout (on_chip_smem_floats, below) and, 16-byte aligned, the
// ring's region where it has one.
__host__ __device__ constexpr int k1_rt_pack_floats(int nx, int passes) {
  return (nx + 7) / 8 * k1_rt_step(nx, passes);
}

// dst = L . R for the (M, N) result, K deep, in kPasses TF32 passes on
// mma.sync, as mma_product (warp v the 16 x 32 tile v: M <= 128, N <= 64),
// with L packed (k1_rt_step) and staged chunk by chunk of k-steps from
// `pack` into the ring at `ring` (cap floats, 16-byte aligned): the next
// chunk in flight while one is multiplied; R read by ld_r and split as it
// is loaded, zero outside [0, K) x [0, N). Every thread meets the block
// after each chunk.
template <int kPasses, class LdR, class St>
__device__ __forceinline__ void staged_product(const float* __restrict__ pack, float* ring,
                                               int cap, int M, int N, int K, LdR ld_r, St st) {
  constexpr int NT = 4, H = kPasses == 3 ? 2 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int mts = (M + 15) / 16, kst = (K + 7) / 8, tiles_n = (N + 31) / 32;
  const int step = mts * 128 * H;              // floats of a k-step
  const int ks = min(kst, cap / (2 * step));   // k-steps a chunk
  const int nch = (kst + ks - 1) / ks;
  auto issue = [&](int ch) {
    const int s0 = ch * ks, n4 = (min(kst, s0 + ks) - s0) * step / 4;
    float* dst = ring + (ch & 1) * ks * step;
    const float* src = pack + (size_t)s0 * step;
    for (int q = threadIdx.x; q < n4; q += kK1Threads)
      __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
  };
  const bool mine = warp < mts * tiles_n;
  const int mt = warp / tiles_n, n0 = warp % tiles_n * 32;
  float acc[NT][4] = {};
  issue(0);
  __pipeline_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) issue(ch + 1);
    __pipeline_commit();  // (empty after the last chunk: the count stays one a chunk)
    __pipeline_wait_prior(1);
    __syncthreads();
    if (mine) {
      const float* a = ring + (ch & 1) * ks * step + (mt * H * 32 + lane) * 4;
      const int s0 = ch * ks, ns = min(kst, s0 + ks) - s0;
      for (int sl = 0; sl < ns; ++sl) {
        const int k0 = 8 * (s0 + sl);
        const float4 vh = *reinterpret_cast<const float4*>(a + sl * step);
        const unsigned ah[4] = {__float_as_uint(vh.x), __float_as_uint(vh.y),
                                __float_as_uint(vh.z), __float_as_uint(vh.w)};
        unsigned al[4] = {};
        if constexpr (kPasses == 3) {
          const float4 vl = *reinterpret_cast<const float4*>(a + sl * step + 128);
          al[0] = __float_as_uint(vl.x), al[1] = __float_as_uint(vl.y);
          al[2] = __float_as_uint(vl.z), al[3] = __float_as_uint(vl.w);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + g;
          const float b[2] = {k0 + t < K && c < N ? ld_r(k0 + t, c) : 0.0f,
                              k0 + t + 4 < K && c < N ? ld_r(k0 + t + 4, c) : 0.0f};
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
    __syncthreads();  // the chunk's stage is free for the chunk after next
  }
  if (mine) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + g + 8 * (i >> 1), c = n0 + 8 * j + 2 * t + (i & 1);
        if (r < M && c < N) st(r, c, acc[j][i]);
      }
    }
  }
}

// ---- K1's TF32 instances on wgmma ------------------------------------------------
//
// Each product P = L . R is computed transposed, P^T = R^T L^T: the nz
// levels are the rows of one wgmma M of 64 (at nz = 32 warps 2 and 3 of each
// warpgroup hold rows of zeros), the block's NXL modes or columns (a CTA's on
// a cluster) its N, warpgroup g of four the NW = NXL / 4 of [g NW, g NW +
// NW) in m64nNWk8 steps over the contraction. A (64 x K) comes from
// registers: the slabs rhs^T and p_hat^T from shared memory (on a cluster
// the source CTA's, through distributed shared memory), the z transforms
// ct^T and st^T from global memory, both stored in the fragment order
// (k1_afrag_index) so that a lane's four values are one 16-byte load. B^T
// (NW x K a warpgroup) lies in shared memory in the K-major core-matrix
// layout without swizzle (k1_bcore_index): r_hat and t, which products 1 and
// 2 write, and F's and G's rows of the warpgroup's modes or columns, KC of
// their columns at a time, each chunk staged by one bulk copy into the
// warpgroup's ring of two slots, the next chunk in flight while one is
// multiplied (K1WgRing). Where the ring lies: in the state copy the march has
// just read (from the march to the correction it is dead), or where that
// copy is too small for two chunks in a region of its own (then r_hat and t
// take the dead copy); at 96 columns and 3 passes r_hat and t take the
// ring's place after product 1, and G's chunks come after product 3.
// Products 1 to 3 are local to a warpgroup's modes, so only the warpgroup
// meets between them.

// Whether the on-chip TF32 instance for a grid runs its solve on wgmma:
// 96x64, 64x64 and 128x32; and the cluster's for a CTA's nxl columns of nz
// levels: 64 and 96 columns of 64 levels (128x64, 256x64; 192x64).
__host__ __device__ constexpr bool k1_wgmma(int nx, int nz, int passes) {
  return passes > 0 && ((nz == 64 && (nx == 96 || nx == 64)) || (nx == 128 && nz == 32));
}
__host__ __device__ constexpr bool k1_cluster_wgmma(int nxl, int nz, int passes) {
  return passes > 0 && nz == 64 && (nxl == 64 || nxl == 96);
}
// TF32 parts of an operand: hi and lo at 3 passes, the rounded value at 1
__host__ __device__ constexpr int k1_tf32_parts(int passes) { return passes == 3 ? 2 : 1; }
// F's or G's columns a chunk, for a block of nxl columns, and the ring's
// place: one fit, written out for the instances there are. The chunk is the
// widest of nxl, nxl / 2, ... whose ring (8 slots) fits the dead state copy
// (2 nc + nf floats), where it then lies, else a region of its own beside
// the rest of the block's shared memory (k1_wg_smem_bytes); r_hat and t take
// the ring's place where it is in the dead copy and a region of their own
// does not fit. ops/limits.py k1_wgmma_chunk computes the fit, and
// tests/test_torch_kernels2d_host_k1_cluster.py holds this table's chunk to
// it. (A constexpr loop computing the fit here changed the PTX of the
// 96 x 64 instances, float32's included.)
__host__ __device__ constexpr int k1_wg_chunk(int nxl, int passes) {
  return nxl == 128 ? (passes == 3 ? 32 : 64) : (nxl == 96 && passes == 3 ? 48 : nxl);
}
// Whether the ring lies in the dead state copy (else in a region of its own,
// with r_hat and t in the dead copy), and whether r_hat and t take the ring's
// place (else a region of their own where the ring is in the dead copy)
__host__ __device__ constexpr bool k1_wg_ring_in_dead(int nxl, int passes) {
  return nxl == 96 || (nxl == 64 && passes == 1);
}
__host__ __device__ constexpr bool k1_wg_rt_in_ring(int nxl, int passes) {
  return nxl == 96 && passes == 3;
}
// floats of one slot: a warpgroup's rows of one chunk, each part
__host__ __device__ constexpr int k1_wg_slot(int nxl, int passes) {
  return k1_tf32_parts(passes) * (nxl / 4) * k1_wg_chunk(nxl, passes);
}
constexpr int kWgBars = 8;  // mbarriers: each warpgroup's two slots

// Floats of a wgmma instance's region of its own: its ring, or r_hat's and
// t's (at 3 passes and 96 columns none).
__host__ __device__ constexpr int k1_wg_own_floats(int nxl, int nz, int passes) {
  return !k1_wg_ring_in_dead(nxl, passes) ? 8 * k1_wg_slot(nxl, passes)
         : k1_wg_rt_in_ring(nxl, passes)  ? 0
                                          : k1_tf32_parts(passes) * nxl * nz;
}
// Shared memory of a wgmma instance over nxl columns of nz levels, bytes:
// two state copies, the slabs s1 (pHY', rhs^T, p) and s2 (p_hat^T), the
// bottom profile, its own region and the mbarriers.
__host__ __device__ constexpr size_t k1_wg_smem_bytes(int nxl, int nz, int passes) {
  const size_t nc = (size_t)nxl * nz;
  return sizeof(float) * (2 * (2 * nc + (size_t)nxl * (nz + 1)) + 2 * nc + nxl +
                          k1_wg_own_floats(nxl, nz, passes)) +
         kWgBars * sizeof(uint64_t);
}

// Element (row, k) of a 16 mw-row A operand in the fragment order: k-step s
// = k / 8, warp w = row / 16 of the group, lane 4 g + t's four values at slot
// 4 g + (t ^ (g / 2 % 4)) (so that the divergence's and product 3's stores
// of one level or column spread over the banks), register i.
__host__ __device__ constexpr int k1_afrag_slot(int lane) {
  return (lane & ~3) | ((lane & 3) ^ ((lane >> 3) & 3));
}
__host__ __device__ constexpr int k1_afrag_index(int row, int k, int mw) {
  return (((k >> 3) * mw + (row >> 4)) * 32 + k1_afrag_slot(4 * (row & 7) + (k & 3))) * 4 +
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

// The packed constants of a wgmma instance on an nx x nz grid (ops/poisson.py
// k1_tf32_constants), in floats, each value TF32-exact as the products take
// it (at 3 passes hi and lo, at 1 the value rounded): F's chunks, then G's,
// each [CTA r][chunk j][warpgroup g][part][the g's rows of the chunk's
// columns as B^T], in the order CTA r takes them (chunk j the columns of CTA
// (r + j / (nxl / KC)) % c); then ct^T and st^T in the fragment order of
// their nz / 16 warps (a lane's values of a k-step, hi then lo; lanes in
// their own order), and dinv in the order of product 2's accumulators
// ([r][g][w][lane][NW / 2]).
__host__ __device__ constexpr int k1_tf32_g(int nx, int passes) {
  return k1_tf32_parts(passes) * nx * nx;
}
__host__ __device__ constexpr int k1_tf32_ct(int nx, int passes) {
  return 2 * k1_tf32_g(nx, passes);
}
__host__ __device__ constexpr int k1_tf32_st(int nx, int nz, int passes) {
  return k1_tf32_ct(nx, passes) + k1_tf32_parts(passes) * nz * nz;
}
__host__ __device__ constexpr int k1_tf32_dinv(int nx, int nz, int passes) {
  return k1_tf32_st(nx, nz, passes) + k1_tf32_parts(passes) * nz * nz;
}

// The warpgroup's accumulators cleared (and fenced from the wgmma after).
template <int N>
__device__ __forceinline__ void wg_clear(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = 0.0f;
    fence_operand(acc[i]);
  }
}

// acc += A . B for the warpgroup's 64 x N tile, KS k-steps deep, in kPasses
// TF32 passes on wgmma: ld(s) loads the lane's A values of k-step s (the
// next k-step's load is in flight while one is multiplied) and Ld::split(v,
// hi, lo) gives their TF32 parts; B^T lies at shared address b (its lo part
// at b_lo), its 8-row groups sbo bytes apart. At most two k-steps are in
// flight, so at most two of A's fragments live in registers. The
// accumulators are ready when it returns.
template <int kPasses, int N, int KS, class Ld>
__device__ __forceinline__ void wg_mma(float (&acc)[N / 2], Ld ld, unsigned b, unsigned b_lo,
                                       unsigned sbo) {
  auto next = ld(0);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const auto v = next;
    if (s + 1 < KS) next = ld(s + 1);
    unsigned ah[4], al[4];
    Ld::split(v, ah, al);
    wgmma_fence();
    const uint64_t dh = k1_bdesc(b + 256 * s, sbo);  // k-step s: two core matrices on
    if constexpr (kPasses == 3) {
      wgmma_tf32<N>(acc, ah, k1_bdesc(b_lo + 256 * s, sbo));
      wgmma_tf32<N>(acc, al, dh);
    }
    wgmma_tf32<N>(acc, ah, dh);
    wgmma_commit();
    wgmma_wait<1>();  // k-step s - 1 is done: its A registers are free again
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
}

// The A values of a slab in the fragment order (rows nz = 16 MW levels, the
// warps past them zero), split here into their TF32 parts.
template <int kPasses, int MW>
struct WgSlabA {
  const float* a;  // the lane's values of k-step 0
  __device__ __forceinline__ float4 operator()(int s) const {
    if (((threadIdx.x >> 5) & 3) >= MW) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return *reinterpret_cast<const float4*>(a + s * MW * 128);
  }
  static __device__ __forceinline__ void split(const float4& v, unsigned (&hi)[4],
                                               unsigned (&lo)[4]) {
    const float x[4] = {v.x, v.y, v.z, v.w};
    tf32_operands<kPasses>(x, hi, lo);
  }
};

// The TF32 parts of a packed constant's A values, as packed (hi, then lo).
struct WgParts {
  float4 hi, lo;
};
template <int kPasses, int MW>
struct WgConstA {
  const float4* p;  // the lane's parts of k-step 0
  __device__ __forceinline__ WgParts operator()(int s) const {
    constexpr int H = k1_tf32_parts(kPasses);
    WgParts v{make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    if (((threadIdx.x >> 5) & 3) < MW) {
      v.hi = __ldg(p + s * MW * 32 * H);
      if constexpr (kPasses == 3) v.lo = __ldg(p + s * MW * 32 * H + 1);
    }
    return v;
  }
  static __device__ __forceinline__ void split(const WgParts& v, unsigned (&hi)[4],
                                               unsigned (&lo)[4]) {
    hi[0] = __float_as_uint(v.hi.x), hi[1] = __float_as_uint(v.hi.y);
    hi[2] = __float_as_uint(v.hi.z), hi[3] = __float_as_uint(v.hi.w);
    lo[0] = __float_as_uint(v.lo.x), lo[1] = __float_as_uint(v.lo.y);
    lo[2] = __float_as_uint(v.lo.z), lo[3] = __float_as_uint(v.lo.w);
  }
};

// A warpgroup's ring (see above): the stream of a stage's 2 nch bulk copies,
// F's chunks of product 1 and then G's of product 4, copy n into slot n & 1,
// each completing its slot's mbarrier, and the two x products over them.
template <int NXL, int NZ, int kPasses>
struct K1WgRing {
  static constexpr int H = k1_tf32_parts(kPasses), NW = NXL / 4, MW = NZ / 16;
  static constexpr int KC = k1_wg_chunk(NXL, kPasses), S = k1_wg_slot(NXL, kPasses);
  static constexpr bool kRtInRing = k1_wg_rt_in_ring(NXL, kPasses);
  float* slots;       // this warpgroup's two slots (the dead copy's move each stage)
  uint64_t* bar;      // their mbarriers
  const float* f;     // this warpgroup's part of this CTA's first chunk of F
  int g_off, nch;     // floats from F's chunks to G's; chunks an x product
  unsigned phases;    // bit s: the parity of slot s's next phase

  // copy n may go now: the stream's, and at kRtInRing not G's before product 3
  __device__ __forceinline__ bool may_issue(int n) const {
    return n < 2 * nch && !(kRtInRing && n >= nch);
  }
  // copy n of the stream, by the warpgroup's first thread
  __device__ __forceinline__ void issue(int n) const {
    if ((threadIdx.x & 127) == 0) {
      const int j = n < nch ? n : n - nch;
      fence_proxy_async();
      bulk_copy_g2s(slots + (n & 1) * S, f + (n < nch ? 0 : g_off) + (size_t)j * 4 * S,
                    sizeof(float) * S, bar + (n & 1));
    }
  }
  // the first two copies of the stage (where the ring is in the dead copy,
  // after the march)
  __device__ __forceinline__ void start() const {
    if (may_issue(0)) issue(0);
    if (may_issue(1)) issue(1);
  }
  // at kRtInRing, after product 3: G's first two chunks
  __device__ __forceinline__ void start_g() const {
    if constexpr (kRtInRing) {
      issue(nch);
      if (nch + 1 < 2 * nch) issue(nch + 1);
    }
  }
  // acc = A . B^T of an x product, its copies m .. m + nch - 1: chunk j's
  // columns those of CTA q = (r + j / (NXL / KC)) % c, A from q's slab
  // (src(q), fragment order) from k-step (j % (NXL / KC)) KC / 8 on.
  template <class Src>
  __device__ __forceinline__ void x_product(float (&acc)[NW / 2], int m, Src src, int r, int c) {
    constexpr int SUB = NXL / KC;
    const int wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    wg_clear(acc);
    for (int j = 0; j < nch; ++j) {
      const int n = m + j, s = n & 1;
      const float* a = src((r + j / SUB) % c) +
                       (((j % SUB) * (KC / 8) * MW + wl) * 32 + k1_afrag_slot(lane)) * 4;
      mbar_wait(bar + s, (phases >> s) & 1);
      phases ^= 1u << s;
      const unsigned b = smem_u32(slots + s * S);
      wg_mma<kPasses, NW, KC / 8>(acc, WgSlabA<kPasses, MW>{a}, b, b + sizeof(float) * NW * KC,
                                  32 * KC);
      warpgroup_barrier();  // every warp's wgmma of the chunk is done: the slot is free
      if (n + 2 < 2 * nch && (!kRtInRing || n >= nch || n + 2 < nch)) issue(n + 2);
    }
  }
};

// One stage's solve on wgmma (see above), products 1 to 3 of this thread's
// warpgroup over a block of NXL columns of NZ levels, nx = c NXL in all (CTA
// r of c on a cluster; 0 of 1 on the chip): rhs^T in s1 (fragment order) of
// every CTA in (src(q): CTA q's s1), p_hat^T out into s2 (fragment order),
// r_hat and then t in rt (this warpgroup's). Product 4 (k1_wg_product_4)
// follows once every CTA's p_hat^T is written.
template <int NXL, int NZ, int kPasses, class Ring, class Src>
__device__ __forceinline__ void k1_wg_products_123(Ring& ring, float* s2, float* rt,
                                                   const float* __restrict__ tf32, int r, int c,
                                                   Src src) {
  constexpr int NW = Ring::NW, MW = Ring::MW, NA = NW / 2;
  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, nx = c * NXL;
  // the lane's rows of a 64 x NW tile are 16 wl + g + 8 h, its columns 8 j +
  // 2 t + e (acc[4 j + 2 h + e]); the rows past nz (warps wl >= MW) are zero
  auto row = [&](int i) { return 16 * wl + g + 8 * ((i >> 1) & 1); };
  auto col = [&](int i) { return 8 * (i >> 2) + 2 * t + (i & 1); };
  // r_hat or t into rt, the B^T operand of the next product: TF32-exact parts
  auto store_b = [&](const float (&acc)[NA]) {
    if (wl < MW) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int idx = k1_bcore_index(col(i), row(i), NZ);
        if constexpr (kPasses == 3) {
          const unsigned hi = __float_as_uint(acc[i]) & 0xffffe000u;
          rt[idx] = __uint_as_float(hi);
          rt[idx + NW * NZ] = __uint_as_float(to_tf32(acc[i] - __uint_as_float(hi)));
        } else {
          rt[idx] = __uint_as_float(to_tf32(acc[i]));
        }
      }
    }
    fence_proxy_async();
    warpgroup_barrier();
  };
  const unsigned b_rt = smem_u32(rt), b_rt_lo = b_rt + sizeof(float) * NW * NZ;
  auto consts = [&](int at) {  // A from the packed constants: the lane's parts of k-step 0
    return WgConstA<kPasses, MW>{reinterpret_cast<const float4*>(tf32 + at) +
                                 (wl * 32 + lane) * k1_tf32_parts(kPasses)};
  };
  float acc[NA];
  ring.x_product(acc, 0, src, r, c);  // r_hat^T = rhs^T F^T
  store_b(acc);
  wg_clear(acc);  // t^T = (ct^T r_hat^T) * dinv^T
  wg_mma<kPasses, NW, NZ / 8>(acc, consts(k1_tf32_ct(nx, kPasses)), b_rt, b_rt_lo, 32 * NZ);
  if (wl < MW) {
    const float4* d = reinterpret_cast<const float4*>(tf32 + k1_tf32_dinv(nx, NZ, kPasses)) +
                      (((r * 4 + wg) * MW + wl) * 32 + lane) * (NA / 4);
#pragma unroll
    for (int q = 0; q < NA / 4; ++q) {
      const float4 v = __ldg(d + q);
      acc[4 * q] *= v.x, acc[4 * q + 1] *= v.y, acc[4 * q + 2] *= v.z, acc[4 * q + 3] *= v.w;
    }
  }
  warpgroup_barrier();  // r_hat read: t takes its place
  store_b(acc);
  wg_clear(acc);  // p_hat^T = st^T t^T
  wg_mma<kPasses, NW, NZ / 8>(acc, consts(k1_tf32_st(nx, NZ, kPasses)), b_rt, b_rt_lo, 32 * NZ);
  if (wl < MW) {
#pragma unroll
    for (int i = 0; i < NA; ++i) s2[k1_afrag_index(row(i), NW * wg + col(i), MW)] = acc[i];
  }
  if constexpr (Ring::kRtInRing) {  // t read: G's first chunks take the ring
    warpgroup_barrier();
    ring.start_g();
  }
}

// Product 4 of k1_wg_products_123's solve, p^T = p_hat^T G^T: p_hat^T of
// every CTA in (src(q): CTA q's s2), p (plain, (column, level)) out into s1.
template <int NXL, int NZ, int kPasses, class Ring, class Src>
__device__ __forceinline__ void k1_wg_product_4(Ring& ring, float* s1, int r, int c, Src src) {
  constexpr int NW = Ring::NW, MW = Ring::MW;
  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[NW / 2];
  ring.x_product(acc, ring.nch, src, r, c);
  if (wl < MW) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i)
      s1[(NW * wg + 8 * (i >> 2) + 2 * t + (i & 1)) * NZ + 16 * wl + g + 8 * ((i >> 1) & 1)] =
          acc[i];
  }
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
// The same with the columns of u, b and the slabs ld floats apart, w's ld +
// 1, the z transforms' rows ld apart, and g ghost columns each side of the
// state's fields (a runtime-size bucket's compile-time stride: the levels
// past nz are padding, never read); on_chip_smem_floats at ld = nz, g = 0.
__host__ __device__ constexpr size_t k1_padded_smem_floats(int nx, int nz, int ld, int g) {
  return 2 * (2 * (size_t)(nx + 2 * g) * ld + (size_t)(nx + 2 * g) * (ld + 1)) +
         2 * (size_t)nx * ld + 2 * (size_t)nz * ld + nx;
}
__host__ __device__ constexpr size_t k1_rt_smem_floats(int nx, int nz, int passes, int ld, int g) {
  return k1_rt_own_floats(nx, nz, passes)
             ? ((k1_padded_smem_floats(nx, nz, ld, g) + 3) & ~(size_t)3) +
                   k1_rt_own_floats(nx, nz, passes)
             : k1_padded_smem_floats(nx, nz, ld, g);
}

// Whether the on-chip instance takes the grid: its warps' columns, its
// lanes' levels and its shared memory.
bool env_step_2d_on_chip(int nx, int nz) {
  return nx >= 4 && k1_cols(nx) <= kK1MaxCols && nz >= 2 && nz <= kK1MaxNz &&
         sizeof(float) * on_chip_smem_floats(nx, nz) <= kSmemPerBlock;
}

// K1's runtime-size bucket for a block of nxl columns (a grid on the chip,
// a CTA's slab on a cluster) of nz levels and a pass count: the columns a
// warp and levels a lane its instance is compiled for, each the fewest of a
// few that hold the block, and the compile-time stride of its columns (0:
// nz, at runtime). A grid off the compile-time instances then pays neither
// for the largest block (the instance's per-thread tendencies and tile are
// XS x NS x 3 and XS x NS registers) nor for a runtime stride in every
// index of its march (the runtime-size instance, 8 x 2 at stride nz, kept
// 1080 bytes a thread in local memory). On the chip in float32: nz <= 32 8
// columns of one level a lane at stride 32; nz <= 48 8 of two at stride 48;
// nz <= 64 4 of two at stride 64 where nxl <= 64; else 8 of two at stride
// nz. On a cluster in float32 8 columns of one level a lane where nz <= 32,
// else of two, at stride nz. At TF32 8 columns of two levels a lane at
// stride nz (buckets of their own, two instances more at each stride, would
// lengthen the build). {0, 0, 0} where a compile-time instance runs the
// block (ops/limits.py env_step_2d_bucket).
struct K1Bucket {
  int cols, levels, ld;
};
K1Bucket k1_bucket(int nxl, int nz, int passes, bool cluster) {
  const bool compiled = cluster ? (passes > 0 ? k1_cluster_wgmma(nxl, nz, passes)
                                              : nz == 64 && (nxl == 64 || nxl == 96))
                                 : (passes > 0 ? k1_wgmma(nxl, nz, passes) : nxl == 96 && nz == 64);
  if (compiled) return {0, 0, 0};
  if (cluster || passes > 0) return {8, passes == 0 && nz <= 32 ? 1 : 2, 0};
  if (nz <= 32) return {8, 1, 32};
  if (nz <= 48) return {8, 2, 48};
  return k1_cols(nxl) <= 4 ? K1Bucket{4, 2, 64} : K1Bucket{8, 2, 0};
}
// Shared memory of the on-chip instance for a grid and a pass count, floats:
// its bucket's stride and, at a compile-time stride, three ghost columns
// each side (the kernel's kG), else on_chip_smem_floats's layout; at TF32
// (k1_rt_smem_floats) and its ring's own region where it has one.
size_t k1_on_chip_smem_floats(int nx, int nz, int passes) {
  const int ld = k1_bucket(nx, nz, passes, false).ld;
  return passes > 0 ? k1_rt_smem_floats(nx, nz, passes, ld ? ld : nz, ld ? 3 : 0)
                    : k1_padded_smem_floats(nx, nz, ld ? ld : nz, ld ? 3 : 0);
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

// Whether K1's instance for a grid and a pass count runs its solve on wgmma:
// the on-chip instance where k1_wgmma takes the grid, the cluster's where
// k1_cluster_wgmma takes a CTA's columns.
bool env_step_2d_wgmma(int nx, int nz, int passes) {
  const int c = env_step_2d_cluster_size(nx, nz);
  return c > 0 ? k1_cluster_wgmma(nx / c, nz, passes)
               : env_step_2d_on_chip(nx, nz) && k1_wgmma(nx, nz, passes);
}

// The runtime-size bucket (k1_bucket) of K1's instance for a grid and a
// pass count, on the chip or over a cluster CTA's slab, as 10000 columns a
// warp + 100 stride + levels a lane; 0 where a compile-time instance or the
// off-chip one takes the grid.
int env_step_2d_bucket(int nx, int nz, int passes) {
  const int c = env_step_2d_cluster_size(nx, nz);
  if (c == 0 && !env_step_2d_on_chip(nx, nz)) return 0;
  const K1Bucket b = k1_bucket(c > 0 ? nx / c : nx, nz, passes, c > 0);
  return 10000 * b.cols + 100 * b.ld + b.levels;
}

// Whether K1's instance for a grid and a pass count reads constants packed
// on the host (the launcher's tf32, ops/poisson.py k1_tf32_constants): the
// wgmma instances and the on-chip runtime-size TF32 one.
bool env_step_2d_packed(int nx, int nz, int passes) {
  return env_step_2d_wgmma(nx, nz, passes) || (passes > 0 && env_step_2d_on_chip(nx, nz));
}

// F's or G's columns a chunk of a wgmma instance's ring (k1_wg_chunk over a
// CTA's columns; ops/limits.py k1_wgmma_chunk, by which the host packs
// them); 0 where the instance is not on wgmma.
int env_step_2d_wgmma_chunk(int nx, int nz, int passes) {
  if (!env_step_2d_wgmma(nx, nz, passes)) return 0;
  const int c = env_step_2d_cluster_size(nx, nz);
  return k1_wg_chunk(c > 0 ? nx / c : nx, passes);
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

// K1's off-chip instance: its products' tiles (a ring of two stages in
// shared memory), its march's strips and carries, and its scratch.
// A product's tiles: narrow, 128 x 64 outputs from 32-deep chunks, a 4 x 4
// block a thread (and the TF32 instances' 32 x 16 a warp); wide (float32
// where nz > 64), 256 x 128 from 16-deep chunks, 8 x 8 a thread, which
// halves the shared-memory loads an FMA: a narrow thread's 8 loaded values
// feed 16 FMA, so the loads, not the FMA pipes, would set the pace.
template <bool kWide>
struct GTile {
  static constexpr int TM = kWide ? 256 : 128, TN = kWide ? 128 : 64, KC = kWide ? 16 : 32;
  static constexpr int LdA = KC + 4;  // floats between a staged A tile's rows (conflict-free)
  static constexpr int LdB = TN + 8;  // floats between a staged B tile's rows (conflict-free)
  static constexpr int Floats = TM * LdA + KC * LdB;
};
// floats of one stage of the ring (two stages: the next chunk in flight
// while this one is used)
constexpr int kGStage =
    GTile<true>::Floats > GTile<false>::Floats ? GTile<true>::Floats : GTile<false>::Floats;
constexpr int kGStrip = 16;  // most columns of a march strip
// a warp's carries from one chunk of its strip to the next below, floats:
// pHY''s running sum (a double) of each column and the strip's left
// neighbour, then each column's z fluxes of u and b and w* at the chunk's
// lowest level
constexpr int kGCarry = 2 * (kGStrip + 1) + 3 * kGStrip + 2;
// a warp's ring of eight columns of u, w and b, each 40 levels from k0 - 3
constexpr int kGColLevels = 40;
constexpr int kGCols = 8 * 3 * kGColLevels;
constexpr size_t kGSmemFloats = 2 * kGStage + kK1Warps * (kGCarry + kGCols);

// Scratch per env of the off-chip instance, in floats: a second copy of u,
// w, b and the tendencies gu, gw, gb (each stage's, then the previous
// stage's), then the two slabs where they are not in shared memory.
__host__ __device__ constexpr size_t off_chip_scratch_floats(int nx, int nz, bool global_slabs) {
  return (global_slabs ? 6 : 4) * (size_t)nx * nz + 2 * (size_t)nx * (nz + 1);
}

// Whether K1 keeps its two (nx, nz) slabs in shared memory: on the chip and
// on a cluster always; the off-chip instance where they fit a block beside
// its products' ring and its march's carries and columns (nx nz <= 13,408:
// 127x64, not 128x224), else in global scratch (256x128, 2048x64).
bool env_step_2d_slabs_on_chip(int nx, int nz) {
  return env_step_2d_on_chip(nx, nz) || env_step_2d_cluster_size(nx, nz) > 0 ||
         sizeof(float) * (kGSmemFloats + 2 * (size_t)nx * nz) <= kSmemPerBlock;
}

// Shared memory K1 needs per block, in floats: the on-chip instance's, a
// cluster CTA's (the on-chip layout over nx / c columns, and its rows of F
// and G where they fit), or the off-chip one's ring and carries and its two
// (nx, nz) slabs where they fit.
size_t env_step_2d_smem_floats(int nx, int nz) {
  if (env_step_2d_on_chip(nx, nz)) return k1_on_chip_smem_floats(nx, nz, 0);
  const int c = env_step_2d_cluster_size(nx, nz);
  if (c == 0) return kGSmemFloats + (env_step_2d_slabs_on_chip(nx, nz) ? 2 * (size_t)nx * nz : 0);
  return on_chip_smem_floats(nx / c, nz) +
         (env_step_2d_cluster_fg(nx, nz) ? 2 * (size_t)(nx / c) * nx : 0);
}

// Global scratch per env, in floats: none on the chip or a cluster; off
// them off_chip_scratch_floats.
size_t env_step_2d_scratch_floats(int nx, int nz) {
  if (env_step_2d_on_chip(nx, nz) || env_step_2d_cluster_size(nx, nz) > 0) return 0;
  return off_chip_scratch_floats(nx, nz, !env_step_2d_slabs_on_chip(nx, nz));
}

// Shared memory K1's instance for a grid and a pass count asks a block,
// bytes: a wgmma instance's (k1_wg_smem_bytes, over a CTA's columns on a
// cluster), the on-chip runtime-size TF32 one's (k1_rt_smem_floats), else
// env_step_2d_smem_floats.
size_t env_step_2d_launch_smem_bytes(int nx, int nz, int passes) {
  const int c = env_step_2d_cluster_size(nx, nz);
  if (env_step_2d_wgmma(nx, nz, passes)) return k1_wg_smem_bytes(c > 0 ? nx / c : nx, nz, passes);
  if (passes > 0 && env_step_2d_on_chip(nx, nz))
    return sizeof(float) * k1_on_chip_smem_floats(nx, nz, passes);
  return sizeof(float) * env_step_2d_smem_floats(nx, nz);
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

// v, opaque to the compiler from here on: nothing computed from it is
// hoisted out of the loop around this point. K1's runtime-size buckets
// launder their column and level bases each column and each product, so
// that the addresses of every column and tap, and every row of F and G,
// are computed where they are used and not held (spilled, at 128
// registers) across the stage loop.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// acc[r][s] += sum_{k < K} L[row_r][k] R[k][col_s], the float32 products of
// K1's runtime-size buckets: rows row_r = min(row0 + r, nrow - 1) of L (ldl
// floats apart), columns col_s = min(lane + 32 s, ncol - 1) of R (rows ldr
// apart). Where vec (K % 4 == 0, L's rows 16-byte aligned) four k a step: R's
// four rows into registers first, then L's row r one float4 at a time beside
// them, so that a thread holds 4 NS + 4 operands (tile_product's kVec holds
// 4 XS + NS: 32 more registers at 8 columns a warp, beside the march's
// tendencies); else one k a step, as tile_product. The sum over k runs in
// the same order either way.
template <int XS, int NS>
__device__ __forceinline__ void bucket_product(const float* L, int ldl, const float* R, int K,
                                               int ldr, int ncol, int row0, int nrow, int lane,
                                               bool vec, float (&acc)[XS][NS]) {
  int row[XS], col[NS];
  row0 = opaque(row0);
#pragma unroll
  for (int r = 0; r < XS; ++r) row[r] = min(row0 + r, nrow - 1) * ldl;
#pragma unroll
  for (int s = 0; s < NS; ++s) col[s] = min(lane + 32 * s, ncol - 1);
  if (vec) {
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float bv[4][NS];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int s = 0; s < NS; ++s) bv[kk][s] = R[(k + kk) * ldr + col[s]];
#pragma unroll
      for (int r = 0; r < XS; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(L + row[r] + k);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          acc[r][s] = fmaf(a.x, bv[0][s], acc[r][s]);
          acc[r][s] = fmaf(a.y, bv[1][s], acc[r][s]);
          acc[r][s] = fmaf(a.z, bv[2][s], acc[r][s]);
          acc[r][s] = fmaf(a.w, bv[3][s], acc[r][s]);
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

// pt = L . R over an on-chip K1 thread's tile (L's rows ldl floats apart,
// R's ldr, its first ncol columns; rows from row0, columns from 0):
// tile_product (ldl = K, ncol = ldr), or in a runtime-size bucket
// bucket_product.
template <bool kBucket, int XS, int NS, bool kVec>
__device__ __forceinline__ void k1_tile(const float* L, int ldl, const float* R, int K, int ldr,
                                        int ncol, int row0, int nrow, int lane, bool vec,
                                        float (&acc)[XS][NS]) {
  if constexpr (kBucket) {
#pragma unroll
    for (int r = 0; r < XS; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s) acc[r][s] = 0.0f;
    bucket_product<XS, NS>(L, ldl, R, K, ldr, ncol, row0, nrow, lane, vec, acc);
  } else {
    tile_product<XS, NS, kVec>(L, R, K, ldr, row0, nrow, 0, lane, acc);
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
  // NX < 0: a runtime-size bucket (k1_bucket) of at most -NX columns a warp,
  // its columns -NZ floats apart (32, 48 or 64: the levels past nz padding,
  // never read) or, at NZ = -1 or -2, nz apart with -NZ levels a lane
  constexpr bool kBucket = NX < 0;
  constexpr int kLd = kBucket && NZ < -2 ? -NZ : 0;  // a bucket's compile-time stride
  // ghost columns each side of the state's fields (their periodic
  // neighbours'): the buckets of a compile-time stride, so that the march's
  // x taps are affine in the column and need no wrap
  constexpr int kG = kLd ? 3 : 0;
  // a lane's levels: one where nz <= 32
  constexpr int NS =
      kBucket ? (kLd ? (kLd + 31) / 32 : -NZ) : (NZ > 0 && NZ <= 32 ? 1 : kK1Levels);
  constexpr int XS = kBucket ? -NX : (NX > 0 ? k1_cols(NX) : kK1MaxCols);
  // a float32 bucket of 16 points a thread keeps the previous stage's
  // tendencies in the state copy the march has read (dead until the next
  // march writes it), not in registers: the march reads them where it
  // writes the point, and holds few of its own until it ends: gb in s2 (free
  // during the march), gu of column i in s1 once column i + 1 has read its
  // pHY' (but the strip's last column's, which the next warp reads), gw in
  // registers. With 48 tendencies in registers 128x40 spilled 168 bytes a
  // thread and took 3 % longer; at 8 points they fit, and the round trips
  // through shared memory cost 64x64 6 % (PERF.md, section 6).
  constexpr bool kGpDead = kBucket && kPasses == 0 && XS * NS > 8;
  constexpr bool kVec = NX > 0 && NX % 4 == 0 && NZ % 4 == 0;
  constexpr bool kWgmma = k1_wgmma(NX, NZ, kPasses);  // the solve on wgmma (tf32: its constants)
  constexpr bool kRingInDead = kWgmma && k1_wg_ring_in_dead(NX, kPasses);
  extern __shared__ float smem[];
  const int nx = NX > 0 ? NX : P.nx, nz = NZ > 0 ? NZ : P.nz, nw = nz + 1;
  // the columns of u, b and the slabs ld floats apart, w's ldw; a copy of
  // the state's fields ncg, nfg floats (with their ghost columns) and ncopy
  // in all; an env's fields in global memory gc and gf floats apart
  const int ld = kLd ? kLd : nz, ldw = ld + 1;
  const int nc = nx * ld, nf = nx * ldw, gc = nx * nz, gf = nx * nw;
  const int ncg = (nx + 2 * kG) * ld, nfg = (nx + 2 * kG) * ldw, ncopy = 2 * ncg + nfg;
  const size_t e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xs = k1_cols(nx), x0 = warp * xs, xn = min(xs, nx - x0);  // xn may be <= 0
  // a bucket's products read L four values at a time where nx and nz allow
  const bool vec = kBucket && (nx & 3) == 0 && (nz & 3) == 0;

  State2D X{smem + kG * ld, smem + ncg + kG * ldw, smem + ncg + nfg + kG * ld};
  State2D Y{X.u + ncopy, X.w + ncopy, X.b + ncopy};
  float* s1 = smem + 2 * ncopy;  // pHY', then the divergence, R~ and p
  float* s2 = s1 + nc;        // r_hat and p_hat
  float* ct = s2 + nc;        // z analysis, (z, j)
  float* st = ct + nz * ld;   // z synthesis, (j, z)
  // bottom (nx); the wgmma instances keep no z transforms: after the bottom
  // their own region (their ring, or r_hat's and t's) and the mbarriers
  float* bot = kWgmma ? s2 + nc : st + nz * ld;
  float* own = bot + nx;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(own + k1_wg_own_floats(NX, NZ, kPasses));
  // The wgmma instances' ring of F's and G's chunks (K1WgRing), this
  // warpgroup's; its first copies of a stage go where the ring allows
  // (ablate_k1 and ablate_k1c drop the lines that call stage_fg)
  using Wg = K1WgRing<kWgmma ? NX : 64, kWgmma ? NZ : 64, kWgmma ? kPasses : 1>;
  Wg ring{nullptr, mbar + 2 * (threadIdx.x >> 7), tf32 + (threadIdx.x >> 7) * Wg::S,
          k1_tf32_g(nx, kPasses), nx / Wg::KC, 0u};
  auto stage_fg = [&] { ring.start(); };

  if constexpr (kLd > 0) {  // column by column into the padded layout
    for (int q = threadIdx.x; q < gc; q += kK1Threads) {
      const int i = q / nz, k = q - i * nz;
      X.u[i * ld + k] = u_in[e * gc + q];
      X.b[i * ld + k] = b_in[e * gc + q];
    }
    for (int q = threadIdx.x; q < gf; q += kK1Threads) {
      const int i = q / nw, k = q - i * nw;
      X.w[i * ldw + k] = Y.w[i * ldw + k] = w_in[e * gf + q];
    }
  } else {
    for (int q = threadIdx.x; q < nc; q += kK1Threads) {
      X.u[q] = u_in[e * nc + q];
      X.b[q] = b_in[e * nc + q];
    }
    for (int q = threadIdx.x; q < nf; q += kK1Threads) X.w[q] = Y.w[q] = w_in[e * nf + q];
  }
  // the TF32 instances' slabs and z transforms: (row, col) at row * ld +
  // (col ^ slab_swizzle(row)) where nz % 32 == 0, else plain
  const bool swz = kPasses > 0 && (NZ > 0 ? NZ % 32 == 0 : nz % 32 == 0);
  auto S = [&](int row, int col) { return row * ld + (swz ? col ^ slab_swizzle(row) : col); };
  if constexpr (kPasses == 0) {
    for (int q = threadIdx.x; q < nz * nz; q += kK1Threads) {
      ct[q] = dct[q];
      st[q] = idct[q];
    }
  } else if constexpr (kWgmma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kWgBars; ++i) mbar_init(mbar + i, 1);
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
  // column i of the state X: i itself where ghost columns hold the periodic
  // neighbours, else wrapped
  auto xcol = [&](int i) { return kG > 0 ? i : wrap(i); };
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
    const float a = u[xcol(c) * ld], b = u[xcol(c + 1) * ld];
    return ub5_upwind(u[xcol(c - 2) * ld], u[xcol(c - 1) * ld], a, b, u[xcol(c + 2) * ld],
                      u[xcol(c + 3) * ld], 0.5f * (a + b));
  };
  auto xflux_face = [&](const float* q, int ld, int c, float vel) {
    return ub5_upwind(q[xcol(c - 3) * ld], q[xcol(c - 2) * ld], q[xcol(c - 1) * ld],
                      q[xcol(c) * ld], q[xcol(c + 1) * ld], q[xcol(c + 2) * ld], vel);
  };
  auto xflux_w = [&](const State2D& S, int c, int s) {
    const float* uc = S.u + xcol(c) * ld;
    const float vel = 0.5f * (uc[max(kl[s] - 1, 0)] + uc[kc[s]]);
    return xflux_face(S.w + kc[s], ldw, c, vel);
  };
  auto xflux_b = [&](const State2D& S, int c, int s) {
    return xflux_face(S.b + kc[s], ld, c, S.u[xcol(c) * ld + kc[s]]);
  };

  float gp[XS][NS][3] = {};  // the previous stage's gu, gw, gb of this thread's points
  float gul[NS];        // a float32 bucket's gu of the strip's last column
  float pt[XS][NS];     // the solve's tile: this thread's points
  for (int step = 0; step < P.n_substeps; ++step) {
    for (int stage = 0; stage < 3; ++stage) {
      const float gamma = kGamma[stage], zeta = kZeta[stage];
      const float dts = P.dts[stage], idts = P.idts[stage];
      const bool last = step == P.n_substeps - 1 && stage == 2;
      auto rk = [&](float f, float g, float g_prev) {
        return stage == 0 ? f + P.dt * (gamma * g) : f + P.dt * (gamma * g + zeta * g_prev);
      };
      if constexpr (kWgmma) {  // the ring in the copy this stage's march reads, or its own
        ring.slots = (kRingInDead ? X.u : own) + (threadIdx.x >> 7) * 2 * Wg::S;
        if constexpr (!kRingInDead) stage_fg();  // its first chunks while the march runs
      }

      // ---- 1. pHY' of this warp's columns: a float64 suffix scan along z ----
#pragma unroll
      for (int xi = 0; xi < XS; ++xi) {
        if (xi < xn) {
          double above = 0.0;
          phy_levels<NS>(X.b + (x0 + xi) * ld, s1 + (x0 + xi) * ld, 0, nz, lane, P, above);
        }
      }
      if constexpr (kG > 0) {  // X's ghost columns -3..-1 and nx..nx + 2 from theirs
        auto ghosts = [&](float* f, int ldf) {
          for (int q = threadIdx.x; q < 2 * kG * ldf; q += kK1Threads) {
            const int g = q / ldf, c = g < kG ? g - kG : nx + g - kG;
            f[c * ldf + q - g * ldf] = f[(g < kG ? c + nx : c - nx) * ldf + q - g * ldf];
          }
        };
        ghosts(X.u, ld);
        ghosts(X.w, ldw);
        ghosts(X.b, ld);
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
            if constexpr (kBucket) {  // this column's bases, computed here (opaque)
              const int ln = opaque(lane);
#pragma unroll
              for (int s = 0; s < NS; ++s) {
                kl[s] = ln + 32 * s;
                kc[s] = min(kl[s], nz - 1);
              }
            }
            const int i = (kBucket ? opaque(x0) : x0) + xi, im = wrap(i - 1);
            const int xm = xcol(i - 1), xp = xcol(i + 1);  // columns i -+ 1 of X
            const float* uc = X.u + i * ld;
            const float* wc = X.w + i * ldw;
            const float* bc = X.b + i * ld;
            const float* wm = X.w + xm * ldw;
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
                const float dphy = (s1[i * ld + k] - s1[im * ld + k]) * P.idx;
                // the previous column's gu where its pHY' was, now read
                if (kGpDead && xi > 0 && kk < nz) s1[im * ld + k] = gp[xi > 0 ? xi - 1 : 0][s][0];
                const float q = uc[k];
                const float qm = kk > 0 ? uc[max(kk - 1, 0)] : -uc[0];
                const float qp = kk < nz - 1 ? uc[min(kk + 1, nz - 1)] : -uc[nz - 1];
                const float lap = (X.u[xp * ld + k] - 2.0f * q + X.u[xm * ld + k]) * P.idx2 +
                                  (qp - 2.0f * q + qm) * P.idz2;
                const float g = -adv - dphy + P.nu * lap;
                if (kk < nz) Y.u[i * ld + k] = rk(q, g, kGpDead ? Y.u[i * ld + k] : gp[xi][s][0]);
                gp[xi][s][0] = g;
                if (kGpDead) gul[s] = g;
              }
              // ---- gw and w* at (center i, face k); face 0 is a wall ----
              {
                const float f_new = xflux_w(X, i + 1, s);
                float adv = (f_new - fw[s]) * P.idx;
                fw[s] = f_new;
                adv += (zw[s] - zw_dn[s]) * P.idz;
                const float q = wc[k];
                const float lap = (X.w[xp * ldw + k] - 2.0f * q + X.w[xm * ldw + k]) * P.idx2 +
                                  (wc[k + 1] - 2.0f * q + wc[max(k - 1, 0)]) * P.idz2;
                const float g = kk == 0 ? 0.0f : -adv + P.nu * lap;
                if (kk < nz) Y.w[i * ldw + k] = rk(q, g, kGpDead ? Y.w[i * ldw + k] : gp[xi][s][1]);
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
                const float lap = (X.b[xp * ld + k] - 2.0f * q + X.b[xm * ld + k]) * P.idx2 +
                                  (qp - 2.0f * q + qm) * P.idz2;
                const float g = -adv + P.kappa * lap;
                if (kk < nz) Y.b[i * ld + k] = rk(q, g, kGpDead ? Y.b[i * ld + k] : gp[xi][s][2]);
                if (kGpDead && kk < nz) {
                  s2[i * ld + k] = g;
                } else {
                  gp[xi][s][2] = g;
                }
              }
            }
          }
        }
      }
      __syncthreads();
      if constexpr (kRingInDead) stage_fg();  // F's first chunks into the state copy just read
      if constexpr (kGpDead) {  // this stage's tendencies into the copy just read
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              X.u[i * ld + k] = xi + 1 < xn ? s1[i * ld + k] : gul[s];
              X.w[i * ldw + k] = gp[xi][s][1];
              X.b[i * ld + k] = s2[i * ld + k];
            }
          }
        }
      }

      // ---- 3. div(u*, w*) / dt_stage ------------------------------------------
#pragma unroll
      for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int i = x0 + xi, k = kl[s];
          if (xi < xn && k < nz) {
            const float div = (Y.u[wrap(i + 1) * ld + k] - Y.u[i * ld + k]) * P.idx +
                              (Y.w[i * ldw + k + 1] - Y.w[i * ldw + k]) * P.idz;
            if constexpr (kPasses == 0) {
              s1[i * ld + k] = div * idts;
            } else if constexpr (kWgmma) {  // rhs^T, product 1's A
              s1[k1_afrag_index(k, i, NZ / 16)] = div * idts;
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
              if (xi < xn && kl[s] < nz) dst[(x0 + xi) * ld + kl[s]] = pt[xi][s];
        };
        // r_hat = F . rhs
        k1_tile<kBucket, XS, NS, kVec>(fmat, nx, s1, nx, ld, nz, x0, nx, lane, vec, pt);
        store(s2);
        __syncthreads();
        k1_tile<kBucket, XS, NS, kVec>(s2, ld, ct, nz, nz, nz, x0, nx, lane, vec,
                                       pt);  // r_hat C^T
#pragma unroll
        for (int xi = 0; xi < XS; ++xi)
#pragma unroll
          for (int s = 0; s < NS; ++s)
            pt[xi][s] *= __ldg(dinv + min(x0 + xi, nx - 1) * nz + kc[s]);
        store(s1);
        __syncthreads();
        k1_tile<kBucket, XS, NS, kVec>(s1, ld, st, nz, nz, nz, x0, nx, lane, vec,
                                       pt);  // p_hat = R~ S^T
        store(s2);
        __syncthreads();
        // p = G . p_hat
        k1_tile<kBucket, XS, NS, kVec>(gmat, nx, s2, nx, ld, nz, x0, nx, lane, vec, pt);
        store(s1);
        if (last) {
#pragma unroll
          for (int xi = 0; xi < XS; ++xi)
#pragma unroll
            for (int s = 0; s < NS; ++s)
              if (xi < xn && kl[s] < nz) p_out[e * gc + (x0 + xi) * nz + kl[s]] = pt[xi][s];
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
              const float pm = xi > 0 ? pt[xi - 1][s] : s1[wrap(i - 1) * ld + k];
              Y.u[i * ld + k] -= dts * ((p - pm) * P.idx);
              if (k > 0) Y.w[i * ldw + k] -= dts * ((p - s1[i * ld + k - 1]) * P.idz);
            }
          }
        }
        __syncthreads();
      } else if constexpr (kWgmma) {
        // ---- 4. the solve on the tensor cores: four products, slab to slab --
        k1_wg_products_123<NX, NZ, kPasses>(
            ring, s2,
            Wg::kRtInRing ? ring.slots
                          : (kRingInDead ? own : X.u) + (threadIdx.x >> 7) * Wg::H * Wg::NW * NZ,
            tf32, 0, 1, [&](int) { return s1; });
        __syncthreads();  // p_hat of every mode
        k1_wg_product_4<NX, NZ, kPasses>(ring, s1, 0, 1, [&](int) { return s2; });
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
        // the ring or r_hat and t took
        for (int q = threadIdx.x; q < nx; q += kK1Threads) X.w[q * nw + nz] = 0.0f;
        __syncthreads();
      } else {
        // ---- 4. the solve on the tensor cores: four products, slab to slab --
        constexpr bool kEdge = !(NX > 0 && NX % 16 == 0 && NZ % 32 == 0);
        auto slab = [&](const float* a) { return [=](int r, int c) { return a[S(r, c)]; }; };
        auto to_slab = [&](float* a) { return [=](int r, int c, float v) { a[S(r, c)] = v; }; };
        // F's and G's packs (tf32: F's, then G's) through the ring (k1_rt_step)
        const int own = k1_rt_own_floats(nx, nz, kPasses);
        float* dead = X.u - kG * ld;  // the state copy the march has read
        float* ring = own ? smem + ((k1_padded_smem_floats(nx, nz, ld, kG) + 3) & ~(size_t)3)
                          : dead + ((4 - ((smem_u32(dead) >> 2) & 3)) & 3);
        const int cap = own ? own : ncopy - 3;
        staged_product<kPasses>(tf32, ring, cap, nx, nz, nx, slab(s1),
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
        staged_product<kPasses>(tf32 + k1_rt_pack_floats(nx, kPasses), ring, cap, nx, nz, nx,
                                slab(s2), to_slab(s1));  // p = G . p_hat
        __syncthreads();

        // ---- 5. correct this thread's u*, w* by grad p, read from the slab --
#pragma unroll
        for (int xi = 0; xi < XS; ++xi) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int i = x0 + xi, k = kl[s];
            if (xi < xn && k < nz) {
              const float p = s1[S(i, k)];
              Y.u[i * ld + k] -= dts * ((p - s1[S(wrap(i - 1), k)]) * P.idx);
              if (k > 0) Y.w[i * ldw + k] -= dts * ((p - s1[S(i, k - 1)]) * P.idz);
              if (last) p_out[e * gc + i * nz + k] = p;
            }
          }
        }
        // the march never writes w's top wall face: zero it again in the copy
        // the ring may have taken
        for (int q = threadIdx.x; q < nx; q += kK1Threads) X.w[q * ldw + nz] = 0.0f;
        __syncthreads();
      }
      const State2D t = X;
      X = Y;
      Y = t;
    }
  }

  if constexpr (kLd > 0) {
    for (int q = threadIdx.x; q < gc; q += kK1Threads) {
      const int i = q / nz, k = q - i * nz;
      u_out[e * gc + q] = X.u[i * ld + k];
      b_out[e * gc + q] = X.b[i * ld + k];
    }
    for (int q = threadIdx.x; q < gf; q += kK1Threads) {
      const int i = q / nw;
      w_out[e * gf + q] = X.w[q + i * (ldw - nw)];
    }
  } else {
    for (int q = threadIdx.x; q < nc; q += kK1Threads) {
      u_out[e * nc + q] = X.u[q];
      b_out[e * nc + q] = X.b[q];
    }
    for (int q = threadIdx.x; q < nf; q += kK1Threads) w_out[e * nf + q] = X.w[q];
  }
}

// The on-chip K1 instance for a grid and a pass count: the float32 solve (0
// passes) specialised for the reference's 96x64, its runtime-size bucket
// (k1_bucket; the template's NX the bucket's -columns a warp, NZ its
// -stride, or -levels a lane at stride nz) for every other grid; the TF32
// one (1 or 3) on wgmma where k1_wgmma takes the grid (96x64, 64x64,
// 128x32), else its bucket: 8 columns a warp of two levels a lane at
// stride nz.
decltype(&env_step_2d_kernel<0, 0>) env_step_kernel_for(int nx, int nz, int passes) {
  const bool ref = nx == 96 && nz == 64;
  const K1Bucket b = k1_bucket(nx, nz, passes, false);
  if (passes == 0) {
    if (ref) return env_step_2d_kernel<96, 64>;
    if (b.ld == 32) return env_step_2d_kernel<-8, -32>;
    if (b.ld == 48) return env_step_2d_kernel<-8, -48>;
    return b.ld == 64 ? env_step_2d_kernel<-4, -64> : env_step_2d_kernel<-8, -2>;
  }
  if (!k1_wgmma(nx, nz, passes)) {
    return passes == 3 ? env_step_2d_kernel<-8, -2, 3> : env_step_2d_kernel<-8, -2, 1>;
  }
  if (passes == 3) {
    return ref ? env_step_2d_kernel<96, 64, 3>
                : (nx == 64 ? env_step_2d_kernel<64, 64, 3> : env_step_2d_kernel<128, 32, 3>);
  }
  return ref ? env_step_2d_kernel<96, 64, 1>
             : (nx == 64 ? env_step_2d_kernel<64, 64, 1> : env_step_2d_kernel<128, 32, 1>);
}

// ---- K1's off-chip instance ---------------------------------------------------
//
// Its solve's products are register-tiled: the block computes the (M, N)
// result a GTile at a time, over the contraction in chunks, each chunk's
// operand tiles staged in shared memory by cp.async (a ring of two: the
// next chunk in flight while this one is used); its march is one pass a
// stage over strips of columns (see the head of this file).

// One operand of a product: row-major rows `ld` floats apart, in shared
// memory (`shared`) or global memory; `vec`: 16-byte copies (ld % 4 == 0
// and the start 16-byte aligned).
struct GOperand {
  const float* p;
  int ld;
  bool shared, vec;
};
__device__ __forceinline__ GOperand g_operand(const float* p, int ld, bool shared) {
  return {p, ld, shared, (ld & 3) == 0 && ((uintptr_t)p & 15) == 0};
}

// Stage rows [r0, r0 + R) x columns [c0, c0 + C) of the (nr, ncol) operand
// into dst (rows ldd floats apart), zero outside it: from global memory by
// cp.async (16 bytes a copy where the operand allows, else 4), from shared
// memory by loads and stores.
template <int R, int C>
__device__ __forceinline__ void g_stage(float* dst, int ldd, const GOperand& a, int nr, int ncol,
                                        int r0, int c0) {
  constexpr int C4 = C / 4;
  for (int q = threadIdx.x; q < R * C4; q += kK1Threads) {
    const int r = q / C4, c = q % C4 * 4, gr = r0 + r, gc = c0 + c;
    float* d = dst + r * ldd + c;
    const float* s = a.p + (size_t)min(gr, nr - 1) * a.ld + gc;
    if (gr < nr && a.vec && gc + 4 <= ncol) {
      if (a.shared) {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
      } else {
        __pipeline_memcpy_async(d, s, 16);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gr < nr && gc + j < ncol) {
          if (a.shared) {
            d[j] = s[j];
          } else {
            __pipeline_memcpy_async(d + j, s + j, sizeof(float));
          }
        } else {
          d[j] = 0.0f;
        }
      }
    }
  }
}

// C = A . B for the (M, N) result, K deep, each element at (m, n) times
// scale[m * N + n] where `scale` is given; the ring is the first 2 kGStage
// floats of the block's shared memory, its tiles GTile<kWide>'s. kPasses
// 0: float32 FMA, thread (mg, ng) of a 32 x 16 grid computing rows mg + 32
// r (r < 4, wide 8) and columns 4 ng .. 4 ng + 3 (wide also 64 more) of a
// tile, from one 16-byte load of each staged A row per four contraction
// steps (wide one 4-byte load a step) and one (two) 16-byte loads of B's a
// step; 1 or
// 3 (narrow only): TF32 mma.sync, warp (wm, wn) of a 4 x 4 grid a 32 x 16
// block of m16n8k8 tiles, its fragments read from the same staged tiles
// and split as mma_product splits them. Not inlined, so that its registers
// are its own and not the stage's. Every thread meets the block before it
// returns.
template <int kPasses, bool kWide>
__device__ __noinline__ void g_product(GOperand A, GOperand B, int M, int N, int K, float* C,
                                       int ldc, const float* __restrict__ scale) {
  using T = GTile<kWide>;
  static_assert(kPasses == 0 || !kWide, "the TF32 products take the narrow tiles");
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nk = (K + T::KC - 1) / T::KC;
  auto epi = [&](float v, int m, int n) { return scale ? v * __ldg(scale + m * N + n) : v; };
  const int ng = (warp >> 3) * 8 + (lane & 7), mg = (warp & 7) * 4 + (lane >> 3);
  const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2;
  constexpr int R = kWide ? 8 : 4;  // rows of a float32 thread's block
  for (int m0 = 0; m0 < M; m0 += T::TM) {
    for (int n0 = 0; n0 < N; n0 += T::TN) {
      auto issue = [&](int c) {
        float* st = smem + (c & 1) * kGStage;
        g_stage<T::TM, T::KC>(st, T::LdA, A, M, K, m0, c * T::KC);
        g_stage<T::KC, T::TN>(st + T::TM * T::LdA, T::LdB, B, K, N, c * T::KC, n0);
      };
      issue(0);
      __pipeline_commit();
      float acc[R][kWide ? 8 : 4] = {};  // TF32: acc[2 i + j] the (i, j) m16n8 tile's
      for (int c = 0; c < nk; ++c) {
        if (c + 1 < nk) issue(c + 1);
        __pipeline_commit();  // (empty after the last chunk: the count stays one a chunk)
        __pipeline_wait_prior(1);
        __syncthreads();
        const float* st = smem + (c & 1) * kGStage;
        if constexpr (kPasses == 0 && kWide) {
          const float* As = st + mg * T::LdA;
          const float* Bs = st + T::TM * T::LdA + 4 * ng;
#pragma unroll 1
          for (int kk = 0; kk < T::KC; ++kk) {  // (unrolled, its 64 sums spill)
            float a[R];
#pragma unroll
            for (int r = 0; r < R; ++r) a[r] = As[32 * r * T::LdA + kk];
            const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * T::LdB);
            const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * T::LdB + 64);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][0] = fmaf(a[r], b0.x, acc[r][0]);
              acc[r][1] = fmaf(a[r], b0.y, acc[r][1]);
              acc[r][2] = fmaf(a[r], b0.z, acc[r][2]);
              acc[r][3] = fmaf(a[r], b0.w, acc[r][3]);
              acc[r][4] = fmaf(a[r], b1.x, acc[r][4]);
              acc[r][5] = fmaf(a[r], b1.y, acc[r][5]);
              acc[r][6] = fmaf(a[r], b1.z, acc[r][6]);
              acc[r][7] = fmaf(a[r], b1.w, acc[r][7]);
            }
          }
        } else if constexpr (kPasses == 0) {
          const float* As = st + mg * T::LdA;
          const float* Bs = st + T::TM * T::LdA + 4 * ng;
#pragma unroll 2
          for (int kk = 0; kk < T::KC; kk += 4) {
            float4 a[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
              a[r] = *reinterpret_cast<const float4*>(As + 32 * r * T::LdA + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 b = *reinterpret_cast<const float4*>(Bs + (kk + q) * T::LdB);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float av = q == 0 ? a[r].x : (q == 1 ? a[r].y : (q == 2 ? a[r].z : a[r].w));
                acc[r][0] = fmaf(av, b.x, acc[r][0]);
                acc[r][1] = fmaf(av, b.y, acc[r][1]);
                acc[r][2] = fmaf(av, b.z, acc[r][2]);
                acc[r][3] = fmaf(av, b.w, acc[r][3]);
              }
            }
          }
        } else {
          const float* As = st + (32 * wm + g) * T::LdA + t;
          const float* Bs = st + T::TM * T::LdA + t * T::LdB + 16 * wn + g;
#pragma unroll
          for (int kk = 0; kk < T::KC; kk += 8) {
            unsigned ah[2][4], al[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float* a = As + 16 * i * T::LdA + kk;
              const float x[4] = {a[0], a[8 * T::LdA], a[4], a[8 * T::LdA + 4]};
              tf32_operands<kPasses>(x, ah[i], al[i]);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float* b = Bs + kk * T::LdB + 8 * j;
              const float y[2] = {b[0], b[4 * T::LdB]};
              unsigned bh[2], bl[2];
              tf32_operands<kPasses>(y, bh, bl);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                if constexpr (kPasses == 3) {
                  mma_tf32(acc[2 * i + j], ah[i], bl);
                  mma_tf32(acc[2 * i + j], al[i], bh);
                }
                mma_tf32(acc[2 * i + j], ah[i], bh);
              }
            }
          }
        }
        __syncthreads();
      }
      if constexpr (kPasses == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int m = m0 + mg + 32 * r;
#pragma unroll
          for (int j = 0; j < (kWide ? 8 : 4); ++j) {
            const int n = n0 + 4 * ng + (j & 3) + 64 * (j >> 2);
            if (m < M && n < N) C[m * ldc + n] = epi(acc[r][j], m, n);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int m = m0 + 32 * wm + 16 * i + g + 8 * (e >> 1);
              const int n = n0 + 16 * wn + 8 * j + 2 * t + (e & 1);
              if (m < M && n < N) C[m * ldc + n] = epi(acc[2 * i + j][e], m, n);
            }
      }
    }
  }
  __syncthreads();  // the result, before anyone reads it
}

// pHY' at level k = k0 + lane of a column of nz levels, its b at k and k +
// 1 (each clamped into the column) given, from `above`, the sum over the
// levels above k0 (which gains this chunk's): phy_levels<1> returning the
// lane's value.
__device__ __forceinline__ float phy_at(float b0, float b1, int k, int nz, int lane,
                                        const K1Params& P, double& above) {
  const double face = 0.5 * ((double)b0 + (double)b1);
  double v = k < nz - 1 ? (double)P.dz * face : (k == nz - 1 ? 0.5 * P.dz * P.min_b : 0.0);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += t;
  }
  const double total = __shfl_sync(kFull, v, 0);
  const float p = (float)-(v + above);
  above += total;
  return p;
}

// K1's off-chip march of one stage (see the head of this file), X to Y:
// pHY', the tendencies, the RK update and the divergence, strip by strip,
// each strip chunk by chunk of 32 levels from the top (lane l the level k0
// + l), each chunk column by column; every tap from the warp's ring of
// columns in shared memory. Not inlined, so that its registers are its own
// and not the stage's.
__device__ __noinline__ void g_march(State2D X, State2D Y, State2D G, float* s1,
                                     const float* bot, K1Params P, int stage, int xw,
                                     int nstrips) {
  extern __shared__ float smem[];
  const int nx = P.nx, nz = P.nz, nw = nz + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // after the products' ring: this warp's carries and its ring of columns
  double* above = reinterpret_cast<double*>(smem + 2 * kGStage + warp * (kGCarry + kGCols));
  float* carry = reinterpret_cast<float*>(above + kGStrip + 1);  // zu, zb, w* of each column
  float* cols = smem + 2 * kGStage + warp * (kGCarry + kGCols) + kGCarry;
  const float gamma = kGamma[stage], zeta = kZeta[stage], idts = P.idts[stage];
  auto rk = [&](float f, float g, float g_prev) {
    return stage == 0 ? f + P.dt * (gamma * g) : f + P.dt * (gamma * g + zeta * g_prev);
  };
  auto wrap = [&](int i) { return i < 0 ? i + nx : (i >= nx ? i - nx : i); };
  // position p of field f (0 u, 1 w, 2 b) of column c in the ring:
  // level k0 - 3 + p clamped into the column (so a tap at offset o
  // from lane l's level is position l + 3 + o, clamped as the z ladder
  // clamps it); slot c & 7 (c > -8)
  auto at = [&](int c, int f, int p) -> const float& {
    return cols[(((c + 8) & 7) * 3 + f) * kGColLevels + p];
  };
  // this lane's values of column c (wrapped cw) for the ring: its
  // level and, lanes < 8, positions 0..2 and 35..39
  struct ColumnValues {
    float main[3], halo[3];
  };
  auto load_column = [&](int cw, int k0) {
    ColumnValues v;
    const int p = lane < 3 ? lane : lane + 32;
    const float* src[3] = {X.u + cw * nz, X.w + cw * nw, X.b + cw * nz};
    const int len[3] = {nz, nw, nz};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      v.main[f] = src[f][min(k0 + lane, len[f] - 1)];
      v.halo[f] = lane < 8 ? src[f][min(max(k0 - 3 + p, 0), len[f] - 1)] : 0.0f;
    }
    return v;
  };
  auto store_column = [&](int c, const ColumnValues& v) {
    float* s = cols + ((c + 8) & 7) * 3 * kGColLevels;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      s[f * kGColLevels + lane + 3] = v.main[f];
      if (lane < 8) s[f * kGColLevels + (lane < 3 ? lane : lane + 32)] = v.halo[f];
    }
  };
  const int p0 = lane + 3;  // this lane's level's position
  // x fluxes at this lane's level: u at center c (its faces c-2..c+3);
  // w, b at face c (their centers c-3..c+2)
  auto xflux_u = [&](int c) {
    const float a = at(c, 0, p0), b = at(c + 1, 0, p0);
    return ub5_upwind(at(c - 2, 0, p0), at(c - 1, 0, p0), a, b, at(c + 2, 0, p0),
                      at(c + 3, 0, p0), 0.5f * (a + b));
  };
  auto xflux_face = [&](int f, int c, float vel) {
    return ub5_upwind(at(c - 3, f, p0), at(c - 2, f, p0), at(c - 1, f, p0), at(c, f, p0),
                      at(c + 1, f, p0), at(c + 2, f, p0), vel);
  };
  auto xflux_w = [&](int c) {
    return xflux_face(1, c, 0.5f * (at(c, 0, p0 - 1) + at(c, 0, p0)));
  };
  auto xflux_b = [&](int c) { return xflux_face(2, c, at(c, 0, p0)); };
  // the z flux of w through center k0 - 3 + q of column c (taps at q - 2 .. q + 3)
  auto zflux_w = [&](int c, int q, int kl) {
    const float w0 = at(c, 1, q), w1 = at(c, 1, q + 1);
    return z_upwind(at(c, 1, q - 2), at(c, 1, q - 1), w0, w1, at(c, 1, q + 2),
                    at(c, 1, q + 3), z_orders(kl + 1, nw), 0.5f * (w0 + w1));
  };
  for (int s = warp; s < nstrips; s += kK1Warps) {
    const int xa = s * xw, n = min(xw, nx - xa);
    for (int j = lane; j <= n; j += 32) above[j] = 0.0;
    for (int k0 = (nz - 1) / 32 * 32; k0 >= 0; k0 -= 32) {
      const int kk = k0 + lane;
      const ZOrders oc = z_orders(kk, nz);
      // the ring: columns xa - 3 .. xa + 3 (for step j, i - 3 .. i + 3)
      __syncwarp();  // the last chunk's ring read by every lane
      for (int c = xa - 3; c <= xa + 3; ++c) store_column(c, load_column(wrap(c), k0));
      __syncwarp();
      double ab = above[0];
      __syncwarp();
      float pm = phy_at(at(xa - 1, 2, p0), at(xa - 1, 2, p0 + 1), kk, nz, lane, P,
                        ab);  // pHY' at i - 1
      if (lane == 0) above[0] = ab;
      float fu = xflux_u(xa - 1), fw = xflux_w(xa), fb = xflux_b(xa);
      float us_prev = 0.0f, ws_prev = 0.0f, wtop_prev = 0.0f;  // column i - 1's
      for (int j = 0; j < n; ++j) {
        const int i = xa + j;
        // column i + 4 for step j + 1, loaded while this step runs
        const bool ahead = j + 1 < n;
        ColumnValues next;
        if (ahead) next = load_column(wrap(i + 4), k0);
        // the chunk above's: pHY''s sum, the z fluxes of u and b through
        // face k0 + 32 and w* there
        ab = above[j + 1];
        const float zu_top = carry[3 * j], zb_top = carry[3 * j + 1];
        const float ws_top = carry[3 * j + 2];
        __syncwarp();
        const float phy = phy_at(at(i, 2, p0), at(i, 2, p0 + 1), kk, nz, lane, P, ab);
        // z fluxes through face k of u (velocity w at the x-face) and b,
        // and through center k of w; each once, the neighbours' by shuffle
        const float zu = z_upwind(at(i, 0, p0 - 3), at(i, 0, p0 - 2), at(i, 0, p0 - 1),
                                  at(i, 0, p0), at(i, 0, p0 + 1), at(i, 0, p0 + 2), oc,
                                  0.5f * (at(i - 1, 1, p0) + at(i, 1, p0)));
        const float zb = z_upwind(at(i, 2, p0 - 3), at(i, 2, p0 - 2), at(i, 2, p0 - 1),
                                  at(i, 2, p0), at(i, 2, p0 + 1), at(i, 2, p0 + 2), oc,
                                  at(i, 1, p0));
        const float zw = zflux_w(i, p0, kk);
        const float ru = __shfl_sync(kFull, zu, (lane + 1) & 31);
        const float rb = __shfl_sync(kFull, zb, (lane + 1) & 31);
        const float rw = __shfl_sync(kFull, zw, (lane + 31) & 31);
        const float zu_up = kk + 1 >= nz ? 0.0f : (lane == 31 ? zu_top : ru);
        const float zb_up = kk + 1 >= nz ? 0.0f : (lane == 31 ? zb_top : rb);
        float zw_dn = rw;  // lane 0: the chunk below's top, its own (face 0: unused)
        if (lane == 0) zw_dn = k0 > 0 ? zflux_w(i, 2, k0 - 1) : 0.0f;
        float us, ws, bs, gu, gw, gb;
        // ---- gu and u* at (face i, center k) ----
        {
          const float f_new = xflux_u(i);
          float adv = (f_new - fu) * P.idx;
          fu = f_new;
          adv += (zu_up - zu) * P.idz;
          const float dphy = (phy - pm) * P.idx;
          const float q = at(i, 0, p0);
          const float qm = kk > 0 ? at(i, 0, p0 - 1) : -q;
          const float qp = kk < nz - 1 ? at(i, 0, p0 + 1) : -q;
          const float lap = (at(i + 1, 0, p0) - 2.0f * q + at(i - 1, 0, p0)) * P.idx2 +
                            (qp - 2.0f * q + qm) * P.idz2;
          gu = -adv - dphy + P.nu * lap;
          us = rk(q, gu, stage > 0 && kk < nz ? G.u[i * nz + kk] : 0.0f);
        }
        // ---- gw and w* at (center i, face k); face 0 is a wall ----
        {
          const float f_new = xflux_w(i + 1);
          float adv = (f_new - fw) * P.idx;
          fw = f_new;
          adv += (zw - zw_dn) * P.idz;
          const float q = at(i, 1, p0);
          const float lap = (at(i + 1, 1, p0) - 2.0f * q + at(i - 1, 1, p0)) * P.idx2 +
                            (at(i, 1, p0 + 1) - 2.0f * q + at(i, 1, p0 - 1)) * P.idz2;
          gw = kk == 0 ? 0.0f : -adv + P.nu * lap;
          ws = rk(q, gw, stage > 0 && kk < nz ? G.w[i * nw + kk] : 0.0f);
        }
        // ---- gb and b' at (center i, center k) ----
        {
          const float f_new = xflux_b(i + 1);
          float adv = (f_new - fb) * P.idx;
          fb = f_new;
          adv += (zb_up - zb) * P.idz;
          const float q = at(i, 2, p0);
          const float qm = kk > 0 ? at(i, 2, p0 - 1) : 2.0f * bot[i] - q;
          const float qp = kk < nz - 1 ? at(i, 2, p0 + 1) : 2.0f * P.min_b - q;
          const float lap = (at(i + 1, 2, p0) - 2.0f * q + at(i - 1, 2, p0)) * P.idx2 +
                            (qp - 2.0f * q + qm) * P.idz2;
          gb = -adv + P.kappa * lap;
          bs = rk(q, gb, stage > 0 && kk < nz ? G.b[i * nz + kk] : 0.0f);
        }
        pm = phy;
        if (kk < nz) {
          Y.u[i * nz + kk] = us;
          Y.w[i * nw + kk] = ws;
          Y.b[i * nz + kk] = bs;
          G.u[i * nz + kk] = gu;
          G.w[i * nw + kk] = gw;
          G.b[i * nz + kk] = gb;
        }
        // ---- div(u*, w*) / dt_stage of column i - 1 (its u*[i] is here) ----
        const float rs = __shfl_sync(kFull, ws_prev, (lane + 1) & 31);
        if (j > 0 && kk < nz) {
          const int im = wrap(i - 1);
          const float wup = kk + 1 < nz ? (lane == 31 ? wtop_prev : rs) : Y.w[im * nw + nz];
          s1[im * nz + kk] = ((us - us_prev) * P.idx + (wup - ws_prev) * P.idz) * idts;
        }
        us_prev = us, ws_prev = ws, wtop_prev = ws_top;
        // for the chunk below
        if (lane == 0) {
          above[j + 1] = ab;
          carry[3 * j] = zu, carry[3 * j + 1] = zb, carry[3 * j + 2] = ws;
        }
        // column i + 4 into the slot of i - 4, which no step reads again
        if (ahead) store_column(i + 4, next);
        __syncwarp();
      }
    }
  }
}

// K1's off-chip instance (see the head of this file), for the grids the
// on-chip one and the cluster cannot hold; kGlobalSlabs: its two slabs in
// per-env global scratch, where they and the ring do not fit a block.
template <int kPasses = 0, bool kGlobalSlabs = false>
__global__ void __launch_bounds__(kK1Threads, 1)
env_step_2d_global_kernel(const float* __restrict__ u_in, const float* __restrict__ w_in,
                          const float* __restrict__ b_in, const float* __restrict__ bottom_in,
                          const float* __restrict__ fmat, const float* __restrict__ gmat,
                          const float* __restrict__ dct, const float* __restrict__ idct,
                          const float* __restrict__ dinv, float* u_all, float* w_all,
                          float* b_all, float* p_all, float* scratch, K1Params P) {
  extern __shared__ float smem[];
  const int nx = P.nx, nz = P.nz, nw = nz + 1;
  const int nc = nx * nz, nf = nx * nw;
  const size_t e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s0 = scratch + e * off_chip_scratch_floats(nx, nz, kGlobalSlabs);
  // the state's two copies: the output tensors and one in scratch, with the
  // tendencies after it and then (kGlobalSlabs) the slabs
  const State2D out{u_all + e * nc, w_all + e * nf, b_all + e * nc};
  const State2D cpy{s0, s0 + nc, s0 + nc + nf};
  const State2D G{cpy.b + nc, cpy.b + nc + nc, cpy.b + nc + nc + nf};  // gu, gw, gb
  float* s1 = kGlobalSlabs ? G.b + nc : smem + kGSmemFloats;  // the divergence, then R~
  float* s2 = s1 + nc;                                         // r_hat, then p_hat
  float* p = p_all + e * nc;
  const float* bot = bottom_in + e * nx;
  const bool sh = !kGlobalSlabs;

  // w's top wall face, which the stages never write, in both copies
  for (int i = threadIdx.x; i < nx; i += kK1Threads)
    out.w[i * nw + nz] = cpy.w[i * nw + nz] = w_in[e * nf + i * nw + nz];
  __syncthreads();

  auto wrap = [&](int i) { return i < 0 ? i + nx : (i >= nx ? i - nx : i); };
  // the march's strips: xw columns each (at most kGStrip), so that at most
  // one strip a warp is short of a full block's share
  const int xw = min(kGStrip, (nx + kK1Warps - 1) / kK1Warps);
  const int nstrips = (nx + xw - 1) / xw;
  const int stages = 3 * P.n_substeps;
  for (int step = 0, t = 0; step < P.n_substeps; ++step) {
    for (int stage = 0; stage < 3; ++stage, ++t) {
      const float dts = P.dts[stage], idts = P.idts[stage];
      // this stage reads X and writes Y: the copies alternate so that the
      // last stage writes the outputs; the first reads the inputs
      const State2D Y = (stages - 1 - t) % 2 == 0 ? out : cpy;
      const State2D Z = (stages - 1 - t) % 2 == 0 ? cpy : out;
      const State2D X = t == 0 ? State2D{const_cast<float*>(u_in) + e * nc,
                                         const_cast<float*>(w_in) + e * nf,
                                         const_cast<float*>(b_in) + e * nc}
                               : Z;

      // ---- 1. the march: pHY', the tendencies, the RK update and the divergence
      g_march(X, Y, G, s1, bot, P, stage, xw, nstrips);
      __syncthreads();
      // ---- 2. the divergence of each strip's last column (its u*[i + 1] the
      // next strip's warp wrote) ----
      for (int s = warp; s < nstrips; s += kK1Warps) {
        const int i = min(s * xw + xw, nx) - 1, ip = wrap(i + 1);
        for (int k = lane; k < nz; k += 32) {
          const float div = (Y.u[ip * nz + k] - Y.u[i * nz + k]) * P.idx +
                            (Y.w[i * nw + k + 1] - Y.w[i * nw + k]) * P.idz;
          s1[i * nz + k] = div * idts;
        }
      }
      __syncthreads();

      // ---- 3. the solve: four tiled products, slab to slab ----
      auto product = [&](const GOperand& a, const GOperand& b, int k, float* c, const float* d) {
        if (kPasses == 0 && nz > 64) {
          g_product<0, true>(a, b, nx, nz, k, c, nz, d);
        } else {
          g_product<kPasses, false>(a, b, nx, nz, k, c, nz, d);
        }
      };
      const GOperand rhs = g_operand(s1, nz, sh), rt = g_operand(s2, nz, sh);
      product(g_operand(fmat, nx, false), rhs, nx, s2, nullptr);  // r_hat = F . rhs
      product(rt, g_operand(dct, nz, false), nz, s1, dinv);       // (r_hat C^T) * d
      product(rhs, g_operand(idct, nz, false), nz, s2, nullptr);  // p_hat = R~ S^T
      product(g_operand(gmat, nx, false), rt, nx, p, nullptr);    // p = G . p_hat

      // ---- 4. correct u*, w* by grad p, a warp a column ----
      for (int i = warp; i < nx; i += kK1Warps) {
        const int im = wrap(i - 1);
        for (int k = lane; k < nz; k += 32) {
          const float pc = p[i * nz + k];
          Y.u[i * nz + k] -= dts * ((pc - p[im * nz + k]) * P.idx);
          if (k > 0) Y.w[i * nw + k] -= dts * ((pc - p[i * nz + k - 1]) * P.idz);
        }
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

// acc += L . R over a cluster K1 thread's tile (L's rows ldl floats apart):
// tile_product_acc, or in a runtime-size bucket bucket_product.
template <bool kBucket, int XS, int NS, bool kVec>
__device__ __forceinline__ void k1_tile_acc(const float* L, int ldl, const float* R, int K,
                                            int ldr, int row0, int nrow, int lane, bool vec,
                                            float (&acc)[XS][NS]) {
  if constexpr (kBucket) {
    bucket_product<XS, NS>(L, ldl, R, K, ldr, ldr, row0, nrow, lane, vec, acc);
  } else {
    tile_product_acc<XS, NS, kVec>(L, ldl, R, K, ldr, row0, nrow, lane, acc);
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
  // NXL < 0: a runtime-size bucket (k1_bucket) of at most -NXL columns a
  // warp and -NZ levels a lane
  constexpr bool kBucket = NXL < 0;
  constexpr int NS = kBucket ? -NZ : kK1Levels;
  constexpr int XS = kBucket ? -NXL : (NXL > 0 ? k1_cols(NXL) : kK1MaxCols);
  constexpr bool kVec = NXL > 0 && NXL % 4 == 0 && NZ % 4 == 0;
  // the solve on wgmma (dct: its packed constants, k1_tf32_constants)
  constexpr bool kWg = NXL > 0 && k1_cluster_wgmma(NXL, NZ, kPasses);
  constexpr bool kRingInDead = kWg && k1_wg_ring_in_dead(NXL, kPasses);
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
  // a bucket's products read L four values at a time where nxl and nz allow
  const bool vec = kBucket && (nxl & 3) == 0 && (nz & 3) == 0;

  State2D X{cta, cta + nc, cta + nc + nf};
  State2D Y{X.b + nc, X.b + nc + nc, X.b + nc + nc + nf};
  float* sa = Y.b + nc;       // the halo, then the divergence, then p
  float* sb = sa + nc;        // pHY', then r_hat, then p_hat
  float* ct = sb + nc;        // z analysis, (z, j)
  float* st = ct + nz * nz;   // z synthesis, (j, z)
  float* bot = kWg ? sb + nc : st + nz * nz;  // bottom (nxl); no z transforms on wgmma
  // the wgmma instances' own region (their ring, or r_hat's and t's), their
  // mbarriers and their ring (K1WgRing), this warpgroup's; its first copies
  // of a stage go where the ring allows (ablate_k1c drops the lines that call
  // stage_fg)
  float* own = bot + nxl;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(own + k1_wg_own_floats(NXL, NZ, kPasses));
  using Wg = K1WgRing<kWg ? NXL : 64, kWg ? NZ : 64, kWg ? kPasses : 1>;
  const float* tf32 = dct;
  const int nch = nx / Wg::KC;
  Wg ring{nullptr, mbar + 2 * (threadIdx.x >> 7), tf32 + (r * nch * 4 + (threadIdx.x >> 7)) * Wg::S,
          k1_tf32_g(nx, kPasses), nch, 0u};
  auto stage_fg = [&] { ring.start(); };
  // with fg_rows (env_step_2d_cluster_fg) this CTA's rows of F, then of G
  // (nxl x nx each), which the float32 products read here
  // (never where the CTA's slab is compile-time and F and G's rows cannot
  // fit beside it even at c = 2, as at 96 x 64: that code is left out)
  constexpr bool kMayHoldFG =
      kBucket || NXL == 0 ||
      sizeof(float) * (on_chip_smem_floats(NXL, NZ) + 4 * (size_t)NXL * NXL) <= kSmemPerBlock;
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
    if constexpr (!kWg) {
      for (int q = threadIdx.x; q < nz * nz; q += kK1Threads) {
        ct[q] = dct[q];
        st[q] = idct[q];
      }
    } else if (threadIdx.x == 0) {
      for (int i = 0; i < kWgBars; ++i) mbar_init(mbar + i, 1);
      fence_mbar_init();
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
      if constexpr (kWg) {  // the ring in D, or its own
        ring.slots = (kRingInDead ? D : own) + (threadIdx.x >> 7) * 2 * Wg::S;
        if constexpr (!kRingInDead) stage_fg();  // its first chunks while the march runs
      }

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
            if constexpr (kBucket) {  // this column's bases, computed here (opaque)
              const int ln = opaque(lane);
#pragma unroll
              for (int s = 0; s < NS; ++s) {
                kl[s] = ln + 32 * s;
                kc[s] = min(kl[s], nz - 1);
              }
            }
            const int i = (kBucket ? opaque(x0) : x0) + xi, im = i - 1, ip = i + 1;
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
      if constexpr (kRingInDead) stage_fg();  // F's first chunks into D

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
              sa[kWg ? k1_afrag_index(k, i, NZ / 16) : i * nz + k] = div * idts;  // wgmma: rhs^T
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
          k1_tile_acc<kBucket, XS, NS, kVec>(Lr + x_off, nx, slab, nxl, nz, x0, nxl, lane, vec,
                                             pt);
          for (int q0 = 1; q0 < c; q0 += kK1StagedSlabs) {
            const int nq = min(kK1StagedSlabs, c - q0);
            if (q0 > 1) __syncthreads();
            stage_slabs(D, slab, q0, nq);
            __syncthreads();
            for (int j = 0; j < nq; ++j) {
              const int q = (r + q0 + j) % c;
              k1_tile_acc<kBucket, XS, NS, kVec>(Lr + q * nxl, nx, D + j * nc, nxl, nz, x0,
                                                 nxl, lane, vec, pt);
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
        k1_tile_acc<kBucket, XS, NS, kVec>(sb, nz, ct, nz, nz, x0, nxl, lane, vec,
                                           pt);  // r_hat C^T
#pragma unroll
        for (int xi = 0; xi < XS; ++xi)
#pragma unroll
          for (int s = 0; s < NS; ++s)
            pt[xi][s] *= __ldg(dinv + (x_off + min(x0 + xi, nxl - 1)) * nz + kc[s]);
        store(D);
        __syncthreads();
        clear();
        k1_tile_acc<kBucket, XS, NS, kVec>(D, nz, st, nz, nz, x0, nxl, lane, vec,
                                           pt);  // p_hat = R~ S^T
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
      } else if constexpr (kWg) {
        // a source CTA's slab: this CTA's own, or a neighbour's through
        // distributed shared memory
        auto from = [&](float* slab) {
          return [=](int q) {
            return q == r ? (const float*)slab : (const float*)cluster_map(slab, q);
          };
        };
        // ---- 4. the solve on the tensor cores: the x products over the cluster's slabs
        float* rt = Wg::kRtInRing ? ring.slots
                                  : (kRingInDead ? own : D) + (threadIdx.x >> 7) * Wg::H * Wg::NW * NZ;
        k1_wg_products_123<NXL, NZ, kPasses>(ring, sb, rt, tf32, r, c, from(sa));
        cluster_barrier();  // (4) every CTA's p_hat
        k1_wg_product_4<NXL, NZ, kPasses>(ring, sa, r, c, from(sb));
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
              const float pm = i > 0 ? sa[(i - 1) * nz + k] : p_left[k];
              Y.u[i * nz + k] -= dts * ((p - pm) * P.idx);
              if (k > 0) Y.w[i * nw + k] -= dts * ((p - sa[i * nz + k - 1]) * P.idz);
              if (last) p_out[e * nx * nz + (size_t)(x_off + i) * nz + k] = p;
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

// The cluster K1 instance for a grid's slab and a pass count: specialised
// for 64 and 96 columns of 64 levels a CTA (128x64 and 256x64; 192x64), at
// TF32 on wgmma, for every other slab its bucket (k1_bucket: 8 columns a
// warp of one level a lane where nz <= 32 in float32, else of two, at
// stride nz).
decltype(&env_step_2d_cluster_kernel<0, 0>) env_step_cluster_kernel_for(int nxl, int nz,
                                                                          int passes) {
  if (passes > 0 && k1_cluster_wgmma(nxl, nz, passes)) {
    if (nxl == 64) {
      return passes == 3 ? env_step_2d_cluster_kernel<64, 64, 3>
                         : env_step_2d_cluster_kernel<64, 64, 1>;
    }
    return passes == 3 ? env_step_2d_cluster_kernel<96, 64, 3>
                       : env_step_2d_cluster_kernel<96, 64, 1>;
  }
  if (passes == 3) return env_step_2d_cluster_kernel<-8, -2, 3>;
  if (passes == 1) return env_step_2d_cluster_kernel<-8, -2, 1>;
  if (nz == 64 && nxl == 64) return env_step_2d_cluster_kernel<64, 64>;
  if (nz == 64 && nxl == 96) return env_step_2d_cluster_kernel<96, 64>;
  return k1_bucket(nxl, nz, 0, true).levels == 1 ? env_step_2d_cluster_kernel<-8, -1>
                                                 : env_step_2d_cluster_kernel<-8, -2>;
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
  const bool wgmma = env_step_2d_wgmma(nx, nz, passes);
  const size_t smem = env_step_2d_launch_smem_bytes(nx, nz, passes);
  if (nx < kK1MinNx || nz < 1 || !env_step_2d_offsets_fit(nx, nz) || smem > kSmemPerBlock ||
      n_substeps < 1 || (!on_chip && csize == 0 && scratch == nullptr) ||
      (passes != 0 && passes != 1 && passes != 3) ||
      (env_step_2d_packed(nx, nz, passes) && tf32 == nullptr)) {
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
    // the wgmma instances take their packed constants in dct's place
    err = cudaLaunchKernelEx(&config, kernel, u, w, b, bottom, fmat, gmat, wgmma ? tf32 : dct, idct,
                             dinv, u_out, w_out, b_out, p_out, P,
                             (int)env_step_2d_cluster_fg(nx, nz));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (!on_chip) {
    auto* global = env_step_global_kernel_for(passes, env_step_2d_slabs_on_chip(nx, nz));
    cudaError_t err =
        cudaFuncSetAttribute(global, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    global<<<n_env, kK1Threads, smem, (cudaStream_t)stream>>>(
        u, w, b, bottom, fmat, gmat, dct, idct, dinv, u_out, w_out, b_out, p_out, scratch, P);
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
  const size_t smem = env_step_2d_launch_smem_bytes(nx, nz, passes);
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
