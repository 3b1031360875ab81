// Hopper kernels of the 3D RBC env step, bound through a plain C ABI.
//
// K3 stage_march_kernel<NZ, NY >= 0> replaces rbc_gym_tpu/ops/pallas3d.py:_stage_rk_kernel
// (reached from make_stage_rk_3d, pl.pallas_call at :1190): one RK3 stage of
// the lazy-projection loop. It corrects the previous stage's unprojected
// u, v, w by grad q (q: the Poisson solve of their unscaled divergence),
// computes pHY' from b, the four UB5 tendencies gu, gv, gw, gb, the RK update
// f* = f + dt (gamma g + zeta g_prev) and div(u*, v*, w*) for the next solve.
// Stage 0 reads no g_prev; stage 2 writes no g.
//   Bound: bytes. Per env and stage it reads u, v, w, b, q, bottom (and
//   g_prev at stages 1-2) and writes u*, v*, w*, b', div (and g at stages
//   0-1): about 1.2 MB at 16x32x32, against some 380 FLOP per cell.
//   The TPU kernel's batch-minor (x, z, y, E) layout fills 128 lanes with
//   envs and has no counterpart here: the fields stay in the public
//   batch-major (E, nx, ny, nz[+1]) layout, and div and q are in the solve
//   layout (E, ny, nx, nz) of ops/poisson.make_poisson_solver_3d.
//   What held its first design (x blocks of 4 columns staged whole with
//   their halos; 4.15-4.52 ms at 1024 envs on 16x32x32 on an H100 80GB HBM3
//   at 700 W, 6-8 % of the bound) were K5's first design's causes: runtime
//   integer division in every index, IEEE division, every face flux
//   computed twice, a divergent z ladder (at nz = 16 a warp holds two
//   columns), x halos staged 2.65 times over in a phase of their own, and a
//   serial pHY' phase. This design takes 0.72-0.81 ms there, 37-45 % of the
//   bound (PERF.md, section 6).
//   Design: K5's x march (below; one template, stage_march_kernel<NZ, NY>
//   with NY >= 0), with one block per env that holds all of its periodic y,
//   the Pallas kernel's own tiling: one thread per (y row, z) point of an
//   x-plane, 512 at 16x32x32. So there are no y halos (rows wrap in the
//   ring), no row that only computes v*, and each y-face flux is computed
//   once: each thread computes the y fluxes of plane i + 1 at its own face
//   (center for v) into shared memory, two planes by parity, and reads its
//   neighbour's after the plane's barrier. pHY' is a float64 suffix scan
//   across the 16 lanes of a column (each column's k = 0 thread sums it in
//   the runtime instance). The training grid's sizes are template
//   parameters; a runtime instance takes ny * nz <= 1024. Shared memory,
//   in floats: ny (48 nz + 9), 99,456 bytes at 16x32x32, where two
//   512-thread blocks share an SM (64 registers; one block an SM at 128
//   registers was slower, PERF.md, section 6). The grid's rule: nx >= 4,
//   ny >= 4, nz >= 2, ny * nz <= 1024 and that formula under the limit.
//
// K3's analysis instance, stage_march_kernel<NZ, NY >= 0, kStage, true>,
// replaces the same Pallas body with emit_rhat (pallas3d.py:853-882; the
// fused="stage_qp" path): the stage writes rhat = T_A div (E, ny, nx nz),
// T_A = kron(Fx, Cz) of ops/poisson.py, in place of div, and the solve's
// tail (y-DFT, modal reciprocal, inverse y-DFT, synthesis) runs after it.
//   Bound: bytes, as K3 (rhat has div's size); the analysis adds 2 (nx + nz)
//   FLOP a cell at its least, 96 at 16x32x32, against K3's ~380.
//   Design: the analysis in its two factors, not the dense T_A column block
//   of the Pallas dot (512 multiply-adds a point there), the z-factor in the
//   march and the x-factor after it. Where K3 writes div of plane i - 1,
//   each thread puts it into shared memory; after the plane's barrier the
//   thread at (y = j, kz = k) sums t = sum_z Cz[k, z] div[j, z] over its
//   column (nz multiply-adds from shared memory: the column's values are
//   broadcasts, Cz^T's row conflict-free) and stores t at rhat's own
//   address for (j, x = i - 1, k): K3's div store, at the same place and of
//   the same size. After the last plane each thread reads its own nx values
//   of t back (its own stores: program order suffices, no barrier) and
//   writes rhat[kx, j, k] = sum_x Fx[kx, x] t(x) over them (rhat_x_factor:
//   at nx = 32 in registers, one accumulator a kx, Fx as float4 through the
//   read-only cache; other nx stage t in the dead rings, threads taking
//   turns). The order of operations is the first design's (Cz over z, then
//   Fx in increasing x from Fx[kx, 0] t(0), fmaf), so rhat is its bits.
//   What held that first design (1.02-1.10 ms a stage at 1024 envs on
//   16x32x32, 27-34 % of the bound, against K3's 0.72-0.81; H100 80GB HBM3
//   at 700 W): a shared rhat accumulator [kx][y][kz], nx ny nz floats,
//   172,160 bytes a block, so one 512-thread block an SM (120 registers)
//   where K3 runs two, nx shared reads and writes a thread a plane into it,
//   and 16x32x64 refused. Shared memory, in floats: K3's, then ny nz + nz^2
//   (one plane of div, Cz^T), and at least nx: 102,528 bytes at 16x32x32,
//   two 512-thread blocks an SM with K3's launch bounds (64 registers). The
//   grid's rule: K3's, with this formula under the limit. The t round trip
//   (div's size once more each way) is L2 traffic. This design takes
//   0.83-0.93 ms a stage there, 32-39 % of the bound, ~0.125 ms over K3;
//   the z-factor by width-16 shuffles, the div row as float4, Fx in the
//   dead rings or in constant memory, and 2 or 4 accumulators at a time
//   were no faster (PERF.md, section 6). The Pallas kernel's
//   x-block accumulation across grid steps has no counterpart: one block
//   marches all of its env's x-planes. The analysis is float32 whatever
//   poisson_precision is, as the Pallas dot is at HIGHEST.
//
// K5 stage_march_kernel<NZ, -1> replaces ops/pallas3d.py:_stage_rk_kernel_xy
// (reached from make_stage_rk_3d_xy, pl.pallas_call at :1592): K3's stage,
// with K3's contract and layouts, for grids outside the path rule's whole-y
// boundary (the 32x64x64 big grid: 2048 points an x-plane).
//   Bound: bytes. At 32x64x64 it moves 7.4 MB per env at stages 0 and 2 and
//   9.5 MB at stage 1, against some 400 FLOP per cell. What held its first
//   design (4 x 8 columns a block; 48.7-51.6 ms at 1024 envs on an H100
//   80GB HBM3 at 700 W) to 5 % of that: runtime integer division in every
//   index, IEEE division in every difference, every face flux computed
//   twice, a divergent z ladder, halos staged 4.85 times over in a phase of
//   their own, and a serial pHY'. This design takes 7.5-7.8 ms there, 29-37
//   % of the bound (PERF.md, section 6).
//   Design: one block per (env, kYT = 8 y rows) that marches along periodic
//   x, one thread per (row, z) point of an x-plane (rows 0..kYT, so at
//   nz = 32 a warp is one column and lane == k). Shared memory holds a ring
//   of kRing = 8 x-planes of u, v, w, b with their y halos, two of q, four
//   of pHY', and v*, w* of one plane. Per plane i:
//   - plane i + 4 is copied in with cp.async while plane i is computed, so
//     each field's plane is read from global memory once per block; the y
//     halos are the only repeat (1.75-2 times the rows a block owns, against
//     4.85 times the cells in the first design), and no phase waits on them;
//   - it is corrected by grad q once, as it arrives (u needs q one plane
//     back, kept in the second q slot);
//   - each thread computes gu, gv, gw, gb and the RK update at its point,
//     with its g_prev loaded before the arithmetic; the x flux of each field
//     enters at one face and is carried in a register to the next plane, so
//     each x-face flux is computed once;
//   - z fluxes select the ladder's UB5, UB3 or UB1 per lane from orders
//     fixed per thread before the march, with taps clamped into the column:
//     every lane runs one instruction stream; at nz = 32 and 16 a column's
//     lanes are consecutive, so each z-face flux is computed once and
//     handed to the neighbouring lane by a warp shuffle;
//   - row kYT, which only computes v* (for the divergence at the far y
//     face), meanwhile sums pHY' of plane i + 2 down each column in
//     float64, one thread a column: no serial phase holds the block, and
//     each value rounds once;
//   - the divergence of plane i - 1 is emitted once u*(i) is known, from
//     v*, w* of plane i - 1 kept in shared memory and u* in a register.
//   nz is a template parameter for 32 and 16 (no runtime / or % in the
//   loop; a runtime-nz instance takes every other nz). The spacings enter
//   as reciprocals taken in double on the host. Shared memory, in floats:
//   (8 * (14 + 15 + 14) + 2 * 16 + 4 * 10 + 9) nz + (8 * 14 + 8) (nz + 1),
//   that is 545 nz + 120: 70,240 bytes at nz = 32, where three 288-thread
//   blocks share an SM (72 registers). The grid's rule: nx >= 4, ny % 8 ==
//   0, nz >= 2 and that formula under the limit (nz <= 106). Each y-face
//   flux is still computed by both of its cells (its rows are in other
//   warps). There is no matrix product, so no wgmma or tensor cores. The
//   Pallas kernel's _YH = 8 (the TPU's sublane tiling), e_blk and XLA-side
//   padding have no counterpart.
//   K5's z split, stage_march_kernel<0, -1, kStage, false, true>, takes the
//   columns one CTA cannot hold (nz >= 107: the rings above 232,448 bytes,
//   and past nz = 113 the (kYT + 1) nz threads above 1024), which the
//   Pallas kernel takes with no nz limit. Each block of the grid above
//   becomes a thread-block cluster of c = 2, 4 or 8 CTAs
//   (stage_xy_split_size: the smallest that fits; 2 up to nz = 198, 8 up
//   to 784), launched with cudaLaunchKernelEx and a cluster dimension. CTA
//   r owns the levels [r p, (r + 1) p), p = ceil(nz / c), the last part
//   shorter, and holds kSplitHalo = 4 more on each inner side: the taps
//   reach 3 levels, and the correction of w's lowest held tap face needs q
//   one level further. Each CTA copies its window of every staged plane
//   straight from global memory with the same cp.async ring, so the field
//   halos need no distributed shared memory, and computes K5's point
//   arithmetic unchanged at its own levels (the z ladder and the walls by
//   the column's level, the taps clamped into the column) and w* at its
//   faces [z0, z1]: face z1, whose w* its top divergence needs, is the next
//   CTA's too, computed identically by both and written by its owner. Its
//   rows have p + 1 threads, (kYT + 1) (p + 1) a CTA. The only value that
//   crosses CTAs is pHY', K5's float64 suffix sum down each column: row
//   kYT sums its CTA's levels of plane i + 3 into a partial total in its
//   shared memory (two planes by parity), the plane's one cluster barrier
//   (barrier.cluster arrive.release / wait.acquire, in place of the CTA
//   barrier after the copy) publishes it, and during plane i + 1 the row
//   reads the totals of the CTAs above through distributed shared memory
//   (cluster_map), adds them in float64 and sums down its own levels from
//   there, so each value still rounds once. Shared memory, in floats: 40
//   (the totals) plus K5's formula over the held levels: 148,880 bytes a
//   CTA at nz = 128, 585 threads, one CTA an SM. On the host, with no FMA
//   contraction, the split's outputs are single-CTA K5's bit for bit.
//
// K4 correct_3d_kernel replaces ops/pallas3d.py:_correct_kernel (reached
// from make_projection_glue_3d, pl.pallas_call at :959): u -= ddx q,
// v -= ddy q, w -= ddz q at interior faces, once per env step after the
// last stage of the lazy loop, and after every stage of the per-field path.
// Bound: bytes (u, v, w, q in; u, v, w out). Design: one thread per w
// point, which also does the u and v point of the same cell.
//
// K6 replaces ops/pallas3d.py:_field_stage_kernel (reached from
// make_field_stage_3d, pl.pallas_call at :1694): one field's UB5 tendency g
// (u, v, w or b; four launches a stage) of the per-field path, without the
// RK update, which runs in PyTorch as it runs in XLA there.
//   Bound: bytes. It reads u, v, w and the field's own input (b for u, v
//   and b, and bottom for b) and writes g: about 330 KB per env at
//   16x32x32 against some 90 FLOP per point. The Pallas kernel reads pHY'
//   for u and v because the JAX package computes it in XLA with the rest of
//   its glue (pallas3d.py:460-468); here the u and v instances take b and
//   compute pHY' of the planes they need themselves, as K3 does, so the
//   per-field loop calls no pHY' between its launches.
//   What held its first design (one thread per output point, taps straight
//   from global memory; 0.59-0.70 ms a launch at 1024 envs on 16x32x32 on
//   an H100 80GB HBM3 at 700 W, 14-17 % of the bound) were K5's first
//   design's causes: 64-bit runtime division in every index, a 64-bit wrap
//   and multiply on every tap, IEEE division in every difference, every
//   face flux computed by both of its cells, no staging, a runtime nz.
//   Design: two instances, picked by the launcher from the grid alone.
//   - The march instance, stage_march_kernel<NZ, NY, field>: K3's x march
//     (one template) with the stage's correction, RK update and divergence
//     compiled out. A block per env holds all of its periodic y, one thread
//     per (y row, z) point of an x-plane; a cp.async ring of x-planes of u,
//     v, w and b (b not for w) reads each plane from global memory once;
//     the field's x flux is carried in a register to the next plane, its z
//     fluxes handed between lanes by shuffles (NZ > 0), its y fluxes
//     computed once into shared memory; pHY' of each plane is K3's float64
//     lane scan of b; the spacings enter as reciprocals. Compile-time sizes
//     for the training grid's 32 rows of 16, a runtime instance for every
//     other grid of K3's whole-y rule (nx >= 4, ny >= 4, nz >= 2, ny * nz
//     <= 1024). Shared memory, in floats: ny (38 nz + 8) for every field
//     (field_smem_floats), 78,848 bytes at 16x32x32. One barrier a plane.
//   - The general instance, field_tendency_3d_kernel, for every other grid
//     the path takes (nx = 3, ny * nz > 1024, the big grid forced): one
//     thread per output point in the public batch-major layout (z fastest),
//     its taps from global memory (L1 and L2 catch the reuse), offsets
//     32-bit within an env, reciprocals from the host; u and v sum pHY' of
//     the two columns they need from b in float64, from k to the top.
//   Both compute the flux form (C6 - |v| D5/60) where the Pallas kernel
//   selects a one-sided UB5 stencil by the sign of the velocity (the march
//   in the select form, ub5_upwind); the forms are one reconstruction and
//   differ in float32 rounding only (pallas3d.py:185-186). The Pallas
//   kernel's env slabs (e_blk lanes) have no counterpart.
//
// K7 div_3d_kernel<NZ> replaces ops/pallas3d.py:_div_kernel (reached from
// make_projection_glue_3d, pl.pallas_call at :947): the staggered
// div(u, v, w) at cell centers, once a stage on the per-field path.
//   Bound: bytes (u, v, w in, div out). What held its first design (one
//   thread per output point; 0.171 ms at 1024 envs on 16x32x32, 47 % of
//   the bound): a 64-bit runtime % and / in every index, three IEEE
//   divisions, u(x + 1) and w(k + 1) loaded again by each thread.
//   Design: a block per (env, y row) writes one contiguous (nx, nz) slab of
//   the solve layout (E, ny, nx, nz) that the Poisson solve reads, as K3
//   and K5 emit theirs, with no shared memory and no barrier: each thread
//   takes four consecutive levels (nz = 16 and 32, template parameters) as
//   float4 loads of u(x), v(y), v(y + 1) and a float4 store, and w as a run
//   of five; u(x + 1) comes by a shuffle from the lane that holds column
//   x + 1 (a load only in a warp's last column and where x wraps). v(y + 1)
//   is the next block's v(y), which L2 catches. Offsets are 32-bit within
//   an env, the spacings reciprocals from the host; other nz (or unaligned
//   tensors) run a one-level-a-thread instance of the same code. A first
//   redesign (tiles of 512 points staged in shared memory between two
//   barriers) took 0.155 ms, 52 % (PERF.md, section 6).
#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "ub5.cuh"

namespace {

constexpr int kThreads = 256;

enum FieldIndex { kFieldU = 0, kFieldV = 1, kFieldW = 2, kFieldB = 3 };

// The march's scalars: reciprocals of the spacings and their squares, taken
// once on the host in double precision, so that no tendency divides.
struct XYParams {
  int nx, ny, nz;
  float idx, idy, idz, idx2, idy2, idz2, dz, nu, kappa, min_b;
};

XYParams xy_params(int nx, int ny, int nz, float dx, float dy, float dz, float nu,
                   float kappa, float min_b) {
  return {nx, ny, nz, (float)(1.0 / dx), (float)(1.0 / dy), (float)(1.0 / dz),
          (float)(1.0 / ((double)dx * dx)), (float)(1.0 / ((double)dy * dy)),
          (float)(1.0 / ((double)dz * dz)), dz, nu, kappa, min_b};
}

// One env's field (nx, ny, nk) in global memory, the public layout (K6's
// general instance): x and y wrap periodically (taps reach 3 points past
// either end, so nx, ny >= 3); offsets within an env are 32-bit.
struct GlobalField {
  const float* p;
  int nx, ny, nk;
  __device__ __forceinline__ const float* col(int x, int y) const {
    return p + (wrap_x(x, nx) * ny + wrap_x(y, ny)) * nk;
  }
  __device__ __forceinline__ float operator()(int x, int y, int k) const {
    return col(x, y)[k];
  }
  __device__ __forceinline__ int yp(int j) const { return wrap_x(j + 1, ny); }
  __device__ __forceinline__ int ym(int j) const { return wrap_x(j - 1, ny); }
  __device__ __forceinline__ float flux_y(int x, int j, int k, int m, float vel) const {
    return uw_flux_periodic(col(x, 0) + k, nk, ny, j, m, vel);
  }
};

// pHY' of one env read as a field, from its b (K6's general instance for u
// and v): the value at (x, y, k) sums its column from the top down to k in
// float64, as hydrostatic_column does, so that it rounds once.
struct HydrostaticField {
  GlobalField b;
  double dz, top;  // top: the half cell under the lid, dz min_b / 2
  __device__ __forceinline__ float operator()(int x, int y, int k) const {
    const float* bc = b.col(x, y);
    double acc = top;
    for (int m = b.nk - 2; m >= k; --m) acc += dz * (0.5 * ((double)bc[m] + (double)bc[m + 1]));
    return (float)-acc;
  }
};

// The tendencies below are templates over K6's slab types.

// vel * UB5 reconstruction along x (non-periodic inside the slab) at
// column i + m, taps i + m + off for off in -3..2.
template <class S>
__device__ __forceinline__ float flux_x(const S& q, int i, int y, int k, int m, float vel) {
  const int c = i + m;
  return c6_d5_flux(q(c - 3, y, k), q(c - 2, y, k), q(c - 1, y, k), q(c, y, k),
                    q(c + 1, y, k), q(c + 2, y, k), vel);
}

template <class S>
__device__ __forceinline__ float lap_h(const S& q, int i, int j, int k, float c,
                                       const XYParams& P) {
  const int jm = q.ym(j), jp = q.yp(j);
  return (q(i + 1, j, k) - 2.0f * c + q(i - 1, j, k)) * P.idx2 +
         (q(i, jp, k) - 2.0f * c + q(i, jm, k)) * P.idy2;
}

// gu at (x-face i, y-center j, z-center k).
template <class S, class H>
__device__ float tendency_u(const S& U, const S& V, const S& W, const H& PH,
                            int i, int j, int k, const XYParams& P) {
  const int nz = P.nz, jp = U.yp(j);
  const float uc_i = 0.5f * (U(i, j, k) + U(i + 1, j, k));
  const float uc_im = 0.5f * (U(i - 1, j, k) + U(i, j, k));
  float adv = (flux_x(U, i, j, k, 1, uc_i) - flux_x(U, i - 1, j, k, 1, uc_im)) * P.idx;
  const float vf_j = 0.5f * (V(i - 1, j, k) + V(i, j, k));
  const float vf_jp = 0.5f * (V(i - 1, jp, k) + V(i, jp, k));
  adv += (U.flux_y(i, j + 1, k, 0, vf_jp) - U.flux_y(i, j, k, 0, vf_j)) * P.idy;
  const float wf_k = 0.5f * (W(i - 1, j, k) + W(i, j, k));
  const float wf_kp = 0.5f * (W(i - 1, j, k + 1) + W(i, j, k + 1));
  const float* uc = U.col(i, j);
  adv += (z_uw_flux(uc, nz, k + 1, 0, wf_kp) - z_uw_flux(uc, nz, k, 0, wf_k)) * P.idz;
  const float dphy = (PH(i, j, k) - PH(i - 1, j, k)) * P.idx;
  const float q = uc[k];
  const float qm = k > 0 ? uc[k - 1] : -uc[0];  // no-slip ghost: 2 * 0 - q0
  const float qp = k < nz - 1 ? uc[k + 1] : -uc[nz - 1];
  const float lap = lap_h(U, i, j, k, q, P) + (qp - 2.0f * q + qm) * P.idz2;
  return -adv - dphy + P.nu * lap;
}

// gv at (x-center i, y-face j, z-center k).
template <class S, class H>
__device__ float tendency_v(const S& U, const S& V, const S& W, const H& PH,
                            int i, int j, int k, const XYParams& P) {
  const int nz = P.nz, jm = V.ym(j), jp = V.yp(j);
  const float uf_i = 0.5f * (U(i, jm, k) + U(i, j, k));
  const float uf_ip = 0.5f * (U(i + 1, jm, k) + U(i + 1, j, k));
  float adv = (flux_x(V, i + 1, j, k, 0, uf_ip) - flux_x(V, i, j, k, 0, uf_i)) * P.idx;
  const float vc_j = 0.5f * (V(i, j, k) + V(i, jp, k));
  const float vc_jm = 0.5f * (V(i, jm, k) + V(i, j, k));
  adv += (V.flux_y(i, j, k, 1, vc_j) - V.flux_y(i, j - 1, k, 1, vc_jm)) * P.idy;
  const float wf_k = 0.5f * (W(i, jm, k) + W(i, j, k));
  const float wf_kp = 0.5f * (W(i, jm, k + 1) + W(i, j, k + 1));
  const float* vc = V.col(i, j);
  adv += (z_uw_flux(vc, nz, k + 1, 0, wf_kp) - z_uw_flux(vc, nz, k, 0, wf_k)) * P.idz;
  const float dphy = (PH(i, j, k) - PH(i, jm, k)) * P.idy;
  const float q = vc[k];
  const float qm = k > 0 ? vc[k - 1] : -vc[0];
  const float qp = k < nz - 1 ? vc[k + 1] : -vc[nz - 1];
  const float lap = lap_h(V, i, j, k, q, P) + (qp - 2.0f * q + qm) * P.idz2;
  return -adv - dphy + P.nu * lap;
}

// gw at (x-center i, y-center j, z-face k); zero on the wall faces.
template <class S>
__device__ float tendency_w(const S& U, const S& V, const S& W, int i, int j,
                            int k, const XYParams& P) {
  const int nz = P.nz, jp = W.yp(j);
  if (k == 0 || k == nz) return 0.0f;
  const float uf_i = 0.5f * (U(i, j, k - 1) + U(i, j, k));
  const float uf_ip = 0.5f * (U(i + 1, j, k - 1) + U(i + 1, j, k));
  float adv = (flux_x(W, i + 1, j, k, 0, uf_ip) - flux_x(W, i, j, k, 0, uf_i)) * P.idx;
  const float vf_j = 0.5f * (V(i, j, k - 1) + V(i, j, k));
  const float vf_jp = 0.5f * (V(i, jp, k - 1) + V(i, jp, k));
  adv += (W.flux_y(i, j + 1, k, 0, vf_jp) - W.flux_y(i, j, k, 0, vf_j)) * P.idy;
  const float* wc = W.col(i, j);
  const float wc_k = 0.5f * (wc[k] + wc[k + 1]);
  const float wc_km = 0.5f * (wc[k - 1] + wc[k]);
  adv += (z_uw_flux(wc, nz + 1, k, 1, wc_k) - z_uw_flux(wc, nz + 1, k - 1, 1, wc_km)) * P.idz;
  const float q = wc[k];
  const float lap = lap_h(W, i, j, k, q, P) + (wc[k + 1] - 2.0f * q + wc[k - 1]) * P.idz2;
  return -adv + P.nu * lap;
}

// gb at (x-center i, y-center j, z-center k); Dirichlet bottom and min_b.
template <class S>
__device__ float tendency_b(const S& U, const S& V, const S& W, const S& B,
                            float bottom, int i, int j, int k, const XYParams& P) {
  const int nz = P.nz, jp = B.yp(j);
  float adv = (flux_x(B, i + 1, j, k, 0, U(i + 1, j, k)) - flux_x(B, i, j, k, 0, U(i, j, k))) * P.idx;
  adv += (B.flux_y(i, j + 1, k, 0, V(i, jp, k)) - B.flux_y(i, j, k, 0, V(i, j, k))) * P.idy;
  const float* bc = B.col(i, j);
  adv += (z_uw_flux(bc, nz, k + 1, 0, W(i, j, k + 1)) - z_uw_flux(bc, nz, k, 0, W(i, j, k))) * P.idz;
  const float q = bc[k];
  const float qm = k > 0 ? bc[k - 1] : 2.0f * bottom - bc[0];
  const float qp = k < nz - 1 ? bc[k + 1] : 2.0f * P.min_b - bc[nz - 1];
  const float lap = lap_h(B, i, j, k, q, P) + (qp - 2.0f * q + qm) * P.idz2;
  return -adv + P.kappa * lap;
}

// ---- K3 and K5: the stage as a march along x ---------------------------------

constexpr int kYT = 8;       // y rows a K5 block owns
constexpr int kRing = 8;     // x-planes of u, v, w, b a block holds
constexpr int kPhRing = 4;   // x-planes of pHY'
constexpr int kMaxThreads = 1024;
// K5: rows of each staged x-plane, relative to the block's first row: the
// first one and how many (the y taps reach 3 rows; v* is computed one row
// wider, at the far y face, for the divergence; v's correction needs q a row
// lower). K3's planes hold every row of periodic y once.
constexpr int kULo = -3, kURows = kYT + 6;
constexpr int kVLo = -3, kVRows = kYT + 7;
constexpr int kWLo = -3, kWRows = kYT + 6;
constexpr int kBLo = -3, kBRows = kYT + 6;
constexpr int kQLo = -4, kQRows = kYT + 8;
constexpr int kPLo = -1, kPRows = kYT + 2;

constexpr int kXYMinNx = 4;                 // plane indices -4..nx+3 wrap once
constexpr size_t kSmemPerBlock = 232448;    // an H100 block's shared memory

// A ring of kSlots x-planes in shared memory, each `rows` rows of nk floats;
// plane x lives in slot x mod kSlots (a power of 2, so negative x works).
// K5's planes hold a y tile and its halos (row r at r - lo); K3's all of
// periodic y (kWrap: row r at r mod rows, lo = 0).
template <int kSlots, bool kWrap = false>
struct Ring {
  float* p;
  int lo, rows, nk;
  __device__ __forceinline__ float* row(int x, int r) const {
    return p + ((x & (kSlots - 1)) * rows + (kWrap ? wrap_x(r, rows) : r - lo)) * nk;
  }
  __device__ __forceinline__ float* end() const { return p + kSlots * rows * nk; }
};

// pHY'[m] = -sum_{m' >= m} inc[m'] of one column, summed from the top in
// float64 (inc[m] = dz (b[m] + b[m + 1]) / 2, the top half cell dz min_b / 2),
// so that each value rounds once.
__device__ __forceinline__ void hydrostatic_column(const float* bc, float* pc, int nz,
                                                   const XYParams& P) {
  const double dz = P.dz;
  double acc = 0.5 * dz * P.min_b;
  pc[nz - 1] = (float)-acc;
  for (int m = nz - 2; m >= 0; --m) {
    acc += dz * (0.5 * ((double)bc[m] + (double)bc[m + 1]));
    pc[m] = (float)-acc;
  }
}

// Shared memory K5 needs per block, in floats: rings of kRing x-planes of u,
// v, b (nz per row) and w (nz + 1), two planes of q, kPhRing of pHY', and
// v*, w* of one plane.
size_t stage_xy_smem_floats(int nz) {
  return (size_t)(kRing * (kURows + kVRows + kBRows) + 2 * kQRows + kPhRing * kPRows +
                  kYT + 1) * nz +
         (size_t)(kRing * kWRows + kYT) * (nz + 1);
}

// Shared memory K3 needs per block, in floats: rings of kRing x-planes of
// u, v, b and w, two of q, kPhRing of pHY', v* and w* of one plane and the
// y fluxes of u, v, w, b of two, each plane all ny rows: ny (48 nz + 9).
__host__ __device__ size_t stage_smem_floats(int ny, int nz) {
  return (size_t)ny *
         ((kRing * 3 + 2 + kPhRing + 1 + 8) * (size_t)nz + (kRing + 1) * (size_t)(nz + 1));
}

// Shared memory K3's analysis instance needs per block, in floats: K3's,
// then the divergence of one plane and Cz^T, ny nz + nz^2 more, and at
// least one thread's nx values of t for the x-factor after the march.
__host__ __device__ size_t stage_qp_smem_floats(int nx, int ny, int nz) {
  const size_t floats = stage_smem_floats(ny, nz) + (size_t)ny * nz + (size_t)nz * nz;
  return floats > (size_t)nx ? floats : (size_t)nx;
}

// Shared memory K6's march instance needs per block, in floats, for every
// field: rings of kRing x-planes of u, v, b and w, kPhRing of pHY' and the
// field's y fluxes of two planes, each plane all ny rows: ny (38 nz + 8).
size_t field_smem_floats(int ny, int nz) {
  return (size_t)ny * ((kRing * 3 + kPhRing + 2) * (size_t)nz + kRing * (size_t)(nz + 1));
}

// Threads of a block: one per (row, z) point of an x-plane; K5's rows
// 0..kYT (NY < 0), K3's and K6's rows 0..ny - 1 (NY >= 0).
__host__ __device__ constexpr int march_threads(int nz, int ny) { return (ny < 0 ? kYT + 1 : ny) * nz; }

// K5's z split (see the head of this file): a cluster of c CTAs for each
// block of the single-CTA K5, CTA r owning the levels [r part, (r + 1)
// part) of the column (the last part shorter) and holding kSplitHalo more
// on each inner side; two planes' partial sums of pHY' (kPRows columns, as
// doubles) head its shared memory.
constexpr int kSplitHalo = 4;
constexpr int kXYMaxSplit = 8;  // the portable cluster size
constexpr int kSplitTotFloats = 2 * 2 * kPRows;

__host__ __device__ constexpr int split_part(int nz, int c) { return (nz + c - 1) / c; }

// The most levels a CTA of the split holds.
int split_levels(int nz, int c) {
  const int part = split_part(nz, c);
  int most = 0;
  for (int r = 0; r < c; ++r) {
    const int z0 = r * part, z1 = min(z0 + part, nz);
    most = max(most, min(z1 + kSplitHalo, nz) - max(z0 - kSplitHalo, 0));
  }
  return most;
}

// Threads of a split CTA: rows 0..kYT of part + 1 levels (the last one the
// face above its part, whose w* its top divergence needs).
int split_threads(int nz, int c) { return (kYT + 1) * (split_part(nz, c) + 1); }

// Shared memory a split CTA needs, in floats: the partial sums, then K5's
// rings over the levels it holds.
size_t stage_xy_split_smem_floats(int nz, int c) {
  return kSplitTotFloats + stage_xy_smem_floats(split_levels(nz, c));
}

// The CTAs of K5's z split for a column of nz levels: 0 where one CTA holds
// it (its rings in a block, its (kYT + 1) nz threads at most 1024: nz <=
// 106), else the smallest c of 2, 4 and 8 whose parts are all non-empty and
// whose CTAs' threads and shared memory fit; 0 where none does (nz > 784).
int stage_xy_split_size(int nz) {
  if (sizeof(float) * stage_xy_smem_floats(nz) <= kSmemPerBlock &&
      march_threads(nz, -1) <= kMaxThreads) {
    return 0;
  }
  for (int c = 2; c <= kXYMaxSplit; c *= 2) {
    if ((c - 1) * split_part(nz, c) < nz && split_threads(nz, c) <= kMaxThreads &&
        sizeof(float) * stage_xy_split_smem_floats(nz, c) <= kSmemPerBlock) {
      return c;
    }
  }
  return 0;
}

// Whether K6 takes the grid with its march instance (K3's whole-y rule);
// every other grid runs its general instance.
bool field_on_march(int nx, int ny, int nz) {
  return nx >= kXYMinNx && ny >= 4 && nz >= 2 && march_threads(nz, ny) <= kMaxThreads &&
         sizeof(float) * field_smem_floats(ny, nz) <= kSmemPerBlock;
}

// The march's kField for a whole stage (K3 and K5), and whether an instance
// of kField computes field f's tendency.
constexpr int kStage = -1;
__host__ __device__ constexpr bool runs(int field, int f) { return field == kStage || field == f; }

// rhat's x-factor, after the march: each thread's column holds t(x) at
// col[x nz] (its own stores, so program order suffices), which becomes
// rhat[kx] = sum_x Fx[kx, x] t(x), summed in increasing x from
// Fx[kx, 0] t(0) with fmaf. At nx = kQpNx the thread holds its t in
// registers, one accumulator a kx, Fx (row-major, 16-byte aligned) through
// the read-only cache as float4. Every other nx stages the t of as many
// threads at a time as the block's shared memory holds (dead after the
// march; stage_qp_smem_floats keeps room for one), [x][thread], and the
// threads take turns.
constexpr int kQpNx = 32;
__device__ __forceinline__ void rhat_x_factor(float* col, const float* __restrict__ fx, int nx,
                                              int ny, int nz, float* smem) {
  if (nx == kQpNx) {
    float t[kQpNx];
#pragma unroll
    for (int x = 0; x < kQpNx; ++x) t[x] = col[x * nz];
    const float4* f4 = reinterpret_cast<const float4*>(fx);
    for (int kx = 0; kx < kQpNx; ++kx, f4 += kQpNx / 4) {
      float4 f = __ldg(f4);
      float a = f.x * t[0];
      a = fmaf(f.y, t[1], a);
      a = fmaf(f.z, t[2], a);
      a = fmaf(f.w, t[3], a);
#pragma unroll
      for (int x = 4; x < kQpNx; x += 4) {
        f = __ldg(f4 + x / 4);
        a = fmaf(f.x, t[x], a);
        a = fmaf(f.y, t[x + 1], a);
        a = fmaf(f.z, t[x + 2], a);
        a = fmaf(f.w, t[x + 3], a);
      }
      col[kx * nz] = a;
    }
    return;
  }
  const int turn = (int)(stage_qp_smem_floats(nx, ny, nz) / nx);  // threads a turn
  for (int t0 = 0; t0 < (int)blockDim.x; t0 += turn) {
    __syncthreads();  // the shared memory is free: the march, or the last turn, is done
    const int s = (int)threadIdx.x - t0;
    if (s < 0 || s >= turn) continue;
    float* ts = smem + s;
    for (int x = 0; x < nx; ++x) ts[x * turn] = col[x * nz];
    for (int kx = 0; kx < nx; ++kx) {
      const float* f = fx + kx * nx;
      float a = __ldg(f) * ts[0];
      for (int x = 1; x < nx; ++x) a = fmaf(__ldg(f + x), ts[x * turn], a);
      col[kx * nz] = a;
    }
  }
}

// The march kernel: K5 for NY < 0 (a block per (env, kYT y rows)), K3 for
// NY >= 0 (a block per env, all of periodic y; NY = 0: ny at run time), and
// K6's march instance for kField >= 0: K3's blocks, one field's tendency g
// only, written to that field's g pointer (no correction, RK update or
// divergence; one barrier a plane). NZ (and NY) > 0 fix the sizes at
// compile time. kRhat: K3's analysis instance, which writes rhat = T_A div
// to div_out in place of div, from Fx and Cz^T in `analysis` (NULL for
// every other instance: a pointer in XYParams moved the other instances'
// register allocation); it has K3's launch bounds. kSplit: K5's z split,
// one CTA of a cluster that shares each block's column (NZ = 0, NY < 0).
template <int NZ, int NY, int kField = kStage, bool kRhat = false, bool kSplit = false>
__global__ void __launch_bounds__(NZ > 0 && NY != 0 ? march_threads(NZ, NY) : kMaxThreads,
                                  NY < 0 ? (NZ == 32 ? 3 : 1) : (NZ > 0 && NY > 0 ? 2 : 1))
stage_march_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                      const float* __restrict__ w_in, const float* __restrict__ b_in,
                      const float* __restrict__ q_in, const float* __restrict__ bottom_in,
                      const float* gu_prev, const float* gv_prev, const float* gw_prev,
                      const float* gb_prev, float* u_out, float* v_out, float* w_out,
                      float* b_out, float* div_out, float* gu_out, float* gv_out,
                      float* gw_out, float* gb_out, float dt, float gamma, float zeta,
                      XYParams P, const float* __restrict__ analysis) {
  constexpr bool kWhole = NY >= 0;  // K3 and K6
  constexpr bool kK6 = kField != kStage;
  static_assert(!kK6 || kWhole, "K6 marches over whole y");
  static_assert(!kRhat || (kWhole && !kK6), "the analysis instance is K3's");
  static_assert(!kSplit || (NZ == 0 && !kWhole), "the z split is K5's, at a runtime nz");
  // the tendencies this instance computes; b is read for gb and for pHY'
  constexpr bool kU = runs(kField, kFieldU), kV = runs(kField, kFieldV);
  constexpr bool kW = runs(kField, kFieldW), kB = runs(kField, kFieldB);
  constexpr bool kPhy = kU || kV, kReadsB = kPhy || kB;
  constexpr int kYF = kK6 ? 1 : 4;  // fields whose y fluxes are staged
  extern __shared__ float smem[];
  // The column's nzg levels. The split's CTA `rank` of n_cta owns the
  // levels [z0, z1) and holds [zlo, zhi); elsewhere a CTA owns and holds
  // them all. (Each expression below that differs for the split is a
  // kSplit ? split : the single CTA's own, so that the other instances
  // compile as they did.)
  const int nx = P.nx, ny = NY > 0 ? NY : P.ny, nzg = NZ > 0 ? NZ : P.nz;
  int n_cta = 1, rank = 0, part = nzg, z0 = 0, z1 = nzg, zlo = 0, zhi = nzg;
  if constexpr (kSplit) {
    n_cta = cluster_size();
    rank = cluster_rank();
    part = split_part(nzg, n_cta);
    z0 = rank * part;
    z1 = min(z0 + part, nzg);
    zlo = max(z0 - kSplitHalo, 0);
    zhi = min(z1 + kSplitHalo, nzg);
  }
  // nz: the levels of a ring's row (nzg, or the split's zhi - zlo)
  const int nz = kSplit ? zhi - zlo : nzg, nw = nz + 1;
  // this thread's point of every x-plane: row j, level k of the rings, kz of
  // the column; the only divisions by a runtime size are these and the
  // block's. A split row has part + 1 threads, the last one face z1's.
  const int tk = kSplit ? part + 1 : nz;
  const int j = threadIdx.x / tk, kl = threadIdx.x - j * tk;
  const int kz = kSplit ? z0 + kl : kl, k = kSplit ? kz - zlo : kl;
  const int n_rows = kWhole ? ny : kYT + 1;  // rows of threads
  size_t e;
  int y0;
  if constexpr (kWhole) {
    e = blockIdx.x;
    y0 = 0;
  } else if constexpr (kSplit) {
    const unsigned blk = blockIdx.x / n_cta;  // the cluster
    const int nyb = ny / kYT;
    e = blk / nyb;
    y0 = (blk - (int)e * nyb) * kYT;
  } else {
    const int nyb = ny / kYT;
    e = blockIdx.x / nyb;
    y0 = (blockIdx.x - (int)e * nyb) * kYT;
  }
  const size_t S = (size_t)ny * (kSplit ? nzg : nz), SW = (size_t)ny * (kSplit ? nzg + 1 : nw);
  const size_t cell0 = e * nx * S, face0 = e * nx * SW;
  // the split's CTA computes u*, v*, b' at its levels and w* at its faces
  // [z0, z1], and writes the faces it owns: face z1 is the next CTA's (the
  // last CTA's top wall its own)
  const bool cell = !kSplit || kz < z1, writes_w = !kSplit || kz < z1 || z1 == nzg;
  const bool w_interior = kz > 0 && kz < nzg;  // the split's: its faces reach the top wall
  // K5's row kYT computes v* only, for the divergence
  const bool own = kSplit ? j < kYT && kz <= z1 : kWhole || j < kYT;
  const bool phy_row = kSplit ? j == kYT : !own;  // the split's pHY' row
  const int jp = kWhole ? wrap_x(j + 1, ny) : j + 1;  // the row of v* above

  // each ring's first row and rows: K5's tile and halos, K3's every row
  auto lo = [&](int tile_lo) { return kWhole ? 0 : tile_lo; };
  auto rows = [&](int tile_rows) { return kWhole ? ny : tile_rows; };
  // the split's partial sums of pHY' (two planes of kPRows columns) head
  // its shared memory, at one address in every CTA of the cluster
  double* const tot = reinterpret_cast<double*>(cta_shared(smem));
  Ring<kRing, kWhole> U{kSplit ? cta_shared(smem) + kSplitTotFloats : smem, lo(kULo),
                        rows(kURows), nz};
  Ring<kRing, kWhole> V{U.end(), lo(kVLo), rows(kVRows), nz};
  Ring<kRing, kWhole> W{V.end(), lo(kWLo), rows(kWRows), nw};
  Ring<kRing, kWhole> B{W.end(), lo(kBLo), rows(kBRows), nz};
  Ring<2, kWhole> Q{B.end(), lo(kQLo), kK6 ? 0 : rows(kQRows), nz};
  Ring<kPhRing, kWhole> PH{Q.end(), lo(kPLo), rows(kPRows), nz};
  float* vs = PH.end();       // v* of the current plane, every row of threads
  float* ws = vs + (kK6 ? 0 : n_rows * nz);  // w* of the current plane, rows 0..kYT-1 (K3: all)
  // K3: y fluxes of a plane, two planes by parity, each [u | v | w | b] (ny, nz);
  // K6: its field's alone
  float* yfl = ws + (kK6 ? 0 : (kWhole ? ny : kYT) * nw);
  // K3's analysis instance: div of one plane (ny, nz) and Cz^T [z][kz]
  float* ds = yfl + 2 * kYF * S;
  float* czs = ds + S;
  if constexpr (kRhat) {  // visible after the prologue's first barrier
    for (int t = threadIdx.x; t < nz * nz; t += blockDim.x) czs[t] = analysis[nx * nx + t];
  }

  // ---- staging: plane x of u, v, w, b and q, raw, by asynchronous copies ----
  auto copy_rows = [&](const Ring<kRing, kWhole>& R, const float* src, size_t row_stride,
                       int x) {
    for (int r = R.lo + j; r < R.lo + R.rows; r += n_rows) {
      const float* s = src + wrap_x(y0 + r, ny) * row_stride;
      float* d = R.row(x, r);
      if constexpr (kSplit) {  // the held levels, from zlo
        for (int kk = kl; kk < R.nk; kk += tk)
          __pipeline_memcpy_async(d + kk, s + zlo + kk, sizeof(float));
      } else {
        __pipeline_memcpy_async(d + k, s + k, sizeof(float));
        if (R.nk > nz && k == 0) __pipeline_memcpy_async(d + nz, s + nz, sizeof(float));
      }
    }
  };
  auto load_q = [&](int x) {  // q is (E, ny, nx, nz): row y of plane x is one run
    const float* qe = q_in + e * ny * nx * nzg + (size_t)wrap_x(x, nx) * nzg;
    for (int r = Q.lo + j; r < Q.lo + Q.rows; r += n_rows) {
      if constexpr (kSplit) {
        const float* qr = qe + (size_t)wrap_x(y0 + r, ny) * nx * nzg + zlo;
        for (int kk = kl; kk < nz; kk += tk)
          __pipeline_memcpy_async(Q.row(x, r) + kk, qr + kk, sizeof(float));
      } else {
        __pipeline_memcpy_async(Q.row(x, r) + k, qe + (size_t)wrap_x(y0 + r, ny) * nx * nz + k,
                                sizeof(float));
      }
    }
  };
  auto load_plane = [&](int x) {
    const size_t xc = (size_t)wrap_x(x, nx);
    copy_rows(U, u_in + cell0 + xc * S, kSplit ? nzg : nz, x);
    copy_rows(V, v_in + cell0 + xc * S, kSplit ? nzg : nz, x);
    if constexpr (kReadsB) copy_rows(B, b_in + cell0 + xc * S, kSplit ? nzg : nz, x);
    copy_rows(W, w_in + face0 + xc * SW, kSplit ? nzg + 1 : nw, x);
    if constexpr (!kK6) load_q(x);
    __pipeline_commit();
  };
  // ---- lazy-projection correction of plane x, once, as it arrives ----------
  auto correct_plane = [&](int x) {
    if constexpr (kSplit) {  // every held level; w at the held faces with q below them
      for (int r = U.lo + j; r < U.lo + U.rows; r += n_rows)
        for (int kk = kl; kk < nz; kk += tk)
          U.row(x, r)[kk] -= (Q.row(x, r)[kk] - Q.row(x - 1, r)[kk]) * P.idx;
      for (int r = V.lo + j; r < V.lo + V.rows; r += n_rows)
        for (int kk = kl; kk < nz; kk += tk)
          V.row(x, r)[kk] -= (Q.row(x, r)[kk] - Q.row(x, r - 1)[kk]) * P.idy;
      for (int r = W.lo + j; r < W.lo + W.rows; r += n_rows)
        for (int kk = kl + 1; kk < nz; kk += tk)
          W.row(x, r)[kk] -= (Q.row(x, r)[kk] - Q.row(x, r)[kk - 1]) * P.idz;
      return;
    }
    for (int r = U.lo + j; r < U.lo + U.rows; r += n_rows)
      U.row(x, r)[k] -= (Q.row(x, r)[k] - Q.row(x - 1, r)[k]) * P.idx;
    for (int r = V.lo + j; r < V.lo + V.rows; r += n_rows)
      V.row(x, r)[k] -= (Q.row(x, r)[k] - Q.row(x, r - 1)[k]) * P.idy;
    if (k > 0) {  // interior faces only
      for (int r = W.lo + j; r < W.lo + W.rows; r += n_rows)
        W.row(x, r)[k] -= (Q.row(x, r)[k] - Q.row(x, r)[k - 1]) * P.idz;
    }
  };
  // ---- pHY' of plane x, in float64 so that each value rounds once: K5's
  // row kYT sums a column a thread from the top; K3's threads take a suffix
  // scan across the lanes of their column (NZ > 0), else each column's
  // k = 0 thread sums it ---------------------------------------------------
  auto hydrostatic = [&](int x) {
    if constexpr (kWhole && NZ > 0) {
      const float* bc = B.row(x, j);
      const double dz = P.dz;
      double v = k < nz - 1 ? dz * (0.5 * ((double)bc[k] + (double)bc[min(k + 1, nz - 1)]))
                            : 0.5 * dz * P.min_b;
#pragma unroll
      for (int off = 1; off < NZ; off <<= 1) {
        const double t = __shfl_down_sync(__activemask(), v, off, NZ);
        if (k + off < NZ) v += t;
      }
      PH.row(x, j)[k] = (float)-v;
    } else {
      const int r0 = kWhole ? (k == 0 ? j : n_rows) : kPLo + k, r1 = kWhole ? j + 1 : kPLo + kPRows;
      for (int r = r0; r < r1; r += nz) hydrostatic_column(B.row(x, r), PH.row(x, r), nz, P);
    }
  };
  // The split's pHY' of plane x, in two passes around a cluster barrier by
  // its row kYT, a column a thread: phy_total puts this CTA's part of each
  // column's sum (the increments of its levels; the last CTA's with the top
  // half cell) into tot[x & 1]; phy_column then sums down its levels in
  // float64 from the parts of the CTAs above, read from their shared
  // memory, so that each value still rounds once.
  auto phy_inc = [&](const float* bc, int m) {  // the increment of level m
    return (double)P.dz * (0.5 * ((double)bc[m - zlo] + (double)bc[m + 1 - zlo]));
  };
  auto phy_total = [&](int x) {
    for (int r = kPLo + kl; r < kPLo + kPRows; r += tk) {
      const float* bc = B.row(x, r);
      double acc = z1 == nzg ? 0.5 * (double)P.dz * P.min_b : 0.0;
      for (int m = min(z1, nzg - 1) - 1; m >= z0; --m) acc += phy_inc(bc, m);
      tot[(x & 1) * kPRows + r - kPLo] = acc;
    }
  };
  auto phy_column = [&](int x) {
    for (int r = kPLo + kl; r < kPLo + kPRows; r += tk) {
      const float* bc = B.row(x, r);
      float* pc = PH.row(x, r);
      double acc = 0.0;
      int m = z1 - 1;
      if (z1 == nzg) {  // the top: the half cell under the lid
        acc = 0.5 * (double)P.dz * P.min_b;
        pc[nzg - 1 - zlo] = (float)-acc;
        m = nzg - 2;
      } else {
        for (int c = n_cta - 1; c > rank; --c)
          acc += cluster_map(tot, c)[(x & 1) * kPRows + r - kPLo];
      }
      for (; m >= z0; --m) {
        acc += phy_inc(bc, m);
        pc[m - zlo] = (float)-acc;
      }
    }
  };

  // z ladder orders of this thread's faces k and k + 1 in a column of nz
  // (u, v, b) and of nz + 1 points (w), once; z taps clamped into the column
  const ZOrders zc0 = z_orders(kz, nzg), zc1 = z_orders(kz + 1, nzg);
  const ZOrders zw0 = z_orders(kz, kSplit ? nzg + 1 : nw);
  const ZOrders zw1 = z_orders(kz + 1, kSplit ? nzg + 1 : nw);
  int zt[7], zwt[7];  // ring offsets of taps kz-3..kz+3
  for (int o = 0; o < 7; ++o) {
    if constexpr (kSplit) {
      zt[o] = min(max(kz + o - 3, 0), nzg - 1) - zlo;
      zwt[o] = min(max(kz + o - 3, 0), nzg) - zlo;
    } else {
      zt[o] = min(max(k + o - 3, 0), nz - 1);
      zwt[o] = min(max(k + o - 3, 0), nw - 1);
    }
  }

  // flux(k + 1) - flux(k) of a column's z fluxes through this thread's two
  // faces (taps at k-3..k+3). At nz = 32 or 16 the lanes of a column are
  // consecutive, and a lane takes face k + 1's flux from its neighbour
  // (through the top wall it is 0: w = 0 there); else it computes both.
  auto z_flux_diff = [&](float t0, float t1, float t2, float t3, float t4, float t5,
                         float t6, float vel_k, float vel_kp) {
    const float f_k = z_upwind(t0, t1, t2, t3, t4, t5, zc0, vel_k);
    float f_kp;
    if constexpr (NZ > 0) {
      f_kp = __shfl_down_sync(__activemask(), f_k, 1, NZ);
      if (k == nz - 1) f_kp = 0.0f;
    } else {
      f_kp = z_upwind(t1, t2, t3, t4, t5, t6, zc1, vel_kp);
    }
    return f_kp - f_k;
  };

  // ---- x fluxes: each face's once, carried to the next plane ---------------
  // u at center c (taps faces c-2..c+3); v, w, b at face c (taps c-3..c+2)
  auto xflux_u = [&](int c) {
    const float a = U.row(c, j)[k], b = U.row(c + 1, j)[k];
    return ub5_upwind(U.row(c - 2, j)[k], U.row(c - 1, j)[k], a, b, U.row(c + 2, j)[k],
                      U.row(c + 3, j)[k], 0.5f * (a + b));
  };
  auto xflux_face = [&](const Ring<kRing, kWhole>& R, int c, float vel) {
    return ub5_upwind(R.row(c - 3, j)[k], R.row(c - 2, j)[k], R.row(c - 1, j)[k],
                      R.row(c, j)[k], R.row(c + 1, j)[k], R.row(c + 2, j)[k], vel);
  };
  auto xflux_v = [&](int c) {
    return xflux_face(V, c, 0.5f * (U.row(c, j - 1)[k] + U.row(c, j)[k]));
  };
  auto xflux_w = [&](int c) {
    const float* uc = U.row(c, j);
    return xflux_face(W, c, 0.5f * (uc[k - 1] + uc[k]));
  };
  auto xflux_b = [&](int c) { return xflux_face(B, c, U.row(c, j)[k]); };
  // vel * UB5 along y at face/center c of plane x, level kk (taps c-3..c+2)
  auto yflux = [&](const Ring<kRing, kWhole>& R, int x, int c, int kk, float vel) {
    return ub5_upwind(R.row(x, c - 3)[kk], R.row(x, c - 2)[kk], R.row(x, c - 1)[kk],
                      R.row(x, c)[kk], R.row(x, c + 1)[kk], R.row(x, c + 2)[kk], vel);
  };
  // K3 and K6: each y flux of plane x once, by the thread at its face (u, w,
  // b: face j) or center (v: center j), for its neighbours to read
  auto y_fluxes = [&](int x) {
    float* yf = yfl + (x & 1) * kYF * S + j * nz + k;
    const float* vc = V.row(x, j);
    if constexpr (kU) yf[0] = yflux(U, x, j, k, 0.5f * (V.row(x - 1, j)[k] + vc[k]));
    if constexpr (kV) yf[(kK6 ? 0 : 1) * S] = yflux(V, x, j + 1, k, 0.5f * (vc[k] + V.row(x, j + 1)[k]));
    if constexpr (kW) {
      yf[(kK6 ? 0 : 2) * S] = k > 0 ? yflux(W, x, j, k, 0.5f * (vc[k - 1] + vc[k])) : 0.0f;
    }
    if constexpr (kB) yf[(kK6 ? 0 : 3) * S] = yflux(B, x, j, k, vc[k]);
  };
  // K3 and K6: the difference of field f's y fluxes of plane x at rows r1 and r0
  auto y_diff = [&](int x, int f, int r1, int r0) {
    const float* yf = yfl + (x & 1) * kYF * S + (kK6 ? 0 : f) * S + k;
    return yf[r1 * nz] - yf[r0 * nz];
  };
  const int jm = kWhole ? wrap_x(j - 1, ny) : j - 1;
  // K3's analysis instance: this thread's column of rhat (E, ny, nx nz),
  // (y = j, kz = k), nx values nz apart
  float* const col = kRhat ? div_out + (e * ny + j) * (size_t)nx * nz + k : nullptr;
  // its z-factor of plane x: t = sum_z Cz[k, z] div(x)[j, z] over its
  // column (the plane's div in shared memory), stored at rhat's own address
  // for (j, x, k), where K3 stores div; the x-factor reads it back
  auto analyse = [&](int x) {
    const float* dc = ds + j * nz;
    float t = 0.0f;
#pragma unroll
    for (int z = 0; z < nz; ++z) t = fmaf(czs[z * nz + k], dc[z], t);
    col[x * nz] = t;
  };
  auto lap_h = [&](const Ring<kRing, kWhole>& R, int i, int kk, float c) {
    return (R.row(i + 1, j)[kk] - 2.0f * c + R.row(i - 1, j)[kk]) * P.idx2 +
           (R.row(i, j + 1)[kk] - 2.0f * c + R.row(i, j - 1)[kk]) * P.idy2;
  };

  // ---- prologue: planes -3..3, pHY' of -1 and 0, the fluxes entering plane 0
  if constexpr (!kK6) load_q(-4);
  for (int x = -3; x <= 3; ++x) {
    load_plane(x);
    __pipeline_wait_prior(0);
    __syncthreads();
    if constexpr (!kK6) {
      correct_plane(x);
      __syncthreads();
    }
  }
  if constexpr (kSplit) {  // pHY' of planes -1..1, and the partial sums of plane 2
    for (int x = -1; x <= 1; ++x) {
      if (phy_row) phy_total(x);
      cluster_barrier();
      if (phy_row) phy_column(x);
    }
    if (phy_row) phy_total(2);
  } else if constexpr (kPhy) {
    if (kWhole || !own) {
      for (int x = -1; x <= 1; ++x) hydrostatic(x);
    }
  }
  if constexpr (kWhole) y_fluxes(0);
  float fu = 0.0f, fv = 0.0f, fw = 0.0f, fb = 0.0f;
  if constexpr (kV) {
    if (cell) fv = xflux_v(0);
  }
  if (own) {
    if constexpr (kU) {
      if (cell) fu = xflux_u(-1);
    }
    if constexpr (kB) {
      if (cell) fb = xflux_b(0);
    }
    if constexpr (kW) {
      if (kSplit ? w_interior : k > 0) fw = xflux_w(0);
    }
  }
  if constexpr (kSplit) {
    cluster_barrier();  // every CTA's partial sums of plane 2
  } else {
    __syncthreads();
  }

  const bool emit_g = gu_out != nullptr, reads_g = gu_prev != nullptr;
  // f + dt (gamma g + zeta g_prev), K3's rk_update on a loaded g_prev; stage 0 has none
  auto rk_value = [&](float f, float g, float gp) {
    return reads_g ? f + dt * (gamma * g + zeta * gp) : f + dt * (gamma * g);
  };
  float u_first = 0.0f, u_prev = 0.0f, dv = 0.0f, dw = 0.0f;
  for (int i = 0; i < nx; ++i) {
    load_plane(i + 4);  // into plane i - 4's slot, overlapping this plane
    const size_t o = cell0 + (size_t)i * S + (size_t)(y0 + j) * (kSplit ? nzg : nz) + kz;
    const size_t ov = cell0 + (size_t)i * S + (size_t)wrap_x(y0 + j, ny) * (kSplit ? nzg : nz) + kz;
    const size_t ow = face0 + (size_t)i * SW + (size_t)(y0 + j) * (kSplit ? nzg + 1 : nw) + kz;
    // this point's g_prev and bottom, loaded before the arithmetic hides them
    float gp_u = 0.0f, gp_v = 0.0f, gp_w = 0.0f, gp_b = 0.0f, bottom = 0.0f;
    if (!kK6 && reads_g) {
      if (cell) gp_v = gv_prev[ov];
      if (own) {
        if (cell) gp_u = gu_prev[o];
        gp_w = gw_prev[ow];
        if (cell) gp_b = gb_prev[o];
      }
    }
    if (kB && own && kz == 0) bottom = bottom_in[(e * nx + i) * ny + y0 + j];
    const float* vc = V.row(i, j);
    // ---- gv and v* at (i, j, k), rows 0..kYT ----
    if constexpr (kV) {
      if (cell) {
        const float f_new = xflux_v(i + 1);
        float adv = (f_new - fv) * P.idx;
        fv = f_new;
        if constexpr (kWhole) {
          adv += y_diff(i, 1, j, jm) * P.idy;
        } else {
          const float vc_j = 0.5f * (vc[k] + V.row(i, j + 1)[k]);
          const float vc_jm = 0.5f * (V.row(i, j - 1)[k] + vc[k]);
          adv += (yflux(V, i, j + 1, k, vc_j) - yflux(V, i, j, k, vc_jm)) * P.idy;
        }
        const float* wa = W.row(i, j - 1);
        const float* wb = W.row(i, j);
        const float wf_k = 0.5f * (wa[k] + wb[k]), wf_kp = 0.5f * (wa[k + 1] + wb[k + 1]);
        const float t0 = vc[zt[0]], t1 = vc[zt[1]], t2 = vc[zt[2]], t3 = vc[k],
                    t4 = vc[zt[4]], t5 = vc[zt[5]], t6 = vc[zt[6]];
        adv += z_flux_diff(t0, t1, t2, t3, t4, t5, t6, wf_k, wf_kp) * P.idz;
        const float dphy = (PH.row(i, j)[k] - PH.row(i, j - 1)[k]) * P.idy;
        const float qm = kz > 0 ? t2 : -vc[0], qp = kz < nzg - 1 ? t4 : -vc[nz - 1];
        const float lap = lap_h(V, i, k, t3) + (qp - 2.0f * t3 + qm) * P.idz2;
        const float g = -adv - dphy + P.nu * lap;
        if constexpr (kK6) {
          gv_out[o] = g;
        } else {
          const float f = rk_value(t3, g, gp_v);
          vs[j * nz + k] = f;
          if (own) {
            v_out[o] = f;
            if (emit_g) gv_out[o] = g;
          }
        }
      }
    }
    // K5's row kYT, which has no other work, sums pHY' of plane i + 2
    // meanwhile (the split's: its last pass, and the first of plane i + 3);
    // K3's and K6's threads take their own points of it
    if constexpr (kSplit) {
      if (phy_row) {
        phy_column(i + 2);
        phy_total(i + 3);
      }
    } else if (kPhy && (kWhole || !own)) {
      hydrostatic(i + 2);
    }
    if (own) {
      const float* uc = U.row(i, j);
      const float* wc = W.row(i, j);
      const float* wm = W.row(i - 1, j);
      // ---- gu and u* at face i ----
      if constexpr (kU) {
        if (cell) {
          const float f_new = xflux_u(i);
          float adv = (f_new - fu) * P.idx;
          fu = f_new;
          if constexpr (kWhole) {
            adv += y_diff(i, 0, jp, j) * P.idy;
          } else {
            const float* va = V.row(i - 1, j);
            const float* vb = V.row(i - 1, j + 1);
            const float vf_j = 0.5f * (va[k] + vc[k]);
            const float vf_jp = 0.5f * (vb[k] + V.row(i, j + 1)[k]);
            adv += (yflux(U, i, j + 1, k, vf_jp) - yflux(U, i, j, k, vf_j)) * P.idy;
          }
          const float wf_k = 0.5f * (wm[k] + wc[k]), wf_kp = 0.5f * (wm[k + 1] + wc[k + 1]);
          const float t0 = uc[zt[0]], t1 = uc[zt[1]], t2 = uc[zt[2]], t3 = uc[k],
                      t4 = uc[zt[4]], t5 = uc[zt[5]], t6 = uc[zt[6]];
          adv += z_flux_diff(t0, t1, t2, t3, t4, t5, t6, wf_k, wf_kp) * P.idz;
          const float dphy = (PH.row(i, j)[k] - PH.row(i - 1, j)[k]) * P.idx;
          const float qm = kz > 0 ? t2 : -uc[0], qp = kz < nzg - 1 ? t4 : -uc[nz - 1];
          const float lap = lap_h(U, i, k, t3) + (qp - 2.0f * t3 + qm) * P.idz2;
          const float g = -adv - dphy + P.nu * lap;
          if constexpr (kK6) {
            gu_out[o] = g;
          } else {
            const float f = rk_value(t3, g, gp_u);
            u_out[o] = f;
            if (emit_g) gu_out[o] = g;
            // div(i - 1) = ((u*(i) - u*(i-1)) / dx + dv) + dw, the plain version's order
            if (i > 0) {
              const float d = ((f - u_prev) * P.idx + dv) + dw;
              if constexpr (kRhat) {
                ds[j * nz + k] = d;
              } else {
                div_out[((e * ny + y0 + j) * nx + i - 1) * nzg + kz] = d;
              }
            } else {
              u_first = f;
            }
            u_prev = f;
          }
        }
      }
      // ---- gw and w* at (i, j, face k); the k = 0 thread takes both walls ----
      if constexpr (kW) {
        const float t0 = wc[zwt[0]], t1 = wc[zwt[1]], t2 = wc[zwt[2]], t3 = wc[k],
                    t4 = wc[k + 1], t5 = wc[zwt[5]], t6 = wc[zwt[6]];
        // z fluxes at the centers k (every lane, k = 0 too) and k - 1
        const float fz = z_upwind(t1, t2, t3, t4, t5, t6, zw1, 0.5f * (t3 + t4));
        float fz_m;
        if constexpr (NZ > 0) {
          fz_m = __shfl_up_sync(__activemask(), fz, 1, NZ);
        } else {
          fz_m = z_upwind(t0, t1, t2, t3, t4, t5, zw0, 0.5f * (t2 + t3));
        }
        if (kSplit ? w_interior : k > 0) {
          const float f_new = xflux_w(i + 1);
          float adv = (f_new - fw) * P.idx;
          fw = f_new;
          if constexpr (kWhole) {
            adv += y_diff(i, 2, jp, j) * P.idy;
          } else {
            const float* va = V.row(i, j + 1);
            const float vf_j = 0.5f * (vc[k - 1] + vc[k]);
            const float vf_jp = 0.5f * (va[k - 1] + va[k]);
            adv += (yflux(W, i, j + 1, k, vf_jp) - yflux(W, i, j, k, vf_j)) * P.idy;
          }
          adv += (fz - fz_m) * P.idz;
          const float lap = lap_h(W, i, k, t3) + (t4 - 2.0f * t3 + t2) * P.idz2;
          const float g = -adv + P.nu * lap;
          if constexpr (kK6) {
            gw_out[ow] = g;
          } else {
            const float f = rk_value(t3, g, gp_w);
            if (writes_w) {
              w_out[ow] = f;
              if (emit_g) gw_out[ow] = g;
            }
            ws[j * nw + k] = f;
          }
        } else if constexpr (kK6) {  // wall faces: g is exactly 0
          gw_out[ow] = 0.0f;
          gw_out[ow + nz] = 0.0f;
        } else {  // wall faces: w, g and g_prev are all 0, so w* stays exactly 0
          // (the split's thread at a wall takes its own face only)
          for (int face = 0; face <= (kSplit ? 0 : nz); face += (kSplit ? 1 : nz)) {
            const int fk = kSplit ? k + face : face;
            const float f = rk_value(wc[fk], 0.0f, reads_g ? gw_prev[ow + face] : 0.0f);
            w_out[ow + face] = f;
            if (emit_g) gw_out[ow + face] = 0.0f;
            ws[j * nw + fk] = f;
          }
        }
      }
      // ---- gb and b' ----
      if constexpr (kB) {
        if (cell) {
          const float* bc = B.row(i, j);
          const float f_new = xflux_b(i + 1);
          float adv = (f_new - fb) * P.idx;
          fb = f_new;
          if constexpr (kWhole) {
            adv += y_diff(i, 3, jp, j) * P.idy;
          } else {
            adv += (yflux(B, i, j + 1, k, V.row(i, j + 1)[k]) - yflux(B, i, j, k, vc[k])) * P.idy;
          }
          const float t0 = bc[zt[0]], t1 = bc[zt[1]], t2 = bc[zt[2]], t3 = bc[k],
                      t4 = bc[zt[4]], t5 = bc[zt[5]], t6 = bc[zt[6]];
          adv += z_flux_diff(t0, t1, t2, t3, t4, t5, t6, wc[k], wc[k + 1]) * P.idz;
          const float qm = kz > 0 ? t2 : 2.0f * bottom - bc[0];
          const float qp = kz < nzg - 1 ? t4 : 2.0f * P.min_b - bc[nz - 1];
          const float lap = lap_h(B, i, k, t3) + (qp - 2.0f * t3 + qm) * P.idz2;
          const float g = -adv + P.kappa * lap;
          if constexpr (kK6) {
            gb_out[o] = g;
          } else {
            const float f = rk_value(t3, g, gp_b);
            b_out[o] = f;
            if (emit_g) gb_out[o] = g;
          }
        }
      }
    }
    if constexpr (kWhole) y_fluxes(i + 1);
    __pipeline_wait_prior(0);
    // plane i + 4 has landed; v*, w* of plane i are complete (the split: and
    // every CTA's partial sums of plane i + 3)
    if constexpr (kSplit) {
      cluster_barrier();
    } else {
      __syncthreads();
    }
    if constexpr (!kK6) {
      correct_plane(i + 4);
      if (kSplit ? own && cell : own) {
        dv = (vs[jp * nz + k] - vs[j * nz + k]) * P.idy;
        dw = (ws[j * nw + k + 1] - ws[j * nw + k]) * P.idz;
      }
      if constexpr (kRhat) {
        if (i > 0) analyse(i - 1);  // ds holds div(i - 1), complete since the barrier
      }
      __syncthreads();
    }
  }
  if (!kK6 && (kSplit ? own && cell : own)) {  // div(nx - 1): u* at face nx is u* at face 0
    const float d = ((u_first - u_prev) * P.idx + dv) + dw;
    if constexpr (kRhat) {
      ds[j * nz + k] = d;
    } else {
      div_out[((e * ny + y0 + j) * nx + nx - 1) * nzg + kz] = d;
    }
  }
  if constexpr (kRhat) {  // the last plane's z-factor, then the x-factor
    __syncthreads();
    analyse(nx - 1);
    rhat_x_factor(col, analysis, nx, ny, nz, smem);
  }
}

// The K5 instance for nz: specialised for the grids users run (the big
// grid's 32, and 16), the runtime-nz one for every other nz.
decltype(&stage_march_kernel<0, -1>) stage_xy_kernel_for(int nz) {
  return nz == 32 ? stage_march_kernel<32, -1>
                  : (nz == 16 ? stage_march_kernel<16, -1> : stage_march_kernel<0, -1>);
}

// K5's z-split instance (stage_xy_split_size > 0: nz >= 107).
decltype(&stage_march_kernel<0, -1>) stage_xy_split_kernel() {
  return stage_march_kernel<0, -1, kStage, false, true>;
}

// The K3 instance: specialised for the training grid's 32 rows of 16, the
// runtime-size one for every other grid.
decltype(&stage_march_kernel<0, 0>) stage_kernel_for(int ny, int nz) {
  return ny == 32 && nz == 16 ? stage_march_kernel<16, 32> : stage_march_kernel<0, 0>;
}

// K3's analysis instance: specialised like K3.
decltype(&stage_march_kernel<0, 0, kStage, true>) stage_qp_kernel_for(int ny, int nz) {
  return ny == 32 && nz == 16 ? stage_march_kernel<16, 32, kStage, true>
                              : stage_march_kernel<0, 0, kStage, true>;
}

// K6's march instance for field kField: specialised like K3's.
template <int kField>
decltype(&stage_march_kernel<0, 0, kField>) field_march_kernel_for(int ny, int nz) {
  return ny == 32 && nz == 16 ? stage_march_kernel<16, 32, kField>
                              : stage_march_kernel<0, 0, kField>;
}

__global__ void __launch_bounds__(kThreads)
correct_3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ q,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  float* __restrict__ w_out, int n_env, int nx, int ny, int nz,
                  float dx, float dy, float dz) {
  const size_t n = (size_t)n_env * nx * ny * (nz + 1);
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int k = p % (nz + 1);
  size_t t = p / (nz + 1);
  const int y = t % ny;
  t /= ny;
  const int x = t % nx;
  const size_t e = t / nx;
  const float* qr = q + (e * ny + y) * nx * nz;  // row (e, y) of the solve layout
  if (k < nz) {
    const size_t c = ((e * nx + x) * ny + y) * nz + k;
    const float qc = qr[x * nz + k];
    u_out[c] = u[c] - (qc - qr[wrap_x(x - 1, nx) * nz + k]) / dx;
    const float* qm = q + (e * ny + wrap_x(y - 1, ny)) * nx * nz;
    v_out[c] = v[c] - (qc - qm[x * nz + k]) / dy;
  }
  w_out[p] = (k == 0 || k == nz) ? w[p] : w[p] - (qr[x * nz + k] - qr[x * nz + k - 1]) / dz;
}

// K6's general instance: one thread per output point of one env's
// (nx, ny, nk) field, blocks_per_env blocks an env. b is read for u and v
// (their pHY') and for b; bottom for b only.
template <int kField>
__global__ void __launch_bounds__(kThreads)
field_tendency_3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                         const float* __restrict__ w, const float* __restrict__ b,
                         const float* __restrict__ bottom, float* __restrict__ g,
                         int blocks_per_env, XYParams P) {
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int nk = kField == kFieldW ? nz + 1 : nz;
  const int e = blockIdx.x / blocks_per_env;
  const int p = (blockIdx.x - e * blocks_per_env) * blockDim.x + threadIdx.x;
  if (p >= nx * ny * nk) return;
  const int k = p % nk, t = p / nk, j = t % ny, i = t / ny;
  const size_t cells = (size_t)nx * ny * nz, faces = (size_t)nx * ny * (nz + 1);
  const GlobalField U{u + e * cells, nx, ny, nz}, V{v + e * cells, nx, ny, nz},
      W{w + e * faces, nx, ny, nz + 1};
  float out;
  if constexpr (kField == kFieldU || kField == kFieldV) {
    const HydrostaticField PH{{b + e * cells, nx, ny, nz}, P.dz, 0.5 * (double)P.dz * P.min_b};
    out = kField == kFieldU ? tendency_u(U, V, W, PH, i, j, k, P)
                            : tendency_v(U, V, W, PH, i, j, k, P);
  } else if constexpr (kField == kFieldW) {
    out = tendency_w(U, V, W, i, j, k, P);
  } else {
    out = tendency_b(U, V, W, GlobalField{b + e * cells, nx, ny, nz},
                     bottom[(size_t)e * nx * ny + t], i, j, k, P);
  }
  g[e * (size_t)(nx * ny * nk) + p] = out;
}

// K7: threads of a block at most; levels a thread (as one float4) where nz
// is a template parameter.
constexpr int kDivThreads = 512;
constexpr int kDivVec = 4;

// K7: the (nx, nz) slab of one (env, y row) of the solve layout, a block's
// threads over its points (x, k), k fastest; NZ > 0 (a multiple of 4): four
// consecutive levels a thread, as float4 loads and stores. A thread reads
// u(x); u(x + 1) comes from the lane that holds column x + 1, except where
// that lane is in the next warp or x + 1 wraps. The loop's trip count is
// the block's, so that every lane reaches each shuffle.
template <int NZ>
__global__ void __launch_bounds__(kDivThreads)
div_3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ w, float* __restrict__ div_out, int nx, int ny,
              int nz_rt, float idx, float idy, float idz) {
  constexpr int kL = NZ > 0 ? kDivVec : 1;  // levels a thread
  static_assert(NZ % kDivVec == 0, "vector K7 instances need nz % 4 == 0");
  const int nz = NZ > 0 ? NZ : nz_rt, nw = nz + 1, lanes = nz / kL;  // lanes a column
  const int e = blockIdx.x / ny, y = blockIdx.x - e * ny, yp = y + 1 < ny ? y + 1 : 0;
  const int S = ny * nz, SW = ny * nw;  // x strides within an env
  const float* ue = u + (size_t)e * nx * S + y * nz;  // row y of each x-plane
  const float* vy = v + (size_t)e * nx * S + y * nz;
  const float* vp = v + (size_t)e * nx * S + yp * nz;
  const float* we = w + (size_t)e * nx * SW + y * nw;
  float* out = div_out + ((size_t)e * ny + y) * nx * nz;
  const int lane = threadIdx.x & 31, points = nx * lanes;
  for (int q0 = 0; q0 < points; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x, x = q / lanes, k = (q - x * lanes) * kL;
    const bool live = q < points;
    const int xp = x + 1 < nx ? x + 1 : 0;
    // the lane lanes further on holds column x + 1 unless it is in the next
    // warp or column x + 1 wraps to 0
    const bool own_xp = lane + lanes >= 32 || x + 1 >= nx;
    float uc[kL], un[kL], dv[kL], wc[kL + 1];
    if (live) {
      if constexpr (NZ > 0) {
        const float4 a = *reinterpret_cast<const float4*>(ue + x * S + k);
        const float4 b = *reinterpret_cast<const float4*>(vy + x * S + k);
        const float4 c = *reinterpret_cast<const float4*>(vp + x * S + k);
        uc[0] = a.x, uc[1] = a.y, uc[2] = a.z, uc[3] = a.w;
        dv[0] = c.x - b.x, dv[1] = c.y - b.y, dv[2] = c.z - b.z, dv[3] = c.w - b.w;
        if (own_xp) {
          const float4 n = *reinterpret_cast<const float4*>(ue + xp * S + k);
          un[0] = n.x, un[1] = n.y, un[2] = n.z, un[3] = n.w;
        }
      } else {
        uc[0] = ue[x * S + k];
        dv[0] = vp[x * S + k] - vy[x * S + k];
        if (own_xp) un[0] = ue[xp * S + k];
      }
      const float* wk = we + x * SW + k;  // a run of kL + 1 levels
#pragma unroll
      for (int l = 0; l <= kL; ++l) wc[l] = wk[l];
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const float t = __shfl_down_sync(0xffffffffu, uc[l], lanes);
      if (!own_xp) un[l] = t;
    }
    if (live) {
      float d[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        d[l] = ((un[l] - uc[l]) * idx + dv[l] * idy) + (wc[l + 1] - wc[l]) * idz;
      }
      if constexpr (NZ > 0) {
        *reinterpret_cast<float4*>(out + x * nz + k) = make_float4(d[0], d[1], d[2], d[3]);
      } else {
        out[x * nz + k] = d[0];
      }
    }
  }
}

// K7's instance (vector where nz is 16 or 32 and the pointers it loads and
// stores as float4 are 16-byte aligned) and its threads a block.
struct DivLaunch {
  decltype(&div_3d_kernel<0>) kernel;
  int threads;
};
DivLaunch div_launch(int nx, int nz, bool aligned) {
  const bool vec = aligned && (nz == 16 || nz == 32);
  const int points = nx * (vec ? nz / kDivVec : nz);
  return {!vec ? div_3d_kernel<0> : (nz == 16 ? div_3d_kernel<16> : div_3d_kernel<32>),
          min(kDivThreads, (points + 31) / 32 * 32)};
}

}  // namespace

extern "C" {

int launch_stage_rk_3d(const float* u, const float* v, const float* w, const float* b,
                       const float* q, const float* bottom, const float* gu_prev,
                       const float* gv_prev, const float* gw_prev, const float* gb_prev,
                       float* u_out, float* v_out, float* w_out, float* b_out,
                       float* div_out, float* gu, float* gv, float* gw, float* gb,
                       int n_env, int nx, int ny, int nz, int stage, float dt,
                       float gamma, float zeta, float dx, float dy, float dz, float nu,
                       float kappa, float min_b, void* stream) {
  const bool reads_g = gu_prev && gv_prev && gw_prev && gb_prev;
  const bool writes_g = gu && gv && gw && gb;
  const size_t smem = sizeof(float) * stage_smem_floats(ny, nz);
  if (nx < kXYMinNx || ny < 4 || nz < 2 || march_threads(nz, ny) > kMaxThreads ||
      smem > kSmemPerBlock || stage < 0 || stage > 2 || reads_g != (stage > 0) ||
      writes_g != (stage < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel = stage_kernel_for(ny, nz);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const XYParams P = xy_params(nx, ny, nz, dx, dy, dz, nu, kappa, min_b);
  kernel<<<n_env, march_threads(nz, ny), smem, (cudaStream_t)stream>>>(
      u, v, w, b, q, bottom, gu_prev, gv_prev, gw_prev, gb_prev, u_out, v_out, w_out,
      b_out, div_out, gu, gv, gw, gb, dt, gamma, zeta, P, nullptr);
  return (int)cudaGetLastError();
}

// K3's analysis instance: launch_stage_rk_3d's arguments with rhat (E, ny,
// nx nz) in place of div and, last before the stream, Fx (nx, nx) and
// Cz^T (nz, nz) in one buffer.
int launch_stage_rk_3d_rhat(const float* u, const float* v, const float* w, const float* b,
                            const float* q, const float* bottom, const float* gu_prev,
                            const float* gv_prev, const float* gw_prev, const float* gb_prev,
                            float* u_out, float* v_out, float* w_out, float* b_out,
                            float* rhat_out, float* gu, float* gv, float* gw, float* gb,
                            int n_env, int nx, int ny, int nz, int stage, float dt,
                            float gamma, float zeta, float dx, float dy, float dz, float nu,
                            float kappa, float min_b, const float* analysis, void* stream) {
  const bool reads_g = gu_prev && gv_prev && gw_prev && gb_prev;
  const bool writes_g = gu && gv && gw && gb;
  const size_t smem = sizeof(float) * stage_qp_smem_floats(nx, ny, nz);
  if (nx < kXYMinNx || ny < 4 || nz < 2 || march_threads(nz, ny) > kMaxThreads ||
      smem > kSmemPerBlock || stage < 0 || stage > 2 || reads_g != (stage > 0) ||
      writes_g != (stage < 2) || analysis == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel = stage_qp_kernel_for(ny, nz);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const XYParams P = xy_params(nx, ny, nz, dx, dy, dz, nu, kappa, min_b);
  kernel<<<n_env, march_threads(nz, ny), smem, (cudaStream_t)stream>>>(
      u, v, w, b, q, bottom, gu_prev, gv_prev, gw_prev, gb_prev, u_out, v_out, w_out,
      b_out, rhat_out, gu, gv, gw, gb, dt, gamma, zeta, P, analysis);
  return (int)cudaGetLastError();
}

// What K3 (rhat = 0) or its analysis instance (rhat = 1) asks of an SM on
// the grid, for the instance its launcher picks: out[0] resident blocks an
// SM at its threads and shared memory, out[1] registers a thread, out[2]
// local memory a thread (stack frame, spills included), out[3] shared
// memory a block in bytes.
int march_occupancy(int rhat, int nx, int ny, int nz, int* out) {
  auto* kernel = rhat ? stage_qp_kernel_for(ny, nz) : stage_kernel_for(ny, nz);
  const size_t smem =
      sizeof(float) * (rhat ? stage_qp_smem_floats(nx, ny, nz) : stage_smem_floats(ny, nz));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, march_threads(nz, ny),
                                                      smem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  return (int)err;
}

int launch_stage_rk_3d_xy(const float* u, const float* v, const float* w, const float* b,
                          const float* q, const float* bottom, const float* gu_prev,
                          const float* gv_prev, const float* gw_prev, const float* gb_prev,
                          float* u_out, float* v_out, float* w_out, float* b_out,
                          float* div_out, float* gu, float* gv, float* gw, float* gb,
                          int n_env, int nx, int ny, int nz, int stage, float dt,
                          float gamma, float zeta, float dx, float dy, float dz, float nu,
                          float kappa, float min_b, void* stream) {
  const bool reads_g = gu_prev && gv_prev && gw_prev && gb_prev;
  const bool writes_g = gu && gv && gw && gb;
  const int csplit = nz >= 2 ? stage_xy_split_size(nz) : 0;
  const size_t smem = sizeof(float) * (csplit > 0 ? stage_xy_split_smem_floats(nz, csplit)
                                                  : stage_xy_smem_floats(nz));
  if (nx < kXYMinNx || ny % kYT != 0 || ny < kYT || nz < 2 || smem > kSmemPerBlock ||
      stage < 0 || stage > 2 || reads_g != (stage > 0) || writes_g != (stage < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const XYParams P = xy_params(nx, ny, nz, dx, dy, dz, nu, kappa, min_b);
  const unsigned blocks = (unsigned)n_env * (ny / kYT);
  if (csplit > 0) {  // the z split: a cluster of csplit CTAs for each block
    auto* kernel = stage_xy_split_kernel();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)csplit;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks * (unsigned)csplit);
    config.blockDim = dim3((unsigned)split_threads(nz, csplit));
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    config.attrs = cluster;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, u, v, w, b, q, bottom, gu_prev, gv_prev, gw_prev,
                             gb_prev, u_out, v_out, w_out, b_out, div_out, gu, gv, gw, gb, dt,
                             gamma, zeta, P, (const float*)nullptr);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  auto* kernel = stage_xy_kernel_for(nz);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, march_threads(nz, -1), smem, (cudaStream_t)stream>>>(
      u, v, w, b, q, bottom, gu_prev, gv_prev, gw_prev, gb_prev, u_out, v_out, w_out,
      b_out, div_out, gu, gv, gw, gb, dt, gamma, zeta, P, nullptr);
  return (int)cudaGetLastError();
}

// What the card gives the K5 instance its launcher picks for a column of
// nz levels: out[0] the instance (0 one CTA a block, 1 the z split), out[1]
// CTAs a cluster (1 off the split), out[2] blocks resident on an SM, out[3]
// clusters resident on the card at once (cudaOccupancyMaxActiveClusters; 0
// off the split), out[4] registers a thread, out[5] local memory a thread
// (stack and spills), bytes, out[6] dynamic shared memory a block, bytes.
int stage_xy_occupancy(int nz, int* out) {
  const int csplit = nz >= 2 ? stage_xy_split_size(nz) : 0;
  const size_t smem = sizeof(float) * (csplit > 0 ? stage_xy_split_smem_floats(nz, csplit)
                                                  : stage_xy_smem_floats(nz));
  if (nz < 2 || smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  auto* kernel = csplit > 0 ? stage_xy_split_kernel() : stage_xy_kernel_for(nz);
  const int threads = csplit > 0 ? split_threads(nz, csplit) : march_threads(nz, -1);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (csplit > 0) {
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)csplit;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)csplit);
    config.blockDim = dim3((unsigned)threads);
    config.dynamicSmemBytes = smem;
    config.attrs = cluster;
    config.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &config);
    if (err != cudaSuccess) return (int)err;
  }
  const int rec[7] = {csplit > 0, csplit > 0 ? csplit : 1, blocks, clusters, attr.numRegs,
                      (int)attr.localSizeBytes, (int)smem};
  for (int i = 0; i < 7; ++i) out[i] = rec[i];
  return 0;
}

int launch_correct_3d(const float* u, const float* v, const float* w, const float* q,
                      float* u_out, float* v_out, float* w_out, int n_env, int nx,
                      int ny, int nz, float dx, float dy, float dz, void* stream) {
  const size_t n = (size_t)n_env * nx * ny * (nz + 1);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  correct_3d_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      u, v, w, q, u_out, v_out, w_out, n_env, nx, ny, nz, dx, dy, dz);
  return (int)cudaGetLastError();
}

int launch_field_tendency_3d(int field, const float* u, const float* v, const float* w,
                             const float* b, const float* bottom, float* g, int n_env,
                             int nx, int ny, int nz, float dx, float dy, float dz, float nu,
                             float kappa, float min_b, void* stream) {
  if (field < kFieldU || field > kFieldB || nx < 3 || ny < 3 || nz < 2 ||
      (size_t)nx * ny * (nz + 1) > (size_t)INT_MAX || (b == nullptr) != (field == kFieldW) ||
      (bottom != nullptr) != (field == kFieldB)) {
    return (int)cudaErrorInvalidValue;
  }
  const XYParams P = xy_params(nx, ny, nz, dx, dy, dz, nu, kappa, min_b);
  cudaStream_t st = (cudaStream_t)stream;
  if (field_on_march(nx, ny, nz)) {
    auto* kernel = field == kFieldU   ? field_march_kernel_for<kFieldU>(ny, nz)
                   : field == kFieldV ? field_march_kernel_for<kFieldV>(ny, nz)
                   : field == kFieldW ? field_march_kernel_for<kFieldW>(ny, nz)
                                      : field_march_kernel_for<kFieldB>(ny, nz);
    const size_t smem = sizeof(float) * field_smem_floats(ny, nz);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    float* gs[4] = {nullptr, nullptr, nullptr, nullptr};
    gs[field] = g;  // the march writes a field's tendency to that field's g
    kernel<<<n_env, march_threads(nz, ny), smem, st>>>(
        u, v, w, b, nullptr, bottom, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, nullptr, gs[0], gs[1], gs[2], gs[3], 0.0f, 0.0f, 0.0f, P, nullptr);
    return (int)cudaGetLastError();
  }
  const int per_env = nx * ny * (field == kFieldW ? nz + 1 : nz);
  const int blocks_per_env = (per_env + kThreads - 1) / kThreads;
  auto* kernel = field == kFieldU   ? field_tendency_3d_kernel<kFieldU>
                 : field == kFieldV ? field_tendency_3d_kernel<kFieldV>
                 : field == kFieldW ? field_tendency_3d_kernel<kFieldW>
                                    : field_tendency_3d_kernel<kFieldB>;
  kernel<<<(unsigned)n_env * blocks_per_env, kThreads, 0, st>>>(u, v, w, b, bottom, g,
                                                                 blocks_per_env, P);
  return (int)cudaGetLastError();
}

int launch_div_3d(const float* u, const float* v, const float* w, float* div_out, int n_env,
                  int nx, int ny, int nz, float dx, float dy, float dz, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || (size_t)nx * ny * (nz + 1) > (size_t)INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const bool aligned = ((uintptr_t)u | (uintptr_t)v | (uintptr_t)div_out) % 16 == 0;
  const DivLaunch L = div_launch(nx, nz, aligned);
  L.kernel<<<(unsigned)n_env * ny, L.threads, 0, (cudaStream_t)stream>>>(
      u, v, w, div_out, nx, ny, nz, (float)(1.0 / dx), (float)(1.0 / dy), (float)(1.0 / dz));
  return (int)cudaGetLastError();
}

}  // extern "C"
