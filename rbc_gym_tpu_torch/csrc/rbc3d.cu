// Hopper kernels of the 3D RBC env step, bound through a plain C ABI.
//
// K3 stage_rk_3d_kernel replaces rbc_gym_tpu/ops/pallas3d.py:_stage_rk_kernel
// (reached from make_stage_rk_3d, pl.pallas_call at :1190): one RK3 stage of
// the lazy-projection loop. It corrects the previous stage's unprojected
// u, v, w by grad q (q: the Poisson solve of their unscaled divergence),
// computes pHY' from b, the four UB5 tendencies gu, gv, gw, gb, the RK update
// f* = f + dt (gamma g + zeta g_prev) and div(u*, v*, w*) for the next solve.
// Stage 0 reads no g_prev; stage 2 writes no g.
//   Bound: bytes. Per env and stage it reads u, v, w, b, q, bottom (and
//   g_prev at stages 1-2) and writes u*, v*, w*, b', div (and g at stages
//   0-1): about 1.2 MB at 16x32x32, against some 380 FLOP per cell.
//   Design: one block per (env, x block of kXBlk = 4 columns); the block
//   holds full y (periodic, wrapped inside the block) and full z. The TPU
//   kernel's batch-minor (x, z, y, E) layout fills 128 lanes with envs and
//   has no counterpart here: the fields stay in the public batch-major
//   (E, nx, ny, nz[+1]) layout, where an (env, x) column is one contiguous
//   ny * nz[+1] run, and div and q are in the solve layout (E, ny, nx, nz)
//   of ops/poisson.make_poisson_solver_3d. Phases, separated by barriers:
//   1. stage x-extended slabs in shared memory: u with 3 halo columns left
//      and 4 right, v, w, b with 3 and 3, q with 4 and 4 (the Pallas
//      kernel's _HALO views, pallas3d.py:684-702);
//   2. correct u, v, w in place (u needs q one column further left);
//   3. pHY' per (x, y) column for x in [-1, kXBlk], a sequential suffix sum
//      along z by one thread, into q's space (q is no longer read);
//   4. per output point, its tendency from the slabs and its RK update,
//      written to global memory; gu and u* are computed one column wider,
//      and u* at the block's right face is kept in shared memory (the
//      Pallas kernel's gu scratch and gp_u_edge view, :776-798);
//   5. div from u*, v*, w* read back from this block's own writes.
//   Each output point is computed from the slabs alone (a face flux is
//   recomputed on both of its cells), so a phase walks its points in any
//   order; consecutive threads take consecutive z. At 16x32x32 the slabs
//   take 109,824 bytes of shared memory, so two 256-thread blocks share an
//   SM. A narrower block fits no third one (kXBlk = 2 needs 89,088 bytes)
//   and stages each field column more often (4.3 times against 2.65).
//   Plain float32 loads and stores, FP32 FMA; making it fast (cp.async or
//   TMA staging, occupancy) is later work.
//
// K5 stage_rk_3d_xy_kernel replaces ops/pallas3d.py:_stage_rk_kernel_xy
// (reached from make_stage_rk_3d_xy, pl.pallas_call at :1592): K3's stage,
// with K3's contract and layouts, on (x, y)-blocked slabs, for grids whose
// whole-y slab does not fit a block's 232,448 bytes of shared memory (the
// 32x64x64 big grid needs 436,736 in K3).
//   Bound: bytes, as K3. At 32x64x64 it moves 7.4 MB per env at stages 0
//   and 2 and 9.5 MB at stage 1, against some 400 FLOP per cell.
//   Design: one block per (env, kXBlk = 4 x columns, kYBlk = 8 y rows),
//   full z in every column. y halos are staged from global memory with
//   periodic wrap, as K3 stages x: q with 4 rows on each side, v with 3
//   below and 4 above (v* is computed one row wider for the divergence at
//   the far y face, the Pallas kernel's gv scratch of y_blk + 1 rows), u,
//   w, b with 3 and 3; no y index wraps inside the block. u* at the right
//   x face and v* at the far y face stay in shared memory for phase 5. The
//   phases and the tendency code are K3's (the Slab types differ only in
//   how y is indexed). At nz = 32 the slabs take 99,888 bytes, so two
//   256-thread blocks share an SM. The halos cost bytes that the bound does
//   not count: the block stages 4.85 times the cells it owns (K3 at
//   16x32x32: 2.65). The Pallas kernel's _YH = 8 (the TPU's sublane
//   tiling), e_blk and XLA-side padding have no counterpart. Plain float32
//   loads and FP32 FMA; making it fast is later work.
//
// K4 correct_3d_kernel replaces ops/pallas3d.py:_correct_kernel (reached
// from make_projection_glue_3d, pl.pallas_call at :959): u -= ddx q,
// v -= ddy q, w -= ddz q at interior faces, once per env step after the
// last stage of the lazy loop, and after every stage of the per-field path.
// Bound: bytes (u, v, w, q in; u, v, w out). Design: one thread per w
// point, which also does the u and v point of the same cell.
//
// K6 field_tendency_3d_kernel replaces ops/pallas3d.py:_field_stage_kernel
// (reached from make_field_stage_3d, pl.pallas_call at :1694): one field's
// UB5 tendency (u, v, w or b; four launches a stage) of the per-field path,
// without the RK update, which runs in PyTorch as it runs in XLA there.
//   Bound: bytes. It reads u, v, w and the field's own input (pHY' for u
//   and v, b and bottom for b) and writes g: about 330 KB per env at
//   16x32x32 against some 90 FLOP per point.
//   Design: one thread per output point in the public batch-major layout
//   (z fastest, so a warp reads and writes runs of consecutive z), reading
//   its taps straight from global memory, where L1 and L2 catch the reuse
//   of neighbouring threads. The tendency code is K3's: GlobalField is a
//   third slab type for the same templates, which wraps x and y
//   periodically. So K6 computes the flux form (C6 - |v| D5/60) where the
//   Pallas kernel selects a one-sided UB5 stencil by the sign of the
//   velocity; the two are the same reconstruction and differ in float32
//   rounding only (pallas3d.py:185-186). No shared memory, so no grid is
//   too large for a block; offsets are 64-bit. The Pallas kernel's env
//   slabs (e_blk lanes) have no counterpart. Plain float32 loads and FP32
//   FMA; staging tiles in shared memory is later work.
//
// K7 div_3d_kernel replaces ops/pallas3d.py:_div_kernel (reached from
// make_projection_glue_3d, pl.pallas_call at :947): the staggered
// div(u, v, w) at cell centers, once a stage on the per-field path.
// Bound: bytes (u, v, w in, div out). Design: one thread per output point,
// written straight into the solve layout (E, ny, nx, nz) that the Poisson
// solve reads, as K3 and K5 emit theirs; the reads of u and v are runs of
// nz consecutive floats.
#include <cuda_runtime.h>

#include "ub5.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kXBlk = 4;  // x columns a K3 or K5 block owns
constexpr int kYBlk = 8;  // y rows a K5 block owns

struct RBC3DParams {
  int nx, ny, nz;
  float dx, dy, dz, nu, kappa, min_b;
};

// An x-extended slab in shared memory that holds all of periodic y (K3):
// columns x = lo, lo + 1, ... (x relative to the block's first column),
// each ny rows of nk z values; y neighbours and y taps wrap in the slab.
struct Slab {
  float* p;
  int lo, ny, nk;
  __device__ __forceinline__ float* col(int x, int y) const {
    return p + ((x - lo) * ny + y) * nk;
  }
  __device__ __forceinline__ float operator()(int x, int y, int k) const {
    return col(x, y)[k];
  }
  __device__ __forceinline__ int yp(int j) const { return wrap_x(j + 1, ny); }
  __device__ __forceinline__ int ym(int j) const { return wrap_x(j - 1, ny); }
  // vel * UB5 reconstruction along periodic y at row j + m of column x.
  __device__ __forceinline__ float flux_y(int x, int j, int k, int m, float vel) const {
    return uw_flux_periodic(col(x, 0) + k, nk, ny, j, m, vel);
  }
};

// An (x, y)-extended slab (K5): columns x = lo, lo + 1, ... and rows
// y = ylo, ..., ylo + ny - 1, both relative to the block's first column
// and row, halos included, so no y neighbour or tap wraps.
struct SlabXY {
  float* p;
  int lo, ylo, ny, nk;
  __device__ __forceinline__ float* col(int x, int y) const {
    return p + ((x - lo) * ny + (y - ylo)) * nk;
  }
  __device__ __forceinline__ float operator()(int x, int y, int k) const {
    return col(x, y)[k];
  }
  __device__ __forceinline__ int yp(int j) const { return j + 1; }
  __device__ __forceinline__ int ym(int j) const { return j - 1; }
  __device__ __forceinline__ float flux_y(int x, int j, int k, int m, float vel) const {
    return uw_flux_strided(col(x, 0) + k, nk, j, m, vel);
  }
};

// One env's field (nx, ny, nk) in global memory, the public layout (K6):
// x and y wrap periodically (taps reach 3 points past either end, so
// nx, ny >= 3).
struct GlobalField {
  const float* p;
  int nx, ny, nk;
  __device__ __forceinline__ const float* col(int x, int y) const {
    return p + ((size_t)wrap_x(x, nx) * ny + wrap_x(y, ny)) * nk;
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

// The tendencies below take any of the three slab types: x wraps only in a
// GlobalField, y goes through the slab's yp/ym/flux_y.

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
                                       const RBC3DParams& P) {
  const int jm = q.ym(j), jp = q.yp(j);
  return (q(i + 1, j, k) - 2.0f * c + q(i - 1, j, k)) / (P.dx * P.dx) +
         (q(i, jp, k) - 2.0f * c + q(i, jm, k)) / (P.dy * P.dy);
}

// gu at (x-face i, y-center j, z-center k).
template <class S>
__device__ float tendency_u(const S& U, const S& V, const S& W, const S& PH,
                            int i, int j, int k, const RBC3DParams& P) {
  const int nz = P.nz, jp = U.yp(j);
  const float uc_i = 0.5f * (U(i, j, k) + U(i + 1, j, k));
  const float uc_im = 0.5f * (U(i - 1, j, k) + U(i, j, k));
  float adv = (flux_x(U, i, j, k, 1, uc_i) - flux_x(U, i - 1, j, k, 1, uc_im)) / P.dx;
  const float vf_j = 0.5f * (V(i - 1, j, k) + V(i, j, k));
  const float vf_jp = 0.5f * (V(i - 1, jp, k) + V(i, jp, k));
  adv += (U.flux_y(i, j + 1, k, 0, vf_jp) - U.flux_y(i, j, k, 0, vf_j)) / P.dy;
  const float wf_k = 0.5f * (W(i - 1, j, k) + W(i, j, k));
  const float wf_kp = 0.5f * (W(i - 1, j, k + 1) + W(i, j, k + 1));
  const float* uc = U.col(i, j);
  adv += (z_uw_flux(uc, nz, k + 1, 0, wf_kp) - z_uw_flux(uc, nz, k, 0, wf_k)) / P.dz;
  const float dphy = (PH(i, j, k) - PH(i - 1, j, k)) / P.dx;
  const float q = uc[k];
  const float qm = k > 0 ? uc[k - 1] : -uc[0];  // no-slip ghost: 2 * 0 - q0
  const float qp = k < nz - 1 ? uc[k + 1] : -uc[nz - 1];
  const float lap = lap_h(U, i, j, k, q, P) + (qp - 2.0f * q + qm) / (P.dz * P.dz);
  return -adv - dphy + P.nu * lap;
}

// gv at (x-center i, y-face j, z-center k).
template <class S>
__device__ float tendency_v(const S& U, const S& V, const S& W, const S& PH,
                            int i, int j, int k, const RBC3DParams& P) {
  const int nz = P.nz, jm = V.ym(j), jp = V.yp(j);
  const float uf_i = 0.5f * (U(i, jm, k) + U(i, j, k));
  const float uf_ip = 0.5f * (U(i + 1, jm, k) + U(i + 1, j, k));
  float adv = (flux_x(V, i + 1, j, k, 0, uf_ip) - flux_x(V, i, j, k, 0, uf_i)) / P.dx;
  const float vc_j = 0.5f * (V(i, j, k) + V(i, jp, k));
  const float vc_jm = 0.5f * (V(i, jm, k) + V(i, j, k));
  adv += (V.flux_y(i, j, k, 1, vc_j) - V.flux_y(i, j - 1, k, 1, vc_jm)) / P.dy;
  const float wf_k = 0.5f * (W(i, jm, k) + W(i, j, k));
  const float wf_kp = 0.5f * (W(i, jm, k + 1) + W(i, j, k + 1));
  const float* vc = V.col(i, j);
  adv += (z_uw_flux(vc, nz, k + 1, 0, wf_kp) - z_uw_flux(vc, nz, k, 0, wf_k)) / P.dz;
  const float dphy = (PH(i, j, k) - PH(i, jm, k)) / P.dy;
  const float q = vc[k];
  const float qm = k > 0 ? vc[k - 1] : -vc[0];
  const float qp = k < nz - 1 ? vc[k + 1] : -vc[nz - 1];
  const float lap = lap_h(V, i, j, k, q, P) + (qp - 2.0f * q + qm) / (P.dz * P.dz);
  return -adv - dphy + P.nu * lap;
}

// gw at (x-center i, y-center j, z-face k); zero on the wall faces.
template <class S>
__device__ float tendency_w(const S& U, const S& V, const S& W, int i, int j,
                            int k, const RBC3DParams& P) {
  const int nz = P.nz, jp = W.yp(j);
  if (k == 0 || k == nz) return 0.0f;
  const float uf_i = 0.5f * (U(i, j, k - 1) + U(i, j, k));
  const float uf_ip = 0.5f * (U(i + 1, j, k - 1) + U(i + 1, j, k));
  float adv = (flux_x(W, i + 1, j, k, 0, uf_ip) - flux_x(W, i, j, k, 0, uf_i)) / P.dx;
  const float vf_j = 0.5f * (V(i, j, k - 1) + V(i, j, k));
  const float vf_jp = 0.5f * (V(i, jp, k - 1) + V(i, jp, k));
  adv += (W.flux_y(i, j + 1, k, 0, vf_jp) - W.flux_y(i, j, k, 0, vf_j)) / P.dy;
  const float* wc = W.col(i, j);
  const float wc_k = 0.5f * (wc[k] + wc[k + 1]);
  const float wc_km = 0.5f * (wc[k - 1] + wc[k]);
  adv += (z_uw_flux(wc, nz + 1, k, 1, wc_k) - z_uw_flux(wc, nz + 1, k - 1, 1, wc_km)) / P.dz;
  const float q = wc[k];
  const float lap = lap_h(W, i, j, k, q, P) + (wc[k + 1] - 2.0f * q + wc[k - 1]) / (P.dz * P.dz);
  return -adv + P.nu * lap;
}

// gb at (x-center i, y-center j, z-center k); Dirichlet bottom and min_b.
template <class S>
__device__ float tendency_b(const S& U, const S& V, const S& W, const S& B,
                            float bottom, int i, int j, int k, const RBC3DParams& P) {
  const int nz = P.nz, jp = B.yp(j);
  float adv = (flux_x(B, i + 1, j, k, 0, U(i + 1, j, k)) - flux_x(B, i, j, k, 0, U(i, j, k))) / P.dx;
  adv += (B.flux_y(i, j + 1, k, 0, V(i, jp, k)) - B.flux_y(i, j, k, 0, V(i, j, k))) / P.dy;
  const float* bc = B.col(i, j);
  adv += (z_uw_flux(bc, nz, k + 1, 0, W(i, j, k + 1)) - z_uw_flux(bc, nz, k, 0, W(i, j, k))) / P.dz;
  const float q = bc[k];
  const float qm = k > 0 ? bc[k - 1] : 2.0f * bottom - bc[0];
  const float qp = k < nz - 1 ? bc[k + 1] : 2.0f * P.min_b - bc[nz - 1];
  const float lap = lap_h(B, i, j, k, q, P) + (qp - 2.0f * q + qm) / (P.dz * P.dz);
  return -adv + P.kappa * lap;
}

// f + dt (gamma g + zeta g_prev); stage 0 has no g_prev.
__device__ __forceinline__ float rk_update(float f, float g, const float* gp, size_t idx,
                                           float dt, float gamma, float zeta) {
  return gp == nullptr ? f + dt * (gamma * g) : f + dt * (gamma * g + zeta * gp[idx]);
}

// pHY'[k] = -sum_{j >= k} inc[j] of one column, walked from the top (the
// order of solver3d's suffix sum).
__device__ __forceinline__ void hydrostatic_column(const float* bc, float* pc,
                                                   const RBC3DParams& P) {
  const int nz = P.nz;
  float acc = 0.5f * P.dz * P.min_b;
  pc[nz - 1] = -acc;
  for (int k = nz - 2; k >= 0; --k) {
    acc += P.dz * (0.5f * (bc[k] + bc[k + 1]));
    pc[k] = -acc;
  }
}

// Copy columns lo .. lo + n_cols - 1 (block-relative, periodic in x) of one
// env's public-layout field into a slab.
__device__ void load_columns(const float* __restrict__ src, float* dst, int x0, int lo,
                             int n_cols, int nx, int col_len) {
  for (int idx = threadIdx.x; idx < n_cols * col_len; idx += blockDim.x) {
    const int c = idx / col_len, r = idx - c * col_len;
    dst[idx] = src[(size_t)wrap_x(x0 + lo + c, nx) * col_len + r];
  }
}

// Shared memory K3 needs per block, in floats: q (kXBlk + 8 columns), u
// (kXBlk + 7), v and b (kXBlk + 6 each) of ny * nz; w (kXBlk + 6) of
// ny * (nz + 1).
size_t stage_smem_floats(int ny, int nz) {
  return (size_t)(4 * kXBlk + 27) * ny * nz + (size_t)(kXBlk + 6) * ny * (nz + 1);
}

__global__ void __launch_bounds__(kThreads, 2)
stage_rk_3d_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                   const float* __restrict__ w_in, const float* __restrict__ b_in,
                   const float* __restrict__ q_in, const float* __restrict__ bottom_in,
                   const float* gu_prev, const float* gv_prev, const float* gw_prev,
                   const float* gb_prev, float* u_out, float* v_out, float* w_out,
                   float* b_out, float* div_out, float* gu_out, float* gv_out,
                   float* gw_out, float* gb_out, float dt, float gamma, float zeta,
                   RBC3DParams P) {
  extern __shared__ float smem[];
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int S = ny * nz, SW = ny * (nz + 1);
  const int nxb = nx / kXBlk;
  const size_t e = blockIdx.x / nxb;
  const int x0 = (blockIdx.x - (int)e * nxb) * kXBlk;

  Slab Q{smem, -4, ny, nz};
  Slab U{Q.p + (kXBlk + 8) * S, -3, ny, nz};
  Slab V{U.p + (kXBlk + 7) * S, -3, ny, nz};
  Slab B{V.p + (kXBlk + 6) * S, -3, ny, nz};
  Slab W{B.p + (kXBlk + 6) * S, -3, ny, nz + 1};
  Slab PH{Q.p, -1, ny, nz};          // phase 3 on: pHY' over x in [-1, kXBlk]
  float* u_edge = Q.p + (kXBlk + 2) * S;  // phase 4 on: u* at x = kXBlk

  // ---- 1. stage the slabs ---------------------------------------------------
  const size_t cell0 = e * nx * S, face0 = e * nx * SW;
  load_columns(u_in + cell0, U.p, x0, U.lo, kXBlk + 7, nx, S);
  load_columns(v_in + cell0, V.p, x0, V.lo, kXBlk + 6, nx, S);
  load_columns(b_in + cell0, B.p, x0, B.lo, kXBlk + 6, nx, S);
  load_columns(w_in + face0, W.p, x0, W.lo, kXBlk + 6, nx, SW);
  {  // q is (E, ny, nx, nz): per y row, the block's columns are one run
    const int n_cols = kXBlk + 8;
    const float* qe = q_in + e * (size_t)ny * nx * nz;
    for (int idx = threadIdx.x; idx < ny * n_cols * nz; idx += blockDim.x) {
      const int k = idx % nz, t = idx / nz;
      const int c = t % n_cols, y = t / n_cols;
      Q.p[(c * ny + y) * nz + k] = qe[((size_t)y * nx + wrap_x(x0 + Q.lo + c, nx)) * nz + k];
    }
  }
  __syncthreads();

  // ---- 2. lazy-projection correction -----------------------------------------
  for (int idx = threadIdx.x; idx < (kXBlk + 7) * S; idx += blockDim.x) {
    const int x = idx / S + U.lo, r = idx % S;
    U.p[idx] -= (Q.col(x, 0)[r] - Q.col(x - 1, 0)[r]) / P.dx;
  }
  for (int idx = threadIdx.x; idx < (kXBlk + 6) * S; idx += blockDim.x) {
    const int x = idx / S + V.lo, r = idx % S, y = r / nz, k = r % nz;
    V.p[idx] -= (Q(x, y, k) - Q(x, wrap_x(y - 1, ny), k)) / P.dy;
  }
  for (int idx = threadIdx.x; idx < (kXBlk + 6) * SW; idx += blockDim.x) {
    const int x = idx / SW + W.lo, r = idx % SW, y = r / (nz + 1), k = r % (nz + 1);
    if (k > 0 && k < nz) W.p[idx] -= (Q(x, y, k) - Q(x, y, k - 1)) / P.dz;
  }
  __syncthreads();

  // ---- 3. pHY' per (x, y) column ---------------------------------------------
  for (int t = threadIdx.x; t < (kXBlk + 2) * ny; t += blockDim.x) {
    const int x = t / ny + PH.lo, y = t % ny;
    hydrostatic_column(B.col(x, y), PH.col(x, y), P);
  }
  __syncthreads();

  // ---- 4. tendencies and RK update ------------------------------------------
  const bool emit_g = gu_out != nullptr;
  for (int idx = threadIdx.x; idx < (kXBlk + 1) * S; idx += blockDim.x) {
    const int i = idx / S, r = idx % S, j = r / nz, k = r % nz;
    const float g = tendency_u(U, V, W, PH, i, j, k, P);
    const size_t o = cell0 + (size_t)wrap_x(x0 + i, nx) * S + r;
    const float f = rk_update(U(i, j, k), g, gu_prev, o, dt, gamma, zeta);
    if (i == kXBlk) {
      u_edge[r] = f;
    } else {
      u_out[o] = f;
      if (emit_g) gu_out[o] = g;
    }
  }
  for (int idx = threadIdx.x; idx < kXBlk * S; idx += blockDim.x) {
    const int i = idx / S, r = idx % S, j = r / nz, k = r % nz;
    const size_t o = cell0 + (size_t)(x0 + i) * S + r;
    const float g = tendency_v(U, V, W, PH, i, j, k, P);
    v_out[o] = rk_update(V(i, j, k), g, gv_prev, o, dt, gamma, zeta);
    if (emit_g) gv_out[o] = g;
  }
  for (int idx = threadIdx.x; idx < kXBlk * SW; idx += blockDim.x) {
    const int i = idx / SW, r = idx % SW, j = r / (nz + 1), k = r % (nz + 1);
    const size_t o = face0 + (size_t)(x0 + i) * SW + r;
    const float g = tendency_w(U, V, W, i, j, k, P);
    // wall faces: W, g and g_prev are all 0, so w* stays exactly 0 there
    w_out[o] = rk_update(W(i, j, k), g, gw_prev, o, dt, gamma, zeta);
    if (emit_g) gw_out[o] = g;
  }
  for (int idx = threadIdx.x; idx < kXBlk * S; idx += blockDim.x) {
    const int i = idx / S, r = idx % S, j = r / nz, k = r % nz;
    const size_t o = cell0 + (size_t)(x0 + i) * S + r;
    const float bottom = bottom_in[(e * nx + x0 + i) * ny + j];
    const float g = tendency_b(U, V, W, B, bottom, i, j, k, P);
    b_out[o] = rk_update(B(i, j, k), g, gb_prev, o, dt, gamma, zeta);
    if (emit_g) gb_out[o] = g;
  }
  __syncthreads();  // this block's u*, v*, w* writes are visible below

  // ---- 5. div(u*, v*, w*) into the solve layout ------------------------------
  for (int idx = threadIdx.x; idx < kXBlk * S; idx += blockDim.x) {
    const int k = idx % nz, t = idx / nz, i = t % kXBlk, j = t / kXBlk;
    const int x = x0 + i, jp = wrap_x(j + 1, ny);
    const size_t o = cell0 + (size_t)x * S + j * nz + k;
    const float u_ip = i + 1 < kXBlk ? u_out[o + S] : u_edge[j * nz + k];
    const float* wc = w_out + face0 + (size_t)x * SW + j * (nz + 1);
    const float d = (u_ip - u_out[o]) / P.dx +
                    (v_out[cell0 + (size_t)x * S + jp * nz + k] - v_out[o]) / P.dy +
                    (wc[k + 1] - wc[k]) / P.dz;
    div_out[((e * ny + j) * nx + x) * nz + k] = d;
  }
}

// Copy the window of columns lo .. lo + n_cols - 1 and rows ylo .. ylo +
// n_rows - 1 (block-relative, periodic in x and y) of one env's
// public-layout field (nx, ny, nk) into an (x, y)-extended slab.
__device__ void load_window(const float* __restrict__ src, float* dst, int x0, int lo,
                            int n_cols, int nx, int y0, int ylo, int n_rows, int ny,
                            int nk) {
  const int col_len = n_rows * nk;
  for (int idx = threadIdx.x; idx < n_cols * col_len; idx += blockDim.x) {
    const int c = idx / col_len, r = idx - c * col_len;
    const int y = r / nk, k = r - y * nk;
    dst[idx] = src[((size_t)wrap_x(x0 + lo + c, nx) * ny + wrap_x(y0 + ylo + y, ny)) * nk + k];
  }
}

// Shared memory K5 needs per block, in floats: q (kXBlk + 8 columns of
// kYBlk + 8 rows), u (kXBlk + 7 of kYBlk + 6), v (kXBlk + 6 of kYBlk + 7),
// b (kXBlk + 6 of kYBlk + 6) of nz; w (kXBlk + 6 of kYBlk + 6) of nz + 1.
size_t stage_xy_smem_floats(int nz) {
  return (size_t)((kXBlk + 8) * (kYBlk + 8) + (kXBlk + 7) * (kYBlk + 6) +
                  (kXBlk + 6) * (kYBlk + 7) + (kXBlk + 6) * (kYBlk + 6)) * nz +
         (size_t)(kXBlk + 6) * (kYBlk + 6) * (nz + 1);
}

__global__ void __launch_bounds__(kThreads, 2)
stage_rk_3d_xy_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                      const float* __restrict__ w_in, const float* __restrict__ b_in,
                      const float* __restrict__ q_in, const float* __restrict__ bottom_in,
                      const float* gu_prev, const float* gv_prev, const float* gw_prev,
                      const float* gb_prev, float* u_out, float* v_out, float* w_out,
                      float* b_out, float* div_out, float* gu_out, float* gv_out,
                      float* gw_out, float* gb_out, float dt, float gamma, float zeta,
                      RBC3DParams P) {
  extern __shared__ float smem[];
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int S = ny * nz, SW = ny * (nz + 1);
  const int nxb = nx / kXBlk, nyb = ny / kYBlk;
  const size_t e = blockIdx.x / (nxb * nyb);
  const int t_blk = blockIdx.x - (int)e * (nxb * nyb);
  const int x0 = (t_blk / nyb) * kXBlk, y0 = (t_blk % nyb) * kYBlk;

  SlabXY Q{smem, -4, -4, kYBlk + 8, nz};
  SlabXY U{Q.p + (kXBlk + 8) * Q.ny * nz, -3, -3, kYBlk + 6, nz};
  SlabXY V{U.p + (kXBlk + 7) * U.ny * nz, -3, -3, kYBlk + 7, nz};
  SlabXY B{V.p + (kXBlk + 6) * V.ny * nz, -3, -3, kYBlk + 6, nz};
  SlabXY W{B.p + (kXBlk + 6) * B.ny * nz, -3, -3, kYBlk + 6, nz + 1};
  // phase 3 on: pHY' over x in [-1, kXBlk], y in [-1, kYBlk]
  SlabXY PH{Q.p, -1, -1, kYBlk + 2, nz};
  // phase 4 on: u* at x = kXBlk (kYBlk rows) and v* at y = kYBlk (kXBlk columns)
  float* u_edge = Q.p + (kXBlk + 2) * PH.ny * nz;
  float* v_edge = u_edge + kYBlk * nz;

  // ---- 1. stage the slabs ---------------------------------------------------
  const size_t cell0 = e * nx * S, face0 = e * nx * SW;
  load_window(u_in + cell0, U.p, x0, U.lo, kXBlk + 7, nx, y0, U.ylo, U.ny, ny, nz);
  load_window(v_in + cell0, V.p, x0, V.lo, kXBlk + 6, nx, y0, V.ylo, V.ny, ny, nz);
  load_window(b_in + cell0, B.p, x0, B.lo, kXBlk + 6, nx, y0, B.ylo, B.ny, ny, nz);
  load_window(w_in + face0, W.p, x0, W.lo, kXBlk + 6, nx, y0, W.ylo, W.ny, ny, nz + 1);
  {  // q is (E, ny, nx, nz): per y row, the block's columns are one run
    const int n_cols = kXBlk + 8;
    const float* qe = q_in + e * (size_t)ny * nx * nz;
    for (int idx = threadIdx.x; idx < Q.ny * n_cols * nz; idx += blockDim.x) {
      const int k = idx % nz, t = idx / nz;
      const int c = t % n_cols, y = t / n_cols;
      Q.p[(c * Q.ny + y) * nz + k] =
          qe[((size_t)wrap_x(y0 + Q.ylo + y, ny) * nx + wrap_x(x0 + Q.lo + c, nx)) * nz + k];
    }
  }
  __syncthreads();

  // ---- 2. lazy-projection correction -----------------------------------------
  {
    const int cu = U.ny * nz, cv = V.ny * nz, cw = W.ny * (nz + 1);
    for (int idx = threadIdx.x; idx < (kXBlk + 7) * cu; idx += blockDim.x) {
      const int x = idx / cu + U.lo, r = idx % cu, y = r / nz + U.ylo, k = r % nz;
      U.p[idx] -= (Q(x, y, k) - Q(x - 1, y, k)) / P.dx;
    }
    for (int idx = threadIdx.x; idx < (kXBlk + 6) * cv; idx += blockDim.x) {
      const int x = idx / cv + V.lo, r = idx % cv, y = r / nz + V.ylo, k = r % nz;
      V.p[idx] -= (Q(x, y, k) - Q(x, y - 1, k)) / P.dy;
    }
    for (int idx = threadIdx.x; idx < (kXBlk + 6) * cw; idx += blockDim.x) {
      const int x = idx / cw + W.lo, r = idx % cw, y = r / (nz + 1) + W.ylo, k = r % (nz + 1);
      if (k > 0 && k < nz) W.p[idx] -= (Q(x, y, k) - Q(x, y, k - 1)) / P.dz;
    }
  }
  __syncthreads();

  // ---- 3. pHY' per (x, y) column ---------------------------------------------
  for (int t = threadIdx.x; t < (kXBlk + 2) * PH.ny; t += blockDim.x) {
    const int x = t / PH.ny + PH.lo, y = t % PH.ny + PH.ylo;
    hydrostatic_column(B.col(x, y), PH.col(x, y), P);
  }
  __syncthreads();

  // ---- 4. tendencies and RK update ------------------------------------------
  const bool emit_g = gu_out != nullptr;
  const int SB = kYBlk * nz;  // the block's own rows of one column
  for (int idx = threadIdx.x; idx < (kXBlk + 1) * SB; idx += blockDim.x) {
    const int i = idx / SB, r = idx % SB, j = r / nz, k = r % nz;
    const float g = tendency_u(U, V, W, PH, i, j, k, P);
    const size_t o = cell0 + (size_t)wrap_x(x0 + i, nx) * S + (size_t)(y0 + j) * nz + k;
    const float f = rk_update(U(i, j, k), g, gu_prev, o, dt, gamma, zeta);
    if (i == kXBlk) {
      u_edge[r] = f;
    } else {
      u_out[o] = f;
      if (emit_g) gu_out[o] = g;
    }
  }
  const int SV = (kYBlk + 1) * nz;  // v one row wider: v* at the far y face
  for (int idx = threadIdx.x; idx < kXBlk * SV; idx += blockDim.x) {
    const int i = idx / SV, r = idx % SV, j = r / nz, k = r % nz;
    const float g = tendency_v(U, V, W, PH, i, j, k, P);
    const size_t o = cell0 + (size_t)(x0 + i) * S + (size_t)wrap_x(y0 + j, ny) * nz + k;
    const float f = rk_update(V(i, j, k), g, gv_prev, o, dt, gamma, zeta);
    if (j == kYBlk) {
      v_edge[i * nz + k] = f;
    } else {
      v_out[o] = f;
      if (emit_g) gv_out[o] = g;
    }
  }
  const int SBW = kYBlk * (nz + 1);
  for (int idx = threadIdx.x; idx < kXBlk * SBW; idx += blockDim.x) {
    const int i = idx / SBW, r = idx % SBW, j = r / (nz + 1), k = r % (nz + 1);
    const size_t o = face0 + (size_t)(x0 + i) * SW + (size_t)(y0 + j) * (nz + 1) + k;
    const float g = tendency_w(U, V, W, i, j, k, P);
    w_out[o] = rk_update(W(i, j, k), g, gw_prev, o, dt, gamma, zeta);
    if (emit_g) gw_out[o] = g;
  }
  for (int idx = threadIdx.x; idx < kXBlk * SB; idx += blockDim.x) {
    const int i = idx / SB, r = idx % SB, j = r / nz, k = r % nz;
    const size_t o = cell0 + (size_t)(x0 + i) * S + (size_t)(y0 + j) * nz + k;
    const float bottom = bottom_in[(e * nx + x0 + i) * ny + y0 + j];
    const float g = tendency_b(U, V, W, B, bottom, i, j, k, P);
    b_out[o] = rk_update(B(i, j, k), g, gb_prev, o, dt, gamma, zeta);
    if (emit_g) gb_out[o] = g;
  }
  __syncthreads();  // this block's u*, v*, w* writes are visible below

  // ---- 5. div(u*, v*, w*) into the solve layout ------------------------------
  for (int idx = threadIdx.x; idx < kXBlk * SB; idx += blockDim.x) {
    const int k = idx % nz, t = idx / nz, i = t % kXBlk, j = t / kXBlk;
    const int x = x0 + i, y = y0 + j;
    const size_t o = cell0 + (size_t)x * S + (size_t)y * nz + k;
    const float u_ip = i + 1 < kXBlk ? u_out[o + S] : u_edge[j * nz + k];
    const float v_jp = j + 1 < kYBlk ? v_out[o + nz] : v_edge[i * nz + k];
    const float* wc = w_out + face0 + (size_t)x * SW + (size_t)y * (nz + 1);
    const float d = (u_ip - u_out[o]) / P.dx + (v_jp - v_out[o]) / P.dy +
                    (wc[k + 1] - wc[k]) / P.dz;
    div_out[((e * ny + y) * nx + x) * nz + k] = d;
  }
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

enum FieldIndex { kFieldU = 0, kFieldV = 1, kFieldW = 2, kFieldB = 3 };

// aux is pHY' for u and v and b for b; bottom is read for b only.
template <int kField>
__global__ void __launch_bounds__(kThreads)
field_tendency_3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                         const float* __restrict__ w, const float* __restrict__ aux,
                         const float* __restrict__ bottom, float* __restrict__ g,
                         int n_env, RBC3DParams P) {
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int nk = kField == kFieldW ? nz + 1 : nz;
  const size_t n = (size_t)n_env * nx * ny * nk;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int k = p % nk;
  size_t t = p / nk;
  const int j = t % ny;
  t /= ny;
  const int i = t % nx;
  const size_t e = t / nx;
  const size_t cells = (size_t)nx * ny * nz, faces = (size_t)nx * ny * (nz + 1);
  const GlobalField U{u + e * cells, nx, ny, nz}, V{v + e * cells, nx, ny, nz},
      W{w + e * faces, nx, ny, nz + 1};
  float out;
  if constexpr (kField == kFieldU) {
    out = tendency_u(U, V, W, GlobalField{aux + e * cells, nx, ny, nz}, i, j, k, P);
  } else if constexpr (kField == kFieldV) {
    out = tendency_v(U, V, W, GlobalField{aux + e * cells, nx, ny, nz}, i, j, k, P);
  } else if constexpr (kField == kFieldW) {
    out = tendency_w(U, V, W, i, j, k, P);
  } else {
    out = tendency_b(U, V, W, GlobalField{aux + e * cells, nx, ny, nz},
                     bottom[(e * nx + i) * ny + j], i, j, k, P);
  }
  g[p] = out;
}

__global__ void __launch_bounds__(kThreads)
div_3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ w, float* __restrict__ div_out, int n_env, int nx,
              int ny, int nz, float dx, float dy, float dz) {
  const size_t n = (size_t)n_env * ny * nx * nz;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int k = p % nz;
  size_t t = p / nz;
  const int x = t % nx;
  t /= nx;
  const int y = t % ny;
  const size_t e = t / ny;
  const size_t c = ((e * nx + x) * ny + y) * nz + k;
  const float u_ip = u[((e * nx + wrap_x(x + 1, nx)) * ny + y) * nz + k];
  const float v_jp = v[((e * nx + x) * ny + wrap_x(y + 1, ny)) * nz + k];
  const float* wc = w + ((e * nx + x) * ny + y) * (nz + 1);
  div_out[p] = (u_ip - u[c]) / dx + (v_jp - v[c]) / dy + (wc[k + 1] - wc[k]) / dz;
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
  if (nx % kXBlk != 0 || nx < kXBlk || ny < 4 || nz < 2 || stage < 0 || stage > 2 ||
      reads_g != (stage > 0) || writes_g != (stage < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * stage_smem_floats(ny, nz);
  cudaError_t err = cudaFuncSetAttribute(
      stage_rk_3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const RBC3DParams P{nx, ny, nz, dx, dy, dz, nu, kappa, min_b};
  stage_rk_3d_kernel<<<n_env * (nx / kXBlk), kThreads, smem, (cudaStream_t)stream>>>(
      u, v, w, b, q, bottom, gu_prev, gv_prev, gw_prev, gb_prev, u_out, v_out, w_out,
      b_out, div_out, gu, gv, gw, gb, dt, gamma, zeta, P);
  return (int)cudaGetLastError();
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
  if (nx % kXBlk != 0 || nx < kXBlk || ny % kYBlk != 0 || ny < kYBlk || nz < 2 ||
      stage < 0 || stage > 2 || reads_g != (stage > 0) || writes_g != (stage < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * stage_xy_smem_floats(nz);
  cudaError_t err = cudaFuncSetAttribute(
      stage_rk_3d_xy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const RBC3DParams P{nx, ny, nz, dx, dy, dz, nu, kappa, min_b};
  const unsigned blocks = (unsigned)n_env * (nx / kXBlk) * (ny / kYBlk);
  stage_rk_3d_xy_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      u, v, w, b, q, bottom, gu_prev, gv_prev, gw_prev, gb_prev, u_out, v_out, w_out,
      b_out, div_out, gu, gv, gw, gb, dt, gamma, zeta, P);
  return (int)cudaGetLastError();
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
                             const float* aux, const float* bottom, float* g, int n_env,
                             int nx, int ny, int nz, float dx, float dy, float dz, float nu,
                             float kappa, float min_b, void* stream) {
  if (field < kFieldU || field > kFieldB || nx < 3 || ny < 3 || nz < 2 ||
      (aux == nullptr) != (field == kFieldW) || (bottom != nullptr) != (field == kFieldB)) {
    return (int)cudaErrorInvalidValue;
  }
  const RBC3DParams P{nx, ny, nz, dx, dy, dz, nu, kappa, min_b};
  const size_t n = (size_t)n_env * nx * ny * (field == kFieldW ? nz + 1 : nz);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto* kernel = field == kFieldU   ? field_tendency_3d_kernel<kFieldU>
                 : field == kFieldV ? field_tendency_3d_kernel<kFieldV>
                 : field == kFieldW ? field_tendency_3d_kernel<kFieldW>
                                    : field_tendency_3d_kernel<kFieldB>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(u, v, w, aux, bottom, g, n_env, P);
  return (int)cudaGetLastError();
}

int launch_div_3d(const float* u, const float* v, const float* w, float* div_out, int n_env,
                  int nx, int ny, int nz, float dx, float dy, float dz, void* stream) {
  const size_t n = (size_t)n_env * ny * nx * nz;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  div_3d_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(u, v, w, div_out, n_env, nx,
                                                                ny, nz, dx, dy, dz);
  return (int)cudaGetLastError();
}

}  // extern "C"
