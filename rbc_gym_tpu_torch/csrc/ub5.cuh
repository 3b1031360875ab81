// UB5 flux-form advection and the 2D RBC tendencies as __device__ code.
//
// Ports the shared Pallas helpers of rbc_gym_tpu/ops/pallas3d.py:
//   _c6_d5_flux (:171-187)        -> c6_d5_flux
//   _uw_flux_periodic (:190-201)  -> uw_flux_periodic (any strided periodic
//                                    axis: x in 2D, y in 3D) and uw_flux_x
//   _z_row_flux/_z_uw_flux        -> z_uw_flux (interior C6/D5 rows, wall
//     (:204-255)                     rows by the UB5 -> UB3 -> UB1 ladder)
// and the body of ops/pallas2d.py:_tendencies (:144-184) -> tendency_u,
// tendency_w, tendency_b (one point each) and tendencies_block (K2's
// general instance), and the select form of
// _upwind_periodic / _z_upwind (:85-168) and stencils._z_order_ladder that
// the x-march kernels (K1, K2, K3, K5) use -> ub5_upwind, z_orders and the
// branch-free z_upwind.
//
// 2D layout: one env's fields are contiguous slabs, x-major with z fastest:
// u, b, p_hy are (nx, nz), w is (nx, nz + 1), bottom is (nx,). x is periodic,
// z is bounded (no-slip walls, w = 0 on the wall faces).
//
// The per-point tendencies compute each output point from the input slabs
// alone (fluxes on both faces of a cell are recomputed rather than staged),
// so a block walks its points in any order. They are templates over the
// scalars' type, which says how a difference is scaled by a spacing
// (K1Params, rbc2d.cu: by reciprocals taken on the host).
#pragma once

__device__ __forceinline__ int wrap_x(int i, int nx) {
  return i < 0 ? i + nx : (i >= nx ? i - nx : i);
}

// v * UB5(q, v) = v * C6(q) - |v| * D5(q) / 60, taps at offsets -3..2
// around the face (C6 - D5/60 = (2,-13,47,27,-3,0)/60 for v > 0).
__device__ __forceinline__ float c6_d5_flux(float tm3, float tm2, float tm1,
                                            float t0, float t1, float t2,
                                            float vel) {
  const float s0 = t0 + tm1, s1 = t1 + tm2, s2 = t2 + tm3;
  const float c6 = (37.0f / 60.0f) * s0 - (8.0f / 60.0f) * s1 + (1.0f / 60.0f) * s2;
  const float d0 = t0 - tm1, d1 = t1 - tm2, d2 = t2 - tm3;
  const float d5 = (10.0f / 60.0f) * d0 - (5.0f / 60.0f) * d1 + (1.0f / 60.0f) * d2;
  return vel * c6 - fabsf(vel) * d5;
}

// Flux vel * UB5 reconstruction of q along a periodic axis of n points
// that sit `stride` floats apart, at point i; the taps are
// q[wrap(i + m + off) * stride] for off in -3..2 (m = 0: centers -> faces,
// m = 1: faces -> centers).
__device__ __forceinline__ float uw_flux_periodic(const float* q, int stride, int n,
                                                  int i, int m, float vel) {
  const int c = i + m;
  return c6_d5_flux(q[wrap_x(c - 3, n) * stride], q[wrap_x(c - 2, n) * stride],
                    q[wrap_x(c - 1, n) * stride], q[wrap_x(c, n) * stride],
                    q[wrap_x(c + 1, n) * stride], q[wrap_x(c + 2, n) * stride], vel);
}

// The same along periodic x of a 2D (nx, stride) slab, at (i, k): `stride`
// is q's row length (nz or nz + 1).
__device__ __forceinline__ float uw_flux_x(const float* q, int stride, int nx,
                                           int i, int k, int m, float vel) {
  return uw_flux_periodic(q + k, stride, nx, i, m, vel);
}

// Flux vel * upwind z reconstruction of one column qc (n_src points) at
// destination row j, with m = j + split (split = 0: centers -> faces, 1:
// faces -> centers). Rows where UB5 fits on both sides (3 <= m <= n_src - 3)
// use C6/D5; the wall rows take, per side, the first stencil of UB5, UB3
// that fits in [0, n_src), else UB1 with zero-padded taps, as
// stencils._z_order_ladder does.
__device__ __forceinline__ float z_uw_flux(const float* qc, int n_src, int j,
                                           int split, float vel) {
  const int m = j + split;
  auto tap = [&](int off) -> float {
    const int idx = m + off;
    return (idx >= 0 && idx < n_src) ? qc[idx] : 0.0f;
  };
  if (m >= 3 && m <= n_src - 3) {
    return c6_d5_flux(tap(-3), tap(-2), tap(-1), tap(0), tap(1), tap(2), vel);
  }
  float left, right;
  if (m >= 3 && m + 1 <= n_src - 1) {  // UB5, taps m-3..m+1
    left = (2.0f * tap(-3) - 13.0f * tap(-2) + 47.0f * tap(-1) + 27.0f * tap(0) -
            3.0f * tap(1)) / 60.0f;
  } else if (m >= 2 && m <= n_src - 1) {  // UB3, taps m-2..m
    left = (-1.0f / 6.0f) * tap(-2) + (5.0f / 6.0f) * tap(-1) + (2.0f / 6.0f) * tap(0);
  } else {  // UB1
    left = tap(-1);
  }
  if (m >= 2 && m + 2 <= n_src - 1) {  // UB5, taps m-2..m+2
    right = (2.0f * tap(2) - 13.0f * tap(1) + 47.0f * tap(0) + 27.0f * tap(-1) -
             3.0f * tap(-2)) / 60.0f;
  } else if (m >= 1 && m + 1 <= n_src - 1) {  // UB3, taps m-1..m+1
    right = (-1.0f / 6.0f) * tap(1) + (5.0f / 6.0f) * tap(0) + (2.0f / 6.0f) * tap(-1);
  } else {  // UB1
    right = tap(0);
  }
  return vel * (vel > 0.0f ? left : right);
}

// UB5 reconstruction in the select form of the plain stencils: the five
// taps upwind of the face, in the left-biased order, then one weighted sum.
__device__ __forceinline__ float ub5_upwind(float tm3, float tm2, float tm1, float t0,
                                            float t1, float t2, float vel) {
  const bool pos = vel > 0.0f;
  const float a0 = pos ? tm3 : t2, a1 = pos ? tm2 : t1, a2 = pos ? tm1 : t0;
  const float a3 = pos ? t0 : tm1, a4 = pos ? t1 : tm2;
  return vel * ((2.0f / 60.0f) * a0 + (-13.0f / 60.0f) * a1 + (47.0f / 60.0f) * a2 +
                (27.0f / 60.0f) * a3 + (-3.0f / 60.0f) * a4);
}

// The order (5, 3 or 1) of the z ladder's left- and right-biased stencils
// at face m of a column of n points, as stencils._z_order_ladder picks it.
struct ZOrders {
  int left, right;
};
__device__ __forceinline__ ZOrders z_orders(int m, int n) {
  return {m >= 3 && m + 1 <= n - 1 ? 5 : (m >= 2 && m <= n - 1 ? 3 : 1),
          m >= 2 && m + 2 <= n - 1 ? 5 : (m >= 1 && m + 1 <= n - 1 ? 3 : 1)};
}

// vel * the z ladder's reconstruction at a face with taps at offsets -3..2
// (clamped into the column: a tap outside it has weight 0 in the order the
// ladder picks, or meets a wall velocity of exactly 0). Every order is
// computed and one is selected, so the lanes of a warp never diverge.
__device__ __forceinline__ float z_upwind(float tm3, float tm2, float tm1, float t0,
                                          float t1, float t2, ZOrders o, float vel) {
  const bool pos = vel > 0.0f;
  const float a0 = pos ? tm3 : t2, a1 = pos ? tm2 : t1, a2 = pos ? tm1 : t0;
  const float a3 = pos ? t0 : tm1, a4 = pos ? t1 : tm2;
  const float r5 = (2.0f / 60.0f) * a0 + (-13.0f / 60.0f) * a1 + (47.0f / 60.0f) * a2 +
                   (27.0f / 60.0f) * a3 + (-3.0f / 60.0f) * a4;
  const float r3 = (-1.0f / 6.0f) * a1 + (5.0f / 6.0f) * a2 + (2.0f / 6.0f) * a3;
  const int order = pos ? o.left : o.right;
  return vel * (order == 5 ? r5 : (order == 3 ? r3 : a2));
}

// gu at (x-face i, z-center k).
template <class RP>
__device__ __forceinline__ float tendency_u(const float* u, const float* w,
                                            const float* p_hy, int i, int k,
                                            const RP& P) {
  const int nx = P.nx, nz = P.nz, sw = nz + 1;
  const int im = wrap_x(i - 1, nx), ip = wrap_x(i + 1, nx);
  const float uc_i = 0.5f * (u[i * nz + k] + u[ip * nz + k]);
  const float uc_im = 0.5f * (u[im * nz + k] + u[i * nz + k]);
  float adv = P.ddx(uw_flux_x(u, nz, nx, i, k, 1, uc_i) -
                    uw_flux_x(u, nz, nx, im, k, 1, uc_im));
  const float wxf_k = 0.5f * (w[im * sw + k] + w[i * sw + k]);
  const float wxf_kp = 0.5f * (w[im * sw + k + 1] + w[i * sw + k + 1]);
  const float* uc = u + i * nz;
  adv += P.ddz(z_uw_flux(uc, nz, k + 1, 0, wxf_kp) - z_uw_flux(uc, nz, k, 0, wxf_k));
  const float dphy = P.ddx(p_hy[i * nz + k] - p_hy[im * nz + k]);
  const float q = uc[k];
  const float lapx = P.d2x(u[ip * nz + k] - 2.0f * q + u[im * nz + k]);
  const float qm = k > 0 ? uc[k - 1] : -uc[0];            // ghost: 2 * 0 - q0
  const float qp = k < nz - 1 ? uc[k + 1] : -uc[nz - 1];
  const float lapz = P.d2z(qp - 2.0f * q + qm);
  return -adv - dphy + P.nu * (lapx + lapz);
}

// gw at (x-center i, z-face k); zero on the wall faces.
template <class RP>
__device__ __forceinline__ float tendency_w(const float* u, const float* w,
                                            int i, int k, const RP& P) {
  const int nx = P.nx, nz = P.nz, sw = nz + 1;
  if (k == 0 || k == nz) return 0.0f;
  const int im = wrap_x(i - 1, nx), ip = wrap_x(i + 1, nx);
  const float uzf_i = 0.5f * (u[i * nz + k - 1] + u[i * nz + k]);
  const float uzf_ip = 0.5f * (u[ip * nz + k - 1] + u[ip * nz + k]);
  float adv = P.ddx(uw_flux_x(w, sw, nx, ip, k, 0, uzf_ip) -
                    uw_flux_x(w, sw, nx, i, k, 0, uzf_i));
  const float* wc = w + i * sw;
  const float wc_k = 0.5f * (wc[k] + wc[k + 1]);
  const float wc_km = 0.5f * (wc[k - 1] + wc[k]);
  adv += P.ddz(z_uw_flux(wc, sw, k, 1, wc_k) - z_uw_flux(wc, sw, k - 1, 1, wc_km));
  const float q = wc[k];
  const float lap = P.d2x(w[ip * sw + k] - 2.0f * q + w[im * sw + k]) +
                    P.d2z(wc[k + 1] - 2.0f * q + wc[k - 1]);
  return -adv + P.nu * lap;
}

// gb at (x-center i, z-center k); Dirichlet bottom[i] and min_b walls.
template <class RP>
__device__ __forceinline__ float tendency_b(const float* u, const float* w,
                                            const float* b, const float* bottom,
                                            int i, int k, const RP& P) {
  const int nx = P.nx, nz = P.nz, sw = nz + 1;
  const int im = wrap_x(i - 1, nx), ip = wrap_x(i + 1, nx);
  float adv = P.ddx(uw_flux_x(b, nz, nx, ip, k, 0, u[ip * nz + k]) -
                    uw_flux_x(b, nz, nx, i, k, 0, u[i * nz + k]));
  const float* bc = b + i * nz;
  adv += P.ddz(z_uw_flux(bc, nz, k + 1, 0, w[i * sw + k + 1]) -
               z_uw_flux(bc, nz, k, 0, w[i * sw + k]));
  const float q = bc[k];
  const float lapx = P.d2x(b[ip * nz + k] - 2.0f * q + b[im * nz + k]);
  const float qm = k > 0 ? bc[k - 1] : 2.0f * bottom[i] - bc[0];
  const float qp = k < nz - 1 ? bc[k + 1] : 2.0f * P.min_b - bc[nz - 1];
  const float lapz = P.d2z(qp - 2.0f * q + qm);
  return -adv + P.kappa * (lapx + lapz);
}

// All three tendency slabs of one env, computed by the calling block (K2's
// general instance).
template <class RP>
__device__ __forceinline__ void tendencies_block(const float* u, const float* w,
                                                 const float* b, const float* p_hy,
                                                 const float* bottom, float* gu,
                                                 float* gw, float* gb, const RP& P) {
  const int nc = P.nx * P.nz, nw = P.nx * (P.nz + 1);
  for (int p = threadIdx.x; p < nc; p += blockDim.x) {
    const int i = p / P.nz, k = p - i * P.nz;
    gu[p] = tendency_u(u, w, p_hy, i, k, P);
    gb[p] = tendency_b(u, w, b, bottom, i, k, P);
  }
  for (int p = threadIdx.x; p < nw; p += blockDim.x) {
    const int i = p / (P.nz + 1), k = p - i * (P.nz + 1);
    gw[p] = tendency_w(u, w, i, k, P);
  }
}
