// Hopper kernels of the 2D RBC env step, bound through a plain C ABI.
//
// K1 env_step_2d_kernel replaces rbc_gym_tpu/ops/pallas2d.py:_env_step_kernel
// (reached from make_env_step_fused_2d, pl.pallas_call at :486): a whole env
// step, n_substeps x 3 low-storage RK3 stages, each doing the hydrostatic
// pressure pHY', the UB5 tendencies, the RK update, the divergence, the
// spectral Poisson solve (F.rhs, per-mode inverse, G.p_hat) and the velocity
// correction.
//   Bound: operations. The spectral solve is 2 (2 nx^2 nz + nx nz^2) FLOP
//   per stage per env, about 3.1 MFLOP at 96x64 and 0.47 GFLOP per env step;
//   the fields move through device memory once per env step, about 170 KB
//   an env in and out.
//   Design: one thread block per env on the batch-major (E, nx, nz[+1])
//   tensors, so an env's slabs are contiguous and the substep loop runs
//   inside the block, phases separated by __syncthreads(). The solve's
//   right-hand side and mode coefficients sit in dynamic shared memory; F, G
//   and the inverses (shared by every env) come through the read-only cache.
//   Per-env scratch (g_prev, the stage tendencies, pHY') lives in global
//   memory, allocated by the caller. FP32 FMA on the CUDA cores; no tensor
//   cores, no TF32.
//
// K2 tendencies_2d_kernel replaces ops/pallas2d.py:_tendency_kernel (reached
// from make_tendencies_2d, pl.pallas_call at :562): gu, gw, gb of one RK3
// stage. Bound: bytes (u, w, b, p_hy, bottom in; gu, gw, gb out, each once).
// Design: one block per env over the same ub5.cuh device code as K1.
#include <cuda_runtime.h>

#include "ub5.cuh"

namespace {

constexpr int kThreads = 256;

// RK3 coefficients of the reference's :RungeKutta3 (pallas2d.py:214-215).
__constant__ float kGamma[3] = {8.0f / 15.0f, 5.0f / 12.0f, 3.0f / 4.0f};
__constant__ float kZeta[3] = {0.0f, -17.0f / 60.0f, -5.0f / 12.0f};

// pHY'[i][k] = -sum_{j >= k} inc[j], inc[j] = dz (b[j] + b[j+1]) / 2 for
// j < nz - 1 and the top half cell dz min_b / 2: one thread per x column
// walks z from the top, in the order of solver2d._hydrostatic_pressure.
__device__ void hydrostatic_block(const float* b, float* p_hy, const RBCParams& P) {
  const int nz = P.nz;
  for (int i = threadIdx.x; i < P.nx; i += blockDim.x) {
    const float* bc = b + i * nz;
    float* pc = p_hy + i * nz;
    float acc = 0.5f * P.dz * P.min_b;
    pc[nz - 1] = -acc;
    for (int k = nz - 2; k >= 0; --k) {
      acc += P.dz * (0.5f * (bc[k] + bc[k + 1]));
      pc[k] = -acc;
    }
  }
}

// out[r][c] = sum_k a[r][k] * x[k][c] for a (R, K) read through the
// read-only cache and x (K, C) in shared memory. Each thread owns a column c
// and kRows consecutive rows, so a warp reads one a[r][k] (a broadcast) and
// 32 consecutive x[k][c].
template <int kRows>
__device__ void dense_left_product(const float* __restrict__ a, const float* x,
                                   float* out, int R, int K, int C) {
  const int groups = (R + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < groups * C; item += blockDim.x) {
    const int r0 = (item / C) * kRows, c = item % C;
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float xv = x[k * C + c];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (r0 + j < R) acc[j] = fmaf(__ldg(a + (r0 + j) * K + k), xv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j < R) out[(r0 + j) * C + c] = acc[j];
    }
  }
}

// p_hat[m][f] = sum_z inv[m][z][f] * r_hat[m][z]: a warp reads 32
// consecutive f of one inverse row and broadcasts r_hat from shared memory.
__device__ void modal_inverse(const float* __restrict__ inv, const float* rhat,
                              float* phat, int nx, int nz) {
  for (int item = threadIdx.x; item < nx * nz; item += blockDim.x) {
    const int m = item / nz, f = item - m * nz;
    const float* im = inv + (size_t)m * nz * nz + f;
    const float* rm = rhat + m * nz;
    float acc = 0.0f;
    for (int z = 0; z < nz; ++z) acc = fmaf(__ldg(im + z * nz), rm[z], acc);
    phat[item] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
env_step_2d_kernel(const float* __restrict__ u_in, const float* __restrict__ w_in,
                   const float* __restrict__ b_in, const float* __restrict__ bottom_in,
                   const float* __restrict__ fmat, const float* __restrict__ gmat,
                   const float* __restrict__ inv, float* u_all, float* w_all,
                   float* b_all, float* p_all, float* scratch, int n_substeps,
                   float dt, RBCParams P) {
  extern __shared__ float smem[];
  const int nx = P.nx, nz = P.nz;
  const int nc = nx * nz, nw = nx * (nz + 1);
  const size_t e = blockIdx.x;

  float* u = u_all + e * nc;
  float* w = w_all + e * nw;
  float* b = b_all + e * nc;
  float* p = p_all + e * nc;
  const float* bottom = bottom_in + e * nx;
  // scratch per env: gu, gw, gb (this stage), gu, gw, gb (previous), pHY'
  float* s = scratch + e * (size_t)(5 * nc + 2 * nw);
  float* gu = s;
  float* gw = gu + nc;
  float* gb = gw + nw;
  float* gu0 = gb + nc;
  float* gw0 = gu0 + nc;
  float* gb0 = gw0 + nw;
  float* p_hy = gb0 + nc;
  float* rhs = smem;       // (nx, nz): div / dt_stage, later p_hat
  float* rhat = smem + nc; // (nx, nz): F . rhs

  for (int q = threadIdx.x; q < nc; q += blockDim.x) {
    u[q] = u_in[e * nc + q];
    b[q] = b_in[e * nc + q];
  }
  for (int q = threadIdx.x; q < nw; q += blockDim.x) w[q] = w_in[e * nw + q];
  __syncthreads();

  for (int step = 0; step < n_substeps; ++step) {
    for (int stage = 0; stage < 3; ++stage) {
      const float gamma = kGamma[stage], zeta = kZeta[stage];
      hydrostatic_block(b, p_hy, P);
      __syncthreads();
      tendencies_block(u, w, b, p_hy, bottom, gu, gw, gb, P);
      __syncthreads();
      // low-storage RK update; stage 0 has no previous tendency
      for (int q = threadIdx.x; q < nc; q += blockDim.x) {
        const float g1 = gu[q], h1 = gb[q];
        if (stage == 0) {
          u[q] += dt * gamma * g1;
          b[q] += dt * gamma * h1;
        } else {
          u[q] += dt * (gamma * g1 + zeta * gu0[q]);
          b[q] += dt * (gamma * h1 + zeta * gb0[q]);
        }
        gu0[q] = g1;
        gb0[q] = h1;
      }
      for (int q = threadIdx.x; q < nw; q += blockDim.x) {
        const float g1 = gw[q];
        w[q] += stage == 0 ? dt * gamma * g1 : dt * (gamma * g1 + zeta * gw0[q]);
        gw0[q] = g1;
      }
      __syncthreads();
      const float dts = (gamma + zeta) * dt;
      for (int q = threadIdx.x; q < nc; q += blockDim.x) {
        const int i = q / nz, k = q - i * nz;
        const int ip = wrap_x(i + 1, nx);
        const float div = (u[ip * nz + k] - u[q]) / P.dx +
                          (w[i * (nz + 1) + k + 1] - w[i * (nz + 1) + k]) / P.dz;
        rhs[q] = div / dts;
      }
      __syncthreads();
      dense_left_product<8>(fmat, rhs, rhat, nx, nx, nz);  // r_hat = F . rhs
      __syncthreads();
      modal_inverse(inv, rhat, rhs, nx, nz);                // p_hat -> rhs
      __syncthreads();
      dense_left_product<8>(gmat, rhs, p, nx, nx, nz);     // p = G . p_hat
      __syncthreads();
      for (int q = threadIdx.x; q < nc; q += blockDim.x) {
        const int i = q / nz, k = q - i * nz;
        const int im = wrap_x(i - 1, nx);
        u[q] -= dts * (p[q] - p[im * nz + k]) / P.dx;
      }
      for (int q = threadIdx.x; q < nw; q += blockDim.x) {
        const int i = q / (nz + 1), k = q - i * (nz + 1);
        if (k > 0 && k < nz) w[q] -= dts * (p[i * nz + k] - p[i * nz + k - 1]) / P.dz;
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tendencies_2d_kernel(const float* __restrict__ u, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ p_hy,
                     const float* __restrict__ bottom, float* __restrict__ gu,
                     float* __restrict__ gw, float* __restrict__ gb, RBCParams P) {
  const size_t e = blockIdx.x;
  const int nc = P.nx * P.nz, nw = P.nx * (P.nz + 1);
  tendencies_block(u + e * nc, w + e * nw, b + e * nc, p_hy + e * nc,
                   bottom + e * P.nx, gu + e * nc, gw + e * nw, gb + e * nc, P);
}

// Dynamic shared memory K1 needs per block: rhs and r_hat, in bytes.
int env_step_2d_smem_bytes(int nx, int nz) {
  return (int)(2 * sizeof(float) * (size_t)nx * nz);
}

}  // namespace

extern "C" {

int launch_env_step_2d(const float* u, const float* w, const float* b,
                       const float* bottom, const float* fmat, const float* gmat,
                       const float* inv, float* u_out, float* w_out, float* b_out,
                       float* p_out, float* scratch, int n_env, int nx, int nz,
                       int n_substeps, float dt, float dx, float dz, float nu,
                       float kappa, float min_b, void* stream) {
  const int smem = env_step_2d_smem_bytes(nx, nz);
  cudaError_t err = cudaFuncSetAttribute(
      env_step_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const RBCParams P{nx, nz, dx, dz, nu, kappa, min_b};
  env_step_2d_kernel<<<n_env, kThreads, smem, (cudaStream_t)stream>>>(
      u, w, b, bottom, fmat, gmat, inv, u_out, w_out, b_out, p_out, scratch,
      n_substeps, dt, P);
  return (int)cudaGetLastError();
}

int launch_tendencies_2d(const float* u, const float* w, const float* b,
                         const float* p_hy, const float* bottom, float* gu,
                         float* gw, float* gb, int n_env, int nx, int nz,
                         float dx, float dz, float nu, float kappa, float min_b,
                         void* stream) {
  const RBCParams P{nx, nz, dx, dz, nu, kappa, min_b};
  tendencies_2d_kernel<<<n_env, kThreads, 0, (cudaStream_t)stream>>>(
      u, w, b, p_hy, bottom, gu, gw, gb, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
