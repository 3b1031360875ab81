"""K1 and K2's CUDA source, compiled for the host and held against the
plain versions, on the CPU.

The card is needed to run the kernels as built; their arithmetic and
indexing can run here. ``_build.host_source`` cuts the C launchers (which
need nvcc) off ``csrc/rbc2d.cu`` and puts ``csrc/host_shim.h`` in place of
the CUDA headers. K1 keeps each point's previous tendencies in registers
of one thread for the whole env step, and K1 and K2 exchange z fluxes and
pHY' partial sums by warp shuffles, so each of their blocks runs as 512
host threads meeting at real barriers. The host program picks K2's
instance as its launcher does and prints it. The gates are the smoke's
on-card ones (``chip_smoke.py``): the emulation differs from the plain
versions in float32 rounding only.
"""

import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from rbc_gym_tpu_torch.ops import _build
from rbc_gym_tpu_torch.ops import kernels2d as k2
from rbc_gym_tpu_torch.ops import limits, poisson
from rbc_gym_tpu_torch.ops.poisson import spectral_constants_2d
from rbc_gym_tpu_torch.sim.grid import Grid2D

DRIVER = r"""
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <memory>
#include <string>
#include <thread>
#include <vector>
namespace host { alignas(16) float smem[1 << 16]; }
#include "rbc2d_host.h"
using namespace host;
static std::string dir;
static std::vector<float> rd(const char* n, size_t count) {
  std::vector<float> v(count);
  FILE* f = fopen((dir + n).c_str(), "rb");
  if (!f || fread(v.data(), 4, count, f) != count) exit(2);
  fclose(f);
  return v;
}
static void wr(const char* n, const std::vector<float>& v) {
  FILE* f = fopen((dir + n).c_str(), "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}
// every block of E, one after another, each as kK1Threads host threads
// meeting at real barriers
static void run_blocks(int E, const std::function<void()>& body) {
  blockDim.x = kK1Threads;
  for (unsigned e = 0; e < (unsigned)E; ++e) {
    blockIdx.x = e;
    std::barrier<> bar(kK1Threads);
    block_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int v = 0; v < kK1Warps; ++v) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      warp_barriers[v] = warps.back().get();
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < kK1Threads; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        body();
      });
    }
    for (auto& th : threads) th.join();
    block_barrier = nullptr;
  }
}
int main(int argc, char** argv) {
  const std::string mode = argv[1];
  if (mode == "smem") {  // smem NX NZ: K1's shared and scratch floats and instance, K2's
    const int nx = atoi(argv[2]), nz = atoi(argv[3]);
    printf("%zu %zu %d %zu %zu %d\n", env_step_2d_smem_floats(nx, nz),
           env_step_2d_scratch_floats(nx, nz), (int)env_step_2d_on_chip(nx, nz),
           tendencies_2d_smem_floats(nx, nz), tendencies_2d_scratch_floats(nx, nz),
           (int)tendencies_on_march(nx, nz));
    return 0;
  }
  // k1|k2 DIR E NX NZ NSUB DT DX DZ NU KAPPA MIN_B [PASSES]
  dir = argv[2];
  const int E = atoi(argv[3]), nx = atoi(argv[4]), nz = atoi(argv[5]), nsub = atoi(argv[6]);
  const float dt = atof(argv[7]), dx = atof(argv[8]), dz = atof(argv[9]), nu = atof(argv[10]),
              kappa = atof(argv[11]), min_b = atof(argv[12]);
  const size_t C = (size_t)E * nx * nz, F = (size_t)E * nx * (nz + 1);
  auto u = rd("u", C), w = rd("w", F), b = rd("b", C), bottom = rd("bottom", (size_t)E * nx);
  if (mode == "k2") {  // as launch_tendencies_2d
    std::vector<float> gu(C, NAN), gw(F, NAN), gb(C, NAN);
    std::vector<float> scratch(E * tendencies_2d_scratch_floats(nx, nz), NAN);
    const K1Params P = k1_params(nx, nz, 1, 1.0f, dx, dz, nu, kappa, min_b);
    const bool on_march = tendencies_on_march(nx, nz);
    auto* kernel = tendencies_kernel_for(nx, nz);
    run_blocks(E, [&] {
      if (on_march)
        kernel(u.data(), w.data(), b.data(), bottom.data(), gu.data(), gw.data(), gb.data(), P);
      else
        tendencies_2d_general_kernel(u.data(), w.data(), b.data(), bottom.data(), gu.data(),
                                     gw.data(), gb.data(), scratch.data(), P);
    });
    wr("gu", gu); wr("gw", gw); wr("gb", gb);
    printf("%s\n", !on_march ? "general"
                   : kernel == tendencies_2d_march_kernel<96, 64> ? "specialised" : "runtime");
    return 0;
  }
  auto f = rd("f", (size_t)nx * nx), g = rd("g", (size_t)nx * nx);
  auto dct = rd("dct", (size_t)nz * nz), idct = rd("idct", (size_t)nz * nz);
  auto dinv = rd("dinv", (size_t)nx * nz);
  std::vector<float> out[4] = {std::vector<float>(C), std::vector<float>(F),
                               std::vector<float>(C), std::vector<float>(C)};
  const K1Params P = k1_params(nx, nz, nsub, dt, dx, dz, nu, kappa, min_b);
  const RBCParams R{nx, nz, dx, dz, nu, kappa, min_b};
  const int passes = argc > 13 ? atoi(argv[13]) : 0;  // as launch_env_step_2d
  const bool on_chip = env_step_2d_on_chip(nx, nz);
  auto* kernel = env_step_kernel_for(nx, nz, passes);
  auto* global = env_step_global_kernel_for(passes);
  std::vector<float> scratch(E * env_step_2d_scratch_floats(nx, nz), NAN);
  run_blocks(E, [&] {
    if (on_chip)
      kernel(u.data(), w.data(), b.data(), bottom.data(), f.data(), g.data(), dct.data(),
             idct.data(), dinv.data(), out[0].data(), out[1].data(), out[2].data(),
             out[3].data(), P);
    else
      global(u.data(), w.data(), b.data(), bottom.data(), f.data(), g.data(), dct.data(),
             idct.data(), dinv.data(), out[0].data(), out[1].data(), out[2].data(),
             out[3].data(), scratch.data(), P, R);
  });
  wr("u_out", out[0]); wr("w_out", out[1]); wr("b_out", out[2]); wr("p_out", out[3]);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build the kernels' host emulation")
    d = tmp_path_factory.mktemp("rbc2d_host")
    (d / "rbc2d_host.h").write_text(_build.host_source("rbc2d.cu"))
    (d / "driver.cpp").write_text(DRIVER)
    exe = d / "driver"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-o", str(exe),
                           str(d / "driver.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return exe


def _run(host_binary, tmp_path, mode, n_env, nx, nz, heater_duration, seed, dt_solver=None,
         precision=None):
    """Write a float32 case (``chip_smoke.make_case``) and the solve's
    constants, run ``mode`` on the host (K1 in the instance for
    ``precision``) -> (solver, case, what the host program printed); the
    outputs are files in ``tmp_path``."""
    solver, case = chip_smoke.make_case("cpu", n_env, (nz, nx), heater_duration, seed=seed,
                                        dtype=torch.float32, dt_solver=dt_solver)
    for name, t in {**case, **solver.spectral._asdict()}.items():
        t.numpy().astype(np.float32).tofile(tmp_path / name)
    c, p = solver.coeffs, solver.params
    args = [mode, f"{tmp_path}/", *map(str, (n_env, nx, nz, p.substeps_per_env_step)),
            *(repr(float(x)) for x in (p.dt_solver, c.dx, c.dz, c.nu, c.kappa, c.min_b)),
            str(k2.K1_PASSES[precision])]
    out = subprocess.run([str(host_binary), *args], check=True, capture_output=True, text=True)
    return solver, case, out.stdout.strip()


def _got(tmp_path, name, like):
    return np.fromfile(tmp_path / name, np.float32).reshape(like.shape)


@pytest.mark.parametrize("n_env,nx,nz", [
    (2, 96, 64),  # the reference grid: the compile-time instance
    (1, 20, 12),  # the runtime instance: two columns a warp, the last warps idle,
                  # one level a lane, the z ladder's walls meeting mid-column
    (1, 128, 40),  # the runtime instance at its edge: 8 columns a warp, two levels a lane
    # the off-chip instance
    (1, 128, 64),  # the on-chip state does not fit: 296,448 bytes
    (1, 20, 80),  # three chunks of 32 levels in pHY', the last part-filled
    (1, 200, 20),  # nx > 128, a part-filled chunk
    (1, 3, 8),  # the fewest columns the x stencils take
    (1, 16, 1),  # one level
])
def test_host_build_of_k1_matches_plain(host_binary, tmp_path, n_env, nx, nz):
    """K1 after 6 substeps (heater_duration 0.18) against
    ``env_step_2d_plain`` at the smoke's gate."""
    _check_k1(host_binary, tmp_path, n_env, nx, nz, 0.18, None)


def test_host_build_of_k1_off_the_chip_on_a_tall_grid(host_binary, tmp_path):
    """The off-chip instance at 128x224 (its two slabs 229,376 bytes, seven
    chunks of 32 levels in pHY'), 6 substeps at a dt_solver that keeps the
    explicit diffusion stable at dz = 2 / 224."""
    _check_k1(host_binary, tmp_path, 1, 128, 224, 0.012, 0.002)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("n_env,nx,nz", [
    (1, 96, 64),  # the reference grid: the compile-time instance, tile-exact, swizzled
    (1, 20, 12),  # the runtime instance: partial tiles in m, n and k, plain slabs
    (1, 128, 64),  # the off-chip instance
    (1, 3, 8),  # the fewest columns: one partial tile, 3 of 8 deep in F and G
    (1, 16, 1),  # one level: the z products 1 deep
])
def test_host_build_of_k1_tf32_instances_match_plain(host_binary, tmp_path, n_env, nx, nz,
                                                     precision):
    """K1's split-product ("high", 3 passes) and one-pass ("default")
    instances after 2 substeps (heater_duration 0.06: every product of
    every stage, the previous stage's tendencies across a substep, p out)
    against ``env_step_2d_plain`` at the same precision, at the smoke's
    gates for 6 substeps (``chip_smoke.k1_tf32_errors``). Each emulated
    mma meets its warp twice, so a substep here costs several times one of
    float32 K1."""
    _check_k1(host_binary, tmp_path, n_env, nx, nz, 0.06, None, precision, n_sub=2)


def _tf32_matmul_of_the_card(a, b, precision=None):
    """``ops.poisson.matmul`` as cuBLAS runs it on the card at "default":
    each float32 operand rounded to TF32 (to nearest) before a float32
    product. On the CPU, which has no TF32, the port's "default" is the
    full float32 product."""
    if precision != "default" or a.dtype != torch.float32:
        return _MATMUL(a, b, precision)
    return torch.matmul(*(((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
                          for t in (a, b)))


_MATMUL = poisson.matmul


def _check_k1(host_binary, tmp_path, n_env, nx, nz, heater_duration, dt_solver,
              precision=None, n_sub=6):
    solver, case, _ = _run(host_binary, tmp_path, "k1", n_env, nx, nz, heater_duration,
                           seed=0, dt_solver=dt_solver, precision=precision)
    assert solver.params.substeps_per_env_step == n_sub

    def plain(c, matmul=_MATMUL):
        with mock.patch.object(poisson, "matmul", matmul):
            return k2.env_step_2d_plain(c["u"], c["w"], c["b"], c["bottom"], solver.spectral,
                                        solver.coeffs, solver.params.dt_solver, n_sub,
                                        precision)

    want = plain(case)
    got = [_got(tmp_path, name, x) for name, x in zip(("u_out", "w_out", "b_out", "p_out"), want)]
    for name, x, y in zip(("u_out", "w_out", "b_out", "p_out"), want, got):
        assert bool(torch.isfinite(x).all()) and np.isfinite(y).all(), name
    if precision == "default":
        errors = chip_smoke.k1_tf32_errors(
            solver, case, [torch.as_tensor(y) for y in got],
            plain(case, _tf32_matmul_of_the_card))
        assert errors["kernel"] <= errors["bound"], errors
    else:
        for name, x, y in zip(("u_out", "w_out", "b_out", "p_out"), want, got):
            np.testing.assert_allclose(y, x.numpy(), rtol=0, atol=chip_smoke.K1_ATOL,
                                       err_msg=name)
    assert np.all(got[1][..., 0] == 0) and np.all(got[1][..., -1] == 0)


@pytest.mark.parametrize("n_env,nx,nz,instance", [
    (2, 96, 64, "specialised"),  # the reference grid: the compile-time march
    (1, 20, 12, "runtime"),  # two columns a warp, the last warps idle, one level a lane
    (1, 128, 64, "runtime"),  # the march at its edge: 8 columns a warp, 132,096 bytes
    (1, 8, 80, "general"),  # nz > 64: three chunks of 32 levels in pHY'
    (1, 3, 8, "general"),  # the fewest columns the x stencils take
    (1, 16, 1, "general"),  # one level: both w faces are walls
])
def test_host_build_of_k2_matches_plain(host_binary, tmp_path, n_env, nx, nz, instance):
    """Each K2 instance, pHY' from b, against ``tendencies_2d_plain`` at
    the smoke's gate (the plain version run in float64 on the same inputs,
    since K2 sums pHY' in float64); the host program ran the instance the
    launcher picks."""
    solver, case, ran = _run(host_binary, tmp_path, "k2", n_env, nx, nz, 0.18, seed=1)
    assert ran == instance == limits.tendencies_2d_instance(nx, nz)
    case = {k: v.double() for k, v in case.items()}
    want = k2.tendencies_2d_plain(case["u"], case["w"], case["b"], case["bottom"],
                                  solver.coeffs)
    for name, x in zip(("gu", "gw", "gb"), want):
        np.testing.assert_allclose(_got(tmp_path, name, x), x.numpy(), rtol=0,
                                   atol=chip_smoke.K2_ATOL, err_msg=name)
    gw = _got(tmp_path, "gw", want[1])
    assert np.all(gw[..., 0] == 0) and np.all(gw[..., -1] == 0)


@pytest.mark.parametrize("nx,nz", [(96, 64), (20, 12), (128, 16), (8, 2), (128, 40),
                                   (128, 64), (128, 224), (256, 32), (64, 128), (3, 8),
                                   (16, 1), (256, 256)])
def test_smem_formulas_match_the_launchers(host_binary, nx, nz):
    """The selection rule's byte count, the wrappers' scratch and the
    instances are the launchers' own, for K1 and K2."""
    out = subprocess.run([str(host_binary), "smem", str(nx), str(nz)], check=True,
                         capture_output=True, text=True).stdout.split()
    assert 4 * int(out[0]) == limits.env_step_2d_smem_bytes(nx, nz)
    assert int(out[1]) == limits.env_step_2d_scratch_floats(nx, nz)
    assert bool(int(out[2])) == limits.env_step_2d_on_chip(nx, nz)
    assert 4 * int(out[3]) == limits.tendencies_2d_smem_bytes(nx, nz)
    assert int(out[4]) == limits.tendencies_2d_scratch_floats(nx, nz)
    assert bool(int(out[5])) == limits.tendencies_2d_on_march(nx, nz)


@pytest.mark.parametrize("nx,nz", [(96, 64), (20, 12), (128, 224), (16, 1)])
def test_dct_form_of_the_vertical_solve_is_the_dense_inverse(nx, nz):
    """K1's per-mode inverse, idct^T diag(dinv[m]) dct^T, is the dense
    stack the plain solve multiplies by (the pseudo-inverse for the mean
    mode; at nz = 1 the stack's operator is -1 / dz^2, not singular), in
    float64."""
    grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
    sp = spectral_constants_2d(nx, nz, grid.dx, grid.dz, torch.float64, "cpu")
    # inv[m][z][f]: p_hat[m][f] = sum_z inv[m][z][f] r_hat[m][z]
    dct_form = torch.einsum("zj,mj,jf->mzf", sp.dct, sp.dinv, sp.idct)
    np.testing.assert_allclose(dct_form.numpy(), sp.inv.numpy(), rtol=0, atol=1e-10)
    assert float(sp.dinv[0, 0]) == (0.0 if nz > 1 else -grid.dz ** 2)
