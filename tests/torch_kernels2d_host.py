"""The host build of K1 and K2's CUDA source, shared by the
``tests/test_torch_kernels2d_host_*.py`` files (not collected itself).

The card is needed to run the kernels as built; their arithmetic and
indexing can run here. ``_build.host_source`` cuts the C launchers (which
need nvcc) off ``csrc/rbc2d.cu`` and puts ``csrc/host_shim.h`` in place of
the CUDA headers. K1 keeps each point's previous tendencies in registers
of one thread for the whole env step, and K1 and K2 exchange z fluxes and
pHY' partial sums by warp shuffles, so each of their blocks runs as 512
host threads meeting at real barriers. The host program picks K2's
instance as its launcher does and prints it. The gates are the smoke's
on-card ones (``chip_smoke.py``): the emulation differs from the plain
versions in float32 rounding only. A test file imports ``host_binary``
(built once a file) and the helpers below.
"""

import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from rbc_gym_tpu_torch.ops import _build, limits
from rbc_gym_tpu_torch.ops import kernels2d as k2
from rbc_gym_tpu_torch.ops import poisson

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
    std::vector<std::unique_ptr<std::barrier<>>> warps, groups;
    for (int v = 0; v < kK1Warps; ++v) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      warp_barriers[v] = warps.back().get();
    }
    for (int v = 0; v < kK1Threads / 128; ++v) {
      groups.push_back(std::make_unique<std::barrier<>>(128));
      wg_barriers[v] = groups.back().get();
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
// every env's cluster of c CTAs, one env after another, its c x kK1Threads
// host threads running together: each CTA with its own shared memory and
// barriers, all meeting at the cluster's barrier
static void run_clusters(int E, int c, const std::function<void()>& body) {
  blockDim.x = kK1Threads;
  host_cluster_ctas = c;
  std::vector<std::unique_ptr<float[]>> mem;
  for (int r = 0; r < c; ++r) {
    mem.push_back(std::make_unique<float[]>(1 << 16));
    host_cluster_smem[r] = mem.back().get();
  }
  for (unsigned e = 0; e < (unsigned)E; ++e) {
    blockIdx.x = e * c;  // the kernel's env is blockIdx.x / c, its CTA host_cta
    std::barrier<> cluster(c * kK1Threads);
    host_cluster_barrier = &cluster;
    std::vector<std::unique_ptr<std::barrier<>>> ctas, warps;
    for (int r = 0; r < c; ++r) {
      ctas.push_back(std::make_unique<std::barrier<>>(kK1Threads));
      for (int v = 0; v < kK1Warps; ++v) {
        warps.push_back(std::make_unique<std::barrier<>>(32));
        warp_barriers[r * 32 + v] = warps.back().get();
      }
    }
    std::vector<std::thread> threads;
    for (int r = 0; r < c; ++r) {
      for (int t = 0; t < kK1Threads; ++t) {
        threads.emplace_back([&, r, t] {
          threadIdx.x = t;
          host_cta = r;
          cta_barrier = ctas[r].get();
          host_cta_smem = host_cluster_smem[r];
          body();
        });
      }
    }
    for (auto& th : threads) th.join();
  }
  host_cluster_barrier = nullptr;
  host_cluster_ctas = 1;
}
int main(int argc, char** argv) {
  const std::string mode = argv[1];
  if (mode == "smem") {  // smem NX NZ: K1's shared and scratch floats and instance, K2's,
                         // K1's cluster size, whether its CTAs hold F and G, whether its
                         // slabs are on the chip and its offsets fit
    const int nx = atoi(argv[2]), nz = atoi(argv[3]);
    printf("%zu %zu %d %zu %zu %d %d %d %d %d\n", env_step_2d_smem_floats(nx, nz),
           env_step_2d_scratch_floats(nx, nz), (int)env_step_2d_on_chip(nx, nz),
           tendencies_2d_smem_floats(nx, nz), tendencies_2d_scratch_floats(nx, nz),
           (int)tendencies_on_march(nx, nz), env_step_2d_cluster_size(nx, nz),
           (int)env_step_2d_cluster_fg(nx, nz), (int)env_step_2d_slabs_on_chip(nx, nz),
           (int)env_step_2d_offsets_fit(nx, nz));
    return 0;
  }
  // k1|k2 DIR E NX NZ NSUB DT DX DZ NU KAPPA MIN_B [PASSES [global|global_slabs]]
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
  // as launch_env_step_2d, unless "global" forces the off-chip instance
  // ("global_slabs": with its slabs in global scratch)
  const int passes = argc > 13 ? atoi(argv[13]) : 0;
  const std::string force = argc > 14 ? argv[14] : "";
  const bool forced = force == "global" || force == "global_slabs";
  const bool on_chip = !forced && env_step_2d_on_chip(nx, nz);
  const int csize = forced ? 0 : env_step_2d_cluster_size(nx, nz);
  if (on_chip) {
    auto* kernel = env_step_kernel_for(nx, nz, passes);
    // the wgmma instances' packed constants (ops/poisson.py k1_tf32_constants)
    const bool wgmma = k1_wgmma(nx, nz, passes);
    const auto tf32 = wgmma ? rd("tf32", k1_tf32_floats(passes)) : std::vector<float>();
    host_smem_base = smem;
    run_blocks(E, [&] {
      kernel(u.data(), w.data(), b.data(), bottom.data(), f.data(), g.data(), dct.data(),
             idct.data(), dinv.data(), out[0].data(), out[1].data(), out[2].data(),
             out[3].data(), P, wgmma ? tf32.data() : nullptr);
    });
  } else if (csize > 0) {
    auto* kernel = env_step_cluster_kernel_for(nx / csize, nz, passes);
    const int fg = env_step_2d_cluster_fg(nx, nz);
    run_clusters(E, csize, [&] {
      kernel(u.data(), w.data(), b.data(), bottom.data(), f.data(), g.data(), dct.data(),
             idct.data(), dinv.data(), out[0].data(), out[1].data(), out[2].data(),
             out[3].data(), P, fg);
    });
  } else {
    const bool slabs = force == "global" || (force.empty() && env_step_2d_slabs_on_chip(nx, nz));
    auto* global = env_step_global_kernel_for(passes, slabs);
    std::vector<float> scratch(
        E * ((slabs ? 5 : 7) * (size_t)nx * nz + 2 * (size_t)nx * (nz + 1)), NAN);
    run_blocks(E, [&] {
      global(u.data(), w.data(), b.data(), bottom.data(), f.data(), g.data(), dct.data(),
             idct.data(), dinv.data(), out[0].data(), out[1].data(), out[2].data(),
             out[3].data(), scratch.data(), P, R);
    });
  }
  wr("u_out", out[0]); wr("w_out", out[1]); wr("b_out", out[2]); wr("p_out", out[3]);
  const bool global_slabs = !on_chip && csize == 0 &&
                            (force == "global_slabs" || (force.empty() && !env_step_2d_slabs_on_chip(nx, nz)));
  printf("%s %d\n", on_chip ? (k1_wgmma(nx, nz, passes) ? "on_chip_wgmma" : "on_chip")
                   : csize > 0 ? "cluster" : (global_slabs ? "global_slabs" : "global"),
         csize > 0 ? csize : 1);
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


def run_case(host_binary, tmp_path, mode, n_env, nx, nz, heater_duration, seed,
             dt_solver=None, precision=None, force_global=False):
    """Write a float32 case (``chip_smoke.make_case``) and the solve's
    constants, run ``mode`` on the host (K1 in the instance for
    ``precision``; ``force_global`` "global" forces its off-chip instance,
    "global_slabs" that instance with its slabs in global scratch, and True
    is "global") -> (solver, case, what the host program printed: for K1
    the instance that ran and its CTAs a cluster); the outputs are files in
    ``tmp_path``."""
    if force_global is True:
        force_global = "global"
    solver, case = chip_smoke.make_case("cpu", n_env, (nz, nx), heater_duration, seed=seed,
                                        dtype=torch.float32, dt_solver=dt_solver)
    for name, t in {**case, **solver.spectral._asdict()}.items():
        t.numpy().astype(np.float32).tofile(tmp_path / name)
    passes = k2.K1_PASSES[precision]
    if limits.env_step_2d_wgmma(nx, nz, passes) and not force_global:
        poisson.k1_tf32_constants(solver.spectral, passes).numpy().tofile(tmp_path / "tf32")
    c, p = solver.coeffs, solver.params
    args = [mode, f"{tmp_path}/", *map(str, (n_env, nx, nz, p.substeps_per_env_step)),
            *(repr(float(x)) for x in (p.dt_solver, c.dx, c.dz, c.nu, c.kappa, c.min_b)),
            str(passes), *([force_global] if force_global else [])]
    out = subprocess.run([str(host_binary), *args], check=True, capture_output=True, text=True)
    return solver, case, out.stdout.strip()


def read_output(tmp_path, name, like):
    return np.fromfile(tmp_path / name, np.float32).reshape(like.shape)


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


def check_k1(host_binary, tmp_path, n_env, nx, nz, heater_duration, dt_solver,
              precision=None, n_sub=6, force_global=False, instance=None):
    """K1 on the host against ``env_step_2d_plain`` at the smoke's gate;
    ``instance`` (e.g. "cluster 2"), if given, is what the host program
    says ran."""
    solver, case, ran = run_case(host_binary, tmp_path, "k1", n_env, nx, nz, heater_duration,
                                 seed=0, dt_solver=dt_solver, precision=precision,
                                 force_global=force_global)
    assert solver.params.substeps_per_env_step == n_sub
    assert instance is None or ran == instance, ran

    def plain(c, matmul=_MATMUL):
        with mock.patch.object(poisson, "matmul", matmul):
            return k2.env_step_2d_plain(c["u"], c["w"], c["b"], c["bottom"], solver.spectral,
                                        solver.coeffs, solver.params.dt_solver, n_sub,
                                        precision)

    want = plain(case)
    names = ("u_out", "w_out", "b_out", "p_out")
    got = [read_output(tmp_path, name, x) for name, x in zip(names, want)]
    for name, x, y in zip(names, want, got):
        assert bool(torch.isfinite(x).all()) and np.isfinite(y).all(), name
    if precision == "default":
        errors = chip_smoke.k1_tf32_errors(
            solver, case, [torch.as_tensor(y) for y in got],
            plain(case, _tf32_matmul_of_the_card))
        assert errors["kernel"] <= errors["bound"], errors
    else:
        for name, x, y in zip(names, want, got):
            np.testing.assert_allclose(y, x.numpy(), rtol=0, atol=chip_smoke.K1_ATOL,
                                       err_msg=name)
    assert np.all(got[1][..., 0] == 0) and np.all(got[1][..., -1] == 0)
