"""The host build of K3 to K7's CUDA source, shared by
``tests/test_torch_kernels3d_host.py`` and
``tests/test_torch_kernels3d_host_k5_split.py`` (not collected itself):
the kernels compiled for the host and held against the plain versions, on
the CPU.

The card is needed to run the kernels as built; their arithmetic and
indexing can run here. ``_build.host_source`` cuts the C launchers (which
need nvcc) off ``csrc/rbc3d.cu`` and puts ``csrc/host_shim.h`` in place of
the CUDA headers. The one-thread-per-point kernels (K4, K6, K7) run point
after point. K3 and K5, one x-march template, keep one thread per point
of an x-plane for the whole march (their carried fluxes live in
registers), so each of their blocks runs as that many host threads
meeting at real barriers (``std::barrier``); a cp.async copy lands at
once, which its wait and the barrier after it guarantee on the card, and
a warp shuffle meets the other lanes of its warp at a barrier of their
own. K5's z split runs the c CTAs of each cluster together, each with its
own shared memory and barrier, reading the partial sums of pHY' of the
CTAs above it through ``cluster_map`` and meeting them at
``cluster_barrier``, as K1's cluster instance does on the host
(``tests/torch_kernels2d_host.py``). The gates are the smoke's on-card
ones (``chip_smoke.py``): the emulation differs from the plain versions in
float32 rounding only. A test file imports ``host_binary`` (built once a
file) and the helpers below.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from rbc_gym_tpu_torch.ops import _build
from rbc_gym_tpu_torch.ops import kernels3d as k3

HOST_PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <string>
#include <thread>
#include <vector>
namespace host { alignas(16) float smem[1 << 20]; }
#include "rbc3d_host.h"
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
// n_blocks blocks of n_thr threads, one after the other; a block's threads
// run `body` as host threads meeting at real barriers
template <class Body>
static void run_blocks(unsigned n_blocks, int n_thr, Body body) {
  blockDim.x = n_thr;
  for (unsigned blk = 0; blk < n_blocks; ++blk) {
    blockIdx.x = blk;
    std::barrier<> bar(n_thr);
    block_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w * 32 < n_thr; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(std::min(32, n_thr - 32 * w)));
      warp_barriers[w] = warps.back().get();
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < n_thr; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        body();
      });
    }
    for (auto& th : threads) th.join();
    block_barrier = nullptr;
  }
}
// n_clusters clusters of c CTAs of n_thr threads, one cluster after another,
// its c x n_thr host threads running together: each CTA with its own shared
// memory and barriers, all meeting at the cluster's barrier
template <class Body>
static void run_clusters(unsigned n_clusters, int c, int n_thr, Body body) {
  blockDim.x = n_thr;
  host_cluster_ctas = c;
  std::vector<std::unique_ptr<float[]>> mem;
  for (int r = 0; r < c; ++r) {
    mem.push_back(std::make_unique<float[]>(1 << 16));
    host_cluster_smem[r] = mem.back().get();
  }
  for (unsigned cl = 0; cl < n_clusters; ++cl) {
    blockIdx.x = cl * c;  // the kernel's block is blockIdx.x / c, its CTA host_cta
    std::barrier<> cluster(c * n_thr);
    host_cluster_barrier = &cluster;
    std::vector<std::unique_ptr<std::barrier<>>> ctas, warps;
    for (int r = 0; r < c; ++r) {
      ctas.push_back(std::make_unique<std::barrier<>>(n_thr));
      for (int w = 0; w * 32 < n_thr; ++w) {
        warps.push_back(std::make_unique<std::barrier<>>(std::min(32, n_thr - 32 * w)));
        warp_barriers[r * 32 + w] = warps.back().get();
      }
    }
    std::vector<std::thread> threads;
    for (int r = 0; r < c; ++r) {
      for (int t = 0; t < n_thr; ++t) {
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
// K6 for field F, the instance its launcher picks for the grid
template <int F>
static void field_tendency(const std::vector<float>& u, const std::vector<float>& v,
                           const std::vector<float>& w, const float* b, const float* bottom,
                           float* g, int E, const XYParams& P) {
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  if (field_on_march(nx, ny, nz)) {
    float* gs[4] = {nullptr, nullptr, nullptr, nullptr};
    gs[F] = g;
    auto* kernel = field_march_kernel_for<F>(ny, nz);
    run_blocks((unsigned)E, march_threads(nz, ny), [&] {
      kernel(u.data(), v.data(), w.data(), b, nullptr, bottom, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, gs[0], gs[1], gs[2], gs[3],
             0.0f, 0.0f, 0.0f, P, nullptr);
    });
  } else {  // the general instance, point after point
    const int per_env = nx * ny * (F == kFieldW ? nz + 1 : nz);
    blockDim.x = 1;
    for (int p = 0; p < E * per_env; ++p) {
      blockIdx.x = (unsigned)p;
      field_tendency_3d_kernel<F>(u.data(), v.data(), w.data(), b, bottom, g, per_env, P);
    }
  }
}
int main(int argc, char** argv) {
  if (std::string(argv[1]) == "smem") {  // smem NY NZ: the launchers' floats
    printf("%zu %zu %zu\n", stage_smem_floats(atoi(argv[2]), atoi(argv[3])),
           stage_xy_smem_floats(atoi(argv[3])), field_smem_floats(atoi(argv[2]), atoi(argv[3])));
    return 0;
  }
  if (std::string(argv[1]) == "split") {  // split NZ: K5's z split, as its launcher sizes it
    const int nz = atoi(argv[2]), c = stage_xy_split_size(nz);
    printf("%d %zu %d %d\n", c, c ? stage_xy_split_smem_floats(nz, c) : stage_xy_smem_floats(nz),
           c ? split_threads(nz, c) : march_threads(nz, -1), c ? split_levels(nz, c) : nz);
    return 0;
  }
  if (std::string(argv[1]) == "smem_qp") {  // smem_qp NX NY NZ: the analysis instance's floats
    printf("%zu\n", stage_qp_smem_floats(atoi(argv[2]), atoi(argv[3]), atoi(argv[4])));
    return 0;
  }
  if (std::string(argv[1]) == "field") {  // field DIR E NX NY NZ DX DY DZ NU KAPPA MIN_B
    dir = argv[2];
    const int E = atoi(argv[3]), nx = atoi(argv[4]), ny = atoi(argv[5]), nz = atoi(argv[6]);
    const float dx = atof(argv[7]), dy = atof(argv[8]), dz = atof(argv[9]);
    const XYParams P = xy_params(nx, ny, nz, dx, dy, dz, atof(argv[10]), atof(argv[11]),
                                 atof(argv[12]));
    const size_t C = (size_t)E * nx * ny * nz, F = (size_t)E * nx * ny * (nz + 1);
    auto u = rd("u", C), v = rd("v", C), w = rd("w", F), b = rd("b", C);
    auto bottom = rd("bottom", (size_t)E * nx * ny);
    std::vector<float> g[4] = {std::vector<float>(C), std::vector<float>(C),
                               std::vector<float>(F), std::vector<float>(C)};
    field_tendency<kFieldU>(u, v, w, b.data(), nullptr, g[0].data(), E, P);
    field_tendency<kFieldV>(u, v, w, b.data(), nullptr, g[1].data(), E, P);
    field_tendency<kFieldW>(u, v, w, nullptr, nullptr, g[2].data(), E, P);
    field_tendency<kFieldB>(u, v, w, b.data(), bottom.data(), g[3].data(), E, P);
    std::vector<float> div(C);
    const DivLaunch L = div_launch(nx, nz, true);
    run_blocks((unsigned)(E * ny), L.threads, [&] {
      L.kernel(u.data(), v.data(), w.data(), div.data(), nx, ny, nz, (float)(1.0 / dx),
               (float)(1.0 / dy), (float)(1.0 / dz));
    });
    wr("gu", g[0]); wr("gv", g[1]); wr("gw", g[2]); wr("gb", g[3]); wr("div", div);
    printf("%s\n", field_on_march(nx, ny, nz) ? "march" : "general");
    return 0;
  }
  dir = argv[1];
  // K5 ("xy": the instance its launcher picks, "splitC": forced onto a
  // split of C CTAs), else K3
  const std::string kind = argv[16];
  const bool xy = kind == "xy" || kind.rfind("split", 0) == 0;
  const bool qp = std::string(argv[16]) == "qp";  // K3's analysis instance: rhat in "div"
  const int E = atoi(argv[2]), nx = atoi(argv[3]), ny = atoi(argv[4]), nz = atoi(argv[5]);
  const int stage = atoi(argv[6]);
  const float dt = atof(argv[7]), gamma = atof(argv[8]), zeta = atof(argv[9]);
  const float dx = atof(argv[10]), dy = atof(argv[11]), dz = atof(argv[12]);
  const size_t C = (size_t)E * nx * ny * nz, F = (size_t)E * nx * ny * (nz + 1);
  auto u = rd("u", C), v = rd("v", C), w = rd("w", F), b = rd("b", C), q = rd("q", C);
  auto bottom = rd("bottom", (size_t)E * nx * ny);
  std::vector<float> gp[4] = {rd("gu_prev", C), rd("gv_prev", C), rd("gw_prev", F),
                              rd("gb_prev", C)};
  std::vector<float> out[5] = {std::vector<float>(C), std::vector<float>(C),
                               std::vector<float>(F), std::vector<float>(C),
                               std::vector<float>(C)};
  std::vector<float> g[4] = {std::vector<float>(C), std::vector<float>(C),
                             std::vector<float>(F), std::vector<float>(C)};
  auto prev = [&](int i) { return stage > 0 ? gp[i].data() : nullptr; };
  auto emit = [&](int i) { return stage < 2 ? g[i].data() : nullptr; };
  std::vector<float> analysis;
  if (qp) analysis = rd("analysis", (size_t)nx * nx + (size_t)nz * nz);
  const XYParams PX = xy_params(nx, ny, nz, dx, dy, dz, atof(argv[13]), atof(argv[14]),
                                atof(argv[15]));
  const int csplit = kind == "xy" ? stage_xy_split_size(nz)
                                  : (xy ? atoi(kind.c_str() + 5) : 0);
  if (csplit > 0) {  // K5's z split: each block's cluster of csplit CTAs together
    auto* kernel = stage_xy_split_kernel();
    run_clusters(E * (unsigned)(ny / kYT), csplit, split_threads(nz, csplit), [&] {
      kernel(u.data(), v.data(), w.data(), b.data(), q.data(), bottom.data(), prev(0), prev(1),
             prev(2), prev(3), out[0].data(), out[1].data(), out[2].data(), out[3].data(),
             out[4].data(), emit(0), emit(1), emit(2), emit(3), dt, gamma, zeta, PX, nullptr);
    });
  } else {  // K3 and K5: every thread of a block, meeting at real barriers
    auto* kernel = xy ? stage_xy_kernel_for(nz)
                      : (qp ? stage_qp_kernel_for(ny, nz) : stage_kernel_for(ny, nz));
    run_blocks(xy ? E * (unsigned)(ny / kYT) : (unsigned)E,
               xy ? march_threads(nz, -1) : march_threads(nz, ny), [&] {
      kernel(u.data(), v.data(), w.data(), b.data(), q.data(), bottom.data(), prev(0), prev(1),
             prev(2), prev(3), out[0].data(), out[1].data(), out[2].data(), out[3].data(),
             out[4].data(), emit(0), emit(1), emit(2), emit(3), dt, gamma, zeta, PX,
             qp ? analysis.data() : nullptr);
    });
  }
  blockDim.x = 1;
  const char* names[9] = {"u_out", "v_out", "w_out", "b_out", "div", "gu", "gv", "gw", "gb"};
  for (int i = 0; i < 5; ++i) wr(names[i], out[i]);
  for (int i = 0; i < 4 && stage < 2; ++i) wr(names[5 + i], g[i]);
  std::vector<float> c[3] = {std::vector<float>(C), std::vector<float>(C),
                             std::vector<float>(F)};
  for (size_t p = 0; p < F; ++p) {
    blockIdx.x = (unsigned)p;
    correct_3d_kernel(u.data(), v.data(), w.data(), q.data(), c[0].data(), c[1].data(),
                      c[2].data(), E, nx, ny, nz, dx, dy, dz);
  }
  wr("cu", c[0]); wr("cv", c[1]); wr("cw", c[2]);
  printf("%s %d\n", csplit > 0 ? "split" : "one", csplit > 0 ? csplit : 1);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build the kernels' host emulation")
    d = tmp_path_factory.mktemp("rbc3d_host")
    (d / "rbc3d_host.h").write_text(_build.host_source("rbc3d.cu"))
    (d / "host_program.cpp").write_text(HOST_PROGRAM)
    exe = d / "host_program"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-o", str(exe),
                           str(d / "host_program.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return exe


def make_case(e, nx, ny, nz, seed):
    rng = np.random.default_rng(seed)
    amp = 0.05
    u = amp * rng.standard_normal((e, nx, ny, nz))
    v = amp * rng.standard_normal((e, nx, ny, nz))
    w = amp * rng.standard_normal((e, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + amp * rng.standard_normal(u.shape), 1.0, 2.0)
    bottom = rng.uniform(1.5, 2.5, (e, nx, ny))
    q = 0.01 * rng.standard_normal((e, ny, nx, nz))
    g_prev = [0.1 * rng.standard_normal(a.shape) for a in (u, v, w, b)]
    g_prev[2][..., 0] = g_prev[2][..., -1] = 0.0
    return dict(u=u, v=v, w=w, b=b, bottom=bottom, q=q, gu_prev=g_prev[0],
                gv_prev=g_prev[1], gw_prev=g_prev[2], gb_prev=g_prev[3])


def run_stage(host_binary, tmp_path, shape, stage, kernel, instance=None, vs_float64=False):
    """Run one stage of ``kernel`` ("x": K3 and K4, "xy": K5 in the
    instance its launcher picks, "split<c>": K5 forced onto a z split of c
    CTAs, "qp": K3's analysis instance, whose rhat lands in "div") on the
    host and hold it against the plain versions; ``instance`` (e.g. "split
    2"), if given, is what the host program says ran. ``vs_float64`` holds
    each output against the plain version run in float64 instead, within
    ``chip_smoke.SPLIT_VS_PLAIN`` times the float32 plain version's own
    error or the gate, whichever is larger (the smoke's rule for K5's z
    split, whose columns of 107 levels and more make outputs of ~10^3 from
    the case's noise)."""
    e, nx, ny, nz = shape
    case = make_case(*shape, seed=0)
    for name, a in case.items():
        a.astype(np.float32).tofile(tmp_path / name)
    if kernel == "qp":
        k3._analysis_factors(nx, nz, torch.device("cpu")).numpy().tofile(tmp_path / "analysis")
    c = k3.Coeffs3D(4 * np.pi / nx, 4 * np.pi / ny, 2.0 / nz, float(np.sqrt(0.7 / 2500)),
                    float(1 / np.sqrt(0.7 * 2500)), 1.0)
    dt = 0.04
    args = [*map(str, (*shape, stage)),
            *(repr(float(x)) for x in (dt, k3.RK3_GAMMA[stage], k3.RK3_ZETA[stage], *c)),
            kernel]
    ran = subprocess.run([str(host_binary), f"{tmp_path}/", *args], check=True,
                         capture_output=True, text=True).stdout.strip()
    assert instance is None or ran == instance, ran

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    def got(name, like):
        return np.fromfile(tmp_path / name, np.float32).reshape(like.shape)

    g_prev = tuple(t(case[n]) for n in ("gu_prev", "gv_prev", "gw_prev", "gb_prev"))
    want = k3.stage_rk_3d_plain(*(t(case[n]) for n in ("u", "v", "w", "b", "q", "bottom")),
                                c, dt, stage, g_prev if stage else None)
    if vs_float64:
        ref = k3.stage_rk_3d_plain(
            *(torch.as_tensor(case[n], dtype=torch.float64)
              for n in ("u", "v", "w", "b", "q", "bottom")),
            c, dt, stage, tuple(g.double() for g in g_prev) if stage else None)
        names = ("u_out", "v_out", "w_out", "b_out", "div", "gu", "gv", "gw", "gb")
        for name, r, p in zip(names, (*ref[:5], *(ref[5] or ())), (*want[:5], *(want[5] or ()))):
            gate = chip_smoke.K3_G_ATOL if name.startswith("g") else chip_smoke.K3_FIELD_ATOL
            plain = float((p.double() - r).abs().max())
            kernel_err = float(np.abs(got(name, r) - r.numpy()).max())
            assert kernel_err <= max(gate, chip_smoke.SPLIT_VS_PLAIN * plain), (name, kernel_err,
                                                                                plain)
        return case, c, got
    for name, x in zip(("u_out", "v_out", "w_out", "b_out", "div"), want[:5]):
        if kernel == "qp" and name == "div":
            rhat = got("div", x).reshape(e, ny, nx * nz)
            inputs = tuple(t(case[n]) for n in ("u", "v", "w", "b", "q", "bottom"))
            errors = chip_smoke.rhat_errors(c, inputs, dt, stage, g_prev if stage else None,
                                            torch.as_tensor(rhat))
            assert errors["kernel"] <= chip_smoke.RHAT_VS_PLAIN * errors["plain_float32"], errors
            continue
        np.testing.assert_allclose(got(name, x), x.numpy(), rtol=0,
                                   atol=chip_smoke.K3_FIELD_ATOL, err_msg=name)
    for name, x in zip(("gu", "gv", "gw", "gb"), want[5] or ()):
        np.testing.assert_allclose(got(name, x), x.numpy(), rtol=0,
                                   atol=chip_smoke.K3_G_ATOL, err_msg=name)
    w_out = got("w_out", want[2])
    assert np.all(w_out[..., 0] == 0) and np.all(w_out[..., -1] == 0)
    return case, c, got
