"""K2, compiled for the host and held against the plain version on the CPU
(``torch_kernels2d_host``), and the 2D byte formulas and the DCT form of
K1's vertical solve."""

import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from rbc_gym_tpu_torch.ops import kernels2d as k2
from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.ops.poisson import spectral_constants_2d
from rbc_gym_tpu_torch.sim.grid import Grid2D

from torch_kernels2d_host import host_binary, read_output, run_case  # noqa: F401 (a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


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
    solver, case, ran = run_case(host_binary, tmp_path, "k2", n_env, nx, nz, 0.18, seed=1)
    assert ran == instance == limits.tendencies_2d_instance(nx, nz)
    case = {k: v.double() for k, v in case.items()}
    want = k2.tendencies_2d_plain(case["u"], case["w"], case["b"], case["bottom"],
                                  solver.coeffs)
    for name, x in zip(("gu", "gw", "gb"), want):
        np.testing.assert_allclose(read_output(tmp_path, name, x), x.numpy(), rtol=0,
                                   atol=chip_smoke.K2_ATOL, err_msg=name)
    gw = read_output(tmp_path, "gw", want[1])
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
