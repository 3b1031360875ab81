"""The (x, y)-blocked stage path and the big grid, the port against the
JAX package, on the CPU.

Inputs are made by numpy from a seed and handed to both packages.
Tolerances, each with its reason:
- the port's ``fused="stage_xy"`` env step runs ``stage_rk_3d_plain``
  through the K5 wrapper here; the JAX side runs its Pallas xy kernel in
  the interpreter. In float32 the two differ in rounding only (the flux
  form and a doubling-shift suffix sum against the select-form stencils
  and a cumulative sum): atol 5e-6, the JAX package's own gate for its xy
  path against its XLA path (tests/test_pallas3d.py:176-205).
- the plain path at the 32x64x64 big grid in float64 against the JAX XLA
  path: atol 1e-10, as every float64 env-step comparison of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.sim import solver3d as jsolver
from rbc_gym_tpu.sim.grid import Grid3D as JGrid3D
from rbc_gym_tpu_torch.ops import kernels3d as k3
from rbc_gym_tpu_torch.sim.grid import Grid3D
from rbc_gym_tpu_torch.sim.solver3d import Fields3D, SimParams3D, make_solver3d
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


def _grids(nx, ny, nz):
    dims = dict(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    return Grid3D(**dims), JGrid3D(**dims)


def _np_fields(n_env, grid, seed, amp=0.05):
    rng = np.random.default_rng(seed)
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    u = amp * rng.standard_normal((n_env, nx, ny, nz))
    v = amp * rng.standard_normal((n_env, nx, ny, nz))
    w = amp * rng.standard_normal((n_env, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * grid.lz / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + amp * rng.standard_normal(u.shape), 1.0, 2.0)
    p_hy = np.asarray(jsolver._hydrostatic_pressure_3d(jnp.asarray(b), grid.dz, 1.0))
    return jsolver.Fields3D(u, v, w, b, p_hy, np.zeros_like(u))


@pytest.mark.parametrize("nx,ny,nz", [
    (32, 32, 16),  # two x blocks and four y blocks in the JAX kernel
    (16, 16, 24),  # nz off 16 and 32: on the card, K5's runtime-nz instance
])
def test_stage_xy_env_steps_match_jax_pallas_xy_kernel(nx, ny, nz):
    """Two env steps of 2 substeps, x blocks of 4 and y blocks of 8 in the
    JAX kernel, so its halos and edge columns are crossed."""
    grid, jgrid = _grids(nx, ny, nz)
    port = make_solver3d(grid, SimParams3D(heater_duration=0.02), dtype=torch.float32,
                         device="cpu", fused="stage_xy")
    assert port.path == "stage_xy"
    ref = jsolver.make_solver3d(jgrid, jsolver.SimParams3D(heater_duration=0.02),
                                dtype=jnp.float32, fused="stage_xy", fused_interpret=True,
                                e_blk=2, x_blk=4, y_blk=8)
    f = _np_fields(2, grid, seed=11)
    actions = np.random.default_rng(12).uniform(-1, 1, (2, 8, 8))
    jf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), f)
    tf = fields_from_numpy(f, dtype=torch.float32, cls=Fields3D)
    step = jax.jit(ref.env_step)
    before = k3.stage_rk_3d_xy.launches
    for _ in range(2):
        jf = step(jf, jnp.asarray(actions, jnp.float32))
        tf = port.env_step(tf, torch.as_tensor(actions, dtype=torch.float32))
    assert k3.stage_rk_3d_xy.launches == before  # the CPU runs the plain version
    for name, got in fields_to_numpy(tf).items():
        np.testing.assert_allclose(got, np.asarray(getattr(jf, name)), rtol=0, atol=5e-6,
                                   err_msg=name)


def test_plain_env_step_on_the_big_grid_matches_jax_float64():
    """The 32x64x64 grid at dt_solver 0.005 (two substeps of 0.02): the
    factored Poisson solve at ny = 64 and nx * nz = 2048."""
    grid, jgrid = _grids(64, 64, 32)
    params = dict(dt_solver=0.005, heater_duration=0.01)
    port = make_solver3d(grid, SimParams3D(**params), dtype=torch.float64, device="cpu")
    assert port.path == "plain"
    assert len(port.params.substep_dts()) == 2
    ref = jsolver.make_solver3d(jgrid, jsolver.SimParams3D(**params), dtype=jnp.float64,
                                fused=False)
    f = _np_fields(1, grid, seed=13)
    actions = np.random.default_rng(14).uniform(-1, 1, (1, 8, 8))
    want = jax.jit(ref.env_step)(jax.tree_util.tree_map(jnp.asarray, f), jnp.asarray(actions))
    got = port.env_step(fields_from_numpy(f, cls=Fields3D), torch.as_tensor(actions))
    for name, g in fields_to_numpy(got).items():
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), rtol=0, atol=1e-10,
                                   err_msg=name)


def test_k5_wrapper_takes_plain_path_only_on_cpu():
    grid, _ = _grids(8, 16, 8)
    s = make_solver3d(grid, SimParams3D(), dtype=torch.float64, device="cpu")
    f = fields_from_numpy(_np_fields(2, grid, seed=15), cls=Fields3D)
    bottom = s.heater_profile(torch.zeros(2, 8, 8, dtype=torch.float64))
    q = k3.to_solve_layout(0.01 * f.u)
    before = k3.stage_rk_3d_xy.launches
    g_prev = None
    for stage in range(3):
        args = (f.u, f.v, f.w, f.b, q, bottom, s.coeffs, 0.04, stage, g_prev)
        got, want = k3.stage_rk_3d_xy(*args), k3.stage_rk_3d_plain(*args)
        for a, b in zip(got[:5] + tuple(got[5] or ()), want[:5] + tuple(want[5] or ())):
            assert torch.equal(a, b)
        g_prev = got[5]
    assert k3.stage_rk_3d_xy.launches == before
    with pytest.raises(ValueError, match="g_prev"):
        k3.stage_rk_3d_xy(f.u, f.v, f.w, f.b, q, bottom, s.coeffs, 0.04, 2)
    with pytest.raises(ValueError, match="stage must be"):
        k3.stage_rk_3d_xy(f.u, f.v, f.w, f.b, q, bottom, s.coeffs, 0.04, 3, g_prev)
    # a tensor on neither the CPU nor CUDA never reaches the plain version
    meta = [t.to("meta") for t in (f.u, f.v, f.w, f.b, q, bottom)]
    with pytest.raises(ValueError, match="CUDA"):
        k3.stage_rk_3d_xy(*meta, s.coeffs, 0.04, 0)
