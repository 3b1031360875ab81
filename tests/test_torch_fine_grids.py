"""The port on the fine grids (the ones its kernels took last: K5's z split
in 3D, K1's off-chip instance with its slabs in global scratch in 2D)
against the JAX package, on the CPU.

The same seeded numpy fields of one env go through the JAX package's XLA
path (``fused=False``, float64) and the port's solver in float64, which on
the CPU runs the kernels' plain versions. Tolerance: 1e-10 after a whole
env step, as ``tests/test_torch_solver2d.py`` and ``_solver3d.py`` hold the
same formulas on the training grids: the two differ by float64 rounding
only. dt_solver keeps the explicit diffusion stable at each grid's spacing
(RK3 needs dt kappa (4/dx^2 + 4/dy^2 + 4/dz^2) <= 2.5: a step of about
0.0096 at 232x128, and 0.0084 at nz = 112, where the 3D solver's step is
dt_solver free-fall times of 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rbc_gym_tpu.sim import solver2d as jsolver2d
from rbc_gym_tpu.sim import solver3d as jsolver3d
from rbc_gym_tpu.sim.grid import Grid2D as JGrid2D
from rbc_gym_tpu.sim.grid import Grid3D as JGrid3D
from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.sim import solver2d, solver3d
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy

ATOL = 1e-10


def _close(got, want):
    for name, g in fields_to_numpy(got).items():
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), rtol=0, atol=ATOL,
                                   err_msg=name)


def _noise(rng, shape, nz, amp=0.05):
    """Velocities of amplitude amp and b about the conduction profile, in
    [1, 2], on a column of nz levels."""
    u = amp * rng.standard_normal(shape)
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + amp * rng.standard_normal(shape), 1.0, 2.0)
    return u, b


def test_2d_env_step_at_232x128_matches_jax():
    """232x128 (nx x nz), whose two solve slabs (237,568 bytes) K1 keeps in
    global scratch on the card: one env step of 2 substeps."""
    nx, nz, dt = 232, 128, 0.005
    assert not limits.env_step_2d_slabs_on_chip(nx, nz)
    dims = dict(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
    port = solver2d.make_solver2d(Grid2D(**dims),
                                  solver2d.SimParams2D(dt_solver=dt, heater_duration=2 * dt),
                                  dtype=torch.float64, device="cpu")
    ref = jsolver2d.make_solver2d(JGrid2D(**dims),
                                  jsolver2d.SimParams2D(dt_solver=dt, heater_duration=2 * dt),
                                  dtype=jnp.float64, fused=False)
    rng = np.random.default_rng(24)
    u, b = _noise(rng, (1, nx, nz), nz)
    w = 0.05 * rng.standard_normal((1, nx, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    p_hy = np.asarray(jsolver2d._hydrostatic_pressure(jnp.asarray(b), 2.0 / nz, 1.0))
    f = jsolver2d.Fields2D(u, w, b, p_hy, np.zeros_like(u))
    actions = rng.uniform(-1, 1, (1, 12))
    want = jax.jit(ref.env_step)(jax.tree_util.tree_map(jnp.asarray, f), jnp.asarray(actions))
    _close(port.env_step(fields_from_numpy(f), torch.as_tensor(actions)), want)


def test_3d_env_step_at_nz_112_matches_jax():
    """(nx, ny, nz) = (4, 16, 112), whose columns K5's z split takes on the
    card (two CTAs of 56 levels): one env step of 2 substeps."""
    nx, ny, nz, dt = 4, 16, 112, 0.0005
    assert limits.stage_xy_split_size(nz) == 2
    dims = dict(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    port = solver3d.make_solver3d(Grid3D(**dims),
                                  solver3d.SimParams3D(dt_solver=dt, heater_duration=2 * dt),
                                  dtype=torch.float64, device="cpu")
    ref = jsolver3d.make_solver3d(JGrid3D(**dims),
                                  jsolver3d.SimParams3D(dt_solver=dt, heater_duration=2 * dt),
                                  dtype=jnp.float64, fused=False)
    rng = np.random.default_rng(112)
    u, b = _noise(rng, (1, nx, ny, nz), nz)
    v = 0.05 * rng.standard_normal(u.shape)
    w = 0.05 * rng.standard_normal((1, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    p_hy = np.asarray(jsolver3d._hydrostatic_pressure_3d(jnp.asarray(b), 2.0 / nz, 1.0))
    f = jsolver3d.Fields3D(u, v, w, b, p_hy, np.zeros_like(u))
    actions = rng.uniform(-1, 1, (1, 8, 8))
    want = jax.jit(ref.env_step)(jax.tree_util.tree_map(jnp.asarray, f), jnp.asarray(actions))
    _close(port.env_step(fields_from_numpy(f, cls=solver3d.Fields3D), torch.as_tensor(actions)),
           want)
