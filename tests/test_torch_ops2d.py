"""The port's 2D building blocks against the JAX package, on the CPU.

Inputs are made by numpy from a seed and handed to both packages. Both
compute in float64 with the same formulas, so they agree to rounding:
atol 1e-12 (values are O(1); differences come from summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.ops import poisson as jpoisson
from rbc_gym_tpu.ops import stencils as jst
from rbc_gym_tpu.sim import actuation as jact
from rbc_gym_tpu.sim import nusselt as jnu
from rbc_gym_tpu.sim.grid import Grid2D as JGrid2D
from rbc_gym_tpu_torch.ops import poisson as tpoisson
from rbc_gym_tpu_torch.ops import stencils as tst
from rbc_gym_tpu_torch.sim import actuation as tact
from rbc_gym_tpu_torch.sim import nusselt as tnu
from rbc_gym_tpu_torch.sim.grid import Grid2D
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ATOL = 1e-12
E, NX, NZ = 3, 16, 12
DX, DZ = 2 * np.pi / NX, 2.0 / NZ


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


# (name, port call, JAX call, input shapes): every 2D stencil of the slice.
_STENCILS = {
    "recon_c2f_periodic": (
        lambda q, v: tst.recon_c2f_periodic(q, v, -2),
        lambda q, v: jst.recon_c2f_periodic(q, v, -2),
        [(E, NX, NZ), (E, NX, NZ)],
    ),
    "recon_f2c_periodic": (
        lambda q, v: tst.recon_f2c_periodic(q, v, -2),
        lambda q, v: jst.recon_f2c_periodic(q, v, -2),
        [(E, NX, NZ), (E, NX, NZ)],
    ),
    "recon_c2f_z_fused": (
        tst.recon_c2f_z_fused, jst.recon_c2f_z_fused, [(E, NX, NZ), (E, NX, NZ + 1)]
    ),
    "recon_f2c_z_fused": (
        tst.recon_f2c_z_fused, jst.recon_f2c_z_fused, [(E, NX, NZ + 1), (E, NX, NZ)]
    ),
    "ddx_f2c": (lambda q: tst.ddx_f2c(q, DX), lambda q: jst.ddx_f2c(q, DX), [(E, NX, NZ)]),
    "ddx_c2f": (lambda q: tst.ddx_c2f(q, DX), lambda q: jst.ddx_c2f(q, DX), [(E, NX, NZ)]),
    "interp_f2c_x": (tst.interp_f2c_x, jst.interp_f2c_x, [(E, NX, NZ)]),
    "interp_c2f_x": (tst.interp_c2f_x, jst.interp_c2f_x, [(E, NX, NZ + 1)]),
    "ddz_f2c": (lambda q: tst.ddz_f2c(q, DZ), lambda q: jst.ddz_f2c(q, DZ), [(E, NX, NZ + 1)]),
    "ddz_c2f_interior": (
        lambda q: tst.ddz_c2f_interior(q, DZ), lambda q: jst.ddz_c2f_interior(q, DZ),
        [(E, NX, NZ)],
    ),
    "interp_f2c_z": (tst.interp_f2c_z, jst.interp_f2c_z, [(E, NX, NZ + 1)]),
    "interp_c2f_z_interior": (tst.interp_c2f_z_interior, jst.interp_c2f_z_interior, [(E, NX, NZ)]),
    "d2x_periodic": (
        lambda q: tst.d2x_periodic(q, DX), lambda q: jst.d2x_periodic(q, DX), [(E, NX, NZ)]
    ),
    "d2z_center_value_bc": (
        lambda q, bot: tst.d2z_center_value_bc(q, DZ, bot[..., 0], 1.0),
        lambda q, bot: jst.d2z_center_value_bc(q, DZ, bot[..., 0], 1.0),
        [(E, NX, NZ), (E, NX, 1)],
    ),
    "d2z_face_interior": (
        lambda q: tst.d2z_face_interior(q, DZ), lambda q: jst.d2z_face_interior(q, DZ),
        [(E, NX, NZ + 1)],
    ),
    "zero_z_walls": (tst.zero_z_walls, jst.zero_z_walls, [(E, NX, NZ + 1)]),
}


@pytest.mark.parametrize("name", sorted(_STENCILS))
def test_stencil_matches_jax(name):
    port, ref, shapes = _STENCILS[name]
    args = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
    _close(port(*map(_t, args)), ref(*map(jnp.asarray, args)))


@pytest.mark.parametrize("kind", ["c2f", "f2c"])
def test_z_recon_matrices_equal_jax_and_fused_path(kind):
    """The port's per-row ladder selection equals the JAX package's
    stencil-matrix form wherever the advecting velocity can be nonzero
    (interior faces / all centers)."""
    mats = [jnp.asarray(m) for m in getattr(jst, f"z_recon_matrices_{kind}")(NZ)]
    n_src, n_dst = (NZ, NZ + 1) if kind == "c2f" else (NZ + 1, NZ)
    q, vel = _rand(E, NX, n_src, seed=5), _rand(E, NX, n_dst, seed=6)
    want = getattr(jst, f"recon_{kind}_z")(jnp.asarray(q), jnp.asarray(vel), mats)
    got = getattr(tst, f"recon_{kind}_z_fused")(_t(q), _t(vel))
    rows = slice(1, -1) if kind == "c2f" else slice(None)
    _close(got[..., rows], np.asarray(want)[..., rows])


def test_ub5_fifth_order_on_smooth_periodic_field():
    """UB5 is a finite-volume scheme: fed the cell averages of sin(x), its
    face values converge at fifth order."""
    errs = []
    for n in (32, 64):
        h = 2 * np.pi / n
        x_f = np.arange(n) * h
        q = _t(((np.cos(x_f) - np.cos(x_f + h)) / h)[:, None])
        got = tst.recon_c2f_periodic(q, torch.ones_like(q), -2)[:, 0].numpy()
        errs.append(np.max(np.abs(got - np.sin(x_f))))
    assert np.log2(errs[0] / errs[1]) > 4.5


def test_poisson_constants_equal_jax():
    for got, want in zip(tpoisson._real_dft_matrices(NX), jpoisson._real_dft_matrices(NX)):
        np.testing.assert_array_equal(got, want)
    lams = tpoisson._dft_eigenvalues(NX, DX)
    np.testing.assert_array_equal(lams, jpoisson._dft_eigenvalues(NX, DX))
    np.testing.assert_array_equal(
        tpoisson._vertical_inverses(lams, NZ, DZ), jpoisson._vertical_inverses(lams, NZ, DZ)
    )


def test_poisson_solve_matches_jax_and_inverts_laplacian():
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal((E, NX, NZ))
    rhs -= rhs.mean(axis=(-2, -1), keepdims=True)  # solvable under Neumann z
    solve = tpoisson.make_poisson_solver_2d_bm(NX, NZ, DX, DZ, torch.float64, "cpu")
    p = solve(_t(rhs))
    want = jpoisson.make_poisson_solver_2d(NX, NZ, DX, DZ, jnp.float64)(jnp.asarray(rhs))
    _close(p, want)
    # discrete Laplacian (periodic x, Neumann z) of the solution is the rhs
    lap = tst.d2x_periodic(p, DX) + tst.ddz_f2c(tst.ddz_c2f_interior(p, DZ), DZ)
    _close(lap, rhs, atol=1e-9)


def test_heater_profile_matches_jax():
    grid = Grid2D(nx=96, nz=64, lx=2 * np.pi, lz=2.0)
    jgrid = JGrid2D(nx=96, nz=64, lx=2 * np.pi, lz=2.0)
    np.testing.assert_array_equal(grid.x_centers(), jgrid.x_centers())
    actions = np.random.default_rng(2).uniform(-1, 1, (E, 12))
    actions[0] = 0.5  # constant action: flat plate at the rest temperature
    got = tact.heater_profile_2d(_t(actions), grid.x_centers(), grid.lx, 12, 0.75, 2.0)
    want = jact.heater_profile_2d(jnp.asarray(actions), jgrid.x_centers(), jgrid.lx, 12, 0.75, 2.0)
    _close(got, want)
    _close(got[0], np.full(96, 2.0))


def test_nusselt_and_sensors_match_jax():
    rng = np.random.default_rng(3)
    t = 1.0 + rng.uniform(size=(E, 96, 64))
    w = 0.1 * rng.standard_normal((E, 96, 64))
    kappa = 1.0 / np.sqrt(0.7e4)
    _close(tnu.index_gradient(_t(t)), jnu.index_gradient(jnp.asarray(t)))
    _close(tnu.nusselt_2d(_t(t), _t(w), kappa, 1.0, 2.0),
           jnu.nusselt_2d(jnp.asarray(t), jnp.asarray(w), kappa, 1.0, 2.0))
    _close(tnu.nusselt_2d_physical(_t(t), _t(w), kappa, 1.0, 2.0, 2.0 / 64),
           jnu.nusselt_2d_physical(jnp.asarray(t), jnp.asarray(w), kappa, 1.0, 2.0, 2.0 / 64))
    got = tnu.sensor_subsample_2d(_t(t), 48, 8)
    assert tuple(got.shape) == (E, 48, 8)
    _close(got, jnu.sensor_subsample_2d(jnp.asarray(t), 48, 8))
