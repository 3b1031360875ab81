"""The per-field 3D path (``fused="field"``), the port against the JAX
package, on the CPU.

Inputs are made by numpy from a seed and handed to both packages, moved
between the JAX kernels' batch-minor (nx, nz[+1], ny, E) layout and the
port's batch-major (E, nx, ny, nz[+1]) one. The JAX side runs its Pallas
kernels in the interpreter, as its own tests do; the port's wrappers take
their plain versions on the CPU. Tolerances, each with its reason:
- one field's tendency, float32: 1e-5. The Pallas kernel selects a
  one-sided UB5 stencil by the sign of the velocity, the port computes
  the flux form C6 - |v| D5/60 (the same reconstruction, float32
  rounding only; pallas3d.py:185-186), as K3's tendency gate. The Pallas
  kernel reads the pHY' of the JAX package's ``_hydrostatic_pressure_3d``
  for u and v, the port computes it from b (its float32 suffix sum).
- the divergence, float32: 1e-6. The same three differences in the same
  order; the values are of order 0.1-1.
- a whole env step of 4 substeps, float32: 5e-6 on u, v, w, b, the JAX
  package's gate for its field path against its XLA path
  (tests/test_pallas3d.py:30-43).
- max|div u| after a step: 5e-4 in float32 (tests/test_pallas3d.py:95)
  and 1e-8 in float64 (tests/test_solver3d.py:65).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.ops import pallas3d
from rbc_gym_tpu.sim import solver3d as jsolver
from rbc_gym_tpu.sim.grid import Grid3D as JGrid3D
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.ops import kernels3d as k3
from rbc_gym_tpu_torch.sim import solver3d as s3
from rbc_gym_tpu_torch.sim.grid import Grid3D
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

NX, NY, NZ = 6, 8, 8  # odd nx / 2: the grids where auto takes the field path
# the Pallas kernels' inputs of each field (make_field_stage_3d): pHY' where
# the port's u and v take b
JAX_INPUTS = {"u": ("u", "v", "w", "p_hy"), "v": ("u", "v", "w", "p_hy"),
              "w": ("u", "v", "w"), "b": ("u", "v", "w", "b", "bottom")}
N_ENV = 2
TEND_ATOL = 1e-5
DIV_ATOL = 1e-6
STEP_ATOL = 5e-6


def _grids(nx=NX, ny=NY, nz=NZ):
    dims = dict(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    return Grid3D(**dims), JGrid3D(**dims)


def _np_fields(n_env, grid, seed, amp=0.05):
    """Random convective-looking state (velocities ~amp, b in [1, 2])."""
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


def _to_bm(a):
    """(E, nx, ny, nk) -> the Pallas kernels' (nx, nk, ny, E)."""
    return jnp.asarray(np.transpose(a, (1, 3, 2, 0)), jnp.float32)


def _coeffs(grid):
    p = s3.SimParams3D()
    return k3.Coeffs3D(grid.dx, grid.dy, grid.dz, p.nu, p.kappa, p.min_b)


@pytest.fixture(scope="module")
def case():
    """Shared float32 inputs of the tendency and divergence comparisons."""
    grid, _ = _grids()
    f = _np_fields(N_ENV, grid, seed=21)
    bottom = np.random.default_rng(22).uniform(1.5, 2.5, (N_ENV, NX, NY))
    arrays = dict(u=f.u, v=f.v, w=f.w, b=f.b, p_hy=f.p_hy, bottom=bottom)
    return grid, {k: np.asarray(a, np.float32) for k, a in arrays.items()}


@pytest.mark.parametrize("field", ["u", "v", "w", "b"])
def test_field_tendency_matches_jax_field_stage_kernel(case, field):
    grid, a = case
    c = _coeffs(grid)
    tend = pallas3d.make_field_stage_3d(field, NX, NY, NZ, grid.dx, grid.dy, grid.dz, c.nu,
                                        c.kappa, c.min_b, e_blk=2, interpret=True)
    jax_args = [_to_bm(a[n]) if n != "bottom" else jnp.asarray(np.moveaxis(a[n], 0, -1))
                for n in JAX_INPUTS[field]]
    want = np.transpose(np.asarray(tend(*jax_args)), (3, 0, 2, 1))  # -> (E, nx, ny, nk)
    args = [torch.as_tensor(a[n]) for n in k3.FIELD_INPUTS[field]]
    before = k3.field_tendency_3d.launches
    got = k3.field_tendency_3d(field, *args, c=c)
    assert k3.field_tendency_3d.launches == before  # the CPU runs the plain version
    assert torch.equal(got, k3.field_tendency_3d_plain(field, *args, c=c))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TEND_ATOL, err_msg=field)
    if field == "w":
        assert np.all(got.numpy()[..., [0, -1]] == 0)


def test_div_matches_jax_div_kernel(case):
    grid, a = case
    div_f, _ = pallas3d.make_projection_glue_3d(NX, NY, NZ, grid.dx, grid.dy, grid.dz,
                                                e_blk=2, interpret=True)
    want = np.transpose(np.asarray(div_f(*(_to_bm(a[n]) for n in "uvw"))), (3, 2, 0, 1))
    u, v, w = (torch.as_tensor(a[n]) for n in "uvw")
    got = k3.div_3d(u, v, w, _coeffs(grid))
    assert tuple(got.shape) == (N_ENV, NY, NX, NZ)  # the solve layout
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DIV_ATOL)


def test_plain_tendencies_are_the_four_field_tendencies(case):
    grid, a = case
    c = _coeffs(grid)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    p_hy = k3.hydrostatic_pressure(t["b"], c.dz, c.min_b)
    whole = k3.tendencies_3d_plain(t["u"], t["v"], t["w"], t["b"], p_hy, t["bottom"], c)
    for field, g in zip("uvwb", whole):
        args = [t[n] for n in k3.FIELD_INPUTS[field]]
        assert torch.equal(g, k3.field_tendency_3d_plain(field, *args, c=c))


def test_wrappers_check_their_arguments(case):
    grid, a = case
    c = _coeffs(grid)
    u, v, w = (torch.as_tensor(a[n]) for n in "uvw")
    with pytest.raises(ValueError, match="one of"):
        k3.field_tendency_3d("p", u, v, w, c=c)
    with pytest.raises(ValueError, match="takes u, v, w, b"):
        k3.field_tendency_3d("u", u, v, w, c=c)
    # a tensor on neither the CPU nor CUDA never reaches the plain version
    meta = [t.to("meta") for t in (u, v, w)]
    with pytest.raises(ValueError, match="CUDA"):
        k3.field_tendency_3d("w", *meta, c=c)
    with pytest.raises(ValueError, match="CUDA"):
        k3.div_3d(*meta, c)


@pytest.fixture(scope="module")
def env_steps():
    """One env step of 4 substeps from shared float32 fields: the port's
    forced field path and the JAX package's auto path (interpret mode),
    which takes its field path on this grid."""
    grid, jgrid = _grids()
    params = dict(heater_duration=0.04)
    port = s3.make_solver3d(grid, s3.SimParams3D(**params), dtype=torch.float32,
                            device="cpu", fused="field")
    built = []
    make = pallas3d.make_field_stage_3d
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas3d, "make_field_stage_3d",
                   lambda field, *args, **kw: built.append(field) or make(field, *args, **kw))
        ref = jsolver.make_solver3d(jgrid, jsolver.SimParams3D(**params), dtype=jnp.float32,
                                    fused=None, fused_interpret=True, e_blk=2)
    f = _np_fields(N_ENV, grid, seed=23)
    actions = np.random.default_rng(24).uniform(-1, 1, (N_ENV, 8, 8))
    jf = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), f)
    want = jax.jit(ref.env_step)(jf, jnp.asarray(actions, jnp.float32))
    tf = fields_from_numpy(f, dtype=torch.float32, cls=s3.Fields3D)
    counts = (k3.field_tendency_3d.launches, k3.div_3d.launches, k3.correct_3d.launches)
    got = port.env_step(tf, torch.as_tensor(actions, dtype=torch.float32))
    assert (k3.field_tendency_3d.launches, k3.div_3d.launches,
            k3.correct_3d.launches) == counts
    return port, built, got, want


def test_field_env_step_matches_jax_field_path(env_steps):
    port, built, got, want = env_steps
    assert port.path == "field" and sorted(built) == ["b", "u", "v", "w"]
    assert len(port.params.substep_dts()) == 4
    for name, g in fields_to_numpy(got).items():
        if name in "uvwb":
            np.testing.assert_allclose(g, np.asarray(getattr(want, name)), rtol=0,
                                       atol=STEP_ATOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_field_step_is_divergence_free(env_steps, dtype):
    """float32 through the solver's field path; float64 through the same
    loop (``field_substeps``, the wrappers taking their plain versions),
    since the field path itself takes float32 only."""
    port, _, got, _ = env_steps
    if dtype == torch.float32:
        div = s3.max_divergence_3d(got, port.grid)
    else:
        grid, _ = _grids()
        f = fields_from_numpy(_np_fields(N_ENV, grid, seed=25), dtype=dtype, cls=s3.Fields3D)
        solver = s3.make_solver3d(grid, s3.SimParams3D(heater_duration=0.04), dtype=dtype,
                                  device="cpu")
        bottom = solver.heater_profile(torch.zeros(N_ENV, 8, 8, dtype=dtype))
        u, v, w, b, _ = s3.field_substeps(f.u, f.v, f.w, f.b, bottom,
                                          solver.params.substep_dts(), solver.solve,
                                          solver.coeffs, *s3.FIELD_KERNELS)
        div = s3.max_divergence_3d(s3.Fields3D(u, v, w, b, b, b), grid)
    assert div < s3.DIVERGENCE_ATOL[dtype]


def test_field_path_env_step_does_not_mutate_its_input():
    env = RBC3DVectorEnv(2, state_shape=(NZ, NY, NX), heater_duration=0.02, fused="field",
                         dtype=torch.float32, device="cpu")
    assert env.solver.path == "field"
    state, _ = env.reset(seed=3)
    before = [t.clone() for t in state.fields]
    new, ts = env.step(state, np.random.default_rng(3).uniform(-1, 1, (2, 8, 8)))
    assert all(torch.equal(a, b) for a, b in zip(before, state.fields))
    assert not torch.equal(new.fields.b, state.fields.b)
    assert bool(torch.isfinite(ts.obs).all())
