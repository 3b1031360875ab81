"""The lazy loop's options, the port against the JAX package, on the CPU:
K3's analysis instance (``fused="stage_qp"``: the stage writes rhat =
kron(Fx, Cz) div and the solve's tail alone follows), ``fused="stage_ew"``
(K3 itself) and the precision of the 3D solve's products
(``poisson_precision``).

Inputs are made by numpy from a seed and handed to both packages.
Tolerances, each with its reason:
- the analysis and the tail in float64 against the JAX functions and the
  port's dense solve: atol 1e-12, the same products in another order;
- the analysis wrapper on the CPU runs its plain version, which is
  ``stage_rk_3d_plain`` and the dense analysis product exactly;
- the env steps in float32 against the JAX package's Pallas kernels in the
  interpreter: atol 5e-6, the JAX package's own gate for these paths
  against its XLA path (tests/test_pallas3d.py:108-125, :232-245); the two
  differ in float32 rounding only;
- the TF32 split is exact (hi + lo == a), and its three products (full
  float32 on the CPU, which has no TF32) within 1e-6 of a float64 product,
  relative to the largest entry: the dropped lo . lo term is under 2^-20
  of each product term;
- "high" and "highest" against the JAX solvers in float32 at 5e-6: on the
  CPU the JAX package ignores the precision, and the port's "high" product
  is float32-accurate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from rbc_gym_tpu.envs.vector2d import RBC2DVectorEnv as JRBC2DVectorEnv
from rbc_gym_tpu.envs.vector3d import RBC3DVectorEnv as JRBC3DVectorEnv
from rbc_gym_tpu.ops import poisson as jpoisson
from rbc_gym_tpu.sim import solver2d as jsolver2d
from rbc_gym_tpu.sim import solver3d as jsolver
from rbc_gym_tpu.sim.grid import Grid3D as JGrid3D
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.ops import kernels3d as k3
from rbc_gym_tpu_torch.ops import poisson as tpoisson
from rbc_gym_tpu_torch.sim.grid import Grid3D
from rbc_gym_tpu_torch.sim.solver2d import Fields2D
from rbc_gym_tpu_torch.sim.solver3d import Fields3D, SimParams3D, make_solver3d
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ATOL64 = 1e-12
ATOL32 = 5e-6
SHAPE = (8, 16, 16)  # nz, ny, nx: two x blocks of 8 in the JAX kernel
HEATER = 0.02  # two substeps of 0.01


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


@pytest.mark.parametrize("shape", [(8, 8, 8), (32, 32, 16), (12, 8, 10)])
def test_analysis_and_tail_match_jax_and_the_dense_solve(shape):
    """rhat (E, ny, nx nz) is the JAX (nx nz, ny, E) rhat; the tail's p
    (E, ny, nx, nz) the JAX (nx, nz, ny, E) p; tail(analysis) is the dense
    solve."""
    nx, ny, nz = shape
    dx, dy, dz = 4 * np.pi / nx, 4 * np.pi / ny, 2.0 / nz
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((2, ny, nx, nz))
    np.testing.assert_array_equal(tpoisson.poisson_analysis_matrix_3d(nx, nz),
                                  jpoisson.poisson_analysis_matrix_3d(nx, nz))
    analysis = tpoisson.make_poisson_analysis_3d(nx, nz, torch.float64, "cpu")
    rhat = analysis(torch.as_tensor(rhs))
    t_a = jpoisson.poisson_analysis_matrix_3d(nx, nz)
    want_rhat = np.einsum("KM,Mye->Kye", t_a, rhs.transpose(2, 3, 1, 0).reshape(nx * nz, ny, 2))
    np.testing.assert_allclose(rhat.numpy(), want_rhat.transpose(2, 1, 0), rtol=0, atol=ATOL64)

    tail = tpoisson.make_poisson_tail_3d(nx, ny, nz, dx, dy, dz, torch.float64, "cpu")
    jtail = jpoisson.make_poisson_tail_3d_bm(nx, ny, nz, dx, dy, dz, jnp.float64)
    r = rng.standard_normal((2, ny, nx * nz))
    want = np.asarray(jtail(jnp.asarray(r.transpose(2, 1, 0)))).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(tail(torch.as_tensor(r)).numpy(), want, rtol=0, atol=ATOL64)

    solve = tpoisson.make_poisson_solver_3d(nx, ny, nz, dx, dy, dz, torch.float64, "cpu",
                                            factored=False)
    np.testing.assert_allclose(tail(rhat).numpy(), solve(torch.as_tensor(rhs)).numpy(),
                               rtol=0, atol=ATOL64)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_analysis_wrapper_on_cpu_is_plain_stage_and_analysis(stage):
    grid, _ = _grids(16, 16, 8)
    s = make_solver3d(grid, SimParams3D(), dtype=torch.float64, device="cpu")
    f = fields_from_numpy(_np_fields(2, grid, seed=15), cls=Fields3D)
    bottom = s.heater_profile(torch.zeros(2, 8, 8, dtype=torch.float64))
    rng = np.random.default_rng(16)
    q = torch.as_tensor(0.01 * rng.standard_normal((2, 16, 16, 8)))
    g_prev = None
    if stage:
        g_prev = tuple(torch.as_tensor(0.1 * rng.standard_normal(t.shape))
                       for t in (f.u, f.v, f.w, f.b))
    before = k3.stage_rk_3d_rhat.launches
    got = k3.stage_rk_3d_rhat(f.u, f.v, f.w, f.b, q, bottom, s.coeffs, 0.04, stage, g_prev)
    assert k3.stage_rk_3d_rhat.launches == before  # the CPU runs the plain version
    want = k3.stage_rk_3d_plain(f.u, f.v, f.w, f.b, q, bottom, s.coeffs, 0.04, stage, g_prev)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert (got[5] is None) == (stage == 2)
    for a, b in zip(got[5] or (), want[5] or ()):
        assert torch.equal(a, b)
    t_a = torch.as_tensor(tpoisson.poisson_analysis_matrix_3d(16, 8))
    rhat = (want[4].reshape(2 * 16, 128) @ t_a.T).reshape(2, 16, 128)
    np.testing.assert_allclose(got[4].numpy(), rhat.numpy(), rtol=0, atol=ATOL64)


@pytest.fixture(scope="module")
def jax_option_steps():
    """One env step of the JAX package's ``fused="stage_qp"`` and
    ``"stage_ew"`` solvers in the interpreter (x_blk 8, e_blk 2) from
    seeded fields, and those fields and actions."""
    nz, ny, nx = SHAPE
    _, jgrid = _grids(nx, ny, nz)
    grid, _ = _grids(nx, ny, nz)
    f = _np_fields(2, grid, seed=21)
    actions = np.random.default_rng(22).uniform(-1, 1, (2, 8, 8))
    jf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), f)
    out = {}
    for fused in ("stage_qp", "stage_ew"):
        ref = jsolver.make_solver3d(jgrid, jsolver.SimParams3D(heater_duration=HEATER),
                                    dtype=jnp.float32, fused=fused, fused_interpret=True,
                                    e_blk=2, x_blk=8)
        want = jax.jit(ref.env_step)(jf, jnp.asarray(actions, jnp.float32))
        out[fused] = jax.tree_util.tree_map(np.asarray, want)
    return f, actions, out


@pytest.mark.parametrize("fused,wrapper", [("stage_qp", "stage_rk_3d_rhat"),
                                           ("stage_ew", "stage_rk_3d")])
def test_option_env_steps_match_jax_interpret(jax_option_steps, fused, wrapper):
    f, actions, want = jax_option_steps
    nz, ny, nx = SHAPE
    grid, _ = _grids(nx, ny, nz)
    port = make_solver3d(grid, SimParams3D(heater_duration=HEATER), dtype=torch.float32,
                         device="cpu", fused=fused)
    assert port.path == fused
    before = getattr(k3, wrapper).launches
    got = port.env_step(fields_from_numpy(f, dtype=torch.float32, cls=Fields3D),
                        torch.as_tensor(actions, dtype=torch.float32))
    assert getattr(k3, wrapper).launches == before
    for name, g in fields_to_numpy(got).items():
        np.testing.assert_allclose(g, getattr(want[fused], name), rtol=0, atol=ATOL32,
                                   err_msg=name)


def test_stage_qp_and_stage_ew_equal_stage_on_cpu():
    """On the CPU all three run the plain stage; "stage_qp"'s tail after the
    analysis is the dense solve's own two halves, so the steps are equal."""
    nz, ny, nx = SHAPE
    grid, _ = _grids(nx, ny, nz)
    params = SimParams3D(heater_duration=HEATER)
    f = fields_from_numpy(_np_fields(2, grid, seed=23), dtype=torch.float32, cls=Fields3D)
    a = torch.as_tensor(np.random.default_rng(24).uniform(-1, 1, (2, 8, 8)),
                        dtype=torch.float32)
    steps = {fused: make_solver3d(grid, params, dtype=torch.float32, device="cpu",
                                  fused=fused).env_step(f, a)
             for fused in ("stage", "stage_qp", "stage_ew")}
    for fused in ("stage_qp", "stage_ew"):
        assert all(torch.equal(x, y) for x, y in zip(steps[fused], steps["stage"])), fused


_FLOATS = hst.floats(allow_nan=False, allow_infinity=False, width=32)


@settings(max_examples=200, deadline=None)
@given(hst.lists(_FLOATS, min_size=1, max_size=64))
def test_tf32_split_is_exact_and_hi_tf32_exact(values):
    a = torch.tensor(values, dtype=torch.float32)
    hi, lo = tpoisson.tf32_split(a)
    assert torch.equal(hi + lo, a)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())  # the 13 bits TF32 drops
    normal = a.abs() >= torch.finfo(torch.float32).tiny  # subnormals have no leading 1
    assert bool((lo.abs() <= a.abs() * 2.0**-10)[normal].all())


@pytest.mark.parametrize("shape", [((64, 512), (512, 512)), ((3, 16, 32), (32, 32))])
def test_split_product_is_float32_accurate(shape):
    rng = np.random.default_rng(6)
    a, b = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32) for s in shape)
    want = a.double() @ b.double()
    for precision in ("high", "highest", None):
        got = tpoisson.matmul(a, b, precision)
        assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-6, precision
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_tf32_flag_is_restored_even_on_error():
    a, b = torch.ones(2, 3), torch.ones(4, 5)  # shapes that do not multiply
    for precision in ("high", "default"):
        with pytest.raises(RuntimeError):
            tpoisson.matmul(a, b, precision)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError, match="precision"):
        tpoisson.matmul(a, b, "bf16x3")


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_3d_env_precision_matches_jax(precision):
    """The 3D env's solver at ``poisson_precision`` on the plain path, in
    float32, against the JAX env's from the same fields."""
    cfg = dict(state_shape=SHAPE, heater_duration=HEATER)
    jenv = JRBC3DVectorEnv(2, **cfg, dtype=jnp.float32, fused=False,
                           poisson_precision=precision)
    env = RBC3DVectorEnv(2, **cfg, dtype=torch.float32, fused=False,
                         poisson_precision=precision, device="cpu")
    grid, _ = _grids(SHAPE[2], SHAPE[1], SHAPE[0])
    f = _np_fields(2, grid, seed=25)
    actions = np.random.default_rng(26).uniform(-1, 1, (2, 8, 8))
    want = jax.jit(jenv.solver.env_step)(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), f), jnp.asarray(actions, jnp.float32))
    got = env.solver.env_step(fields_from_numpy(f, dtype=torch.float32, cls=Fields3D),
                              torch.as_tensor(actions, dtype=torch.float32))
    for name, g in fields_to_numpy(got).items():
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), rtol=0, atol=ATOL32,
                                   err_msg=name)
    RBC3DVectorEnv(2, **cfg, poisson_precision="default", device="cpu")


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_2d_env_precision_matches_jax(precision):
    """The 2D env at ``poisson_precision``: "high" is "highest" in both
    packages; the solver against the JAX env's in float32."""
    cfg = dict(state_shape=(16, 32), observation_shape=(8, 16), heater_duration=0.06)
    jenv = JRBC2DVectorEnv(2, **cfg, dtype=jnp.float32, poisson_precision=precision)
    env = RBC2DVectorEnv(2, **cfg, dtype=torch.float32, poisson_precision=precision,
                         device="cpu")
    rng = np.random.default_rng(27)
    nz, nx = cfg["state_shape"]
    u = 0.05 * rng.standard_normal((2, nx, nz))
    w = 0.05 * rng.standard_normal((2, nx, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + 0.05 * rng.standard_normal((2, nx, nz)), 1.0, 2.0)
    p_hy = np.asarray(jsolver2d._hydrostatic_pressure(jnp.asarray(b), 2.0 / nz, 1.0))
    f = jsolver2d.Fields2D(u, w, b, p_hy, np.zeros_like(u))
    actions = rng.uniform(-1, 1, (2, 12))
    want = jax.jit(jenv.solver.env_step)(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), f), jnp.asarray(actions, jnp.float32))
    got = env.solver.env_step(fields_from_numpy(f, dtype=torch.float32, cls=Fields2D),
                              torch.as_tensor(actions, dtype=torch.float32))
    for name, g in fields_to_numpy(got).items():
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), rtol=0, atol=ATOL32,
                                   err_msg=name)
