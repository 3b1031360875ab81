"""The port's 2D solver and its kernels' plain versions against the JAX
package, on the CPU.

Inputs are made by numpy from a seed and handed to both packages.
Tolerances, each with its reason:
- float32 against the Pallas kernels run in the interpreter: the kernels
  use the C6/D5 flux factorization and MXU/matmul contractions, the plain
  versions the select-form stencils and cumulative sums, so the two differ
  in float32 summation order only: atol 1e-5 for one stage's tendencies
  (tests/test_solver2d.py:208) and 5e-6 for a whole env step
  (tests/test_solver2d.py:225, utils/parity.py:20).
- float64 against the JAX XLA path (``fused=False``), same formulas: atol
  1e-10 after a full 50-substep env step at 96x64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.ops.pallas2d import make_env_step_fused_2d, make_tendencies_2d
from rbc_gym_tpu.sim import solver2d as jsolver
from rbc_gym_tpu.sim.grid import Grid2D as JGrid2D
from rbc_gym_tpu_torch import default_device
from rbc_gym_tpu_torch.ops import kernels2d as k2d
from rbc_gym_tpu_torch.sim.grid import Grid2D
from rbc_gym_tpu_torch.sim.solver2d import (
    DIVERGENCE_ATOL,
    Fields2D,
    SimParams2D,
    make_solver2d,
    max_divergence,
)
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

NX, NZ = 96, 64


def _grids(nx=NX, nz=NZ):
    return (Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0),
            JGrid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0))


def _np_fields(n_env, nx=NX, nz=NZ, seed=0, amp=0.05):
    """Random convective-looking state (velocities ~amp, b in [1, 2])."""
    rng = np.random.default_rng(seed)
    u = amp * rng.standard_normal((n_env, nx, nz))
    w = amp * rng.standard_normal((n_env, nx, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + amp * rng.standard_normal((n_env, nx, nz)), 1.0, 2.0)
    p_hy = np.asarray(jsolver._hydrostatic_pressure(jnp.asarray(b), 2.0 / nz, 1.0))
    return jsolver.Fields2D(u, w, b, p_hy, np.zeros_like(u))


def _bottom(n_env, nx=NX, seed=1):
    return 2.0 + 0.3 * np.sin(np.linspace(0, 2 * np.pi, nx, endpoint=False)
                              + np.random.default_rng(seed).uniform(0, 6, (n_env, 1)))


def _bm(a, dtype=np.float32):
    """(E, nx, nk) -> JAX batch-minor (nx, nk, E)."""
    return jnp.asarray(np.moveaxis(np.asarray(a, dtype), 0, -1))


def _from_bm(a):
    return np.moveaxis(np.asarray(a), -1, 0)


def _coeffs(grid, params=SimParams2D()):
    return k2d.Coeffs2D(grid.dx, grid.dz, params.nu, params.kappa, params.min_b)


def _pallas_tendencies(f, bottom, grid):
    """The Pallas tendency kernel in interpret mode, fed pHY' from the JAX
    package's ``_hydrostatic_pressure`` (``_np_fields``)."""
    p = SimParams2D()
    tend = make_tendencies_2d(NX, NZ, grid.dx, grid.dz, p.nu, p.kappa, p.min_b,
                              e_blk=8, interpret=True)
    return tend(_bm(f.u), _bm(f.w), _bm(f.b), _bm(f.p_hy), _bm(bottom))


def test_tendencies_plain_matches_pallas_tendency_kernel():
    """The stencil composition that takes pHY' (``tendencies_2d_phy``),
    term for term the JAX package's, from the same pHY'."""
    grid, _ = _grids()
    f, bottom = _np_fields(8, seed=3), _bottom(8)
    want = _pallas_tendencies(f, bottom, grid)
    t = fields_from_numpy(f, "cpu", torch.float32)
    got = k2d.tendencies_2d_phy(t.u, t.w, t.b, t.p_hy,
                                torch.as_tensor(bottom, dtype=torch.float32), _coeffs(grid))
    for name, g, w in zip(("gu", "gw", "gb"), got, want):
        np.testing.assert_allclose(g.numpy(), _from_bm(w), rtol=0, atol=1e-5, err_msg=name)


def test_tendencies_from_b_match_pallas_tendency_kernel():
    """K2's plain version takes b and computes pHY' itself; it matches the
    Pallas kernel fed the JAX package's pHY' of the same b."""
    grid, _ = _grids()
    f, bottom = _np_fields(8, seed=11), _bottom(8, seed=12)
    want = _pallas_tendencies(f, bottom, grid)
    t = fields_from_numpy(f, "cpu", torch.float32)
    got = k2d.tendencies_2d_plain(t.u, t.w, t.b, torch.as_tensor(bottom, dtype=torch.float32),
                                  _coeffs(grid))
    for name, g, w in zip(("gu", "gw", "gb"), got, want):
        np.testing.assert_allclose(g.numpy(), _from_bm(w), rtol=0, atol=1e-5, err_msg=name)


def test_env_step_plain_matches_pallas_whole_step_kernel():
    grid, _ = _grids()
    p = SimParams2D(heater_duration=0.06)  # 2 substeps keep the interpreter fast
    f, bottom = _np_fields(8, seed=4), _bottom(8, seed=2)
    step = make_env_step_fused_2d(NX, NZ, grid.dx, grid.dz, p.dt_solver, p.nu, p.kappa,
                                  p.min_b, p.substeps_per_env_step, e_blk=8, interpret=True)
    want = step(_bm(f.u), _bm(f.w), _bm(f.b), _bm(bottom))
    s = make_solver2d(grid, p, dtype=torch.float32, device="cpu")
    t = fields_from_numpy(f, "cpu", torch.float32)
    got = k2d.env_step_2d_plain(t.u, t.w, t.b, torch.as_tensor(bottom, dtype=torch.float32),
                                s.spectral, s.coeffs, p.dt_solver, p.substeps_per_env_step)
    for name, g, w in zip(("u", "w", "b", "p_nhs"), got, want):
        np.testing.assert_allclose(g.numpy(), _from_bm(w), rtol=0, atol=5e-6, err_msg=name)


def _pallas_and_plain_steps(precision, kernel_precision, seed):
    """One 2-substep env step of 8 envs from the same float32 fields: the
    Pallas whole-step kernel in the interpreter at ``kernel_precision``, the
    port's plain version at ``precision`` (``ops.poisson.matmul``'s names),
    and the plain version run in float64."""
    grid, _ = _grids()
    p = SimParams2D(heater_duration=0.06)
    f, bottom = _np_fields(8, seed=seed), _bottom(8, seed=seed + 1)
    step = make_env_step_fused_2d(NX, NZ, grid.dx, grid.dz, p.dt_solver, p.nu, p.kappa,
                                  p.min_b, p.substeps_per_env_step, e_blk=8, interpret=True,
                                  poisson_precision=kernel_precision)
    want = [_from_bm(x) for x in step(_bm(f.u), _bm(f.w), _bm(f.b), _bm(bottom))]
    got, ref = [], []
    for dtype, out in ((torch.float32, got), (torch.float64, ref)):
        s = make_solver2d(grid, p, dtype=dtype, device="cpu")
        t = fields_from_numpy(f, "cpu", dtype)
        out += [x.double().numpy() for x in k2d.env_step_2d_plain(
            t.u, t.w, t.b, torch.as_tensor(bottom, dtype=dtype), s.spectral, s.coeffs,
            p.dt_solver, p.substeps_per_env_step, precision)]
    return got, want, ref


def test_env_step_plain_at_high_matches_pallas_split_product_branch():
    """The plain version at "high" (three TF32-split products, the JAX 2D
    solver's "bf16x3") against the Pallas kernel's split-product branch
    (``poisson_precision="high"``: three bf16-split dots). Each side drops
    its lo . lo term: at most 2^-18 of a product's terms for bf16's 8 bits,
    2^-20 for TF32's 10; the products run in float32 on the CPU on both
    sides. Over 2 substeps with max |p| ~ 7e-3 those drops stay far under
    the float32 summation-order differences that the float32 gate, 5e-6,
    already allows (``test_env_step_plain_matches_pallas_whole_step_kernel``);
    each side's error against the plain version in float64 is in the message."""
    got, want, ref = _pallas_and_plain_steps("high", "high", seed=13)
    for name, g, w, r in zip(("u", "w", "b", "p_nhs"), got, want, ref):
        off64 = f"port {np.abs(g - r).max():.3e}, JAX {np.abs(w - r).max():.3e} off float64"
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-6, err_msg=f"{name}: {off64}")


def test_env_step_plain_at_default_matches_pallas_default_products():
    """The plain version at "default" against the Pallas kernel at
    ``poisson_precision="default"`` (one DEFAULT pass a product): on the
    CPU both run their products in full float32, so the float32 gate
    5e-6 holds."""
    got, want, _ = _pallas_and_plain_steps("default", "default", seed=15)
    for name, g, w in zip(("u", "w", "b", "p_nhs"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-6, err_msg=name)


def test_substep_at_bf16x3_matches_jax_substep():
    """``Solver2D.substep`` at ``poisson_precision="bf16x3"`` (its
    projections' products three TF32-split products) against the JAX
    solver's substep at "bf16x3" (its XLA projection at ``Precision.HIGH``,
    full float32 on the CPU), float32, at the float32 gate 5e-6: the lo . lo
    term the port drops is under 2^-20 of a product's terms."""
    grid, jgrid = _grids()
    port = make_solver2d(grid, SimParams2D(), dtype=torch.float32, device="cpu",
                         poisson_precision="bf16x3")
    ref = jsolver.make_solver2d(jgrid, jsolver.SimParams2D(), dtype=jnp.float32, fused=False,
                                poisson_precision="bf16x3")
    f, bottom = _np_fields(2, seed=17), _bottom(2, seed=18)
    want = jax.jit(ref.substep)(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), f),
                                jnp.asarray(bottom, jnp.float32))
    got = port.substep(fields_from_numpy(f, "cpu", torch.float32),
                       torch.as_tensor(bottom, dtype=torch.float32))
    _assert_fields_close(got, want, atol=5e-6)


@pytest.fixture(scope="module")
def solvers64():
    grid, jgrid = _grids()
    params = SimParams2D()  # heater_duration 1.5: the main path's 50 substeps
    jparams = jsolver.SimParams2D()
    return (make_solver2d(grid, params, dtype=torch.float64, device="cpu"),
            jsolver.make_solver2d(jgrid, jparams, dtype=jnp.float64, fused=False))


def _assert_fields_close(got: Fields2D, want, atol):
    want = want._asdict() if hasattr(want, "_asdict") else want
    for name, g in fields_to_numpy(got).items():
        np.testing.assert_allclose(g, np.asarray(want[name]), rtol=0, atol=atol, err_msg=name)


def test_env_step_matches_jax_xla_path_float64(solvers64):
    port, ref = solvers64
    f = _np_fields(2, seed=5)
    actions = np.random.default_rng(6).uniform(-1, 1, (2, 12))
    want = jax.jit(ref.env_step)(jax.tree_util.tree_map(jnp.asarray, f), jnp.asarray(actions))
    got = port.env_step(fields_from_numpy(f), torch.as_tensor(actions))
    _assert_fields_close(got, want, atol=1e-10)


def test_substep_matches_jax_xla_path_float64(solvers64):
    port, ref = solvers64
    f, bottom = _np_fields(2, seed=7), _bottom(2, seed=8)
    want = jax.jit(ref.substep)(jax.tree_util.tree_map(jnp.asarray, f), jnp.asarray(bottom))
    got = port.substep(fields_from_numpy(f), torch.as_tensor(bottom))
    _assert_fields_close(got, want, atol=1e-10)


def test_hydrostatic_pressure_and_heater_profile_match_jax(solvers64):
    port, ref = solvers64
    f = _np_fields(2, seed=9)
    np.testing.assert_allclose(
        k2d.hydrostatic_pressure(torch.as_tensor(f.b), 2.0 / NZ, 1.0).numpy(), f.p_hy,
        rtol=0, atol=1e-12)
    actions = np.random.default_rng(10).uniform(-1, 1, (2, 12))
    np.testing.assert_allclose(port.heater_profile(actions).numpy(),
                               np.asarray(ref.heater_profile(jnp.asarray(actions))),
                               rtol=0, atol=1e-12)


def test_conduction_is_a_fixed_point():
    """Zero velocity + the linear conductive profile stays put under zero
    action (PARITY.md section 1)."""
    grid, _ = _grids(32, 16)
    params = SimParams2D(heater_duration=0.3)
    s = make_solver2d(grid, params, dtype=torch.float64, device="cpu")
    b0 = params.min_b + (grid.lz - grid.z_centers()) * params.delta_b / 2.0
    b = torch.as_tensor(np.tile(b0, (grid.nx, 1)))
    f = Fields2D(torch.zeros(grid.shape_c, dtype=torch.float64),
                 torch.zeros(grid.shape_w, dtype=torch.float64), b,
                 torch.zeros_like(b), torch.zeros_like(b))
    for _ in range(5):
        f = s.env_step(f, torch.zeros(12, dtype=torch.float64))
    np.testing.assert_allclose(f.u.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(f.w.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(f.b.numpy(), b.numpy(), atol=1e-10)


def test_divergence_free_after_step_and_substep(solvers64):
    port, _ = solvers64
    f = port.init_random(torch.Generator().manual_seed(0), (2,))
    actions = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (2, 12)))
    stepped = port.env_step(f, actions)
    sub = port.substep(f, port.heater_profile(actions))
    assert max_divergence(stepped, port.grid) < DIVERGENCE_ATOL[torch.float64]
    assert max_divergence(sub, port.grid) < DIVERGENCE_ATOL[torch.float64]


def test_init_random_properties():
    grid, _ = _grids(32, 16)
    p = SimParams2D()
    s = make_solver2d(grid, p, dtype=torch.float64, device="cpu")
    f = s.init_random(torch.Generator().manual_seed(1), (3,))
    assert tuple(f.u.shape) == (3, 32, 16) and tuple(f.w.shape) == (3, 32, 17)
    assert torch.all(f.w[..., 0] == 0) and torch.all(f.w[..., -1] == 0)
    assert f.b.min() >= p.min_b and f.b.max() <= p.min_b + p.delta_b
    assert torch.equal(f.p_hy, k2d.hydrostatic_pressure(f.b, grid.dz, p.min_b))
    again = s.init_random(torch.Generator().manual_seed(1), (3,))
    assert all(torch.equal(a, b) for a, b in zip(f, again))


def test_wrappers_take_plain_path_only_on_cpu():
    grid, _ = _grids(32, 16)
    s = make_solver2d(grid, SimParams2D(heater_duration=0.06), dtype=torch.float64, device="cpu")
    f = s.init_random(torch.Generator().manual_seed(2), (2,))
    bottom = s.heater_profile(torch.zeros(2, 12, dtype=torch.float64))
    before = (k2d.env_step_2d.launches, k2d.tendencies_2d.launches)
    args = (f.u, f.w, f.b, bottom, s.coeffs)
    for got, want in zip(k2d.tendencies_2d(*args), k2d.tendencies_2d_plain(*args)):
        assert torch.equal(got, want)
    step_args = (f.u, f.w, f.b, bottom, s.spectral, s.coeffs, 0.03, 2)
    for got, want in zip(k2d.env_step_2d(*step_args), k2d.env_step_2d_plain(*step_args)):
        assert torch.equal(got, want)
    assert (k2d.env_step_2d.launches, k2d.tendencies_2d.launches) == before
    # a tensor on neither the CPU nor CUDA never reaches a plain version
    meta = [t.to("meta") for t in (f.u, f.w, f.b, bottom)]
    with pytest.raises(ValueError, match="CUDA"):
        k2d.tendencies_2d(*meta, s.coeffs)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError):
        make_solver2d(_grids(32, 16)[0], SimParams2D())
    assert default_device("cpu") == torch.device("cpu")
