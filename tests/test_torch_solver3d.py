"""The port's 3D solver against the JAX package, on the CPU.

Inputs are made by numpy (or a seeded torch generator, then shared as
numpy) and handed to both packages. Tolerances, each with its reason:
- float64 against the JAX XLA path (``fused=False``), same formulas: atol
  1e-10 after whole env steps; the port runs the lazy-projection loop
  (the kernels' plain versions), the JAX side its eager substep loop, so
  the two differ by rounding only.
- the physics oracles of tests/test_solver3d.py with its own gates:
  conduction is a fixed point (velocities 0 to 1e-12, Nu = 1 to 1e-10) and
  a step leaves max|div u| < 1e-8 in float64.
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
from rbc_gym_tpu_torch.sim.nusselt import nusselt_3d
from rbc_gym_tpu_torch.sim.solver3d import (
    DIVERGENCE_ATOL,
    Fields3D,
    SimParams3D,
    lazy_substeps,
    make_solver3d,
    max_divergence_3d,
)
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ATOL = 1e-10


def _grids(nx=8, ny=8, nz=8):
    dims = dict(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    return Grid3D(**dims), JGrid3D(**dims)


def _np_fields(n_env, grid, seed=0, amp=0.05):
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
    return jsolver.Fields3D(u, v, w, b, p_hy, 0.1 * rng.standard_normal(u.shape))


def _to_port(f) -> Fields3D:
    return fields_from_numpy(f, cls=Fields3D)


def _assert_fields_close(got: Fields3D, want, atol=ATOL):
    for name, g in fields_to_numpy(got).items():
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), rtol=0, atol=atol,
                                   err_msg=name)


def test_substep_dts_clip_the_last_step():
    p = SimParams3D()  # the training grid's env step: 0.125 * t_ff = 0.5
    dts = p.substep_dts()
    assert len(dts) == 13
    np.testing.assert_allclose(dts[:-1], 0.04)
    np.testing.assert_allclose(dts[-1], 0.02)
    np.testing.assert_allclose(dts.sum(), 0.5)
    np.testing.assert_array_equal(dts, jsolver.SimParams3D().substep_dts())
    exact = SimParams3D(heater_duration=0.25, dt_solver=0.005)
    assert len(exact.substep_dts()) == 50
    np.testing.assert_allclose(exact.substep_dts(), 0.02)


@pytest.mark.parametrize("shape,heater_duration,n_env", [
    ((8, 8, 8), 0.125, 2),  # the full 13-substep env step, clipped last step
    ((32, 32, 16), 0.015, 1),  # the training grid, 2 substeps (0.04, 0.02)
])
def test_env_step_matches_jax_xla_path_float64(shape, heater_duration, n_env):
    grid, jgrid = _grids(*shape)
    params = SimParams3D(heater_duration=heater_duration)
    port = make_solver3d(grid, params, dtype=torch.float64, device="cpu")
    ref = jsolver.make_solver3d(jgrid, jsolver.SimParams3D(heater_duration=heater_duration),
                                dtype=jnp.float64, fused=False)
    f = _np_fields(n_env, grid, seed=1)
    actions = np.random.default_rng(2).uniform(-1, 1, (n_env, 8, 8))
    want = jax.jit(ref.env_step)(jax.tree_util.tree_map(jnp.asarray, f), jnp.asarray(actions))
    _assert_fields_close(port.env_step(_to_port(f), torch.as_tensor(actions)), want)


def test_substep_and_heater_profile_match_jax_float64():
    grid, jgrid = _grids()
    port = make_solver3d(grid, SimParams3D(), dtype=torch.float64, device="cpu")
    ref = jsolver.make_solver3d(jgrid, jsolver.SimParams3D(), dtype=jnp.float64, fused=False)
    f = _np_fields(2, grid, seed=3)
    bottom = np.random.default_rng(4).uniform(1.5, 2.5, (2, 8, 8))
    want = jax.jit(ref.substep)(jax.tree_util.tree_map(jnp.asarray, f), jnp.asarray(bottom), 0.04)
    _assert_fields_close(port.substep(_to_port(f), torch.as_tensor(bottom), 0.04), want)
    actions = np.random.default_rng(5).uniform(-1, 1, (2, 8, 8))
    np.testing.assert_allclose(port.preprocess_action(actions).numpy(),
                               np.asarray(ref.preprocess_action(jnp.asarray(actions))),
                               rtol=0, atol=ATOL)


def test_lazy_loop_matches_the_plain_substep_loop():
    """env_step (one correction per env step, solves carried unscaled)
    equals the eager substep loop (a projection after every stage)."""
    grid, _ = _grids()
    s = make_solver3d(grid, SimParams3D(), dtype=torch.float64, device="cpu")
    f = _to_port(_np_fields(2, grid, seed=6))
    actions = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, (2, 8, 8)))
    stepped = s.env_step(f, actions)
    g, bottom = f, s.heater_profile(actions)
    for dt in s.params.substep_dts():
        g = s.substep(g, bottom, float(dt))
    _assert_fields_close(stepped, g)


def test_lazy_loop_launches_one_stage_per_rk_stage_and_one_correction():
    grid, _ = _grids()
    s = make_solver3d(grid, SimParams3D(), dtype=torch.float64, device="cpu")
    f = _to_port(_np_fields(2, grid, seed=8))
    calls = {"stage": [], "correct": 0}

    def stage(*args):
        calls["stage"].append(args[8])
        return k3.stage_rk_3d_plain(*args)

    def correct(*args):
        calls["correct"] += 1
        return k3.correct_3d_plain(*args)

    dts = s.params.substep_dts()
    out = lazy_substeps(f.u, f.v, f.w, f.b, s.heater_profile(torch.zeros(2, 8, 8)), dts,
                        s.solve, s.coeffs, stage, correct)
    assert calls == {"stage": [0, 1, 2] * 13, "correct": 1}
    assert tuple(out[4].shape) == (2, 8, 8, 8)  # q in the solve layout


def test_conduction_is_a_fixed_point():
    """Zero velocity + the linear conductive profile stays put under zero
    action; Nu is exactly 1 in the reference's 3D definition."""
    grid, _ = _grids(16, 16, 8)
    params = SimParams3D()
    s = make_solver3d(grid, params, dtype=torch.float64, device="cpu")
    b0 = params.min_b + (grid.lz - grid.z_centers()) * params.delta_b / 2.0
    b = torch.as_tensor(np.broadcast_to(b0, grid.shape_c).copy())
    zeros = torch.zeros(grid.shape_c, dtype=torch.float64)
    f = Fields3D(zeros, zeros, torch.zeros(grid.shape_w, dtype=torch.float64), b, zeros, zeros)
    for _ in range(3):
        f = s.env_step(f, torch.zeros(8, 8, dtype=torch.float64))
    for name in ("u", "v", "w"):
        np.testing.assert_allclose(getattr(f, name).numpy(), 0.0, atol=1e-12, err_msg=name)
    nus = nusselt_3d(f.b, f.w[..., : grid.nz], params.kappa, 1.0, 1.0)
    np.testing.assert_allclose(float(nus), 1.0, atol=1e-10)


def test_divergence_free_after_step_and_substep():
    grid, _ = _grids()
    s = make_solver3d(grid, SimParams3D(), dtype=torch.float64, device="cpu")
    f = s.init_random(torch.Generator().manual_seed(0), (2,))
    actions = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (2, 8, 8)))
    assert max_divergence_3d(s.env_step(f, actions), grid) < DIVERGENCE_ATOL[torch.float64]
    sub = s.substep(f, s.heater_profile(actions), 0.04)
    assert max_divergence_3d(sub, grid) < DIVERGENCE_ATOL[torch.float64]


def test_init_random_properties():
    grid, _ = _grids(8, 12, 6)
    p = SimParams3D()
    s = make_solver3d(grid, p, dtype=torch.float64, device="cpu")
    f = s.init_random(torch.Generator().manual_seed(1), (3,))
    assert tuple(f.u.shape) == (3, 8, 12, 6) and tuple(f.w.shape) == (3, 8, 12, 7)
    assert torch.all(f.w[..., 0] == 0) and torch.all(f.w[..., -1] == 0)
    assert f.b.min() >= p.min_b and f.b.max() <= p.min_b + p.delta_b
    assert torch.equal(f.p_hy, k3.hydrostatic_pressure(f.b, grid.dz, p.min_b))
    assert not bool(f.p_nhs.any())
    again = s.init_random(torch.Generator().manual_seed(1), (3,))
    assert all(torch.equal(a, b) for a, b in zip(f, again))


def test_wrappers_take_plain_path_only_on_cpu():
    grid, _ = _grids()
    s = make_solver3d(grid, SimParams3D(), dtype=torch.float64, device="cpu")
    f = _to_port(_np_fields(2, grid, seed=9))
    bottom = s.heater_profile(torch.zeros(2, 8, 8))
    q = k3.to_solve_layout(f.p_nhs)
    before = (k3.stage_rk_3d.launches, k3.correct_3d.launches)
    g_prev = None
    for stage in range(3):
        args = (f.u, f.v, f.w, f.b, q, bottom, s.coeffs, 0.04, stage, g_prev)
        got, want = k3.stage_rk_3d(*args), k3.stage_rk_3d_plain(*args)
        for a, b in zip(got[:5] + tuple(got[5] or ()), want[:5] + tuple(want[5] or ())):
            assert torch.equal(a, b)
        g_prev = got[5]
    for a, b in zip(k3.correct_3d(f.u, f.v, f.w, q, s.coeffs),
                    k3.correct_3d_plain(f.u, f.v, f.w, q, s.coeffs)):
        assert torch.equal(a, b)
    assert (k3.stage_rk_3d.launches, k3.correct_3d.launches) == before
    with pytest.raises(ValueError, match="g_prev"):
        k3.stage_rk_3d(f.u, f.v, f.w, f.b, q, bottom, s.coeffs, 0.04, 1)
    # a tensor on neither the CPU nor CUDA never reaches a plain version
    meta = [t.to("meta") for t in (f.u, f.v, f.w, f.b, q, bottom)]
    with pytest.raises(ValueError, match="CUDA"):
        k3.stage_rk_3d(*meta, s.coeffs, 0.04, 0)
    with pytest.raises(ValueError, match="CUDA"):
        k3.correct_3d(meta[0], meta[1], meta[2], meta[4], s.coeffs)


def test_solver_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_solver3d(_grids()[0], SimParams3D())
    assert make_solver3d(_grids()[0], SimParams3D(), device="cpu").device.type == "cpu"
