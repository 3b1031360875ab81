"""The port's 3D building blocks against the JAX package, on the CPU.

Inputs are made by numpy from a seed and handed to both packages.
Tolerances, each with its reason:
- float64, the same formulas in both packages (actuation, Nusselt, both
  Poisson forms): atol 1e-10; the differences are summation order only.
- float32 against the Pallas stage and correction kernels run in the
  interpreter: the kernels use the C6/D5 flux form and a doubling-shift
  suffix sum, the plain versions the select-form stencils and a cumulative
  sum, so the two differ in float32 rounding only: atol 5e-6, the JAX
  package's own gate for its stage kernel against its XLA path
  (tests/test_pallas3d.py:56-70).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.ops import poisson as jpoisson
from rbc_gym_tpu.ops.pallas3d import make_projection_glue_3d, make_stage_rk_3d
from rbc_gym_tpu.sim import actuation as jact
from rbc_gym_tpu.sim import nusselt as jnu
from rbc_gym_tpu_torch.ops import kernels3d as k3
from rbc_gym_tpu_torch.ops import poisson as tpoisson
from rbc_gym_tpu_torch.ops import stencils as tst
from rbc_gym_tpu_torch.sim import actuation as tact
from rbc_gym_tpu_torch.sim import nusselt as tnu
from rbc_gym_tpu_torch.sim.grid import Grid3D
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ATOL64 = 1e-10
ATOL32 = 5e-6
E, NX, NY, NZ = 2, 8, 8, 8
GRID = Grid3D(nx=NX, ny=NY, nz=NZ, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
NU, KAPPA, MIN_B = float(np.sqrt(0.7 / 2500)), float(1 / np.sqrt(0.7 * 2500)), 1.0
COEFFS = k3.Coeffs3D(GRID.dx, GRID.dy, GRID.dz, NU, KAPPA, MIN_B)


def _np_case(seed=0, amp=0.05, e=E, nx=NX, ny=NY, nz=NZ):
    """Convective-looking fields, a bottom plate, a pending solve q (solve
    layout) and previous-stage tendencies, all from one seed."""
    rng = np.random.default_rng(seed)
    u = amp * rng.standard_normal((e, nx, ny, nz))
    v = amp * rng.standard_normal((e, nx, ny, nz))
    w = amp * rng.standard_normal((e, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + amp * rng.standard_normal((e, nx, ny, nz)), 1.0, 2.0)
    bottom = rng.uniform(1.5, 2.5, (e, nx, ny))
    q = 0.01 * rng.standard_normal((e, ny, nx, nz))
    g_prev = [0.1 * rng.standard_normal(a.shape) for a in (u, v, w, b)]
    g_prev[2][..., 0] = g_prev[2][..., -1] = 0.0
    return dict(u=u, v=v, w=w, b=b, bottom=bottom, q=q, g_prev=g_prev)


def _t32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _bm(a):
    """Public (E, nx, ny, nk) -> JAX batch-minor (nx, nk, ny, E), float32."""
    return jnp.asarray(np.transpose(a, (1, 3, 2, 0)).astype(np.float32))


def _from_bm(a):
    return np.transpose(np.asarray(a), (3, 0, 2, 1))


def test_preprocess_action_and_heater_profile_match_jax():
    rng = np.random.default_rng(1)
    for actions in (rng.uniform(-1, 1, (3, 8, 8)), 3.0 * rng.standard_normal((2, 8, 8))):
        want = np.asarray(jact.preprocess_action_3d(jnp.asarray(actions), 0.9, 1.0, 1.0))
        got = tact.preprocess_action_3d(torch.as_tensor(actions), 0.9, 1.0, 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL64)
        for nx, ny in ((32, 32), (12, 20)):
            lx, ly = 4 * np.pi, 3.0
            xc, yc = (np.arange(nx) + 0.5) * lx / nx, (np.arange(ny) + 0.5) * ly / ny
            jprof = jact.heater_profile_3d(jnp.asarray(want), xc, yc, lx, ly, 8)
            prof = tact.heater_profile_3d(got, xc, yc, lx, ly, 8)
            assert tuple(prof.shape) == actions.shape[:-2] + (nx, ny)
            np.testing.assert_allclose(prof.numpy(), np.asarray(jprof), rtol=0, atol=ATOL64)
    # a constant action is a flat plate at min_b + delta_b
    flat = tact.preprocess_action_3d(torch.full((8, 8), 0.7, dtype=torch.float64), 0.9, 1.0, 1.0)
    assert torch.all(flat == 2.0)


def test_nusselt_3d_matches_jax_and_keeps_unit_height_midpoints():
    case = _np_case(seed=2)
    b, w = case["b"], case["w"][..., :NZ]
    for kappa, min_b, delta_b in ((KAPPA, 1.0, 1.0), (0.01, 0.5, 2.0)):
        want = np.asarray(jnu.nusselt_3d(jnp.asarray(b), jnp.asarray(w), kappa, min_b, delta_b))
        got = tnu.nusselt_3d(torch.as_tensor(b), torch.as_tensor(w), kappa, min_b, delta_b)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL64)
    # the conductive profile ignores the domain height: zero w gives exactly 1
    zero = tnu.nusselt_3d(torch.as_tensor(b), torch.zeros_like(torch.as_tensor(w)), KAPPA, 1, 1)
    assert torch.all(zero == 1.0)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("shape", [(8, 8, 8), (32, 32, 16), (12, 8, 10)])
def test_poisson_3d_matches_jax_both_forms(shape, factored):
    nx, ny, nz = shape
    dx, dy, dz = 4 * np.pi / nx, 4 * np.pi / ny, 2.0 / nz
    rhs = np.random.default_rng(3).standard_normal((2, ny, nx, nz))
    jsolve = jpoisson.make_poisson_solver_3d_bm(nx, ny, nz, dx, dy, dz, jnp.float64,
                                                factored=factored)
    want = np.asarray(jsolve(jnp.asarray(rhs.transpose(2, 3, 1, 0)))).transpose(3, 2, 0, 1)
    solve = tpoisson.make_poisson_solver_3d(nx, ny, nz, dx, dy, dz, torch.float64, "cpu",
                                            factored=factored)
    np.testing.assert_allclose(solve(torch.as_tensor(rhs)).numpy(), want, rtol=0, atol=ATOL64)


def test_poisson_3d_default_form_follows_the_jax_rule():
    assert tpoisson.FACTORED_POISSON_MIN_NXNZ == jpoisson.FACTORED_POISSON_MIN_NXNZ
    # the solve inverts the discrete Laplacian of the stage's divergence
    p = np.random.default_rng(4).standard_normal((1, NX, NY, NZ))
    p -= p.mean()
    t = torch.as_tensor(p)
    lap = k3.divergence_3d(tst.ddx_c2f(t, GRID.dx, -3), tst.ddx_c2f(t, GRID.dy, -2),
                           tst.ddz_c2f_interior(t, GRID.dz), COEFFS)
    solve = tpoisson.make_poisson_solver_3d(NX, NY, NZ, GRID.dx, GRID.dy, GRID.dz,
                                            torch.float64, "cpu")
    back = k3.from_solve_layout(solve(k3.to_solve_layout(lap)))
    np.testing.assert_allclose(back.numpy(), p, rtol=0, atol=ATOL64)


@pytest.fixture(scope="module")
def pallas_stages():
    return make_stage_rk_3d(NX, NY, NZ, GRID.dx, GRID.dy, GRID.dz, NU, KAPPA, MIN_B,
                            x_blk=4, e_blk=E, interpret=True)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_plain_matches_pallas_stage_kernel(pallas_stages, stage):
    case = _np_case(seed=5 + stage)
    dt = 0.04
    q_public = np.transpose(case["q"], (0, 2, 1, 3))
    args = [_bm(case[n]) for n in "uvwb"] + [
        _bm(q_public), jnp.asarray(np.transpose(case["bottom"], (1, 2, 0)).astype(np.float32)),
        jnp.float32(dt),
    ]
    g_prev = None
    if stage > 0:
        args.append(tuple(_bm(a) for a in case["g_prev"]))
        g_prev = tuple(_t32(a) for a in case["g_prev"])
    want = pallas_stages[stage](*args)
    got = k3.stage_rk_3d_plain(*(_t32(case[n]) for n in ("u", "v", "w", "b", "q", "bottom")),
                               COEFFS, dt, stage, g_prev)
    names = ["u", "v", "w", "b", "div"] + (["gu", "gv", "gw", "gb"] if stage < 2 else [])
    assert (got[5] is None) == (stage == 2) and len(want) == len(names)
    outs = list(got[:4]) + [k3.from_solve_layout(got[4])] + (list(got[5]) if stage < 2 else [])
    for name, g, w in zip(names, outs, want):
        np.testing.assert_allclose(g.numpy(), _from_bm(w), rtol=0, atol=ATOL32, err_msg=name)
    # the wall faces of w* stay exactly zero
    assert torch.all(got[2][..., 0] == 0) and torch.all(got[2][..., -1] == 0)


def test_correct_plain_matches_pallas_correct_kernel():
    case = _np_case(seed=9)
    _, correct = make_projection_glue_3d(NX, NY, NZ, GRID.dx, GRID.dy, GRID.dz, e_blk=E,
                                         interpret=True)
    q_public = np.transpose(case["q"], (0, 2, 1, 3))
    want = correct(*(_bm(case[n]) for n in "uvw"), _bm(q_public))
    got = k3.correct_3d_plain(*(_t32(case[n]) for n in ("u", "v", "w", "q")), COEFFS)
    for name, g, w in zip("uvw", got, want):
        np.testing.assert_allclose(g.numpy(), _from_bm(w), rtol=0, atol=ATOL32, err_msg=name)


def test_solve_layout_round_trip():
    a = torch.arange(2 * 3 * 4 * 5, dtype=torch.float64).reshape(2, 3, 4, 5)
    s = k3.to_solve_layout(a)
    assert tuple(s.shape) == (2, 4, 3, 5) and s.is_contiguous()
    assert s[1, 2, 0, 3] == a[1, 0, 2, 3]
    assert torch.equal(k3.from_solve_layout(s), a)
