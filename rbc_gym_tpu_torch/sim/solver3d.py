"""3D Rayleigh-Bénard solver (periodic x/y, bounded z) on the staggered C-grid.

Port of ``rbc_gym_tpu.sim.solver3d``. Physics: the reference's
sim/rbc_sim3D.jl (UpwindBiasedFifthOrder, :RungeKutta3, buoyancy tracer,
nu = sqrt(Pr/Ra), kappa = 1/sqrt(Pr Ra), no-slip u/v, fixed top
temperature, actuated S x S bottom tiles). Times are in free-fall units,
t_ff = Lz^2: one env step spans heater_duration * t_ff, split into solver
steps of dt_solver * t_ff whose last one is clipped to land on the step
boundary (``SimParams3D.substep_dts``).

Public layout (batch..., nx, ny, nz[+1]):
  u (x-face, y-center, z-center), v (x-center, y-face, z-center),
  w (x-center, y-center, z-face), b and pressures at centers.

``env_step`` runs one of two substep loops of the JAX package, picked
once per solver by ``select_stage_path`` (``Solver3D.path``):
- the lazy-projection loop of its stage paths (``lazy_substeps``): per
  substep three stage launches with a Poisson solve after each, the
  pending (unscaled) solve ``q`` carried between stages; one correction
  at the end of the env step; pHY' and p_nhs = q / dt_stage recovered
  once. The stage function is K3 ``stage_rk_3d`` ("stage", and
  "stage_ew"), K3's analysis instance ``stage_rk_3d_rhat`` ("stage_qp",
  whose solve is then the tail alone) or K5 ``stage_rk_3d_xy``
  ("stage_xy"), with K4 ``correct_3d``, or their plain versions ("plain");
- the per-field loop of its ``fused="field"`` path (``field_substeps``,
  "field"): each stage computes the four tendencies (K6
  ``field_tendency_3d``, pHY' inside its u and v launches), the RK update,
  the divergence (K7 ``div_3d``), its solve and the correction (K4), so
  every stage is projected.
All kernels are in ``csrc/rbc3d.cu``; for CPU tensors a kernel wrapper
runs its plain version. ``substep`` is one substep of the per-field loop
through the plain versions: the JAX package's eager ``substep_bm``, which
reaches no kernel there either.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from rbc_gym_tpu_torch import default_device
from rbc_gym_tpu_torch.ops.kernels2d import RK3_GAMMA, RK3_ZETA, hydrostatic_pressure
from rbc_gym_tpu_torch.ops.kernels3d import (
    Coeffs3D,
    correct_3d,
    correct_3d_plain,
    div_3d,
    div_3d_plain,
    divergence_3d,
    field_tendency_3d,
    field_tendency_3d_plain,
    from_solve_layout,
    stage_rk_3d,
    stage_rk_3d_plain,
    stage_rk_3d_rhat,
    stage_rk_3d_xy,
    tendencies_3d_plain,
    to_solve_layout,
    X,
    Y,
    Z,
)
from rbc_gym_tpu_torch.ops import stencils as st
from rbc_gym_tpu_torch.ops.limits import (
    SMEM_PER_BLOCK,
    MAX_ENV_POINTS,
    MAX_THREADS,
    XY_MAX_SPLIT,
    XY_MIN_NX,
    Y_BLK,
    stage_qp_smem_bytes,
    stage_smem_bytes,
    stage_xy_smem_bytes,
    stage_xy_split_size,
    stage_xy_split_smem_bytes,
    whole_y_fits,
)
from rbc_gym_tpu_torch.ops.poisson import make_poisson_solver_3d, make_poisson_tail_3d
from rbc_gym_tpu_torch.sim.actuation import heater_profile_3d, preprocess_action_3d
from rbc_gym_tpu_torch.sim.grid import Grid3D


@dataclasses.dataclass(frozen=True)
class SimParams3D:
    """Defaults: reference rbc_sim3D_api.jl:17 + envs/rbc3D.py:43-60."""

    ra: float = 2500.0
    pr: float = 0.7
    min_b: float = 1.0
    delta_b: float = 1.0
    dt_solver: float = 0.01  # free-fall units
    heater_duration: float = 0.125  # env step, free-fall units
    n_heaters: int = 8
    heater_limit: float = 0.9
    random_kick: float = 0.01
    lz: float = 2.0

    @property
    def nu(self) -> float:
        return float(np.sqrt(self.pr / self.ra))

    @property
    def kappa(self) -> float:
        return float(1.0 / np.sqrt(self.pr * self.ra))

    @property
    def t_ff(self) -> float:
        return self.lz**2

    def substep_dts(self) -> np.ndarray:
        """Solver dt sequence per env step (buoyancy time units); the final
        entry is clipped so the sum is exactly heater_duration * t_ff."""
        total = self.heater_duration * self.t_ff
        dt = self.dt_solver * self.t_ff
        n_full = int(total / dt + 1e-9)
        rem = total - n_full * dt
        if rem > 1e-12 * max(1.0, total):
            return np.array([dt] * n_full + [rem])
        return np.array([dt] * n_full)


class Fields3D(NamedTuple):
    u: torch.Tensor  # (..., nx, ny, nz)
    v: torch.Tensor  # (..., nx, ny, nz)
    w: torch.Tensor  # (..., nx, ny, nz + 1)
    b: torch.Tensor  # (..., nx, ny, nz)
    p_hy: torch.Tensor  # (..., nx, ny, nz)
    p_nhs: torch.Tensor  # (..., nx, ny, nz)


class Solver3D(NamedTuple):
    """Function bundle for one grid + params + dtype + device."""

    grid: Grid3D
    params: SimParams3D
    dtype: torch.dtype
    device: torch.device
    path: str  # env_step's loop and kernels: a KERNEL_PATHS value or "plain"
    coeffs: Coeffs3D
    solve: Callable  # solve-layout rhs (E, ny, nx, nz) -> p
    stage_solve: Callable  # the solve of a stage's output: ``solve``, or on "stage_qp" the tail
    init_random: Callable  # (generator, batch_shape) -> Fields3D
    env_step: Callable  # (Fields3D, action (..., S, S)) -> Fields3D
    substep: Callable  # (Fields3D, bottom (..., nx, ny), dt) -> Fields3D
    preprocess_action: Callable  # action (..., S, S) -> tile temperatures
    heater_profile: Callable  # action (..., S, S) -> bottom (..., nx, ny)


# Largest max|div u| a projected step may leave: float64 as the JAX
# package's oracle (tests/test_solver3d.py:65), float32 its device gate
# (tests/test_pallas3d.py:95).
DIVERGENCE_ATOL = {torch.float64: 1e-8, torch.float32: 5e-4}


# The stage and correction functions of each lazy-loop path. "stage_ew" is
# the JAX package's K3 read through overlapping x-padded pl.Element windows,
# so that no x halo is concatenated in VMEM; K3's x march already reads each
# x-plane once through its cp.async ring, so on the card the same function
# runs K3 itself. "stage_qp" runs K3's analysis instance, whose rhat the
# solve's tail takes (``make_solver3d``).
STAGE_PATHS = {
    "stage": (stage_rk_3d, correct_3d),
    "stage_ew": (stage_rk_3d, correct_3d),
    "stage_qp": (stage_rk_3d_rhat, correct_3d),
    "stage_xy": (stage_rk_3d_xy, correct_3d),
    "plain": (stage_rk_3d_plain, correct_3d_plain),
}
# The tendency, divergence and correction functions of the per-field loop:
# the kernels, and their plain versions.
FIELD_KERNELS = (field_tendency_3d, div_3d, correct_3d)
FIELD_PLAIN = (field_tendency_3d_plain, div_3d_plain, correct_3d_plain)
KERNEL_PATHS = ("stage", "stage_xy", "field", "stage_qp", "stage_ew")
# K3's paths: the stage kernel over whole y (its analysis instance on "stage_qp")
K3_PATHS = ("stage", "stage_qp", "stage_ew")


def stage_kernel_limit(kernel: str, dtype: torch.dtype, nx: int, ny: int, nz: int):
    """Why the kernels of path ``kernel`` ("stage" and "stage_ew" for K3,
    "stage_qp" for K3's analysis instance, "stage_xy" for K5, "field" for
    K6 and K7) cannot take this configuration, or None if they can: the
    checks of the launchers in ``csrc/rbc3d.cu`` and the card's shared
    memory per block."""
    if dtype != torch.float32:
        return f"the {kernel} kernel takes float32, not {dtype}"
    if kernel == "field":  # K6's general instance and K7 take any grid whose taps wrap once
        if nx < 3 or ny < 3 or nz < 2:
            return f"the field kernels need nx, ny >= 3 and nz >= 2 (nx={nx}, ny={ny}, nz={nz})"
        if nx * ny * (nz + 1) > MAX_ENV_POINTS:
            return (f"the field kernels index an env with 32-bit offsets: nx * ny * (nz + 1) "
                    f"<= {MAX_ENV_POINTS:,} (nx={nx}, ny={ny}, nz={nz})")
        return None
    if kernel in K3_PATHS:
        if nx < XY_MIN_NX or ny < 4 or nz < 2:
            return (f"the {kernel} kernel needs nx >= {XY_MIN_NX}, ny >= 4 and nz >= 2 "
                    f"(nx={nx}, ny={ny}, nz={nz})")
        if ny * nz > MAX_THREADS:
            return (f"the {kernel} kernel needs ny * nz <= {MAX_THREADS}, one thread per point "
                    f"of an x-plane (ny={ny}, nz={nz})")
        if kernel == "stage_qp":
            need = stage_qp_smem_bytes(nx, ny, nz)
        else:
            need = stage_smem_bytes(ny, nz)
    else:
        if nx < XY_MIN_NX or ny % Y_BLK or nz < 2:
            return (f"the stage_xy kernel needs nx >= {XY_MIN_NX}, ny % {Y_BLK} == 0 and "
                    f"nz >= 2 (nx={nx}, ny={ny}, nz={nz})")
        if stage_xy_split_size(nz):  # one CTA cannot hold the column: K5's z split
            return None
        need = stage_xy_smem_bytes(nz)
        if need > SMEM_PER_BLOCK:
            need = stage_xy_split_smem_bytes(nz, XY_MAX_SPLIT)
            return (f"the {kernel} kernel needs {need:,} bytes of shared memory per block "
                    f"at nx={nx}, ny={ny}, nz={nz} even with its column split over "
                    f"{XY_MAX_SPLIT} CTAs; the card's limit is {SMEM_PER_BLOCK:,}")
    if need > SMEM_PER_BLOCK:
        return (f"the {kernel} kernel needs {need:,} bytes of shared memory per block "
                f"at nx={nx}, ny={ny}, nz={nz}; the card's limit is {SMEM_PER_BLOCK:,}")
    return None


def select_stage_path(dtype: torch.dtype, nx: int, ny: int, nz: int, device_type: str,
                      fused=None) -> str:
    """The loop and kernels ``env_step`` runs: "stage" (K3), "stage_xy"
    (K5), "field" (K6 and K7) or "plain", from the dtype and the grid only.

    Auto (``fused=None``) follows the JAX package's rule
    (rbc_gym_tpu/sim/solver3d.py:323-350) with a boundary on the card,
    ``limits.whole_y_fits``, in place of the TPU's VMEM rule. On CUDA in
    float32: inside it, K3 if nx % 4 == 0 and K3 takes the grid (one
    thread per point of an x-plane: ny * nz <= 1024), otherwise the
    per-field path; outside it,
    K5 if nx % 4 == 0 and ny % 8 == 0 (its z split over a cluster of 2, 4
    or 8 CTAs where one CTA cannot hold the column, nz >= 107:
    ``limits.stage_xy_split_size``), raising ``NotImplementedError`` only
    past the split's reach (nz > 784); otherwise the plain path, as the
    JAX package takes its XLA path there. float64 and the CPU take the plain
    path, as the JAX package does. ``fused=False`` is the plain path;
    a ``KERNEL_PATHS`` value (True is the JAX package's alias of "field")
    forces that path and raises ``ValueError``, naming the limit, if its
    kernels cannot take the configuration (on the CPU the wrappers then
    run their plain versions). "stage_qp" (K3's analysis instance, which
    needs Cz^T, nz^2 floats, beside K3's shared memory) and "stage_ew" (K3)
    are opt-in, as in the JAX package.
    """
    if fused is False:
        return "plain"
    if fused is True:
        fused = "field"
    if fused is None:
        if device_type != "cuda" or dtype != torch.float32:
            return "plain"
        if whole_y_fits(ny, nz):
            k3_takes = stage_kernel_limit("stage", dtype, nx, ny, nz) is None
            want = "stage" if nx % 4 == 0 and k3_takes else "field"
        elif nx % 4 == 0 and ny % Y_BLK == 0:
            want = "stage_xy"
        else:
            return "plain"
        limit = stage_kernel_limit(want, dtype, nx, ny, nz)
        if limit is not None:
            raise NotImplementedError(
                f"the JAX package runs its {want} kernel here, and {limit}")
        return want
    if fused not in KERNEL_PATHS:
        raise ValueError(f"unknown fused={fused!r}: None, False, True, "
                         + ", ".join(map(repr, KERNEL_PATHS)))
    limit = stage_kernel_limit(fused, dtype, nx, ny, nz)
    if limit is not None:
        raise ValueError(f"fused={fused!r} cannot be forced here: {limit}")
    return fused


def max_divergence_3d(f: Fields3D, grid: Grid3D) -> float:
    """max |div u| over all envs and cells."""
    c = Coeffs3D(grid.dx, grid.dy, grid.dz, 0.0, 0.0, 0.0)
    return float(divergence_3d(f.u, f.v, f.w, c).abs().max())


def lazy_substeps(
    u: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bottom: torch.Tensor,
    dts: Sequence[float],
    solve: Callable,
    c: Coeffs3D,
    stage_rk: Callable,
    correct: Callable,
):
    """The lazy-projection substep loop of one env step on (E, ...) fields
    -> (u, v, w, b, q), velocities projected, q the last stage's unscaled
    solve in the solve layout.

    The incoming fields are projected, so the pending solve starts at zero.
    ``stage_rk`` and ``correct`` are a path's pair of ``STAGE_PATHS``;
    ``solve`` takes a stage's fifth output to q (div, or on "stage_qp"
    rhat, through the tail: ``Solver3D.stage_solve``)."""
    e, nx, ny, nz = u.shape
    q = torch.zeros((e, ny, nx, nz), dtype=u.dtype, device=u.device)
    for dt in dts:
        g = None
        for m in range(3):
            u, v, w, b, div, g = stage_rk(u, v, w, b, q, bottom, c, float(dt), m, g)
            q = solve(div)
    u, v, w = correct(u, v, w, q, c)
    return u, v, w, b, q


def field_substeps(
    u: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bottom: torch.Tensor,
    dts: Sequence[float],
    solve: Callable,
    c: Coeffs3D,
    tend: Callable,
    div: Callable,
    correct: Callable,
):
    """The per-field substep loop of one env step on (E, ...) fields
    (the JAX package's ``substep_bm_fused``) -> (u, v, w, b, q), q the
    last stage's unscaled solve in the solve layout, which the last
    correction has already applied.

    Each stage: the four tendencies (u and v compute pHY' from b), the RK
    update, the divergence, its solve and the correction. ``tend``, ``div``
    and ``correct`` are ``FIELD_KERNELS`` or ``FIELD_PLAIN``."""
    q = None
    for dt in dts:
        dt = float(dt)
        g_prev = None
        for m in range(3):
            gamma, zeta = RK3_GAMMA[m], RK3_ZETA[m]
            g = (tend("u", u, v, w, b, c=c), tend("v", u, v, w, b, c=c),
                 tend("w", u, v, w, c=c), tend("b", u, v, w, b, bottom, c=c))
            if m == 0:
                u, v, w, b = (f + dt * gamma * gf for f, gf in zip((u, v, w, b), g))
            else:
                u, v, w, b = (f + dt * (gamma * gf + zeta * gp)
                              for f, gf, gp in zip((u, v, w, b), g, g_prev))
            g_prev = g
            q = solve(div(u, v, w, c))
            u, v, w = correct(u, v, w, q, c)
    return u, v, w, b, q


def make_solver3d(
    grid: Grid3D,
    params: SimParams3D,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = "cuda",
    fused: bool | str | None = None,
    poisson_precision: str | None = None,
) -> Solver3D:
    """Build the 3D solver bundle on ``device``. ``fused`` picks the loop
    and its kernels (``select_stage_path``); the Poisson solve takes the
    JAX package's form for the grid (dense below nx * nz = 1024), on
    "stage_qp" its tail after K3's analysis instance.
    ``poisson_precision`` is the precision of the solve's products
    (``ops.poisson.matmul``): None or "highest" full float32, "high" three
    TF32 products of split operands, "default" one; the analysis inside
    K3's instance is float32 whatever it is, as the Pallas kernel's dot is
    HIGHEST."""
    if abs(grid.lz - params.lz) > 1e-12:
        params = dataclasses.replace(params, lz=grid.lz)
    device = default_device(device)
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    path = select_stage_path(dtype, nx, ny, nz, device.type, fused)
    min_b = params.min_b
    coeffs = Coeffs3D(grid.dx, grid.dy, grid.dz, params.nu, params.kappa, min_b)
    solve = make_poisson_solver_3d(nx, ny, nz, grid.dx, grid.dy, grid.dz, dtype, device,
                                   precision=poisson_precision)
    stage_solve = solve
    if path == "stage_qp":
        stage_solve = make_poisson_tail_3d(nx, ny, nz, grid.dx, grid.dy, grid.dz, dtype, device,
                                           precision=poisson_precision)
    dts = [float(d) for d in params.substep_dts()]
    dt_last = (RK3_GAMMA[2] + RK3_ZETA[2]) * dts[-1]

    def flat(f: Fields3D) -> Fields3D:
        return Fields3D(*(q.reshape((-1,) + q.shape[-3:]).contiguous() for q in f))

    def unflat(f: Fields3D, batch) -> Fields3D:
        return Fields3D(*(q.reshape(batch + q.shape[-3:]) for q in f))

    def flat_bottom(bottom: torch.Tensor, batch) -> torch.Tensor:
        return torch.broadcast_to(bottom, batch + (nx, ny)).reshape(-1, nx, ny).contiguous()

    def preprocess(action) -> torch.Tensor:
        action = torch.as_tensor(action, dtype=dtype, device=device)
        return preprocess_action_3d(action, params.heater_limit, min_b, params.delta_b)

    def heater_profile(action) -> torch.Tensor:
        return heater_profile_3d(preprocess(action), grid.x_centers(), grid.y_centers(),
                                 grid.lx, grid.ly, params.n_heaters)

    def env_step(f: Fields3D, action) -> Fields3D:
        """Advance one env step; action is the raw (..., S, S) agent action."""
        batch = f.u.shape[:-3]
        g = flat(f)
        bottom = flat_bottom(heater_profile(action), batch)
        if path == "field":
            u, v, w, b, q = field_substeps(g.u, g.v, g.w, g.b, bottom, dts, solve, coeffs,
                                           *FIELD_KERNELS)
        else:
            u, v, w, b, q = lazy_substeps(g.u, g.v, g.w, g.b, bottom, dts, stage_solve, coeffs,
                                          *STAGE_PATHS[path])
        out = Fields3D(u, v, w, b, hydrostatic_pressure(b, grid.dz, min_b),
                       from_solve_layout(q) / dt_last)
        return unflat(out, batch)

    def substep(f: Fields3D, bottom: torch.Tensor, dt: float) -> Fields3D:
        """One plain RK3 solver step of ``dt``, each stage projected; bottom
        (..., nx, ny) broadcasting."""
        batch = f.u.shape[:-3]
        g = flat(f)
        bot = flat_bottom(torch.as_tensor(bottom, dtype=dtype, device=device), batch)
        u, v, w, b, q = field_substeps(g.u, g.v, g.w, g.b, bot, [dt], solve, coeffs,
                                       *FIELD_PLAIN)
        p_nhs = from_solve_layout(q) / ((RK3_GAMMA[2] + RK3_ZETA[2]) * float(dt))
        out = Fields3D(u, v, w, b, hydrostatic_pressure(b, grid.dz, min_b), p_nhs)
        return unflat(out, batch)

    def init_random(generator: torch.Generator, batch_shape: Tuple[int, ...] = ()) -> Fields3D:
        """Reference sim/rbc_sim3D.jl:169-178: conductive profile + kick."""
        batch_shape = tuple(batch_shape)
        kick = params.random_kick

        def normal(shape):
            return torch.randn(shape, generator=generator, dtype=dtype, device=device)

        shape_c = batch_shape + (nx, ny, nz)
        u = kick * normal(shape_c)
        v = kick * normal(shape_c)
        w = kick * normal(batch_shape + (nx, ny, nz + 1))
        w[..., 0] = 0.0
        w[..., -1] = 0.0
        z_c = torch.as_tensor(grid.z_centers(), dtype=dtype, device=device)
        profile = min_b + (grid.lz - z_c) * params.delta_b / 2.0
        b = torch.clamp(profile + kick * normal(shape_c), min_b, min_b + params.delta_b)
        return Fields3D(u, v, w, b, hydrostatic_pressure(b, grid.dz, min_b), torch.zeros_like(u))

    return Solver3D(
        grid=grid,
        params=params,
        dtype=dtype,
        device=device,
        path=path,
        coeffs=coeffs,
        solve=solve,
        stage_solve=stage_solve,
        init_random=init_random,
        env_step=env_step,
        substep=substep,
        preprocess_action=preprocess,
        heater_profile=heater_profile,
    )
