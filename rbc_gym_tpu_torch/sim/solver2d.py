"""2D Rayleigh-Bénard solver: RK3 fractional step on the staggered C-grid.

Port of ``rbc_gym_tpu.sim.solver2d``. Physics (the reference's Oceananigans
NonhydrostaticModel setup, sim/rbc_sim2D.jl:149-160):

    du/dt = -div(u u) - dp/dx + nu laplace(u)
    dw/dt = -div(u w) - dp/dz + nu laplace(w) + b
    db/dt = -div(u b) + kappa laplace(b)
    div(u) = 0

with nu = sqrt(Pr/Ra), kappa = 1/sqrt(Pr*Ra), UB5 flux-form advection,
no-slip walls, fixed top temperature min_b, actuated bottom temperature and
periodic x. Pressure is split p = pHY' + pNHS (hydrostatic anomaly plus
projection pressure). Time stepping is the low-storage 3-stage RK3 of the
reference's ``:RungeKutta3`` with a projection after every stage.

Fields are batch-major, (..., nx, nz[+1]) with any leading env batch. The
dispatch follows the JAX solver's: for CUDA tensors ``env_step`` launches
the whole-step kernel and ``substep`` the tendency kernel with the RK
update and projection around it; for CPU tensors both take the plain path.
The kernels take float32; a CUDA solver of another dtype raises when it
launches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from rbc_gym_tpu_torch import default_device
from rbc_gym_tpu_torch.ops.kernels2d import (
    Coeffs2D,
    env_step_2d,
    hydrostatic_pressure,
    rk3_substep,
    tendencies_2d,
)
from rbc_gym_tpu_torch.ops import stencils as st
from rbc_gym_tpu_torch.ops.poisson import Spectral2D, spectral_constants_2d
from rbc_gym_tpu_torch.sim.actuation import heater_profile_2d
from rbc_gym_tpu_torch.sim.grid import Grid2D


@dataclasses.dataclass(frozen=True)
class SimParams2D:
    """Static simulation parameters (defaults: reference rbc_sim2D_api.jl:17-38)."""

    ra: float = 1.0e4
    pr: float = 0.7
    min_b: float = 1.0
    delta_b: float = 1.0
    dt_solver: float = 0.03
    heater_duration: float = 1.5  # env step interval ("dt" in the reference API)
    n_heaters: int = 12
    heater_limit: float = 0.75
    random_kick: float = 0.01

    @property
    def nu(self) -> float:
        return float(np.sqrt(self.pr / self.ra))

    @property
    def kappa(self) -> float:
        return float(1.0 / np.sqrt(self.pr * self.ra))

    @property
    def substeps_per_env_step(self) -> int:
        n = self.heater_duration / self.dt_solver
        n_int = int(round(n))
        if abs(n - n_int) > 1e-9:
            # Oceananigans run! overshoots to stop_time with a final partial
            # step; we require divisibility to keep the step count fixed.
            raise ValueError(
                f"heater_duration {self.heater_duration} must be an integer "
                f"multiple of dt_solver {self.dt_solver}"
            )
        return n_int


class Fields2D(NamedTuple):
    """Prognostic + diagnostic fields; leading axes are env batch axes."""

    u: torch.Tensor  # (..., nx, nz)    x-velocity at (x-face, z-center)
    w: torch.Tensor  # (..., nx, nz+1)  z-velocity at (x-center, z-face)
    b: torch.Tensor  # (..., nx, nz)    buoyancy at centers
    p_hy: torch.Tensor  # (..., nx, nz) hydrostatic anomaly pressure
    p_nhs: torch.Tensor  # (..., nx, nz) nonhydrostatic (projection) pressure


class Solver2D(NamedTuple):
    """Function bundle for one grid + params + dtype + device."""

    grid: Grid2D
    params: SimParams2D
    dtype: torch.dtype
    device: torch.device
    coeffs: Coeffs2D
    spectral: Spectral2D
    init_random: Callable  # (generator, batch_shape) -> Fields2D
    env_step: Callable  # (Fields2D, action (..., S)) -> Fields2D
    substep: Callable  # (Fields2D, bottom_b (..., nx)) -> Fields2D
    heater_profile: Callable  # action (..., S) -> (..., nx)


# Largest max|div u| a projected step may leave, per working dtype: float64
# as the JAX package's oracle (tests/test_solver2d.py:57); float32 from its
# rounding (~1e-6 at |u| ~ 0.2 on 96x64, growing with the velocity).
DIVERGENCE_ATOL = {torch.float64: 1e-8, torch.float32: 1e-4}


def max_divergence(f: Fields2D, grid: Grid2D) -> float:
    """max |div u| over all envs and cells."""
    div = st.ddx_f2c(f.u, grid.dx) + st.ddz_f2c(f.w, grid.dz)
    return float(div.abs().max())


def make_solver2d(
    grid: Grid2D,
    params: SimParams2D,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = "cuda",
) -> Solver2D:
    """Build the 2D solver function bundle on ``device``."""
    device = default_device(device)
    nx, nz = grid.nx, grid.nz
    min_b = params.min_b
    coeffs = Coeffs2D(grid.dx, grid.dz, params.nu, params.kappa, min_b)
    spectral = spectral_constants_2d(nx, nz, grid.dx, grid.dz, dtype, device)
    x_centers = grid.x_centers()
    n_substeps = params.substeps_per_env_step

    def flat(f: Fields2D) -> Fields2D:
        return Fields2D(*(q.reshape((-1,) + q.shape[-2:]).contiguous() for q in f))

    def unflat(f: Fields2D, batch) -> Fields2D:
        return Fields2D(*(q.reshape(batch + q.shape[-2:]) for q in f))

    def flat_bottom(bottom_b: torch.Tensor, batch) -> torch.Tensor:
        return torch.broadcast_to(bottom_b, batch + (nx,)).reshape(-1, nx).contiguous()

    def heater_profile(action) -> torch.Tensor:
        return heater_profile_2d(
            torch.as_tensor(action, dtype=dtype, device=device),
            x_centers,
            grid.lx,
            params.n_heaters,
            params.heater_limit,
            rest_temperature=params.min_b + params.delta_b,
        )

    def substep(f: Fields2D, bottom_b: torch.Tensor) -> Fields2D:
        """One RK3 solver step of dt_solver; bottom (..., nx) broadcasting."""
        batch = f.u.shape[:-2]
        g = flat(f)
        u, w, b, p_nhs = rk3_substep(
            g.u, g.w, g.b, flat_bottom(bottom_b, batch), spectral, coeffs,
            params.dt_solver, tendencies_2d,
        )
        out = Fields2D(u, w, b, hydrostatic_pressure(b, grid.dz, min_b), p_nhs)
        return unflat(out, batch)

    def env_step(f: Fields2D, action) -> Fields2D:
        """Advance by one environment step (heater_duration of sim time)."""
        batch = f.u.shape[:-2]
        g = flat(f)
        u, w, b, p_nhs = env_step_2d(
            g.u, g.w, g.b, flat_bottom(heater_profile(action), batch), spectral,
            coeffs, params.dt_solver, n_substeps,
        )
        out = Fields2D(u, w, b, hydrostatic_pressure(b, grid.dz, min_b), p_nhs)
        return unflat(out, batch)

    def init_random(generator: torch.Generator, batch_shape: Tuple[int, ...] = ()) -> Fields2D:
        """Random initial condition (reference sim/rbc_sim2D.jl:163-171).

        Linear conductive buoyancy profile plus Gaussian kick (clamped to the
        plate range), kick noise on the velocities; w wall faces zeroed.
        """
        batch_shape = tuple(batch_shape)
        kick = params.random_kick

        def normal(shape):
            return torch.randn(shape, generator=generator, dtype=dtype, device=device)

        u = kick * normal(batch_shape + (nx, nz))
        w = kick * normal(batch_shape + (nx, nz + 1))
        w[..., 0] = 0.0
        w[..., -1] = 0.0
        z_c = torch.as_tensor(grid.z_centers(), dtype=dtype, device=device)
        profile = min_b + (grid.lz - z_c) * params.delta_b / 2.0
        b = torch.clamp(
            profile + kick * normal(batch_shape + (nx, nz)), min_b, min_b + params.delta_b
        )
        return Fields2D(u, w, b, hydrostatic_pressure(b, grid.dz, min_b), torch.zeros_like(u))

    return Solver2D(
        grid=grid,
        params=params,
        dtype=dtype,
        device=device,
        coeffs=coeffs,
        spectral=spectral,
        init_random=init_random,
        env_step=env_step,
        substep=substep,
        heater_profile=heater_profile,
    )
