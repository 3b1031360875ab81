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

Fields are batch-major, (..., nx, nz[+1]) with any leading env batch.
``select_env_step_path`` picks the path once per solver (``Solver2D.path``),
as the JAX solver's ``fused`` does: on "fused", ``env_step`` launches the
whole-step kernel K1 (the instance for ``poisson_precision``) and
``substep`` the tendency kernel K2 with the RK update and projection around
it; on "plain" both run the plain versions.
Auto takes "fused" on CUDA for float32, as the JAX solver does, and
raises where K1 cannot take the grid (``env_step_kernel_limit``); "plain" for
float64 and on the CPU.
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
    env_step_2d_plain,
    hydrostatic_pressure,
    rk3_substep,
    tendencies_2d,
    tendencies_2d_plain,
)
from rbc_gym_tpu_torch.ops import stencils as st
from rbc_gym_tpu_torch.ops.limits import K1_MIN_NX, MAX_INT32, env_step_2d_offsets_fit
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
    path: str  # "fused" (K1 env_step, K2 substep) or "plain"
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


# The env-step and tendency functions of each path.
ENV_STEP_PATHS = {
    "fused": (env_step_2d, tendencies_2d),
    "plain": (env_step_2d_plain, tendencies_2d_plain),
}


def env_step_kernel_limit(dtype: torch.dtype, nx: int, nz: int):
    """Why K1 cannot take this configuration, or None if it can: float32
    only, nx >= 3 (its x stencils wrap once) and an env within its 32-bit
    offsets (the checks of ``launch_env_step_2d`` in ``csrc/rbc2d.cu``).
    Every such grid has an instance whose shared memory fits a block: on
    the chip, on a cluster, or off the chip with its two slabs in shared
    memory or, where they do not fit, in global scratch
    (``limits.env_step_2d_slabs_on_chip``)."""
    if dtype != torch.float32:
        return f"the fused kernels take float32, not {dtype}"
    if nx < K1_MIN_NX:
        return f"the env-step kernel needs nx >= {K1_MIN_NX} (nx={nx})"
    if not env_step_2d_offsets_fit(nx, nz):
        return (f"the env-step kernel indexes an env with 32-bit offsets: 9 nx (nz + 1) <= "
                f"{MAX_INT32:,} (nx={nx}, nz={nz})")
    return None


def select_env_step_path(dtype: torch.dtype, nx: int, nz: int, device_type: str,
                         fused: bool | None = None) -> str:
    """"fused" or "plain", from the dtype and the grid only.

    Auto (``fused=None``) is the JAX package's rule
    (rbc_gym_tpu/sim/solver2d.py:247-250): "fused" on CUDA for float32,
    "plain" for float64 and on the CPU. Where K1 cannot take a float32
    grid on CUDA (``env_step_kernel_limit``: nx < 3, or an env past its
    32-bit offsets) it raises ``NotImplementedError`` naming the limit,
    since the JAX package runs its kernel there. ``fused=False`` is
    "plain"; ``fused=True`` forces the kernels and raises ``ValueError``,
    naming the limit, if they cannot take it (on the CPU the wrappers
    then run their plain versions)."""
    if fused is None:
        if device_type != "cuda" or dtype != torch.float32:
            return "plain"
        limit = env_step_kernel_limit(dtype, nx, nz)
        if limit is not None:
            raise NotImplementedError(f"the JAX package runs its fused kernels here, and {limit}")
        return "fused"
    if fused is False:
        return "plain"
    if fused is not True:
        raise ValueError(f"unknown fused={fused!r}: None, True or False")
    limit = env_step_kernel_limit(dtype, nx, nz)
    if limit is not None:
        raise ValueError(f"fused=True cannot be forced here: {limit}")
    return "fused"


def max_divergence(f: Fields2D, grid: Grid2D) -> float:
    """max |div u| over all envs and cells."""
    div = st.ddx_f2c(f.u, grid.dx) + st.ddz_f2c(f.w, grid.dz)
    return float(div.abs().max())


# The JAX package's 2D ``poisson_precision`` names and the precision of the
# solve's products that each means (``ops.poisson.matmul``'s names;
# rbc_gym_tpu/sim/solver2d.py:174-184): None, "highest" and "high" (which
# the JAX package maps to "highest") the full float32 solve; "bf16x3", which
# runs its K1's split-product branch and HIGH products in its XLA-side
# projection, "high" here (K1's split-product instance, three TF32 products
# of split operands); "default" one pass in both.
POISSON_PRECISIONS_2D = {None: None, "highest": None, "high": None, "bf16x3": "high",
                         "default": "default"}


def check_poisson_precision_2d(precision) -> str | None:
    """The precision of the solve's products for a 2D ``poisson_precision``
    (``POISSON_PRECISIONS_2D``); an unknown name is refused by name."""
    if precision not in POISSON_PRECISIONS_2D:
        raise ValueError(f"unknown poisson_precision={precision!r}: one of "
                         + ", ".join(map(repr, POISSON_PRECISIONS_2D)))
    return POISSON_PRECISIONS_2D[precision]


def make_solver2d(
    grid: Grid2D,
    params: SimParams2D,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = "cuda",
    fused: bool | None = None,
    poisson_precision: str | None = None,
) -> Solver2D:
    """Build the 2D solver function bundle on ``device``; ``fused`` picks
    the path (``select_env_step_path``); ``poisson_precision`` is one of
    ``POISSON_PRECISIONS_2D``: the precision of the solve's products in
    ``env_step`` (on "fused" the K1 instance that matches it) and in the
    projections of ``substep``."""
    products = check_poisson_precision_2d(poisson_precision)
    device = default_device(device)
    nx, nz = grid.nx, grid.nz
    path = select_env_step_path(dtype, nx, nz, device.type, fused)
    step_fn, tendencies = ENV_STEP_PATHS[path]
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
        """One RK3 solver step of dt_solver; bottom (..., nx) broadcasting.
        Each stage's tendencies compute pHY' from b themselves, so the
        output's is the one ``hydrostatic_pressure`` call."""
        batch = f.u.shape[:-2]
        g = flat(f)
        u, w, b, p_nhs = rk3_substep(
            g.u, g.w, g.b, flat_bottom(bottom_b, batch), spectral, coeffs,
            params.dt_solver, tendencies, products,
        )
        out = Fields2D(u, w, b, hydrostatic_pressure(b, grid.dz, min_b), p_nhs)
        return unflat(out, batch)

    def env_step(f: Fields2D, action) -> Fields2D:
        """Advance by one environment step (heater_duration of sim time)."""
        batch = f.u.shape[:-2]
        g = flat(f)
        u, w, b, p_nhs = step_fn(
            g.u, g.w, g.b, flat_bottom(heater_profile(action), batch), spectral,
            coeffs, params.dt_solver, n_substeps, products,
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
        path=path,
        coeffs=coeffs,
        spectral=spectral,
        init_random=init_random,
        env_step=env_step,
        substep=substep,
        heater_profile=heater_profile,
    )
