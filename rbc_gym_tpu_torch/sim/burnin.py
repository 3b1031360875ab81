"""Checkpoint-bank generation on the device: burn-in to turbulence.

Port of ``rbc_gym_tpu.sim.burnin``. The reference's pipeline (its
scripts/create_checkpoints_2D.sh): per episode, seed the RNG, integrate the
zero-action environment for ``duration`` time units and keep only the
final fields. Here all episodes integrate at once, as one batch of
``solver.env_step`` calls of one snapshot window each: on the card K1 in
2D and K3 with K4 in 3D. The train/test/val splits keep the reference's
seeds (42/62/72).

Episode i starts from the solver's random initial condition drawn from its
own ``torch.Generator``, seeded from ``(seed, i + 1)`` by the envs' key
mixer (``envs.autoreset.fold_in``). torch cannot replay the JAX package's
``jax.random.fold_in(seed, i + 1)`` streams, so a bank made here holds
other (equally independent) episodes than the JAX package's; the burn-in
itself (``burn_in``) is the JAX package's scan and can start from any
fields, e.g. the JAX package's own initial fields.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rbc_gym_tpu_torch.envs.autoreset import fold_in
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
from rbc_gym_tpu_torch.sim.solver2d import SimParams2D, make_solver2d
from rbc_gym_tpu_torch.sim.solver3d import SimParams3D, make_solver3d
from rbc_gym_tpu_torch.utils.checkpoints import CheckpointBank2D, CheckpointBank3D

# reference split seeds (scripts/create_checkpoints_2D.sh:18-20)
SPLIT_SEEDS = {"train": 42, "test": 62, "val": 72}
SPLIT_EPISODES = {"train": 20, "test": 10, "val": 10}


def initial_fields(solver, n_episodes: int, seed: int):
    """The solver's random initial fields of ``n_episodes`` episodes, with
    a leading episode axis; episode i's from a generator seeded from
    ``(seed, i + 1)``."""
    base = torch.tensor([seed], dtype=torch.int64)
    per_episode = [
        solver.init_random(torch.Generator(device=solver.device).manual_seed(
            int(fold_in(base, i + 1)[0])))
        for i in range(n_episodes)
    ]
    return type(per_episode[0])(*(torch.stack(qs) for qs in zip(*per_episode)))


def burn_in(solver, fields, n_windows: int):
    """``n_windows`` zero-action env steps of ``fields`` (episodes first)."""
    n = fields.b.shape[0]
    a_shape = (n,) + (solver.params.n_heaters,) * (2 if fields.b.dim() == 4 else 1)
    action = torch.zeros(a_shape, dtype=solver.dtype, device=solver.device)
    for _ in range(n_windows):
        fields = solver.env_step(fields, action)
    return fields


def _float64(fields, names, nan_guard: bool) -> dict:
    out = {n: getattr(fields, n).detach().cpu().numpy().astype(np.float64) for n in names}
    if nan_guard and not np.isfinite(out["b"]).all():
        raise FloatingPointError("NaN values found during burn-in")
    return out


def generate_bank_2d(
    ra: float,
    n_episodes: int,
    seed: int,
    grid: Optional[Grid2D] = None,
    duration: float = 600.0,
    dt_solver: float = 0.03,
    random_kick: float = 0.2,  # reference CLI default (rbc_sim2D.jl:280)
    snapshot_interval: float = 0.3,
    dtype: torch.dtype = torch.float32,
    nan_guard: bool = True,
    device: str | torch.device | None = "cuda",
) -> CheckpointBank2D:
    """Burn in ``n_episodes`` independent 2D states at once (float64 arrays)."""
    grid = grid or Grid2D(nx=96, nz=64, lx=2 * np.pi, lz=2.0)
    params = SimParams2D(ra=ra, dt_solver=dt_solver, heater_duration=snapshot_interval,
                         random_kick=random_kick)
    solver = make_solver2d(grid, params, dtype=dtype, device=device)
    fields = burn_in(solver, initial_fields(solver, n_episodes, seed),
                     int(round(duration / snapshot_interval)))
    return CheckpointBank2D(**_float64(fields, ("b", "u", "w"), nan_guard), start_seed=seed)


def generate_bank_3d(
    ra: float,
    n_episodes: int,
    seed: int,
    grid: Optional[Grid3D] = None,
    duration: float = 200.0,  # free-fall units (reference rbc_sim3D.jl:283)
    dt_solver: float = 0.01,
    random_kick: float = 0.01,
    snapshot_interval: float = 0.125,
    pr: float = 0.7,
    dtype: torch.dtype = torch.float32,
    nan_guard: bool = True,
    device: str | torch.device | None = "cuda",
) -> CheckpointBank3D:
    """Burn in ``n_episodes`` independent 3D states at once (float64 arrays)."""
    grid = grid or Grid3D(nx=32, ny=32, nz=16, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    params = SimParams3D(ra=ra, pr=pr, dt_solver=dt_solver, heater_duration=snapshot_interval,
                         random_kick=random_kick, lz=grid.lz)
    solver = make_solver3d(grid, params, dtype=dtype, device=device)
    fields = burn_in(solver, initial_fields(solver, n_episodes, seed),
                     int(round(duration / snapshot_interval)))
    return CheckpointBank3D(**_float64(fields, ("b", "u", "v", "w"), nan_guard),
                            start_seed=seed)
