"""Batched 3D environment over an explicit state.

Port of ``rbc_gym_tpu.envs.vector3d.RBC3DVectorEnv`` with the JAX class's
defaults: the 16x32x32 training grid (nz, ny, nx) on a (2, 4 pi, 4 pi)
domain, Ra 2500, Pr 0.7, 8x8 heater tiles, heater_duration 0.125 free-fall
units (13 solver steps), episodes of 300 time units (600 env steps). All
fields carry a leading ``(num_envs,)`` axis; ``reset``/``step`` are pure
functions over an explicit ``EnvState3D``:

    state, obs = env.reset(seed)
    state, timestep = env.step(state, actions)   # actions (E, 8, 8)

``step`` never writes to the state it is given. Truncation and masked
autoreset with per-env key streams happen inside ``step``; reward = -Nu
(the reference's 3D definition, over the full state). With ``checkpoint=``
a bank file (``.npz`` anywhere, the reference's HDF5 on a host with h5py)
supplies the initial conditions; see ``envs.bank``.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rbc_gym_tpu_torch.envs.autoreset import (
    autoreset_step,
    fleet_slice,
    fold_in,
    key_index,
    seed_keys,
)
from rbc_gym_tpu_torch.envs.bank import DeviceBank
from rbc_gym_tpu_torch.sim.grid import Grid3D
from rbc_gym_tpu_torch.sim.nusselt import nusselt_3d
from rbc_gym_tpu_torch.sim.solver3d import Fields3D, SimParams3D, make_solver3d


class EnvState3D(NamedTuple):
    fields: Fields3D
    t: torch.Tensor  # (E,) sim time within the episode
    step: torch.Tensor  # (E,) int32, 1-based like the reference
    key: torch.Tensor  # (E,) int64 per-env key stream, on the host


class TimeStep3D(NamedTuple):
    obs: torch.Tensor  # (E, 4, nz, ny, nx): next policy input (post-autoreset)
    final_obs: torch.Tensor  # pre-autoreset obs (for truncation bootstrapping)
    reward: torch.Tensor  # (E,)
    terminated: torch.Tensor  # (E,) always False (no terminal state)
    truncated: torch.Tensor  # (E,)
    nusselt: torch.Tensor  # (E,)
    t: torch.Tensor  # (E,)
    step: torch.Tensor  # (E,)


class RBC3DVectorEnv:
    """Functional vector env; every tensor of its state lives on ``device``
    except the per-env keys."""

    def __init__(
        self,
        num_envs: int,
        rayleigh_number: float = 2500,
        prandtl_number: float = 0.7,
        domain: Tuple[float, float, float] = (2, 4 * np.pi, 4 * np.pi),
        state_shape: Tuple[int, int, int] = (16, 32, 32),
        temperature_difference: Tuple[float, float] = (1, 2),
        heater_segments: int = 8,
        heater_limit: float = 0.9,
        heater_duration: float = 0.125,
        episode_length: float = 300,
        dt_solver: float = 0.01,
        checkpoint: Optional[str] = None,
        checkpoint_idx: Optional[int] = None,
        auto_reset: bool = True,
        bank_sampling: str = "random",
        ic_noise: float = 0.0,
        dtype: torch.dtype = torch.float32,
        fused: bool | str | None = None,
        poisson_precision: Optional[str] = None,
        device: str | torch.device | None = "cuda",
        env_slice: Optional[Tuple[int, int]] = None,
    ):
        """``checkpoint``, ``bank_sampling``, ``ic_noise``: as in
        ``RBC2DVectorEnv`` (bank initial conditions, random or sequential
        bank index, Gaussian kick; sequential sampling governs explicit
        ``reset()`` calls only, with a warning under ``auto_reset=True``).
        ``checkpoint_idx`` pins every env to one bank state; it contradicts
        sequential sampling and raises with it.

        ``fused`` picks the solver's loop and kernels (``Solver3D.path``, see
        ``sim.solver3d.select_stage_path``): None for auto, False for plain
        PyTorch, "stage" (K3), "stage_xy" (K5) or "field" (the per-field
        path, K6 and K7; True is its alias). Auto takes "field" on CUDA in
        float32 inside the whole-y boundary where nx % 4 != 0 or K3 cannot
        take the grid; "stage_qp" (K3's analysis instance and the solve's
        tail) and "stage_ew" (K3) are opt-in. ``poisson_precision`` is the
        precision of the solve's products (``sim.solver3d.make_solver3d``):
        None or "highest" (full float32), "high" (three TF32 products of
        split operands) or "default" (one TF32 product).

        ``env_slice``: as in ``RBC2DVectorEnv`` (this env as envs ``[offset,
        offset + num_envs)`` of a fleet of ``fleet_size``; a shard draws its
        own ``ic_noise`` kick)."""
        if bank_sampling not in ("random", "sequential"):
            raise ValueError(f"unknown bank_sampling {bank_sampling!r}")
        if bank_sampling == "sequential":
            if checkpoint_idx is not None:
                raise ValueError(
                    "checkpoint_idx and bank_sampling='sequential' conflict: sequential "
                    "assigns env i bank state i % bank_size, checkpoint_idx pins all "
                    "envs to one state"
                )
            if auto_reset:
                logging.getLogger(__name__).warning(
                    "bank_sampling='sequential' with auto_reset=True: mid-episode "
                    "autoresets draw random bank states; the duplicate-free guarantee "
                    "only covers the initial reset(). Pass auto_reset=False for evaluation."
                )
        self.num_envs = num_envs
        self.env_offset, self.fleet_size = fleet_slice(num_envs, env_slice)
        nz, ny, nx = state_shape
        lz, ly, lx = domain
        self.grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=lx, ly=ly, lz=lz)
        min_b = float(temperature_difference[0])
        self.params = SimParams3D(
            ra=float(rayleigh_number),
            pr=float(prandtl_number),
            min_b=min_b,
            delta_b=float(temperature_difference[1]) - min_b,
            dt_solver=float(dt_solver),
            heater_duration=float(heater_duration),
            n_heaters=int(heater_segments),
            heater_limit=float(heater_limit),
            lz=float(lz),
        )
        self._t_per_step = self.params.heater_duration * self.params.t_ff
        self.episode_steps = int(round(float(episode_length) / self._t_per_step))
        self.auto_reset = auto_reset
        self.bank_sampling = bank_sampling
        self.ic_noise = float(ic_noise)
        self.checkpoint_idx = checkpoint_idx
        self.dtype = dtype
        self.solver = make_solver3d(self.grid, self.params, dtype=dtype, device=device,
                                    fused=fused, poisson_precision=poisson_precision)
        self.device = self.solver.device
        self._bank = None
        if checkpoint is not None:
            p = self.params
            self._bank = DeviceBank(checkpoint, Fields3D, (nx, ny, nz), dtype, self.device,
                                    self.ic_noise, p.min_b, p.delta_b, self.grid.dz)

    # -- init ----------------------------------------------------------
    def _init_fields(self, keys: torch.Tensor) -> Fields3D:
        """Fresh initial state per env, each from its own key: a bank
        episode (``checkpoint_idx``, else random), or the solver's random
        initial condition."""
        if self._bank is not None:
            if self.checkpoint_idx is not None:
                idx = torch.full((len(keys),), self.checkpoint_idx, dtype=torch.int64)
            else:
                idx = key_index(keys, self._bank.size)
            return self._bank.fields(idx, keys)
        per_env = [
            self.solver.init_random(torch.Generator(device=self.device).manual_seed(k))
            for k in keys.tolist()
        ]
        return Fields3D(*(torch.stack(qs) for qs in zip(*per_env)))

    def reset(self, seed: int = 0) -> Tuple[EnvState3D, torch.Tensor]:
        lo, hi = self.env_offset, self.env_offset + self.num_envs
        keys = seed_keys(seed, self.fleet_size)[lo:hi]
        init_keys = fold_in(keys, 0)
        if self._bank is not None and self.bank_sampling == "sequential":
            idx = torch.arange(lo, hi) % self._bank.size
            fields = self._bank.fields(idx, init_keys)
        else:
            fields = self._init_fields(init_keys)
        state = EnvState3D(
            fields=fields,
            t=torch.zeros(self.num_envs, dtype=self.dtype, device=self.device),
            step=torch.ones(self.num_envs, dtype=torch.int32, device=self.device),
            key=keys,
        )
        return state, self._observe(fields)

    # -- observation / reward ------------------------------------------
    def _observe(self, fields: Fields3D) -> torch.Tensor:
        nz = self.grid.nz
        state = torch.stack([fields.b, fields.u, fields.v, fields.w[..., :nz]], dim=-4)
        return state.transpose(-1, -3).contiguous()  # (E, 4, nz, ny, nx)

    def _nusselt(self, fields: Fields3D) -> torch.Tensor:
        p = self.params
        return nusselt_3d(fields.b, fields.w[..., : self.grid.nz], p.kappa, p.min_b, p.delta_b)

    # -- step ----------------------------------------------------------
    def step(self, state: EnvState3D, actions) -> Tuple[EnvState3D, TimeStep3D]:
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        fields = self.solver.env_step(state.fields, actions)
        step = state.step + 1
        t = (step - 1).to(self.dtype) * self._t_per_step
        # in int64: an int32 step against an episode of more than 2**31 - 1
        # steps (episode_length=10**9 at a short heater_duration) would wrap
        truncated = (step - 1).long() >= self.episode_steps

        nus = self._nusselt(fields)
        final_obs = self._observe(fields)

        if self.auto_reset:
            fields, key, obs = autoreset_step(
                fields, state.key, truncated, final_obs, self._init_fields, self._observe
            )
            t = torch.where(truncated, torch.zeros_like(t), t)
            step = torch.where(truncated, torch.ones_like(step), step)
        else:
            obs, key = final_obs, state.key

        ts = TimeStep3D(
            obs=obs,
            final_obs=final_obs,
            reward=-nus,
            terminated=torch.zeros_like(truncated),
            truncated=truncated,
            nusselt=nus,
            t=t,
            step=step,
        )
        return EnvState3D(fields=fields, t=t, step=step, key=key), ts
