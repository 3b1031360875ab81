"""Batched 2D environment over an explicit state.

Port of ``rbc_gym_tpu.envs.vector2d.RBC2DVectorEnv``. All fields carry a
leading ``(num_envs,)`` axis; ``reset``/``step`` are pure functions over an
explicit ``EnvState2D``:

    state, obs = env.reset(seed)
    state, timestep = env.step(state, actions)

``step`` never writes to the state it is given. Episode bookkeeping
(truncation at ``episode_length``, masked autoreset with per-env key
streams) happens inside ``step``. reward = -Nu of the sensor observation.
With ``checkpoint=`` a bank file (``.npz`` anywhere, the reference's HDF5
on a host with h5py) supplies the initial conditions; see ``envs.bank``.
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
from rbc_gym_tpu_torch.sim import nusselt as nu
from rbc_gym_tpu_torch.sim.grid import Grid2D
from rbc_gym_tpu_torch.sim.solver2d import Fields2D, SimParams2D, make_solver2d


class EnvState2D(NamedTuple):
    fields: Fields2D
    t: torch.Tensor  # (E,) sim time within the episode
    step: torch.Tensor  # (E,) int32, 1-based like the reference
    key: torch.Tensor  # (E,) int64 per-env key stream, on the host


class TimeStep(NamedTuple):
    obs: torch.Tensor  # (E, C, nz_obs, nx_obs): next policy input (post-autoreset)
    final_obs: torch.Tensor  # pre-autoreset obs (for truncation bootstrapping)
    reward: torch.Tensor  # (E,)
    terminated: torch.Tensor  # (E,) always False (no terminal state)
    truncated: torch.Tensor  # (E,)
    nusselt_state: torch.Tensor  # (E,)
    nusselt_obs: torch.Tensor  # (E,)
    t: torch.Tensor  # (E,)
    step: torch.Tensor  # (E,)


class RBC2DVectorEnv:
    """Functional vector env; every tensor of its state lives on ``device``
    except the per-env keys."""

    def __init__(
        self,
        num_envs: int,
        rayleigh_number: float = 10_000,
        episode_length: float = 300,
        observation_shape: Tuple[int, int] = (8, 48),
        state_shape: Tuple[int, int] = (64, 96),
        heater_segments: int = 12,
        heater_limit: float = 0.75,
        heater_duration: float = 1.5,
        pressure: bool = False,
        checkpoint: Optional[str] = None,
        auto_reset: bool = True,
        bank_sampling: str = "random",
        ic_noise: float = 0.0,
        dtype: torch.dtype = torch.float32,
        poisson_precision: Optional[str] = None,
        device: str | torch.device | None = "cuda",
        env_slice: Optional[Tuple[int, int]] = None,
    ):
        """``checkpoint``: a bank file (``.npz``, or HDF5 where h5py is
        installed) of initial conditions; None starts from the solver's
        random ones. ``bank_sampling``: "random" draws a bank index per env
        from its key (reference semantics, sim/rbc_sim2D.jl:178),
        "sequential" gives env i bank state i % bank_size (deterministic and
        duplicate-free up to the bank size, for evaluation). ``ic_noise``
        adds a Gaussian kick of that amplitude to bank states at reset, so
        lockstep envs sharing a bank index decorrelate.

        Sequential sampling governs explicit ``reset()`` calls only:
        autoresets draw random bank states, so evaluation protocols relying
        on the duplicate-free guarantee pass ``auto_reset=False`` (a
        warning is logged otherwise).

        ``poisson_precision``: the JAX env's names. None, "highest" and
        "high" are one full float32 solve; "bf16x3" runs K1's
        split-product instance (three TF32 tensor-core passes a product)
        and "default" its one-pass instance; an unknown name is refused
        (``sim.solver2d.POISSON_PRECISIONS_2D``).

        ``env_slice=(offset, fleet_size)`` makes this env the envs ``[offset,
        offset + num_envs)`` of a fleet of ``fleet_size`` (default: the whole
        fleet): a reset draws their keys and sequential bank states, so a
        rank's shard (``parallel.shard_vector_env``) resets and steps as
        those rows of the one-process fleet. ``ic_noise`` is the exception:
        its kick is drawn for the batch at hand (``envs.bank``), so a shard
        draws its own."""
        if bank_sampling not in ("random", "sequential"):
            raise ValueError(f"unknown bank_sampling {bank_sampling!r}")
        if bank_sampling == "sequential" and auto_reset:
            logging.getLogger(__name__).warning(
                "bank_sampling='sequential' with auto_reset=True: mid-episode "
                "autoresets draw random bank states; the duplicate-free guarantee "
                "only covers the initial reset(). Pass auto_reset=False for evaluation."
            )
        self.num_envs = num_envs
        self.env_offset, self.fleet_size = fleet_slice(num_envs, env_slice)
        nz, nx = state_shape
        self.grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
        self.params = SimParams2D(
            ra=float(rayleigh_number),
            heater_duration=float(heater_duration),
            n_heaters=int(heater_segments),
            heater_limit=float(heater_limit),
        )
        self.episode_length = float(episode_length)
        self.episode_steps = int(round(self.episode_length / heater_duration))
        self.observation_shape = tuple(observation_shape)
        self.include_pressure = pressure
        self.auto_reset = auto_reset
        self.bank_sampling = bank_sampling
        self.ic_noise = float(ic_noise)
        self.dtype = dtype
        self.solver = make_solver2d(self.grid, self.params, dtype=dtype, device=device,
                                    poisson_precision=poisson_precision)
        self.device = self.solver.device
        self._bank = None
        if checkpoint is not None:
            p = self.params
            self._bank = DeviceBank(checkpoint, Fields2D, (nx, nz), dtype, self.device,
                                    self.ic_noise, p.min_b, p.delta_b, self.grid.dz)

    # -- init ----------------------------------------------------------
    def _init_fields(self, keys: torch.Tensor) -> Fields2D:
        """Fresh initial state per env, each from its own key: a random bank
        episode, or the solver's random initial condition."""
        if self._bank is not None:
            return self._bank.fields(key_index(keys, self._bank.size), keys)
        per_env = [
            self.solver.init_random(torch.Generator(device=self.device).manual_seed(k))
            for k in keys.tolist()
        ]
        return Fields2D(*(torch.stack(qs) for qs in zip(*per_env)))

    def reset(self, seed: int = 0) -> Tuple[EnvState2D, torch.Tensor]:
        lo, hi = self.env_offset, self.env_offset + self.num_envs
        keys = seed_keys(seed, self.fleet_size)[lo:hi]
        init_keys = fold_in(keys, 0)
        if self._bank is not None and self.bank_sampling == "sequential":
            idx = torch.arange(lo, hi) % self._bank.size
            fields = self._bank.fields(idx, init_keys)
        else:
            fields = self._init_fields(init_keys)
        state = EnvState2D(
            fields=fields,
            t=torch.zeros(self.num_envs, dtype=self.dtype, device=self.device),
            step=torch.ones(self.num_envs, dtype=torch.int32, device=self.device),
            key=keys,
        )
        return state, self._observe(fields)

    # -- observation / reward ------------------------------------------
    def _channels(self, fields: Fields2D) -> torch.Tensor:
        nzc = self.grid.nz
        chans = [fields.b, fields.u, fields.w[..., :nzc]]
        if self.include_pressure:
            chans += [fields.p_hy, fields.p_nhs]
        return torch.stack(chans, dim=-3)  # (E, C, nx, nz)

    def _observe(self, fields: Fields2D) -> torch.Tensor:
        nz_o, nx_o = self.observation_shape
        obs = nu.sensor_subsample_2d(self._channels(fields), nx_o, nz_o)
        return obs.transpose(-1, -2).contiguous()  # (E, C, nz_obs, nx_obs)

    def _nusselts(self, fields: Fields2D) -> Tuple[torch.Tensor, torch.Tensor]:
        nzc = self.grid.nz
        t, w = fields.b, fields.w[..., :nzc]
        nz_o, nx_o = self.observation_shape
        p = self.params
        ns = nu.nusselt_2d(t, w, p.kappa, p.delta_b, self.grid.lz)
        no = nu.nusselt_2d(
            nu.sensor_subsample_2d(t, nx_o, nz_o),
            nu.sensor_subsample_2d(w, nx_o, nz_o),
            p.kappa,
            p.delta_b,
            self.grid.lz,
        )
        return ns, no

    # -- step ----------------------------------------------------------
    def step(self, state: EnvState2D, actions) -> Tuple[EnvState2D, TimeStep]:
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        fields = self.solver.env_step(state.fields, actions)
        step = state.step + 1
        t = (step - 1).to(self.dtype) * self.params.heater_duration
        # in int64: an int32 step against an episode of more than 2**31 - 1
        # steps (episode_length=10**9 at a short heater_duration) would wrap
        truncated = (step - 1).long() >= self.episode_steps

        ns, no = self._nusselts(fields)
        final_obs = self._observe(fields)

        if self.auto_reset:
            fields, key, obs = autoreset_step(
                fields, state.key, truncated, final_obs, self._init_fields, self._observe
            )
            t = torch.where(truncated, torch.zeros_like(t), t)
            step = torch.where(truncated, torch.ones_like(step), step)
        else:
            obs, key = final_obs, state.key

        ts = TimeStep(
            obs=obs,
            final_obs=final_obs,
            reward=-no,
            terminated=torch.zeros_like(truncated),
            truncated=truncated,
            nusselt_state=ns,
            nusselt_obs=no,
            t=t,
            step=step,
        )
        return EnvState2D(fields=fields, t=t, step=step, key=key), ts
