"""The single 2D Rayleigh-Bénard environment, without gymnasium.

Port of ``rbc_gym_tpu.envs.rbc2d`` (lines 37-267) minus gymnasium's types:
``RBC2DEnvCore`` has the JAX env's constructor (plus ``device``), reset
from a seed or a checkpoint bank, step, reward (-Nusselt of the sensor
observation), info dict, truncation rule and render modes, in torch and
numpy only, so it runs where gymnasium is not installed.
``envs.rbc2d.RayleighBenardConvection2DEnv`` adds the gymnasium spaces
and seeding over it.

One env is a batch of one for the solver: on CUDA in float32 each step is
one launch of the env-step kernel (K1) at one block. Everything the step
reports comes from one diagnostics function, and the host reads each of
its results once a step.

Seeding follows gymnasium's: ``reset(seed=s)`` makes ``np_random`` a
``numpy.random.Generator`` over ``PCG64(SeedSequence(s))``, which draws
the bank index, so a seed picks the same bank episode as in the JAX env;
a random initial condition comes from a ``torch.Generator`` seeded from
``np_random_seed % (2**63 - 1)`` (torch cannot replay the JAX key's
stream, so the field differs from the JAX env's).
"""

from __future__ import annotations

import logging
import warnings
from enum import IntEnum
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rbc_gym_tpu_torch import default_device
from rbc_gym_tpu_torch.envs.rendering import PygameRenderer2D
from rbc_gym_tpu_torch.ops.kernels2d import hydrostatic_pressure
from rbc_gym_tpu_torch.sim import nusselt as nu
from rbc_gym_tpu_torch.sim.grid import Grid2D
from rbc_gym_tpu_torch.sim.solver2d import Fields2D, SimParams2D, make_solver2d
from rbc_gym_tpu_torch.utils.checkpoints import load_bank_2d


class RBCField(IntEnum):
    """Channel indices (reference envs/rbc2D.py:16-20)."""

    T = 0
    UX = 1
    UY = 2
    P = 3


def torch_dtype(dtype) -> torch.dtype:
    """The JAX env's dtype strings ("float32", "float64") or a torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[str(dtype)]


def seeded_np_random(seed: Optional[int] = None) -> Tuple[np.random.Generator, int]:
    """gymnasium's ``utils.seeding.np_random``: a PCG64 generator over
    ``SeedSequence(seed)`` and its entropy (fresh entropy for None)."""
    if seed is not None and not (isinstance(seed, (int, np.integer)) and seed >= 0):
        raise ValueError(f"seed must be a non-negative integer, got {seed!r}")
    seq = np.random.SeedSequence(None if seed is None else int(seed))
    return np.random.Generator(np.random.PCG64(seq)), seq.entropy


class SeededCore:
    """gymnasium.Env's ``np_random`` and ``np_random_seed`` semantics for the
    gym-free cores (created from fresh entropy on first use; a seed passed
    to ``reset`` re-creates them)."""

    _np_random: Optional[np.random.Generator] = None
    _np_random_seed: Optional[int] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random, self._np_random_seed = seeded_np_random()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator) -> None:
        self._np_random, self._np_random_seed = value, -1

    @property
    def np_random_seed(self) -> int:
        if self._np_random_seed is None:
            self._np_random, self._np_random_seed = seeded_np_random()
        return self._np_random_seed

    def _seed(self, seed: Optional[int]) -> None:
        if seed is not None:
            self._np_random, self._np_random_seed = seeded_np_random(seed)

    def _ic_generator(self, device: torch.device) -> torch.Generator:
        """The random initial condition's generator (the 128-bit entropy of
        an unseeded reset folded into torch's seed range)."""
        return torch.Generator(device=device).manual_seed(
            (self.np_random_seed or 0) % (2**63 - 1))


@lru_cache(maxsize=8)
def _cached_solver(grid: Grid2D, params: SimParams2D, dtype: torch.dtype,
                   device: torch.device, obs_shape: tuple):
    """The solver and the diagnostics function, one per (grid, params,
    dtype, device, observation shape)."""
    solver = make_solver2d(grid, params, dtype=dtype, device=device)
    nz_o, nx_o = obs_shape  # python (nz, nx) order

    def diagnostics(f: Fields2D):
        """obs, state (python (C, nz, nx) order), Nu of the state and of the
        observation, and whether b and u are finite: all of what step() and
        reset() report."""
        nz = grid.nz
        state = torch.stack([f.b, f.u, f.w[..., :nz], f.p_hy, f.p_nhs])
        obs = nu.sensor_subsample_2d(state, nx_o, nz_o)
        nus = nu.nusselt_2d(f.b, f.w[..., :nz], params.kappa, params.delta_b, grid.lz)
        nuo = nu.nusselt_2d(obs[0], obs[2], params.kappa, params.delta_b, grid.lz)
        finite = torch.isfinite(f.b).all() & torch.isfinite(f.u).all()
        return obs.transpose(-1, -2), state.transpose(-1, -2), nus, nuo, finite

    return solver, diagnostics


class RBC2DEnvCore(SeededCore):
    """The 2D env's behaviour over the port's solver, gymnasium-free."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        rayleigh_number: Optional[int] = 10_000,
        episode_length: Optional[int] = 300,
        observation_shape: Optional[list] = (8, 48),
        state_shape: Optional[list] = (64, 96),
        heater_segments: Optional[int] = 12,
        heater_limit: Optional[float] = 0.75,
        heater_duration: Optional[float] = 1.5,
        pressure: Optional[bool] = False,
        use_gpu: Optional[bool] = False,  # accepted for API parity; ignored (see device)
        checkpoint: Optional[str] = None,
        render_mode: Optional[str] = None,
        dtype: str | torch.dtype = "float32",
        device: str | torch.device | None = "cuda",
    ) -> None:
        self.closed = False
        self.checkpoint = checkpoint

        self.ra = rayleigh_number
        self.episode_length = episode_length
        self.observation_shape = tuple(observation_shape)  # (nz_obs, nx_obs)
        self.state_shape = tuple(state_shape)  # (nz, nx)
        self.temperature_difference = [1, 2]
        self.heater_segments = heater_segments
        self.heater_limit = heater_limit
        self.heater_duration = heater_duration
        self.include_pressure = pressure
        self.episode_steps = int(episode_length / heater_duration)

        self.logger = logging.getLogger(__name__)
        self.logger.info(f"Using Rayleigh number Ra={self.ra}")

        nz, nx = self.state_shape
        self._grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
        self._params = SimParams2D(
            ra=float(rayleigh_number),
            heater_duration=float(heater_duration),
            n_heaters=int(heater_segments),
            heater_limit=float(heater_limit),
        )
        self._dtype = torch_dtype(dtype)
        self.device = default_device(device)
        self._solver, self._diag_fn = _cached_solver(
            self._grid, self._params, self._dtype, self.device, self.observation_shape
        )
        self._fields: Optional[Fields2D] = None
        self._t = 0.0
        self._step_count = 1
        self._bank = None

        self.render_mode = render_mode
        self._renderer = PygameRenderer2D(fps=self.metadata["render_fps"])

    # ------------------------------------------------------------------
    def reset(
        self,
        seed: int | None = None,
        options: Dict[str, Any] | None = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        self._seed(seed)
        return self._begin_episode()

    def _begin_episode(self) -> Tuple[Any, Dict[str, Any]]:
        """The initial state from the bank (an index drawn from
        ``np_random``) or the random IC, then the first diagnostics."""
        if self.checkpoint:
            path = Path(self.checkpoint)
            if not path.exists():
                raise FileNotFoundError(
                    f"Checkpoint file {path} does not exist. "
                    "Please provide a valid checkpoint directory."
                )
            if self._bank is None:
                self._bank = load_bank_2d(str(path))
            idx = int(self.np_random.integers(self._bank.num_episodes))
            self.logger.info(
                f"Loading checkpoint with index: {idx} from file: {path}"
            )
            self._fields = self._fields_from_bank(idx)
        else:
            self._fields = self._solver.init_random(self._ic_generator(self.device))

        self._t = 0.0
        self._step_count = 1
        self.last_action = np.zeros((self.heater_segments,), np.float32)
        self._refresh_diag()
        return self._get_obs(), self._get_info()

    def _fields_from_bank(self, idx: int) -> Fields2D:
        def field(a):
            return torch.as_tensor(np.asarray(a[idx]), dtype=self._dtype, device=self.device)

        b = field(self._bank.b)
        p_hy = hydrostatic_pressure(b, self._grid.dz, self._params.min_b)
        return Fields2D(u=field(self._bank.u), w=field(self._bank.w), b=b, p_hy=p_hy,
                        p_nhs=torch.zeros_like(b))

    # ------------------------------------------------------------------
    def step(
        self, action: Any = None
    ) -> Tuple[Any, float, bool, bool, Dict[str, Any]]:
        terminated = False  # no terminal state (reference envs/rbc2D.py:161)
        truncated = False
        if action is None:
            action = np.zeros((self.heater_segments,), dtype=np.float32)
            warnings.warn("No action provided, using zero action")

        self._fields = self._solver.env_step(
            self._fields,
            torch.as_tensor(np.asarray(action), dtype=self._dtype, device=self.device),
        )
        # t = (step-1) * duration, computed multiplicatively so episodes whose
        # length is an exact multiple of the duration truncate exactly
        self._step_count += 1
        self._t = (self._step_count - 1) * self.heater_duration
        self._refresh_diag()
        if not self._diag_finite:
            raise RuntimeError("Error in simulation step, probably NaN values")

        self.last_obs = self._get_obs()
        self.last_reward = self._get_reward()
        self.last_info = self._get_info()
        # The reference truncates on accumulated t >= episode_length
        # (envs/rbc2D.py:179); counting completed steps is equivalent for
        # exact-multiple configs and immune to float accumulation drift.
        if self._step_count - 1 >= self.episode_steps:
            truncated = True
        return self.last_obs, self.last_reward, terminated, truncated, self.last_info

    # ------------------------------------------------------------------
    def _refresh_diag(self) -> None:
        """Run the diagnostics once; the host reads each result once."""
        obs, state, nus, nuo, finite = self._diag_fn(self._fields)
        n_ch = 5 if self.include_pressure else 3
        self._diag_obs = obs[:n_ch].cpu().numpy().astype(np.float32)
        self._diag_state = state[:n_ch].cpu().numpy().astype(np.float32)
        self._diag_nu_state = float(nus)
        self._diag_nu_obs = float(nuo)
        self._diag_finite = bool(finite)

    def _get_obs(self) -> np.ndarray:
        return self._diag_obs

    def _get_reward(self) -> float:
        return -self._diag_nu_obs

    def _get_info(self) -> Dict[str, Any]:
        return {
            "t": self._t,
            "step": self._step_count,
            "nusselt_state": self._diag_nu_state,
            "nusselt_obs": self._diag_nu_obs,
            "state": self._diag_state,
        }

    # ------------------------------------------------------------------
    def render(self):
        if self.render_mode is None:
            warnings.warn(
                "You are calling render method without specifying any render "
                "mode. You can specify the render_mode at initialization."
            )
            return None
        temperature = self._diag_state[RBCField.T]  # (nz, nx)
        return self._renderer.render(
            temperature,
            vmin=1.0,
            vmax=2.0 + self.heater_limit,
            mode=self.render_mode,
        )

    def close(self):
        if self.closed:
            return
        self.closed = True
        self._renderer.close()
