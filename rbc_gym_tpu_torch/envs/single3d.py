"""The single 3D Rayleigh-Bénard environment, without gymnasium.

Port of ``rbc_gym_tpu.envs.rbc3d`` (lines 38-324) minus gymnasium's types:
``RBC3DEnvCore`` has the JAX env's constructor (plus ``device``), spaces'
bounds aside: obs = the full 4-channel state at state resolution, reward
= -Nusselt (state-based, the reference's 3D definition), info {t, step,
nusselt}, free-fall time bookkeeping (t advances by heater_duration * t_ff
a step), truncation at t >= episode_length, a per-env file logger, and
render through PyVista where it imports, else a slice montage.
``envs.rbc3d.RayleighBenardConvection3DEnv`` adds the gymnasium spaces
and seeding over it.

One env is a batch of one for the solver: on CUDA in float32 on the
training grid a step launches the stage kernel (K3) three times a substep
and the correction kernel (K4) once, at one env. Seeding is the 2D
core's (``envs.single2d.SeededCore``).
"""

from __future__ import annotations

import logging
import warnings
from enum import IntEnum
from functools import lru_cache
from os.path import join
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rbc_gym_tpu_torch import default_device
from rbc_gym_tpu_torch.envs.rendering import render_volume_slices
from rbc_gym_tpu_torch.envs.single2d import SeededCore, torch_dtype
from rbc_gym_tpu_torch.ops.kernels2d import hydrostatic_pressure
from rbc_gym_tpu_torch.sim import nusselt as nu
from rbc_gym_tpu_torch.sim.grid import Grid3D
from rbc_gym_tpu_torch.sim.solver3d import Fields3D, SimParams3D, make_solver3d
from rbc_gym_tpu_torch.utils.checkpoints import load_bank_3d


class RBC3DField(IntEnum):
    """Channel indices (reference envs/rbc3D.py:24-28)."""

    T = 0
    U = 1
    V = 2
    W = 3


@lru_cache(maxsize=8)
def _cached_solver3d(grid: Grid3D, params: SimParams3D, dtype: torch.dtype,
                     device: torch.device):
    """The solver and the diagnostics function, one per (grid, params,
    dtype, device)."""
    solver = make_solver3d(grid, params, dtype=dtype, device=device)

    def diagnostics(f: Fields3D):
        """The state in python (4, nz, ny, nx) order, its Nu, and whether
        b, u, v and w are finite."""
        nz = grid.nz
        state = torch.stack([f.b, f.u, f.v, f.w[..., :nz]])  # (4, nx, ny, nz)
        nus = nu.nusselt_3d(f.b, f.w[..., :nz], params.kappa, params.min_b, params.delta_b)
        finite = (
            torch.isfinite(f.b).all()
            & torch.isfinite(f.u).all()
            & torch.isfinite(f.v).all()
            & torch.isfinite(f.w).all()
        )
        return state.permute(0, 3, 2, 1), nus, finite

    return solver, diagnostics


class RBC3DEnvCore(SeededCore):
    """The 3D env's behaviour over the port's solver, gymnasium-free."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        rayleigh_number: Optional[int] = 2500,
        prandtl_number: Optional[float] = 0.7,
        domain: Optional[list] = (2, 4 * np.pi, 4 * np.pi),  # (Lz, Ly, Lx)
        state_shape: Optional[list] = (16, 32, 32),  # (nz, ny, nx)
        temperature_difference: Optional[list] = (1, 2),
        heater_segments: Optional[int] = 8,
        heater_limit: Optional[float] = 0.9,
        heater_duration: Optional[float] = 0.125,
        episode_length: Optional[int] = 300,
        dt_solver: Optional[float] = 0.01,
        use_gpu: Optional[bool] = False,  # accepted for API parity; ignored (see device)
        checkpoint: Optional[str] = None,
        checkpoint_idx: Optional[int] = None,
        render_mode: Optional[str] = None,
        log_dir: Optional[str] = None,
        env_id: int = 0,
        dtype: str | torch.dtype = "float32",
        device: str | torch.device | None = "cuda",
    ) -> None:
        self.closed = False
        self.checkpoint = checkpoint
        self.checkpoint_idx = checkpoint_idx

        self.ra = rayleigh_number
        self.pr = prandtl_number
        self.domain = list(domain)
        self.episode_length = episode_length
        self.dt_solver = dt_solver
        self.state_shape = tuple(state_shape)
        self.temperature_difference = list(temperature_difference)
        self.heater_segments = heater_segments
        self.heater_limit = heater_limit
        self.heater_duration = heater_duration

        # per-env file logger (reference envs/rbc3D.py:83-99)
        self.logger = logging.getLogger(f"{__name__}.env_{env_id}")
        self.logger.setLevel(logging.INFO)
        if log_dir is not None:
            handler = logging.FileHandler(join(log_dir, f"env_{env_id}.log"))
            handler.setFormatter(
                logging.Formatter(
                    "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
                )
            )
            self.logger.addHandler(handler)
        self.logger.info(f"Using Rayleigh number Ra={self.ra}")

        nz, ny, nx = self.state_shape
        lz, ly, lx = self.domain
        self._grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=lx, ly=ly, lz=lz)
        min_b = float(temperature_difference[0])
        delta_b = float(temperature_difference[1] - temperature_difference[0])
        self._params = SimParams3D(
            ra=float(rayleigh_number),
            pr=float(prandtl_number),
            min_b=min_b,
            delta_b=delta_b,
            dt_solver=float(dt_solver),
            heater_duration=float(heater_duration),
            n_heaters=int(heater_segments),
            heater_limit=float(heater_limit),
            lz=float(lz),
        )
        self._dtype = torch_dtype(dtype)
        self.device = default_device(device)
        self._solver, self._diag_fn = _cached_solver3d(
            self._grid, self._params, self._dtype, self.device
        )
        self._fields: Optional[Fields3D] = None
        self._bank = None
        self._step_count = 1
        self._t = 0.0
        # env step advances heater_duration * t_ff of buoyancy time
        self._t_per_step = self._params.heater_duration * self._params.t_ff
        self.episode_steps = int(round(episode_length / self._t_per_step))

        self.render_mode = render_mode
        self._plotter = None

    # ------------------------------------------------------------------
    def reset(
        self,
        seed: int | None = None,
        options: Dict[str, Any] | None = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        self._seed(seed)
        return self._begin_episode()

    def _begin_episode(self) -> Tuple[Any, Dict[str, Any]]:
        """The initial state from the bank (``checkpoint_idx``, else an index
        drawn from ``np_random``) or the random IC, then the first
        diagnostics."""
        if self.checkpoint:
            path = Path(self.checkpoint)
            if not path.exists():
                raise FileNotFoundError(
                    f"Checkpoint file {path} does not exist. "
                    "Please provide a valid checkpoint directory."
                )
            if self._bank is None:
                self._bank = load_bank_3d(str(path))
            if self.checkpoint_idx is not None:
                idx = int(self.checkpoint_idx)
            else:
                idx = int(self.np_random.integers(self._bank.num_episodes))
            self.logger.info(
                f"Loading checkpoint with index: {idx} from file: {path}"
            )
            self._fields = self._fields_from_bank(idx)
        else:
            self._fields = self._solver.init_random(self._ic_generator(self.device))

        self._t = 0.0
        self._step_count = 1
        s = self.heater_segments
        self.last_action = np.zeros((s, s), np.float32)
        self._refresh_diag()
        return self._get_obs(), self._get_info()

    def _fields_from_bank(self, idx: int) -> Fields3D:
        def field(a):
            return torch.as_tensor(np.asarray(a[idx]), dtype=self._dtype, device=self.device)

        b = field(self._bank.b)
        return Fields3D(
            u=field(self._bank.u),
            v=field(self._bank.v),
            w=field(self._bank.w),
            b=b,
            p_hy=hydrostatic_pressure(b, self._grid.dz, self._params.min_b),
            p_nhs=torch.zeros_like(b),
        )

    # ------------------------------------------------------------------
    def step(
        self, action: Any = None
    ) -> Tuple[Any, float, bool, bool, Dict[str, Any]]:
        try:
            terminated = False
            truncated = False
            if action is None:
                s = self.heater_segments
                action = np.zeros((s, s), dtype=np.float32)
                warnings.warn("No action provided, using zero action")

            self._fields = self._solver.env_step(
                self._fields,
                torch.as_tensor(np.asarray(action), dtype=self._dtype, device=self.device),
            )
            self._step_count += 1
            self._t = (self._step_count - 1) * self._t_per_step
            self._refresh_diag()
            if not self._diag_finite:
                self.logger.error(
                    "Simulation step failed, probably NaN values in the "
                    "simulation."
                )
                raise RuntimeError(
                    "Error in simulation step, probably NaN values"
                )

            self.last_obs = self._get_obs()
            self.last_reward = self._get_reward()
            self.last_info = self._get_info()
            if self._step_count - 1 >= self.episode_steps:
                truncated = True
        except Exception as e:
            self.logger.error(f"Error during step: {e}")
            raise
        return self.last_obs, self.last_reward, terminated, truncated, self.last_info

    # ------------------------------------------------------------------
    def _refresh_diag(self) -> None:
        """Run the diagnostics once; the host reads each result once."""
        state, nus, finite = self._diag_fn(self._fields)
        self._diag_state = state.cpu().numpy().astype(np.float32)
        self._diag_nu = float(nus)
        self._diag_finite = bool(finite)

    def _get_obs(self) -> np.ndarray:
        return self._diag_state

    def _get_reward(self) -> float:
        return -self._diag_nu

    def _get_info(self) -> Dict[str, Any]:
        return {"t": self._t, "step": self._step_count, "nusselt": self._diag_nu}

    # ------------------------------------------------------------------
    def render(self):
        if self.render_mode not in ("human", "rgb_array"):
            return None
        temperature = self._diag_state[RBC3DField.T]  # (nz, ny, nx)
        cmin = self.temperature_difference[0]
        cmax = self.temperature_difference[1]
        try:
            import pyvista  # noqa: F401

            return self._render_pyvista(temperature, cmin, cmax)
        except ImportError:
            img = render_volume_slices(np.flip(temperature, axis=1), cmin, cmax)
            if self.render_mode == "rgb_array":
                return img
            return None

    def _render_pyvista(self, t, cmin, cmax):
        # Optional dependency; tests drive this branch through a fake module.
        import pyvista as pv

        t = np.flip(t, axis=1)
        if self._plotter is None:
            nz, ny, nx = t.shape
            lz, ly, lx = self.domain
            grid = pv.RectilinearGrid(
                np.arange(nx) * lx / nx,
                np.arange(ny) * ly / ny,
                np.arange(nz) * lz / nz,
            )
            grid["T"] = t.ravel(order="C")
            self._grid_pv = grid
            self._plotter = pv.Plotter(
                off_screen=(self.render_mode != "human"), window_size=(800, 608)
            )
            self._plotter.add_volume(
                grid, scalars="T", cmap="turbo", clim=(cmin, cmax),
                opacity="sigmoid_1",
            )
            self._plotter.add_axes()
        self._grid_pv.point_data["T"][:] = t.ravel(order="C")
        if self.render_mode == "human":
            self._plotter.render()
            return None
        img = self._plotter.screenshot(return_img=True)
        self._plotter.close()
        self._plotter = None
        return img[:, :, :3]

    def close(self):
        if self.closed:
            return
        self.closed = True
        if self._plotter is not None:
            self._plotter.close()
