"""Gymnasium VectorEnv adapters over the port's vector envs (host-only).

Port of ``RBC2DGymVectorEnv`` (``rbc_gym_tpu/envs/vector2d.py:251-299``)
and ``RBC3DGymVectorEnv`` (``vector3d.py:269-320``): numpy in and out over
``RBC2DVectorEnv`` and ``RBC3DVectorEnv``, whose state stays on their
device between steps. Keyword arguments go to the vector env as they
are (``device``, ``checkpoint``, ``fused`` in 3D; ``poisson_precision``,
the JAX env's names in 2D and 3D). ``reset(seed=)`` seeds the
vector env's per-env key streams, which are the port's own: the initial
conditions differ from the JAX adapters' for the same seed.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np

from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv


def _numpy(x, dtype=None) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


class _GymVectorAdapter(gym.vector.VectorEnv):
    """reset/step over a port vector env; the subclass sets the spaces and
    the info keys."""

    metadata = {"render_modes": []}
    info_keys: tuple = ()

    def _spaces(self, single_obs: gym.spaces.Box, single_action: gym.spaces.Box) -> None:
        self.single_observation_space = single_obs
        self.single_action_space = single_action
        self.observation_space = gym.vector.utils.batch_space(single_obs, self.num_envs)
        self.action_space = gym.vector.utils.batch_space(single_action, self.num_envs)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._seed = seed
        self._state, obs = self._env.reset(seed=self._seed)
        return _numpy(obs, np.float32), {}

    def step(self, actions):
        self._state, ts = self._env.step(self._state, np.asarray(actions))
        info = {k: _numpy(getattr(ts, k)) for k in self.info_keys}
        return (
            _numpy(ts.obs, np.float32),
            _numpy(ts.reward, np.float32),
            _numpy(ts.terminated),
            _numpy(ts.truncated),
            info,
        )

    def close_extras(self, **kwargs):
        pass


class RBC2DGymVectorEnv(_GymVectorAdapter):
    """Gymnasium VectorEnv adapter (numpy I/O) over ``RBC2DVectorEnv``."""

    info_keys = ("t", "step", "nusselt_state", "nusselt_obs")

    def __init__(self, num_envs: int, seed: int = 0, **kwargs):
        self._env = RBC2DVectorEnv(num_envs, **kwargs)
        self.num_envs = num_envs
        nz_o, nx_o = self._env.observation_shape
        channels = 5 if self._env.include_pressure else 3
        self._spaces(
            gym.spaces.Box(-np.inf, np.inf, shape=(channels, nz_o, nx_o), dtype=np.float32),
            gym.spaces.Box(-1, 1, shape=(self._env.params.n_heaters,), dtype=np.float32),
        )
        self._seed = seed
        self._state = None


class RBC3DGymVectorEnv(_GymVectorAdapter):
    """Gymnasium VectorEnv adapter (numpy I/O) over ``RBC3DVectorEnv``."""

    info_keys = ("t", "step", "nusselt")

    def __init__(self, num_envs: int, seed: int = 0, **kwargs):
        self._env = RBC3DVectorEnv(num_envs, **kwargs)
        self.num_envs = num_envs
        g = self._env.grid
        s = self._env.params.n_heaters
        self._spaces(
            gym.spaces.Box(-np.inf, np.inf, shape=(4, g.nz, g.ny, g.nx), dtype=np.float32),
            gym.spaces.Box(-1, 1, shape=(s, s), dtype=np.float32),
        )
        self._seed = seed
        self._state = None
