"""Gymnasium-compatible 3D Rayleigh-Bénard environment (host-only).

Port of ``rbc_gym_tpu.envs.rbc3d.RayleighBenardConvection3DEnv``: the
JAX env's constructor (plus ``device``, default ``"cuda"``), spaces (obs
= the full 4-channel state at state resolution), reward = -Nusselt, info
{t, step, nusselt}, free-fall time bookkeeping and truncation. The
behaviour is ``envs.single3d.RBC3DEnvCore``'s, which needs no gymnasium;
this module adds the gymnasium types and seeds through ``gym.Env.reset``,
so it needs gymnasium installed. ``use_gpu`` is accepted and ignored, as
in the JAX env: ``device`` says where the env runs.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import gymnasium as gym
import numpy as np

from rbc_gym_tpu_torch.envs.single3d import RBC3DEnvCore, RBC3DField

__all__ = ["RayleighBenardConvection3DEnv", "RBC3DField"]


class RayleighBenardConvection3DEnv(RBC3DEnvCore, gym.Env):
    @functools.wraps(RBC3DEnvCore.__init__)  # its signature: the JAX env's, plus device
    def __init__(self, *args, **kwargs) -> None:
        RBC3DEnvCore.__init__(self, *args, **kwargs)
        s = self.heater_segments
        t_lo, t_hi = self.temperature_difference
        self.action_space = gym.spaces.Box(-1, 1, shape=(s, s), dtype=np.float32)
        lows = np.stack(
            [np.full(self.state_shape, t_lo)] + [np.full(self.state_shape, -np.inf)] * 3,
            dtype=np.float32,
            axis=0,
        )
        highs = np.stack(
            [np.full(self.state_shape, t_hi + self.heater_limit)]
            + [np.full(self.state_shape, np.inf)] * 3,
            dtype=np.float32,
            axis=0,
        )
        self.observation_space = gym.spaces.Box(
            lows, highs, shape=(4, *self.state_shape), dtype=np.float32
        )

    def reset(
        self,
        seed: int | None = None,
        options: Dict[str, Any] | None = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        gym.Env.reset(self, seed=seed)
        return self._begin_episode()
