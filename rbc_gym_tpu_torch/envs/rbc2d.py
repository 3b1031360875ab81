"""Gymnasium-compatible 2D Rayleigh-Bénard environment (host-only).

Port of ``rbc_gym_tpu.envs.rbc2d.RayleighBenardConvection2DEnv``: the
JAX env's constructor (plus ``device``, default ``"cuda"``), spaces,
reward (-Nusselt on the sensor observation), info dict, truncation rule
and render modes. The behaviour is ``envs.single2d.RBC2DEnvCore``'s,
which needs no gymnasium; this module adds the gymnasium types and seeds
through ``gym.Env.reset``, so it needs gymnasium installed.

``use_gpu`` is accepted and ignored, as in the JAX env: ``device`` says
where the env runs, and without a CUDA device the default raises (pass
``device="cpu"`` for the plain PyTorch path).

For RL at scale prefer ``envs.vector2d.RBC2DVectorEnv``: the same
physics with many lockstep envs per card.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import gymnasium as gym
import numpy as np

from rbc_gym_tpu_torch.envs.single2d import RBC2DEnvCore, RBCField

__all__ = ["RayleighBenardConvection2DEnv", "RBCField"]


class RayleighBenardConvection2DEnv(RBC2DEnvCore, gym.Env):
    @functools.wraps(RBC2DEnvCore.__init__)  # its signature: the JAX env's, plus device
    def __init__(self, *args, **kwargs) -> None:
        RBC2DEnvCore.__init__(self, *args, **kwargs)

        # --- spaces (reference envs/rbc2D.py:75-108) ---
        self.action_space = gym.spaces.Box(
            -1, 1, shape=(self.heater_segments,), dtype=np.float32
        )
        channels = 3 + (2 if self.include_pressure else 0)
        lows = [np.ones(self.observation_shape, np.float32) * 1]
        highs = [np.ones(self.observation_shape, np.float32) * 2 + self.heater_limit]
        for _ in range(channels - 1):
            lows.append(np.full(self.observation_shape, -np.inf, np.float32))
            highs.append(np.full(self.observation_shape, np.inf, np.float32))
        self.observation_space = gym.spaces.Box(
            np.stack(lows, axis=0),
            np.stack(highs, axis=0),
            shape=(channels, *self.observation_shape),
            dtype=np.float32,
        )

    def reset(
        self,
        seed: int | None = None,
        options: Dict[str, Any] | None = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        gym.Env.reset(self, seed=seed)
        return self._begin_episode()
