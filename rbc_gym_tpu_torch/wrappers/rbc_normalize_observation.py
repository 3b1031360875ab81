"""Observation normalization wrapper (host-only: needs gymnasium).

Port of ``rbc_gym_tpu.wrappers.rbc_normalize_observation``; behavioural
parity with the reference wrappers/rbc_normalize_observation.py —
per-channel affine map to approximately [-maxval, maxval]:

    obs[c] <- maxval * (2 (obs[c] - min_c) / (max_c - min_c) - 1)

Temperature channel bounds are [minT, maxT + heater_limit]; velocity
channels use +-u_limit. For 3D with u_limit=None the limit comes from the
fitted Hill curve w_inf * Ra^n / (Ra^n + Ra_c^n) with the constants the
reference extracted from its flowstats sweep (lines 77-81). Optional clip;
prints a warning when an observation exceeds (1 + eps) * maxval.
"""

from __future__ import annotations

from typing import Any

import gymnasium as gym
import numpy as np

# Hill-fit constants W_INF, RA_C, HILL_N (reference
# rbc_normalize_observation.py:77-81 / BASELINE.md "3D max-w saturation
# fit") and the limit they give, shared with the on-device wrappers
from rbc_gym_tpu_torch.wrappers.functional import HILL_N, RA_C, W_INF, u_limit_3d

__all__ = ["HILL_N", "RA_C", "W_INF", "RBCNormalizeObservation", "u_limit_3d"]


class RBCNormalizeObservation(gym.ObservationWrapper):
    """Normalize the observation to approximately lie in range [-1, 1]."""

    def __init__(
        self,
        env: gym.Env,
        heater_limit: float,
        maxval: float = 1,
        u_limit: float | None = 1.3,
        eps: float = 0.3,
        clip: bool = False,
    ):
        gym.ObservationWrapper.__init__(self, env)
        self.heater_limit = heater_limit
        self.clip = clip
        self.maxval = maxval
        self.excursion_eps = eps
        shape = env.observation_space.shape

        t_range = env.unwrapped.temperature_difference
        min_t = t_range[0]
        max_t = t_range[1] + heater_limit

        if u_limit is None:
            from rbc_gym_tpu_torch.envs.rbc3d import RayleighBenardConvection3DEnv

            if isinstance(env.unwrapped, RayleighBenardConvection3DEnv):
                u_limit = u_limit_3d(env.unwrapped.ra)
            else:
                raise ValueError("u_limit must be provided for 2D RBC.")

        n_channels = shape[0]
        self.min_vals = np.asarray(
            [min_t] + [-u_limit] * (n_channels - 1), np.float32
        )
        self.max_vals = np.asarray(
            [max_t] + [u_limit] * (n_channels - 1), np.float32
        )

        limit = maxval * (1 + eps)
        self.observation_space = gym.spaces.Box(
            low=-limit, high=limit, shape=shape, dtype=np.float32
        )

    def observation(self, obs) -> Any:
        mins = self.min_vals.reshape((-1,) + (1,) * (obs.ndim - 1))
        maxs = self.max_vals.reshape((-1,) + (1,) * (obs.ndim - 1))
        obs = self.maxval * (2 * (obs - mins) / (maxs - mins) - 1)
        if self.clip:
            obs = np.clip(obs, -self.maxval, self.maxval)
        if np.any(np.abs(obs) > (1 + self.excursion_eps) * self.maxval):
            max_obs = np.max(np.abs(obs))
            print(
                f"Warning: observation exceeds maxval {self.maxval}, "
                f"namely: {max_obs} is the max observed value."
            )
        return obs.astype(np.float32)
