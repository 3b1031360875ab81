"""Reward normalization wrapper (host-only: needs gymnasium).

Port of ``rbc_gym_tpu.wrappers.rbc_normalize_reward``; behavioural parity
with the reference wrappers/rbc_normalize_reward.py — the maximum
Nusselt number follows the empirical power law Nu_max ~ s * Ra^a (2D:
s=0.1, a=0.4; 3D: s=0.22, a=0.27), and the raw reward -Nu in
[-Nu_max, -1] is mapped to roughly [0, 1]:

    reward <- (reward + scale) / (scale - 1),   scale = s * Ra^a
"""

from __future__ import annotations

import gymnasium as gym


class RBCNormalizeReward(gym.RewardWrapper):
    """Normalize the reward to ~[0, 1]."""

    def __init__(self, env: gym.Env):
        super().__init__(env)
        from rbc_gym_tpu_torch.envs.rbc2d import RayleighBenardConvection2DEnv
        from rbc_gym_tpu_torch.envs.rbc3d import RayleighBenardConvection3DEnv

        ra = env.unwrapped.ra
        if isinstance(env.unwrapped, RayleighBenardConvection2DEnv):
            s, a = 0.1, 0.4
        elif isinstance(env.unwrapped, RayleighBenardConvection3DEnv):
            s, a = 0.22, 0.27
        else:
            raise TypeError(
                "RBCNormalizeReward expects an RBC 2D or 3D environment"
            )
        self.scale = s * (ra**a)

    def reward(self, reward):
        return (reward + self.scale) / (self.scale - 1)
