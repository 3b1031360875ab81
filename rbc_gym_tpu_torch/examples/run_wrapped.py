"""Wrapper-stack demo on the port (twin of ``example/run_wrapped.py``):
observation and reward normalization, reward shaping, then gymnasium's
``FlattenObservation`` and ``FrameStackObservation``.

Host-only: gymnasium. The env itself runs on ``device``.

Usage:
  python -m rbc_gym_tpu_torch.examples.run_wrapped [--device cpu]
"""

from __future__ import annotations

import argparse

import gymnasium as gym
from gymnasium.wrappers import FlattenObservation, FrameStackObservation

from rbc_gym_tpu_torch import ENV_ID_2D
from rbc_gym_tpu_torch.wrappers import (
    RBCNormalizeObservation,
    RBCNormalizeReward,
    RBCRewardShaping,
)


def main(episode_length=15, device="cuda", **env_kwargs):
    """One random-action episode through the stack; returns the stacked
    observation's shape and the steps taken."""
    env = gym.make(ENV_ID_2D, episode_length=episode_length, device=device, **env_kwargs)
    env = RBCNormalizeObservation(env, heater_limit=0.75, u_limit=1.3)
    env = RBCNormalizeReward(env)
    env = RBCRewardShaping(env, shaping_weight=0.3)
    env = FlattenObservation(env)
    env = FrameStackObservation(env, 4)

    obs, info = env.reset(seed=42)
    print("stacked obs shape:", obs.shape)
    steps, truncated = 0, False
    while not truncated:
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        steps += 1
        print(f"t={info['t']:5.1f} reward={reward:+.3f} "
              f"cell_dist={info['cell_dist']:.3f}")
    env.close()
    return obs.shape, steps


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
