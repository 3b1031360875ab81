"""2D demo on the port (twin of ``example/run_2D.py``): full-resolution
observation with pressure channels (5 channels: T, u, w and the two
pressures), zero actions, rendered in "human" mode where ``DISPLAY`` is
set, else as rgb arrays.

Host-only: gymnasium. The env itself runs on ``device``.

Usage:
  python -m rbc_gym_tpu_torch.examples.run_2D [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import gymnasium as gym
import numpy as np

from rbc_gym_tpu_torch import ENV_ID_2D


def main(steps=100, observation_shape=(64, 96), pressure=True, device="cuda", **env_kwargs):
    """``steps`` zero-action steps (fewer where the episode truncates);
    returns the last observation and info."""
    env = gym.make(
        ENV_ID_2D,
        render_mode="human" if os.environ.get("DISPLAY") else "rgb_array",
        observation_shape=observation_shape,
        pressure=pressure,
        device=device,
        **env_kwargs,
    )
    obs, info = env.reset(seed=42)
    for _ in range(steps):
        action = np.zeros(env.action_space.shape, np.float32)
        obs, reward, terminated, truncated, info = env.step(action)
        env.render()
        print(f"t={info['t']:6.1f} Nu_state={info['nusselt_state']:.3f} "
              f"reward={reward:.3f}")
        if truncated:
            break
    env.close()
    return obs, info


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
