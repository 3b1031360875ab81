"""W&B logging demo on the port (twin of ``example/run_wandb.py``):
per-step reward/Nusselt logging and frame capture assembled into a
video. Gated on the wandb import: without wandb ``main`` prints so and
returns 0.

Host-only: gymnasium (and wandb). The env itself runs on ``device``.

Usage:
  python -m rbc_gym_tpu_torch.examples.run_wandb [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import gymnasium as gym
import numpy as np

from rbc_gym_tpu_torch import ENV_ID_2D


def main(episode_length=30, project="rbc-gym-tpu-demo", device="cuda", **env_kwargs) -> int:
    """One random-action episode logged to W&B; 0 (also without wandb)."""
    try:
        import wandb
    except ImportError:
        print("wandb is not installed; install it to run this demo.")
        return 0

    run = wandb.init(project=project)
    env = gym.make(
        ENV_ID_2D,
        render_mode="rgb_array",
        episode_length=episode_length,
        device=device,
        **env_kwargs,
    )
    obs, info = env.reset(seed=42)
    frames = []
    truncated = False
    while not truncated:
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        frames.append(env.render())
        wandb.log(
            {
                "reward": reward,
                "nusselt_state": info["nusselt_state"],
                "nusselt_obs": info["nusselt_obs"],
                "t": info["t"],
            }
        )
    video = np.stack(frames).transpose(0, 3, 1, 2)
    wandb.log({"rollout": wandb.Video(video, fps=10, format="mp4")})
    env.close()
    run.finish()
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    sys.exit(main(device=parser.parse_args().device))
