"""3D demo on the port (twin of ``example/run_3D.py``): a random-action
rollout at Ra=2500 with a progress bar driven by ``info["t"]``, rendered
as rgb arrays (PyVista where installed, else the slice montage).

``RBC3D_CHECKPOINT`` optionally names a 3D bank. Host-only: gymnasium (and
tqdm). The env itself runs on ``device``.

Usage:
  [RBC3D_CHECKPOINT=BANK] python -m rbc_gym_tpu_torch.examples.run_3D [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import gymnasium as gym

from rbc_gym_tpu_torch import ENV_ID_3D


def main(rayleigh_number=2500, episode_length=30, checkpoint=None, device="cuda",
         **env_kwargs):
    """One episode to its truncation; returns the steps taken, the last
    info and the last frame."""
    from tqdm import tqdm

    if checkpoint is None:
        checkpoint = os.environ.get("RBC3D_CHECKPOINT")
    env = gym.make(
        ENV_ID_3D,
        rayleigh_number=rayleigh_number,
        episode_length=episode_length,
        render_mode="rgb_array",
        checkpoint=checkpoint,
        device=device,
        **env_kwargs,
    )
    obs, info = env.reset(seed=42)
    pbar = tqdm(total=env.unwrapped.episode_length, desc="sim time")
    steps, truncated = 0, False
    while not truncated:
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        frame = env.render()
        steps += 1
        pbar.update(info["t"] - pbar.n)
        pbar.set_postfix(nusselt=f"{info['nusselt']:.3f}")
    pbar.close()
    env.close()
    return steps, info, frame


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
