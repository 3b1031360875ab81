"""Checkpoint demo on the port (twin of ``example/run_checkpoint.py``):
reset the 2D env from a turbulent initial-condition bank.

``RBC_CHECKPOINT`` names the bank: the port's committed Ra=1e4 training
bank by default (``.npz``, which any host reads), or any bank the port
reads, such as the reference's HDF5 files on a host with h5py.

Host-only: gymnasium. The env itself runs on ``device``.

Usage:
  [RBC_CHECKPOINT=BANK] python -m rbc_gym_tpu_torch.examples.run_checkpoint [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import gymnasium as gym
import numpy as np

from rbc_gym_tpu_torch import ENV_ID_2D

DEFAULT_CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "assets", "ckpt_ra10000_train.npz")


def main(checkpoint=None, episode_length=15, device="cuda", **env_kwargs):
    """One zero-action episode from the bank (``checkpoint``, else
    ``RBC_CHECKPOINT``, else the committed bank); returns the (t, Nu)
    pairs it printed, the reset's first."""
    if checkpoint is None:
        checkpoint = os.environ.get("RBC_CHECKPOINT", DEFAULT_CHECKPOINT)
    env = gym.make(ENV_ID_2D, checkpoint=checkpoint, episode_length=episode_length,
                   device=device, **env_kwargs)
    obs, info = env.reset(seed=42)
    print(f"reset from bank: Nu_state={info['nusselt_state']:.3f} (turbulent)")
    records = [(info["t"], info["nusselt_state"])]
    truncated = False
    while not truncated:
        obs, reward, terminated, truncated, info = env.step(
            np.zeros(env.action_space.shape, np.float32)
        )
        print(f"t={info['t']:5.1f} Nu={info['nusselt_state']:.3f}")
        records.append((info["t"], info["nusselt_state"]))
    env.close()
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
