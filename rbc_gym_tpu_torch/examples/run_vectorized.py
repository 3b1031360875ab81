"""Vectorized demo on the port (twin of ``example/run_vectorized.py``).

The reference sanity-checks Gymnasium's AsyncVectorEnv with 6 subprocess
envs, each paying a ~7.7 s Julia warmup. The port's equivalent is the
lockstep vector env: all envs advance together, one K1 launch an env
step on the card. Both paths are shown; the native one is the product.

Usage:
  python -m rbc_gym_tpu_torch.examples.run_vectorized [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rbc_gym_tpu_torch import ENV_ID_2D


def _sync(device: torch.device) -> None:
    """Wait for the card (the host clock alone would time the enqueue)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def native_lockstep(num_envs=6, steps=20, device="cuda", **env_kwargs):
    """One warm-up step, then ``steps`` timed steps of zero actions;
    returns the last rewards (numpy) and env-steps/s."""
    from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv

    env = RBC2DVectorEnv(num_envs=num_envs, device=device, **env_kwargs)
    state, obs = env.reset(seed=0)
    actions = torch.zeros(num_envs, env.params.n_heaters, dtype=env.dtype, device=env.device)
    state, ts = env.step(state, actions)  # warm-up (and the kernels' build)
    _sync(env.device)
    t0 = time.time()
    for _ in range(steps):
        state, ts = env.step(state, actions)
    _sync(env.device)
    dt = time.time() - t0
    rate = num_envs * steps / dt
    print(f"native lockstep: {num_envs} envs x {steps} steps in {dt:.2f}s "
          f"({rate:.0f} env-steps/s)")
    rewards = ts.reward.cpu().numpy()
    print("rewards:", rewards.round(3))
    return rewards, rate


def gymnasium_sync(num_envs=6, steps=3, device="cuda", **env_kwargs):
    """``gym.make_vec`` in "sync" mode over the port's gym ID (host-only:
    gymnasium); ``device`` reaches every sub-env. Returns the last obs and
    rewards."""
    import gymnasium as gym

    envs = gym.make_vec(ENV_ID_2D, num_envs=num_envs, vectorization_mode="sync",
                        device=device, **env_kwargs)
    obs, _ = envs.reset(seed=42)
    for _ in range(steps):
        obs, rewards, term, trunc, infos = envs.step(
            np.zeros(envs.action_space.shape, np.float32)
        )
    print("gymnasium sync vec:", obs.shape, rewards.round(3))
    envs.close()
    return obs, rewards


def main(device="cuda") -> None:
    native_lockstep(device=device)
    gymnasium_sync(device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
