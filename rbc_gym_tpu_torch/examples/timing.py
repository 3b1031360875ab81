"""Timing micro-benchmark on the port (twin of ``example/timing.py``):
timeit over init / reset / step.

The reference measures one env: 0.12 s a step for dt=1 of sim time, the
Julia/Oceananigans reference on a CPU (``example/timing.py:4``). This
script reports the single-env gym path (host-only: gymnasium) and the
batched native path (``RBC2DVectorEnv``, K1 once an env step on the card).

The JAX script steps at heater_duration 1.0, which is no multiple of the
solver's dt of 0.03: ``SimParams2D.substeps_per_env_step`` raises there
(in the JAX package at the first step, in the port when the env is
built). The twin steps at 0.99, the multiple nearest 1.0 (33 substeps),
and sets the reference's time against its own per unit of sim time.

Usage:
  python -m rbc_gym_tpu_torch.examples.timing [--device cpu]
"""

from __future__ import annotations

import argparse
import timeit

import numpy as np
import torch

from rbc_gym_tpu_torch import ENV_ID_2D

HEATER_DURATION = 0.99
# the reference's seconds for one unit of sim time (one env, CPU)
REFERENCE_S_PER_TIME_UNIT = 0.12


def _sync(device: torch.device) -> None:
    """Wait for the card (the host clock alone would time the enqueue)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_gym_env(steps=50, device="cuda", heater_duration=HEATER_DURATION, **env_kwargs):
    """Init, reset and step seconds of one gym env (host-only: gymnasium)."""
    import gymnasium as gym

    t_init = timeit.default_timer()
    env = gym.make(ENV_ID_2D, heater_duration=heater_duration, device=device, **env_kwargs)
    obs, info = env.reset(seed=0)  # includes loading the kernels on the card
    t_warm = timeit.default_timer() - t_init

    t_reset = timeit.timeit(lambda: env.reset(seed=1), number=10) / 10
    action = np.zeros(env.action_space.shape, np.float32)
    env.step(action)  # warm-up
    # each step returns numpy observations: it waits for the device
    t_step = timeit.timeit(lambda: env.step(action), number=steps) / steps
    env.close()
    print(f"gym env:   init {t_warm:.2f}s | reset {t_reset:.4f}s | "
          f"step (dt={heater_duration:g}) {t_step:.4f}s")
    return {"init_s": t_warm, "reset_s": t_reset, "step_s": t_step}


def time_native(num_envs=1024, steps=10, device="cuda", heater_duration=HEATER_DURATION,
                **env_kwargs):
    """Microseconds an env step of ``RBC2DVectorEnv`` at ``num_envs`` envs,
    after one warm-up step; returns them with the heater_duration, the
    substep count and the last rewards (numpy)."""
    from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv

    env = RBC2DVectorEnv(num_envs=num_envs, heater_duration=heater_duration, device=device,
                         **env_kwargs)
    state, _ = env.reset(seed=0)
    actions = torch.zeros(num_envs, env.params.n_heaters, dtype=env.dtype, device=env.device)
    state, ts = env.step(state, actions)
    _sync(env.device)
    t0 = timeit.default_timer()
    for _ in range(steps):
        state, ts = env.step(state, actions)
    _sync(env.device)
    per_env_step = (timeit.default_timer() - t0) / (steps * num_envs)
    ratio = REFERENCE_S_PER_TIME_UNIT / (per_env_step / heater_duration)
    n_sub = env.params.substeps_per_env_step
    print(f"native vec ({num_envs} envs): {per_env_step * 1e6:.1f} us/env-step "
          f"(dt={heater_duration:g}, {n_sub} substeps) -> {ratio:.0f}x the reference's "
          f"CPU time per unit of sim time")
    return {"heater_duration": heater_duration, "us_per_env_step": per_env_step * 1e6,
            "substeps": n_sub, "x_reference": ratio, "rewards": ts.reward.cpu().numpy()}


def main(device="cuda") -> None:
    time_gym_env(device=device)
    time_native(device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
