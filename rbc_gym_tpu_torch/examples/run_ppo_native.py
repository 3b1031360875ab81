"""End-to-end native training demo on the port: PPO on the 3D env, all on
one card (twin of ``example/run_ppo_native.py``).

No reference counterpart: this replaces the reference's SB3 workflow
(``experiments/run_sarl.py``) with ~20 lines. The env steps run K3 three
times a substep and K4 once an env step on the card; the update runs the
policy's Conv3d layers. ``rbc_gym_tpu_torch.experiments.run_sarl`` is the
full-featured CLI.

Usage:
  python -m rbc_gym_tpu_torch.examples.run_ppo_native [--device cpu]
"""

from __future__ import annotations

import argparse

from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.models import RBCActorCritic
from rbc_gym_tpu_torch.rl import PPO, PPOConfig, MetricsLogger, NusseltCallback
from rbc_gym_tpu_torch.wrappers import functional as fn


def main(num_envs=16, iterations=10, n_steps=8, n_epochs=4, n_minibatches=4, device="cuda",
         callbacks=(), **env_kwargs):
    """Train ``iterations`` PPO iterations; ``callbacks`` run after the
    demo's own two. Returns the trainer and its ``NusseltCallback``."""
    env = RBC3DVectorEnv(num_envs=num_envs, rayleigh_number=2500, episode_length=6,
                         device=device, **env_kwargs)
    norm = fn.make_obs_norm_3d(ra=2500, heater_limit=0.9)
    trainer = PPO(
        env,
        RBCActorCritic(),
        PPOConfig(n_steps=n_steps, n_epochs=n_epochs, n_minibatches=n_minibatches),
        obs_transform=lambda o: fn.normalize_observation(o, norm, channel_axis=-4),
        device=device,
    )
    nusselt = NusseltCallback()
    trainer.learn(iterations, callbacks=(nusselt, MetricsLogger(echo_every=1), *callbacks))
    print("best rollout nusselt:", nusselt.best_nusselt)
    return trainer, nusselt


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
