"""Evaluate a trained 3D policy on the port: deterministic episodes.

Twin of ``experiments/eval_sarl.py``, plus ``--device`` (default
``cuda``). It rebuilds the trained architecture from the result dir's
``config.yaml`` (heater grid and extractor flag), loads ``--model`` (the
port's ``.npz`` or, on a host with msgpack, the JAX package's
``.msgpack``), runs ``--episodes`` greedy episodes of one env with
``auto_reset=False`` and prints each episode's mean, min and max Nu.
``--render DIR`` writes a slice montage of the temperature after every
step, as PNG with imageio or as ``.npy`` without it (host-only).

Usage:
  python -m rbc_gym_tpu_torch.experiments.eval_sarl results/run1 \\
      [--model models/best_model.npz] [--episodes 1] [--render out/] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("result_dir")
    p.add_argument("--episodes", type=int, default=1)
    p.add_argument("--render", type=str, default=None,
                   help="directory to write rendered frames to")
    p.add_argument("--model", default="models/best_model.npz")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import yaml

    from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
    from rbc_gym_tpu_torch.models.nets import RBCActorCritic
    from rbc_gym_tpu_torch.models.params import load_params
    from rbc_gym_tpu_torch.wrappers import functional as fn

    with open(os.path.join(args.result_dir, "config.yaml")) as f:
        config = yaml.safe_load(f)

    s = int(config.get("rbc_heater_segments", 8))
    env = RBC3DVectorEnv(
        num_envs=1,
        rayleigh_number=config["rbc_rayleigh_number"],
        state_shape=tuple(config["rbc_state_shape"]),
        heater_duration=config["rbc_heater_duration"],
        heater_segments=s,
        heater_limit=config["rbc_heater_limit"],
        episode_length=config["rbc_episode_length"],
        dt_solver=config.get("rbc_dt_solver", 0.01),
        checkpoint=config.get("rbc_checkpoint"),
        checkpoint_idx=config.get("rbc_checkpoint_idx"),
        auto_reset=False,
        device=args.device,
    )
    norm = fn.make_obs_norm_3d(ra=config["rbc_rayleigh_number"],
                               heater_limit=config["rbc_heater_limit"])
    # the trained architecture from the frozen config (trunk flag, heater grid)
    model = RBCActorCritic(action_grid=(s, s), share_features_extractor=bool(
        config.get("rl_share_features_extractor", False)))
    model = load_params(os.path.join(args.result_dir, args.model), model.to(dtype=env.dtype))
    model = model.to(env.device).eval()

    @torch.no_grad()
    def policy(obs):
        mean, _, _ = model(fn.normalize_observation(obs, norm, channel_axis=-4))
        return torch.clamp(mean, -1.0, 1.0)

    if args.render:
        from rbc_gym_tpu_torch.envs.rendering import render_volume_slices

        os.makedirs(args.render, exist_ok=True)

    state, obs = env.reset(seed=config.get("seed", 0))
    for ep in range(args.episodes):
        nus = []
        for step in range(env.episode_steps):
            state, ts = env.step(state, policy(obs))
            obs = ts.obs
            nus.append(float(ts.nusselt[0]))
            if args.render:
                t_field = ts.obs[0, 0].cpu().numpy()  # (nz, ny, nx)
                img = render_volume_slices(np.flip(t_field, 1), 1.0, 2.0)
                frame = os.path.join(args.render, f"ep{ep}_s{step:04d}")
                try:
                    import imageio

                    imageio.imwrite(frame + ".png", img)
                except ImportError:
                    np.save(frame + ".npy", img)
        print(f"episode {ep}: mean Nu {np.mean(nus):.4f} "
              f"min {np.min(nus):.4f} max {np.max(nus):.4f}", flush=True)
        if ep + 1 < args.episodes:
            state, obs = env.reset(seed=ep + 1)


if __name__ == "__main__":
    main()
