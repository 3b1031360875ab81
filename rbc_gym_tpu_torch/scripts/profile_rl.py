"""Training-loop profile on the port: where does a PPO iteration spend its time?

Twin of ``scripts/profile_rl.py``, with its flags and table, plus
``--device`` (default ``cuda``). At each env count of ``--envs`` it times

  env      - the bare vector-env step loop (``n_steps`` zero-action steps,
             no policy): the solver's ceiling
  rollout  - ``PPO._rollout`` alone (env steps, policy forward, storage)
  iter     - ``PPO._iteration`` (rollout, GAE and the minibatch update)

and derives update = iter - rollout. Each time is a host clock around
``--k`` calls after one warm-up call, ending in a synchronise; on the CPU
the same clock times the plain path.

Usage:
  python -m rbc_gym_tpu_torch.scripts.profile_rl [--dim 3] [--envs 256,512,1024] [--k 5] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch


def build(dim: int, n_envs: int, n_steps: int, epochs: int, device):
    """The JAX script's trainer: 3D at Ra=2500 on 16x32x32 (heater_duration
    0.375, 60-unit episodes) or 2D at Ra=1e4; minibatches of 2048."""
    from rbc_gym_tpu_torch.rl import PPO, PPOConfig
    from rbc_gym_tpu_torch.wrappers import functional as fn

    if dim == 3:
        from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
        from rbc_gym_tpu_torch.models.nets import RBCActorCritic

        env = RBC3DVectorEnv(num_envs=n_envs, rayleigh_number=2500, state_shape=(16, 32, 32),
                             heater_duration=0.375, episode_length=60, dt_solver=0.01,
                             device=device)
        model = RBCActorCritic(action_grid=(8, 8))
        norm = fn.make_obs_norm_3d(ra=2500, heater_limit=0.9)
        channel_axis, action_shape = -4, (n_envs, 8, 8)
    else:
        from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
        from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D

        env = RBC2DVectorEnv(num_envs=n_envs, rayleigh_number=10_000, device=device)
        model = RBCActorCritic2D(n_heaters=12)
        norm = fn.make_obs_norm_2d(heater_limit=0.75)
        channel_axis, action_shape = -3, (n_envs, 12)
    cfg = PPOConfig(n_steps=n_steps, n_epochs=epochs,
                    n_minibatches=max(1, (n_steps * n_envs) // 2048))
    trainer = PPO(env, model, cfg, seed=0, device=device,
                  obs_transform=lambda o: fn.normalize_observation(o, norm, channel_axis))
    actions = torch.zeros(action_shape, dtype=env.dtype, device=env.device)
    return trainer, actions


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, k: int, device) -> float:
    """Seconds a call of ``fn``: one warm-up call, then ``k`` calls, the
    host clock stopped after a synchronise."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / k


def profile_row(dim, n_envs, n_steps, epochs, k, device) -> dict:
    trainer, actions = build(dim, n_envs, n_steps, epochs, device)
    env = trainer.env

    def env_loop():
        state = trainer.env_state
        for _ in range(n_steps):
            state, ts = env.step(state, actions)
        return ts.reward

    t_env = timed(env_loop, k, device)
    t_roll = timed(trainer._rollout, k, device)
    t_iter = timed(trainer._iteration, k, device)
    steps = n_steps * n_envs
    return {"envs": n_envs, "env_ms": 1e3 * t_env, "rollout_ms": 1e3 * t_roll,
            "iter_ms": 1e3 * t_iter, "update_ms": 1e3 * (t_iter - t_roll),
            "train_steps_per_s": steps / t_iter, "env_ceiling_steps_per_s": steps / t_env}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dim", type=int, default=3, choices=(2, 3))
    p.add_argument("--envs", default="256,512,1024")
    p.add_argument("--n_steps", type=int, default=None,
                   help="rollout length (default: 4 in 3D, 64 in 2D)")
    p.add_argument("--k", type=int, default=5, help="timing repetitions")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n_steps = args.n_steps or (4 if args.dim == 3 else 64)

    print(f"dim={args.dim} n_steps={n_steps} epochs={args.epochs} (k={args.k} reps)")
    print(f"{'envs':>6} {'env ms':>9} {'rollout ms':>11} {'iter ms':>9} "
          f"{'update ms':>10} {'train steps/s':>14} {'env ceiling':>12}")
    rows = []
    for n_envs in [int(x) for x in args.envs.split(",")]:
        r = profile_row(args.dim, n_envs, n_steps, args.epochs, args.k, args.device)
        rows.append(r)
        print(f"{n_envs:>6} {r['env_ms']:>9.1f} {r['rollout_ms']:>11.1f} "
              f"{r['iter_ms']:>9.1f} {r['update_ms']:>10.1f} "
              f"{r['train_steps_per_s']:>14.0f} {r['env_ceiling_steps_per_s']:>12.0f}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
