"""Weak-scaling benchmark of the env-axis split: the twin of
``scripts/bench_multihost.py``.

Each rank steps its ``--num_envs_per_process`` envs of a fleet of that
many times the ranks (``parallel.shard_vector_env``), as a training launch
does; the fleet advances when the slowest rank does, so the wall time is
the slowest rank's. Rank 0 prints ONE JSON line:

  {"metric": "multihost_env_steps_per_sec_2d", "value": ..., "unit":
   "env-steps/s", "processes": R, "num_envs": total, "envs_per_process": E,
   "steps": S, "per_process_sec": [...], "device": ..., "backend": ...}

Weak-scaling efficiency = value(R ranks) / (R * value(1 rank)), from a
run at each rank count: ``bench_multihost.sh`` runs both. Ranks sharing
one card (``--backend gloo``) measure the split, not scaling.

Usage (one process, the baseline):
  python -m rbc_gym_tpu_torch.scripts.bench_multihost --num_envs_per_process 512
Two ranks (torchrun's variables; one rank a card, or gloo to share one):
  python -m torch.distributed.run --standalone --nproc_per_node 2 \\
      -m rbc_gym_tpu_torch.scripts.bench_multihost --backend gloo
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dim", choices=["2d", "3d"], default="2d")
    p.add_argument("--num_envs_per_process", type=int, default=512)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--state_shape", type=int, nargs="+", default=None)
    p.add_argument("--out", type=str, default=None,
                   help="also write the JSON record to this path")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--backend", type=str, default=None,
                   help="torch.distributed backend (default: nccl on CUDA, gloo on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from rbc_gym_tpu_torch.parallel import initialize_distributed, shutdown_distributed

    distributed = initialize_distributed(backend=args.backend, device=args.device)
    done = False
    try:
        record = run(args, distributed)
        done = True
    finally:
        shutdown_distributed(barrier=done)
    return record


def run(args, distributed: bool) -> dict:
    """The timed steps of ``main`` on this rank's shard; rank 0's record."""
    from rbc_gym_tpu_torch.parallel import make_host_env_mesh, shard_vector_env

    mesh = make_host_env_mesh(device=args.device)
    device = mesh.device
    num_envs = args.num_envs_per_process * mesh.size

    if args.dim == "2d":
        from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv as env_cls

        nz, nx = args.state_shape or (64, 96)
        kwargs = dict(rayleigh_number=10_000, state_shape=(nz, nx),
                      observation_shape=(8, nx // 2), heater_duration=1.5, episode_length=300)
        action_shape = (12,)
    else:
        from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv as env_cls

        nz, ny, nx = args.state_shape or (16, 32, 32)
        kwargs = dict(rayleigh_number=2500, state_shape=(nz, ny, nx), heater_duration=0.125,
                      dt_solver=0.01, episode_length=37.5)
        action_shape = (8, 8)
    env = shard_vector_env(env_cls, num_envs, mesh, device=device, **kwargs)
    actions = torch.zeros((env.num_envs,) + action_shape, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state, _ = env.reset(seed=0)
    state, ts = env.step(state, actions)  # warm-up
    sync()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, ts = env.step(state, actions)
    sync()
    elapsed = mesh.gather_rows(torch.tensor([time.perf_counter() - t0], dtype=torch.float64))
    record = None
    if mesh.rank == 0:
        wall = float(elapsed.max())
        record = {
            "metric": f"multihost_env_steps_per_sec_{args.dim}",
            "value": num_envs * args.steps / wall,
            "unit": "env-steps/s",
            "processes": mesh.size,
            "num_envs": num_envs,
            "envs_per_process": args.num_envs_per_process,
            "steps": args.steps,
            "per_process_sec": elapsed.tolist(),
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "backend": torch.distributed.get_backend() if distributed else None,
        }
        print(json.dumps(record), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(record, f)
    return record


if __name__ == "__main__":
    main()
