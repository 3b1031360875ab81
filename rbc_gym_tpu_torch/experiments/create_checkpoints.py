"""Checkpoint-bank generation CLI on the port.

Twin of ``scripts/create_checkpoints.py`` (which replaces the reference's
Julia CLIs, sim/rbc_sim2D.jl:231-322 and sim/rbc_sim3D.jl:228-310): the
same flags and defaults and the same output names, ``ckpt_ra{Ra}`` in 2D
and ``3D_ckpt_ra{Ra}`` in 3D, plus ``--device`` (default ``cuda``). The
burn-in runs on the device (``sim.burnin``). ``--format h5`` (the default,
as in the JAX script) needs h5py; on a machine without it, such as the
card, write ``--format npz``.

Examples:
  python -m rbc_gym_tpu_torch.experiments.create_checkpoints 2d --dir data/checkpoints/train \\
      --seed 42 --random_inits 20 --Ra 10000 --format npz
  python -m rbc_gym_tpu_torch.experiments.create_checkpoints 3d --dir data/checkpoints/train \\
      --seed 42 --random_inits 20 --Ra 2500 --format npz
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dim", choices=["2d", "3d"])
    p.add_argument("--dir", default="data/checkpoints")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--random_inits", type=int, default=1)
    p.add_argument("--Ra", type=int, default=None)
    p.add_argument("--Pr", type=float, default=0.7)
    p.add_argument("--N", type=int, nargs="+", default=None,
                   help="grid size: 2d [nx nz] (default 96 64), 3d [nx ny nz] (default 32 32 16)")
    p.add_argument("--random_kick", type=float, default=None)
    p.add_argument("--delta_t", type=float, default=None, help="solver dt")
    p.add_argument("--duration", type=float, default=None,
                   help="burn-in duration (2d: time units, 3d: free-fall)")
    p.add_argument("--format", choices=["h5", "npz"], default="h5")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Generate and save one bank; returns its path."""
    args = parse_args(argv)
    import numpy as np

    from rbc_gym_tpu_torch.sim import burnin
    from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
    from rbc_gym_tpu_torch.utils import checkpoints as ck

    os.makedirs(args.dir, exist_ok=True)
    t0 = time.time()
    if args.dim == "2d":
        ra = args.Ra or 100_000
        n = args.N or [96, 64]
        bank = burnin.generate_bank_2d(
            ra=ra,
            n_episodes=args.random_inits,
            seed=args.seed,
            grid=Grid2D(nx=n[0], nz=n[1], lx=2 * np.pi, lz=2.0),
            duration=args.duration or 600.0,
            dt_solver=args.delta_t or 0.03,
            random_kick=args.random_kick or 0.2,
            device=args.device,
        )
        path = os.path.join(args.dir, f"ckpt_ra{ra}.{args.format}")
        ck.save_bank_2d(path, bank)
    else:
        ra = args.Ra or 2500
        n = args.N or [32, 32, 16]
        bank = burnin.generate_bank_3d(
            ra=ra,
            n_episodes=args.random_inits,
            seed=args.seed,
            grid=Grid3D(nx=n[0], ny=n[1], nz=n[2], lx=4 * np.pi, ly=4 * np.pi, lz=2.0),
            duration=args.duration or 200.0,
            dt_solver=args.delta_t or 0.01,
            random_kick=args.random_kick or 0.01,
            pr=args.Pr,
            device=args.device,
        )
        path = os.path.join(args.dir, f"3D_ckpt_ra{ra}.{args.format}")
        ck.save_bank_3d(path, bank)
    print(f"Saved {args.random_inits} episodes to {path} in {time.time() - t0:.1f}s")
    return path


if __name__ == "__main__":
    main()
