"""Flow statistics against the Rayleigh number on the port (3D, big grid).

Twin of ``experiments/flowstats/flowstats_ra.py``: zero-action rollouts of
the 3D env across a Ra sweep, recording per-step Nusselt and per-channel
velocity maxima, with the JAX script's flags, record layout and printed
lines, plus ``--device`` (default ``cuda``). The output is a pickle of
records ``{ra, nusselt, max_u, max_v, max_w}`` (a rerun replaces a Ra's
record and the file is written after every Ra) and a JSON summary over
the last 100 steps; the defaults go beside this module, as
``flowstats_ra_torch.{pkl,json}``, so they never overwrite the JAX
records.

The statistics of a step (Nu mean over envs; max |obs| over env, z, y and
x per channel, channels 1-3 being u, v and w) are computed on the device
and read back as one small tensor a step. At 32x64x64 in float32 on CUDA
the solver runs K5 (``stage_xy``).

Usage:
  python -m rbc_gym_tpu_torch.experiments.flowstats.flowstats_ra [--ra 500 2000] \\
      [--steps 300] [--num_envs 1] [--device cpu] [--out FILE.pkl]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

RA_SWEEP = [500, 750, 1000, 1500, 2000, 4000, 8000, 16000, 32000,
            64000, 128000, 256000, 512000, 1000000]
HERE = os.path.dirname(os.path.abspath(__file__))
TAIL = 100  # steps of the summary's steady window


def make_env(ra, state_shape=(32, 64, 64), dt_solver=0.005, heater_duration=0.25,
             num_envs=1, device="cuda", dtype=torch.float32):
    """The sweep's env at one Ra; it never truncates (``episode_length``
    10**9), as in the JAX script."""
    from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv

    return RBC3DVectorEnv(
        num_envs=num_envs,
        rayleigh_number=ra,
        state_shape=tuple(state_shape),
        dt_solver=dt_solver,
        heater_duration=heater_duration,
        episode_length=10**9,
        dtype=dtype,
        device=device,
    )


def step_stats(env, state, actions):
    """One env step and its statistics on the device: (state, tensor of
    [Nu mean over envs, max |b|, max |u|, max |v|, max |w|])."""
    state, ts = env.step(state, actions)
    maxima = ts.obs.abs().amax(dim=(0, 2, 3, 4))  # per channel
    return state, torch.cat([ts.nusselt.mean().reshape(1), maxima])


def run_stats(env, state, steps: int):
    """``steps`` zero-action steps from ``state``: (state, {"nusselt",
    "max_u", "max_v", "max_w"} lists), one read from the device a step."""
    actions = torch.zeros((env.num_envs,) + (env.params.n_heaters,) * 2, dtype=env.dtype,
                          device=env.device)
    rows = []
    for _ in range(steps):
        state, stats = step_stats(env, state, actions)
        rows.append(stats.tolist())
    cols = list(zip(*rows)) if rows else [()] * 5
    return state, {"nusselt": list(cols[0]), "max_u": list(cols[2]),
                   "max_v": list(cols[3]), "max_w": list(cols[4])}


def perform_experiment(ra, steps, state_shape, dt_solver, heater_duration, num_envs, seed,
                       device="cuda"):
    env = make_env(ra, state_shape, dt_solver, heater_duration, num_envs, device)
    state, _ = env.reset(seed=seed)
    _, stats = run_stats(env, state, steps)
    return {"ra": ra, **stats}


def summary(records) -> dict:
    """The JSON summary: per Ra, Nu mean and std over the last ``TAIL``
    steps and the largest max |w| over all steps."""
    return {
        str(r["ra"]): {
            "nu_mean": float(np.mean(r["nusselt"][-TAIL:])),
            "nu_std": float(np.std(r["nusselt"][-TAIL:])),
            "max_w": float(max(r["max_w"])),
        }
        for r in sorted(records, key=lambda r: r["ra"])
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ra", type=int, nargs="*", default=RA_SWEEP)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--state_shape", type=int, nargs=3, default=[32, 64, 64])
    p.add_argument("--dt_solver", type=float, default=0.005)
    p.add_argument("--heater_duration", type=float, default=0.25)
    p.add_argument("--num_envs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(HERE, "flowstats_ra_torch.pkl"))
    args = p.parse_args(argv)

    records = []
    if os.path.exists(args.out):
        with open(args.out, "rb") as f:
            records = pickle.load(f)

    for ra in args.ra:
        t0 = time.time()
        rec = perform_experiment(ra, args.steps, args.state_shape, args.dt_solver,
                                 args.heater_duration, args.num_envs, args.seed, args.device)
        records = [r for r in records if r["ra"] != ra] + [rec]
        with open(args.out, "wb") as f:
            pickle.dump(records, f)
        tail = rec["nusselt"][-TAIL:]
        print(
            f"Ra={ra}: Nu={np.mean(tail):.3f}+-{np.std(tail):.3f} "
            f"max|w|={max(rec['max_w']):.3f} ({time.time()-t0:.1f}s)", flush=True
        )

    out = summary(records)
    with open(args.out.replace(".pkl", ".json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
