"""2D flow statistics against the Rayleigh number on the port.

Twin of ``experiments/flowstats/flowstats_ra_2d.py``: zero-action rollouts
of the 2D env across the checkpoint-bank Ra ladder, recording per-step
Nusselt and velocity maxima, with the JAX script's flags, protocol block,
summary keys and printed lines, plus ``--device`` (default ``cuda``). The
summary grounds the 2D reward normaliser's Nu_max ~ 0.1*Ra^0.4 constant.

Initial conditions come from the checkpoint banks: by default the port's
``assets/ckpt_ra{ra}_train.npz``, or ``ckpt_ra{ra}.h5`` in a named
``--bank_dir`` (HDF5 needs h5py, on the host). Where a Ra has no bank the
run starts from random initial conditions, as the JAX script does, and
records ``from_bank: false`` for that point. The default output is
``flowstats_ra_2d_torch.json`` beside this module, so it never overwrites
the JAX record.

Usage:
  python -m rbc_gym_tpu_torch.experiments.flowstats.flowstats_ra_2d [--ra 10000 1000000] \\
      [--steps 120] [--tail 60] [--num_envs 4] [--bank_dir DIR] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

RA_SWEEP = [10_000, 30_000, 100_000, 300_000,
            1_000_000, 3_000_000, 10_000_000]
HERE = os.path.dirname(os.path.abspath(__file__))
ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "assets")


def bank_path(ra, bank_dir=None):
    """The bank of ``ra``: the port's asset without ``bank_dir``, else the
    reference's name in ``bank_dir``; None where that file is absent."""
    if bank_dir is None:
        path = os.path.join(ASSET_DIR, f"ckpt_ra{ra}_train.npz")
    else:
        path = os.path.join(bank_dir, f"ckpt_ra{ra}.h5")
    return path if os.path.exists(path) else None


def make_env(ra, num_envs, bank=None, device="cuda", dtype=torch.float32):
    """The sweep's env at one Ra; it never truncates (``episode_length``
    10**9), as in the JAX script."""
    from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv

    return RBC2DVectorEnv(num_envs=num_envs, rayleigh_number=ra, episode_length=10**9,
                          checkpoint=bank, dtype=dtype, device=device)


def run_stats(env, state, steps: int):
    """``steps`` zero-action steps from ``state``: (state, {"nusselt",
    "max_u", "max_w"} lists); each step's [Nu(state) mean over envs,
    max |u|, max |w|] is computed on the device and read as one tensor."""
    actions = torch.zeros((env.num_envs, env.params.n_heaters), dtype=env.dtype,
                          device=env.device)
    rows = []
    for _ in range(steps):
        state, ts = env.step(state, actions)
        f = state.fields
        rows.append(torch.stack([ts.nusselt_state.mean(), f.u.abs().max(),
                                 f.w.abs().max()]).tolist())
    cols = list(zip(*rows)) if rows else [()] * 3
    return state, {"nusselt": list(cols[0]), "max_u": list(cols[1]), "max_w": list(cols[2])}


def perform_experiment(ra, steps, num_envs, seed, bank_dir=None, device="cuda"):
    bank = bank_path(ra, bank_dir)
    env = make_env(ra, num_envs, bank, device)
    state, _ = env.reset(seed=seed)
    _, stats = run_stats(env, state, steps)
    return {"ra": ra, "from_bank": bank is not None, **stats}


def point(rec, tail: int) -> dict:
    """A summary point from a record: statistics over the last ``tail`` steps."""
    ra = rec["ra"]
    tail_nu = np.array(rec["nusselt"][-tail:])
    tail_w = np.array(rec["max_w"][-tail:])
    nu_ref = 0.1 * ra ** 0.4  # 2D reward-normalizer Nu_max power law
    return {
        "nu_mean": float(tail_nu.mean()),
        "nu_std": float(tail_nu.std()),
        "nu_max": float(tail_nu.max()),
        "max_w": float(tail_w.max()),
        "from_bank": rec["from_bank"],
        "nu_max_ref_power_law": nu_ref,
        "nu_max_ratio_to_ref": float(tail_nu.max() / nu_ref),
    }


def protocol(steps, tail, num_envs) -> dict:
    return {"steps": steps, "tail": tail, "num_envs": num_envs, "state_shape": [64, 96],
            "dt_solver": 0.03, "heater_duration": 1.5}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ra", type=int, nargs="*", default=RA_SWEEP)
    p.add_argument("--steps", type=int, default=120,
                   help="env steps (heater_duration=1.5 each)")
    p.add_argument("--tail", type=int, default=60,
                   help="steady-window length for the summary stats")
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bank_dir", default=None,
                   help="directory of ckpt_ra{Ra}.h5 banks (default: the port's assets)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(HERE, "flowstats_ra_2d_torch.json"))
    args = p.parse_args(argv)

    summary = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            summary = json.load(f).get("points", {})

    for ra in args.ra:
        t0 = time.time()
        rec = perform_experiment(ra, args.steps, args.num_envs, args.seed, args.bank_dir,
                                 args.device)
        pt = summary[str(ra)] = point(rec, args.tail)
        print(
            f"Ra={ra}: Nu={pt['nu_mean']:.3f}+-{pt['nu_std']:.3f} "
            f"Nu_max={pt['nu_max']:.3f} (0.1*Ra^0.4={pt['nu_max_ref_power_law']:.3f}) "
            f"max|w|={pt['max_w']:.3f} ({time.time() - t0:.1f}s)", flush=True
        )
        with open(args.out, "w") as f:
            json.dump({"protocol": protocol(args.steps, args.tail, args.num_envs),
                       "points": summary}, f, indent=2)

    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
