"""Actuation-energy ablation for the 3D suppression analysis, on the port.

Twin of ``scripts/ablate_actuation3d.py``, with its flags and printed
table, plus ``--device`` (default ``cuda``) and ``--out`` (a JSON record).
Claim to test (docs/RL_RESULTS.md): at Ra=2500 with 8x8 tiles, ANY
tile-scale heater forcing pumps energy into the flow — Nu increases
monotonically with actuation amplitude regardless of the action's
structure. Rolls the held-out bank under iid random actions of scale
a in {0, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0} (resampled every step, zero-mean by
the env's preprocess_action) and under constant checkerboard forcing, and
prints the second-half Nu(amplitude) curve.

The rollouts are plain loops of ``RBC3DVectorEnv.step`` from one reset
(no autoreset). Each random rollout draws its actions from one
``torch.Generator`` on the env's device seeded from ``--seed + 1``, so
every amplitude sees the same draws, as the JAX script's shared keys do
(the streams themselves are torch's, not JAX's). ``--bank`` defaults to
the port's ``assets/3D_ckpt_ra2500_test.npz`` (10 episodes); where the
file is absent the run starts from random initial conditions, as the JAX
script does.

Usage:
  python -m rbc_gym_tpu_torch.scripts.ablate_actuation3d [--episodes 32] [--n-steps 80] \\
      [--ra 2500] [--heater-duration 0.375] [--bank BANK] [--seed 7] [--device cpu] \\
      [--out ablation.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
DEFAULT_BANK = os.path.join(ASSET_DIR, "3D_ckpt_ra2500_test.npz")
AMPLITUDES = (0.0, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
MODES = ("random", "checker")


def make_env(episodes, ra, heater_duration, bank, device="cuda"):
    """The ablation's env: one episode an env, no autoreset."""
    from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv

    return RBC3DVectorEnv(num_envs=episodes, rayleigh_number=ra,
                          heater_duration=heater_duration, checkpoint=bank,
                          auto_reset=False, device=device)


def checkerboard(s: int) -> np.ndarray:
    """The +-1 checkerboard on the s x s tiles (+1 where i + j is odd)."""
    ij = np.indices((s, s)).sum(axis=0) % 2
    return (2.0 * ij - 1.0).astype(np.float32)


def rollout(env, state0, mode: str, amp: float, n_steps: int, seed: int) -> np.ndarray:
    """``n_steps`` env steps from ``state0`` under ``mode`` ("random": amp *
    U(-1, 1) per env and step from a generator seeded ``seed``; "checker":
    amp * the checkerboard for every env): Nu per step and env, (n_steps, E)."""
    e, s = env.num_envs, env.params.n_heaters
    gen = torch.Generator(device=env.device).manual_seed(seed)
    checker = torch.as_tensor(checkerboard(s), dtype=env.dtype, device=env.device)
    state, nus = state0, []
    for _ in range(n_steps):
        if mode == "random":
            u = torch.rand((e, s, s), generator=gen, dtype=env.dtype, device=env.device)
            a = amp * (2.0 * u - 1.0)
        else:
            a = amp * checker.expand(e, s, s)
        state, ts = env.step(state, a)
        nus.append(ts.nusselt)
    return torch.stack(nus).cpu().numpy()


def second_half(nus: np.ndarray) -> float:
    return float(nus[nus.shape[0] // 2:].mean())


def ablate(env, state0, amplitudes, n_steps: int, seed: int, log=print) -> dict:
    """Both modes at each amplitude; prints the JAX script's table rows
    through ``log`` and returns {mode: [Nu at each amplitude]}."""
    table = {mode: [] for mode in MODES}
    for amp in amplitudes:
        nr = second_half(rollout(env, state0, "random", amp, n_steps, seed + 1))
        nc = second_half(rollout(env, state0, "checker", amp, n_steps, seed + 1))
        table["random"].append(nr)
        table["checker"].append(nc)
        log(f"{amp:>5.1f} {nr:>11.4f} {nc:>12.4f}")
    return table


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--episodes", type=int, default=32)
    p.add_argument("--n-steps", type=int, default=80)
    p.add_argument("--ra", type=float, default=2500)
    p.add_argument("--heater-duration", type=float, default=0.375)
    p.add_argument("--bank", default=DEFAULT_BANK)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the table as JSON here")
    args = p.parse_args(argv)

    bank = args.bank if os.path.exists(args.bank) else None
    env = make_env(args.episodes, args.ra, args.heater_duration, bank, args.device)
    state0, _ = env.reset(seed=args.seed)

    print(f"Ra={args.ra:g} duration={args.heater_duration} "
          f"({args.episodes} episodes x {args.n_steps} steps, 2nd-half Nu)")
    print(f"{'amp':>5} {'Nu(random)':>11} {'Nu(checker)':>12}")
    table = ablate(env, state0, AMPLITUDES, args.n_steps, args.seed,
                   log=lambda line: print(line, flush=True))
    record = {"ra": args.ra, "heater_duration": args.heater_duration,
              "episodes": args.episodes, "n_steps": args.n_steps, "seed": args.seed,
              "bank": bank, "device": str(env.device), "amplitudes": list(AMPLITUDES),
              "nu_random": table["random"], "nu_checker": table["checker"]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
