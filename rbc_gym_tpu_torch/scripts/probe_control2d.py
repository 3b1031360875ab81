"""Controllability probe on the port: a proportional controller on the 2D env.

Twin of ``scripts/probe_control2d.py``, with its flags and printed lines,
plus ``--device`` (default ``cuda``). Before trusting an RL result, check
that the task is controllable: a linear feedback law -- cool the plate
under hot (rising) fluid, heat it under cold (sinking) fluid -- maps the
observed temperature fluctuation per heater segment to an opposing heater
command. For each (sensor row, gain) pair it prints the mean Nusselt
number over the second half of the horizon against the zero-action
baseline, every rollout starting from the same initial states.

Initial conditions: ``--bank`` (``.npz``, or HDF5 on a host with h5py);
by default the port's ``assets/ckpt_ra{ra}_test.npz``. Where that file is
absent the run starts from random initial conditions, as the JAX script
does; the first line says which it used.

Usage:
  python -m rbc_gym_tpu_torch.scripts.probe_control2d [--episodes 32] [--n-steps 100] \\
      [--ra 1000000] [--gains 1.0,30.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
ROWS = (0, 1, 2, 4)


def law(obs: torch.Tensor, gain: float, row: int, n_heaters: int) -> torch.Tensor:
    """Oppose the segment-averaged temperature fluctuation at sensor row
    ``row`` (z from the bottom): obs (E, C, nz_obs, nx_obs) -> (E, n_heaters)."""
    t_row = obs[:, 0, row, :]  # (E, nx_obs)
    t_seg = t_row.reshape(t_row.shape[0], n_heaters, t_row.shape[1] // n_heaters).mean(-1)
    fluct = t_seg - t_seg.mean(dim=-1, keepdim=True)
    return torch.clamp(-gain * fluct, -1.0, 1.0)


def rollout(env, state0, obs0, action_fn, n_steps: int) -> np.ndarray:
    """``n_steps`` env steps from (state0, obs0) under ``action_fn(obs)``:
    Nu(state) per step and env, (n_steps, E)."""
    state, obs, nus = state0, obs0, []
    for _ in range(n_steps):
        state, ts = env.step(state, action_fn(obs))
        obs = ts.obs
        nus.append(ts.nusselt_state)
    return torch.stack(nus).cpu().numpy()


def second_half(nus: np.ndarray) -> float:
    return float(nus[nus.shape[0] // 2:].mean())


def default_bank(ra: float) -> str:
    return os.path.join(ASSET_DIR, f"ckpt_ra{int(ra)}_test.npz")


def make_env(episodes, ra, bank, device="cuda"):
    """The probe's env: no autoreset, the bank's states or random ones."""
    from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv

    return RBC2DVectorEnv(num_envs=episodes, rayleigh_number=ra, checkpoint=bank,
                          auto_reset=False, device=device)


def probe(env, state0, obs0, n_steps, pairs, log=print) -> dict:
    """The zero-action baseline, then the law at each (row, gain) of
    ``pairs``; prints the JAX script's lines through ``log`` and returns
    {"zero": Nu, (row, gain): Nu}."""
    n_heaters = env.params.n_heaters
    if env.observation_shape[1] % n_heaters:
        raise ValueError(f"{env.observation_shape[1]} sensor columns do not split into "
                         f"{n_heaters} heater segments")
    zero = torch.zeros((env.num_envs, n_heaters), dtype=env.dtype, device=env.device)
    nu_zero = second_half(rollout(env, state0, obs0, lambda o: zero, n_steps))
    log(f"zero-action Nu (2nd half of {n_steps} steps): {nu_zero:.4f}")
    out = {"zero": nu_zero}
    for row, gain in pairs:
        nu = second_half(rollout(env, state0, obs0,
                                 lambda o: law(o, gain, row, n_heaters), n_steps))
        supp = 100.0 * (nu_zero - nu) / nu_zero
        log(f"row={row} gain={gain:5.1f}: Nu={nu:.4f}  suppression vs zero = {supp:+.2f}%")
        out[(row, gain)] = nu
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--episodes", type=int, default=32)
    p.add_argument("--n-steps", type=int, default=100)
    p.add_argument("--ra", type=float, default=10_000)
    p.add_argument("--bank", default=None,
                   help="bank file (default: the port's assets/ckpt_ra{ra}_test.npz)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--gains", default="1.0,3.0,10.0,30.0",
                   help="comma-separated proportional gains to sweep")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    gains = tuple(float(g) for g in args.gains.split(","))

    bank = args.bank or default_bank(args.ra)
    bank = bank if os.path.exists(bank) else None
    print(f"initial conditions: {bank or 'random'}")
    env = make_env(args.episodes, args.ra, bank, args.device)
    state0, obs0 = env.reset(seed=args.seed)
    return probe(env, state0, obs0, args.n_steps,
                 [(row, gain) for row in ROWS for gain in gains])


if __name__ == "__main__":
    main()
