"""Controllability probe on the port for the 3D env (see probe_control2d).

Twin of ``scripts/probe_control3d.py``, with its flags and printed lines,
plus ``--device`` (default ``cuda``): proportional feedback on the
tile-averaged fluctuation of temperature (law T, near-bottom sensor rows)
or vertical velocity (law w, mid-height), opposing plumes through the SxS
heater grid. The env's action preprocessing (mean-subtract and
K-normalise) composes with these laws, whose commands are already zero-mean.
``--segments``, ``--heater-limit``, ``--burnin`` and ``--no-bank`` go to
the port's ``RBC3DVectorEnv``; the gain is a plain argument of each
rollout.

Initial conditions: ``--bank`` (``.npz``, or HDF5 on a host with h5py);
by default the port's ``assets/3D_ckpt_ra{ra}_test.npz``. Where that file
is absent, or with ``--no-bank``, the run starts from random initial
conditions, as the JAX script does; the first line says which it used.

Usage:
  python -m rbc_gym_tpu_torch.scripts.probe_control3d [--episodes 32] [--n-steps 80] \\
      [--ra 500] [--heater-duration 0.375] [--gains 0.3,1.0,3.0,10.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def tiled_fluct(field2d: torch.Tensor, s: int) -> torch.Tensor:
    """(E, ny, nx) -> (E, s, s) tile means, mean-subtracted."""
    e, ny, nx = field2d.shape
    tiles = field2d.reshape(e, s, ny // s, s, nx // s).mean(dim=(2, 4))
    return tiles - tiles.mean(dim=(-2, -1), keepdim=True)


def law_T(obs: torch.Tensor, gain: float, row: int, s: int) -> torch.Tensor:
    """Oppose the near-plate temperature fluctuation (cool under hot)."""
    return torch.clamp(-gain * tiled_fluct(obs[:, 0, row], s), -1.0, 1.0)


def law_w(obs: torch.Tensor, gain: float, row: int, s: int) -> torch.Tensor:
    """Heat under downwelling fluid (w < 0) to brake the circulation."""
    return torch.clamp(-gain * tiled_fluct(obs[:, 3, row], s), -1.0, 1.0)


LAWS = {"T": law_T, "w": law_w}


def rollout(env, state0, obs0, action_fn, n_steps: int) -> np.ndarray:
    """``n_steps`` env steps from (state0, obs0) under ``action_fn(obs)``:
    Nu per step and env, (n_steps, E)."""
    state, obs, nus = state0, obs0, []
    for _ in range(n_steps):
        state, ts = env.step(state, action_fn(obs))
        obs = ts.obs
        nus.append(ts.nusselt)
    return torch.stack(nus).cpu().numpy()


def second_half(nus: np.ndarray) -> float:
    return float(nus[nus.shape[0] // 2:].mean())


def default_bank(ra: float) -> str:
    return os.path.join(ASSET_DIR, f"3D_ckpt_ra{int(ra)}_test.npz")


def make_env(episodes, ra, heater_duration, bank, segments=8, heater_limit=0.9,
             device="cuda"):
    """The probe's env: no autoreset, the bank's states or random ones."""
    from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv

    return RBC3DVectorEnv(num_envs=episodes, rayleigh_number=ra,
                          heater_duration=heater_duration, heater_segments=segments,
                          heater_limit=heater_limit, checkpoint=bank, auto_reset=False,
                          device=device)


def zero_action(env) -> torch.Tensor:
    s = env.params.n_heaters
    return torch.zeros((env.num_envs, s, s), dtype=env.dtype, device=env.device)


def burn_in(env, state, obs, steps: int):
    """``steps`` zero-action steps: equilibrate random initial conditions."""
    zero = zero_action(env)
    for _ in range(steps):
        state, ts = env.step(state, zero)
        obs = ts.obs
    return state, obs


def sweep(gains, nz: int):
    """The JAX script's (law, row, gain) sweep: law T at rows 1, 2, 4 and
    law w at mid-height, each gain with both signs."""
    for name in LAWS:
        for row in ((1, 2, 4) if name == "T" else (nz // 2,)):
            for gain in gains:
                for sign in (+1.0, -1.0):
                    yield name, row, sign * gain


def probe(env, state0, obs0, n_steps, triples, header, log=print) -> dict:
    """The zero-action baseline, then each (law, row, gain) of ``triples``;
    prints the JAX script's lines through ``log`` (``header`` leads the
    first) and returns {"zero": Nu, (law, row, gain): Nu}."""
    s = env.params.n_heaters
    if env.grid.ny % s or env.grid.nx % s:
        raise ValueError(f"a {env.grid.ny}x{env.grid.nx} plate does not split into "
                         f"{s}x{s} tiles")
    zero = zero_action(env)
    nu_zero = second_half(rollout(env, state0, obs0, lambda o: zero, n_steps))
    log(f"{header} zero-action Nu: {nu_zero:.4f}")
    out = {"zero": nu_zero}
    for name, row, gain in triples:
        nu = second_half(rollout(env, state0, obs0,
                                 lambda o: LAWS[name](o, gain, row, s), n_steps))
        supp = 100.0 * (nu_zero - nu) / nu_zero
        log(f"{name} row={row:2d} gain={gain:+6.2f}: Nu={nu:.4f}  supp={supp:+.2f}%")
        out[(name, row, gain)] = nu
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--episodes", type=int, default=32)
    p.add_argument("--n-steps", type=int, default=80)
    p.add_argument("--ra", type=float, default=2500)
    p.add_argument("--heater-duration", type=float, default=0.375)
    p.add_argument("--bank", default=None,
                   help="bank file (default: the port's assets/3D_ckpt_ra{ra}_test.npz)")
    p.add_argument("--no-bank", action="store_true",
                   help="random ICs instead of the bank (use with --burnin)")
    p.add_argument("--burnin", type=int, default=0,
                   help="zero-action steps before the controlled phase "
                        "(equilibrate random ICs at Ra values with no bank)")
    p.add_argument("--gains", default="0.3,1.0,3.0,10.0")
    p.add_argument("--segments", type=int, default=8,
                   help="heater grid size S (SxS tiles)")
    p.add_argument("--heater-limit", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    bank = args.bank or default_bank(args.ra)
    bank = None if args.no_bank or not os.path.exists(bank) else bank
    print(f"initial conditions: {bank or 'random'}", flush=True)
    env = make_env(args.episodes, args.ra, args.heater_duration, bank, args.segments,
                   args.heater_limit, args.device)
    state0, obs0 = burn_in(env, *env.reset(seed=args.seed), args.burnin)
    gains = [float(g) for g in args.gains.split(",")]
    header = f"Ra={args.ra:g} duration={args.heater_duration} burnin={args.burnin}"
    return probe(env, state0, obs0, args.n_steps, sweep(gains, env.grid.nz), header,
                 log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
