"""Ablation timing of the 3D substep's parts on the port.

Twin of ``scripts/ablate3d.py``. On the 16x32x32 training grid at E envs
(default 1024) it times each part as N = 39 dependent applications (one
env step's stage units: 13 substeps x 3 RK stages), each feeding the
next, so that no launch is timed alone. The JAX script ran them in a
``lax.scan``; here a Python loop carries the fields. Parts: K3's stage 0
alone (its tendencies folded back into the fields), the dense Poisson
solve alone, pHY' alone (``ops/kernels2d.hydrostatic_pressure``), the
divergence (K7), its solve and the correction (K4), and the full env
step on the stage path (K3 and K4). Times are CUDA events on the card;
with ``--device cpu`` the wrappers take their plain versions and the host
clock times them, and the first line says so. The pHY' row times plain
PyTorch that the kernel paths do not run a stage unit: K3 and K6 compute
pHY' in their own bodies, and a 3D env step calls
``hydrostatic_pressure`` once, for the state's p_hy.

Usage:
  python -m rbc_gym_tpu_torch.scripts.ablate3d [E] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

N_UNITS = 39  # one env step's stage units (13 substeps x 3 RK stages)


def _applied(body, carry, n: int):
    for _ in range(n):
        carry = body(carry)
    return carry


def ablate(num_envs: int = 1024, device="cuda", n_units: int = N_UNITS, log=print) -> dict:
    """ms per unit of each part (the JAX script's rows)."""
    from rbc_gym_tpu_torch.ops import kernels3d as k3d
    from rbc_gym_tpu_torch.ops.kernels2d import hydrostatic_pressure
    from rbc_gym_tpu_torch.scripts.profile3d import make_inputs
    from rbc_gym_tpu_torch.sim.solver3d import Fields3D
    from rbc_gym_tpu_torch.utils.profiling import device_ms

    device = torch.device(device)
    clock = "cuda events" if device.type == "cuda" else "host clock (plain versions on the CPU)"
    solver, case = make_inputs(num_envs, device)
    c, solve = solver.coeffs, solver.solve
    dt = 0.001
    q0 = torch.zeros_like(case["q"])
    bottom = case["bottom"]
    log(f"16x32x32 at {num_envs} envs, {n_units} units a part, {clock}")

    def stage_only(f):
        u, v, w, b, _, g = k3d.stage_rk_3d(*f, q0, bottom, c, dt, 0)
        return tuple(x + dt * gx for x, gx in zip((u, v, w, b), g))

    def poisson_only(q):
        return q + dt * solve(q)

    def hydro_only(b):
        return b + dt * hydrostatic_pressure(b, c.dz, c.min_b)

    def divcorr_only(f):
        u, v, w, b = f
        u, v, w = k3d.correct_3d(u, v, w, solve(k3d.div_3d(u, v, w, c)), c)
        return u, v, w, b

    fields = tuple(case[n] for n in ("u", "v", "w", "b"))
    parts = (("hydro + stage + RK (K3)", stage_only, fields),
             ("poisson only (dense)", poisson_only, case["q"]),
             ("hydro only (pHY')", hydro_only, case["b"]),
             ("div (K7) + poisson + correction (K4)", divcorr_only, fields))
    ms_per_unit = {}
    for name, body, carry in parts:
        ms = device_ms(lambda: _applied(body, carry, n_units), 1, device)
        ms_per_unit[name] = ms / n_units
        log(f"{name:38}: {ms:8.2f} ms / {n_units} iters = {ms / n_units:7.3f} ms/unit")

    zeros = torch.zeros_like(case["u"])
    f0 = Fields3D(*fields, zeros, zeros)
    act = torch.zeros((num_envs, 8, 8), dtype=torch.float32, device=device)
    units = 3 * len(solver.params.substep_dts())
    ms = device_ms(lambda: solver.env_step(f0, act), 1, device)
    name = f"full env step ({solver.path}, {units} units)"
    ms_per_unit[name] = ms / units
    log(f"{name:38}: {ms:8.2f} ms = {ms / units:7.3f} ms/unit")
    return {"num_envs": num_envs, "n_units": n_units, "clock": clock, "path": solver.path,
            "ms_per_unit": ms_per_unit}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("envs", nargs="?", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return ablate(args.envs, args.device, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
