"""Micro-profile of the 3D substep's parts on the port.

Twin of ``scripts/profile3d.py``: on the 16x32x32 training grid at E envs
it times K3's three stage variants alone, the four K6 field tendencies,
the Poisson solve, and the whole env step on the "stage" path (K3 and K4)
against the plain PyTorch path (``fused=False``), to locate the time
before optimising. Inputs are made from a seed in the port's batch-major
layout, (E, nx, ny, nz[+1]). Times are CUDA events
(``utils.profiling.device_ms``) on the card; with ``--device cpu`` the
wrappers take their plain versions and the host clock times them, and the
rows say so.

Usage:
  python -m rbc_gym_tpu_torch.scripts.profile3d [E] [--reps 20] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SHAPE = (16, 32, 32)  # (nz, ny, nx)


def make_inputs(num_envs: int, device, seed: int = 0):
    """The solver on the training grid and seeded fields: (solver, dict of
    u, v, w, b, q (solve layout), bottom)."""
    from rbc_gym_tpu_torch.ops import kernels3d as k3d
    from rbc_gym_tpu_torch.sim.grid import Grid3D
    from rbc_gym_tpu_torch.sim.solver3d import SimParams3D, make_solver3d

    nz, ny, nx = SHAPE
    grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    solver = make_solver3d(grid, SimParams3D(), dtype=torch.float32, device=device,
                           fused="stage" if torch.device(device).type == "cuda" else None)
    rng = np.random.default_rng(seed)
    u, v = (0.1 * rng.standard_normal((num_envs, nx, ny, nz)) for _ in range(2))
    w = 0.1 * rng.standard_normal((num_envs, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    b = 1.5 + 0.1 * rng.standard_normal((num_envs, nx, ny, nz))
    bottom = 2.0 + 0.1 * rng.standard_normal((num_envs, nx, ny))
    case = {k: torch.as_tensor(a, dtype=torch.float32, device=solver.device)
            for k, a in dict(u=u, v=v, w=w, b=b, bottom=bottom).items()}
    case["q"] = solver.solve(k3d.div_3d_plain(case["u"], case["v"], case["w"], solver.coeffs))
    return solver, case


def profile(num_envs: int = 1024, reps: int = 20, device="cuda", log=print) -> dict:
    """ms of each part (the JAX script's rows) and the clock that timed them."""
    from rbc_gym_tpu_torch.ops import kernels3d as k3d
    from rbc_gym_tpu_torch.sim.solver3d import Fields3D, make_solver3d
    from rbc_gym_tpu_torch.utils.profiling import device_ms

    device = torch.device(device)
    clock = "cuda events" if device.type == "cuda" else "host clock (plain versions on the CPU)"
    solver, case = make_inputs(num_envs, device)
    c = solver.coeffs
    rows = {}

    def bench(name, fn):
        rows[name] = device_ms(fn, reps, device)
        log(f"{name:28}: {rows[name]:8.3f} ms")

    log(f"16x32x32 at {num_envs} envs, {reps} reps, {clock}")
    args = [case[n] for n in ("u", "v", "w", "b", "q", "bottom")]
    dt = 0.001
    g_prev = k3d.stage_rk_3d(*args, c, dt, 0)[5]
    for stage in range(3):
        gp = g_prev if stage else None
        bench(f"stage-RK kernel (m={stage})", lambda: k3d.stage_rk_3d(*args, c, dt, stage, gp))

    def fields_all():
        return [k3d.field_tendency_3d(f, *(case[n] for n in k3d.FIELD_INPUTS[f]), c=c)
                for f in k3d.FIELD_INPUTS]

    bench("per-field kernels (4x)", fields_all)
    bench("poisson solve", lambda: solver.solve(case["q"]))
    zeros = torch.zeros_like(case["u"])
    f0 = Fields3D(case["u"], case["v"], case["w"], case["b"], zeros, zeros)
    act = torch.zeros((num_envs, 8, 8), dtype=torch.float32, device=device)
    bench(f"full env step ({solver.path})", lambda: solver.env_step(f0, act))
    n_units = len(solver.params.substep_dts()) * 3
    log(f"  = {rows[f'full env step ({solver.path})'] / n_units:.3f} ms per stage-unit "
        f"({n_units // 3} substeps x 3 stages)")
    plain = make_solver3d(solver.grid, solver.params, dtype=torch.float32, device=device,
                          fused=False)
    bench("full env step (fused=False)", lambda: plain.env_step(f0, act))
    return {"num_envs": num_envs, "reps": reps, "clock": clock, "path": solver.path,
            "ms": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("envs", nargs="?", type=int, default=1024)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return profile(args.envs, args.reps, args.device,
                   log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
