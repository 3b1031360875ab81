#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repo root on a machine with one CUDA card (H100, sm_90a) and
nvcc under $CUDA_HOME (default /usr/local/cuda). It builds the kernels from
``rbc_gym_tpu_torch/csrc`` and runs, printing one JSON line per phase:

1. build          nvcc into rbc_gym_tpu_torch/_build/ (ctypes, no torch headers)
2. kernel_parity  each kernel against its plain PyTorch version on the card
3. main_path      RBC2DVectorEnv(num_envs=1024) at 96x64, Ra=1e4: reset, 3
                  steps with random actions, one Solver2D.substep; checks
                  shapes, finiteness, Nu, divergence and the launch counters
4. timing         each kernel, its plain version and its bound, in ms

then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and last ``{"ok": true, "device": {...}}``.
Any failure is a traceback and a non-zero exit; without a CUDA device it
exits non-zero before printing a result.

The phase functions take the device and sizes as arguments, so the CPU
tests run them at a tiny size with the plain versions.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.ops import _build
from rbc_gym_tpu_torch.ops import kernels2d as k2d
from rbc_gym_tpu_torch.sim.grid import Grid2D
from rbc_gym_tpu_torch.sim.nusselt import nusselt_2d_physical
from rbc_gym_tpu_torch.sim.solver2d import (
    SimParams2D,
    max_divergence,
    DIVERGENCE_ATOL,
    make_solver2d,
)

# K1 after 6 substeps: the JAX package's own device gate for the fused
# whole-step kernel against the XLA path (rbc_gym_tpu/utils/parity.py:20);
# the two differ only in float32 summation order. After the main path's
# 50 substeps the same gate scaled by the 50/6 more stages, rounded down.
K1_ATOL = 5e-6
K1_MAIN_ATOL = 4e-5
# K2, one stage: the JAX test of the tendency kernel (tests/test_solver2d.py:208).
K2_ATOL = 1e-5
# Physical Nu at Ra=1e4 spans conduction (1) to developed 2D convection (~5).
NU_RANGE = (0.9, 6.0)

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

SOURCE = "rbc_gym_tpu_torch/csrc/rbc2d.cu"
MAIN_SHAPE_CHECK = {"env_step_2d": "env_step_2d_main", "tendencies_2d": "tendencies_2d"}
REPLACES = {
    "env_step_2d": "rbc_gym_tpu/ops/pallas2d.py:220",
    "tendencies_2d": "rbc_gym_tpu/ops/pallas2d.py:187",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def working_dtype(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cuda" else torch.float64


# ---------------------------------------------------------------------------
# Work counts (what each kernel must do on its inputs) and bounds
# ---------------------------------------------------------------------------

# FLOP per cell of one stage outside the spectral products, counted from
# csrc with each face flux counted once (the kernels recompute a flux on
# both of its cells; that repeat is not work the function needs): the
# tendencies gu 61 + gw 59 + gb 54 (one 19-FLOP C6/D5 flux per face and
# direction, the face interpolations, differences, Laplacians), pHY' 4,
# RK update 15, divergence 6, correction 8.
_TENDENCY_FLOPS_PER_CELL = 61 + 59 + 54
_STAGE_FLOPS_PER_CELL = _TENDENCY_FLOPS_PER_CELL + 4 + 15 + 6 + 8


def env_step_work(n_env: int, nx: int, nz: int, n_substeps: int) -> dict:
    """FLOP and bytes of K1 on these shapes: u, w, b, bottom read and u, w,
    b, p written once per env; F, G and the modal inverses read once."""
    cells, faces = nx * nz, nx * (nz + 1)
    solve = 2 * (2 * nx * nx * nz + nx * nz * nz)  # F.rhs, inverse, G.p_hat
    flops = n_env * n_substeps * 3 * (_STAGE_FLOPS_PER_CELL * cells + solve)
    words = n_env * (5 * cells + 2 * faces + nx) + 2 * nx * nx + nx * nz * nz
    return {"flops": flops, "bytes": 4 * words}


def tendencies_work(n_env: int, nx: int, nz: int) -> dict:
    cells = nx * nz
    words = n_env * (3 * cells + nx * (nz + 1) + nx + 2 * cells + nx * (nz + 1))
    return {"flops": n_env * _TENDENCY_FLOPS_PER_CELL * cells, "bytes": 4 * words}


def bound(work: dict) -> tuple[float, str]:
    t_ops = work["flops"] / FP32_FLOPS
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Inputs and the two halves of each comparison
# ---------------------------------------------------------------------------


def make_case(device, num_envs: int, state_shape=(64, 96), heater_duration=0.18, seed=0,
              dtype=None):
    """Solver plus fields, bottom profile and pHY' made by numpy from a seed."""
    device = torch.device(device)
    dtype = dtype or working_dtype(device)
    nz, nx = state_shape
    grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
    params = SimParams2D(heater_duration=heater_duration)
    solver = make_solver2d(grid, params, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    kick = params.random_kick
    u = kick * rng.standard_normal((num_envs, nx, nz))
    w = kick * rng.standard_normal((num_envs, nx, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    profile = params.min_b + (grid.lz - grid.z_centers()) * params.delta_b / 2.0
    b = np.clip(profile + kick * rng.standard_normal((num_envs, nx, nz)),
                params.min_b, params.min_b + params.delta_b)
    actions = rng.uniform(-1.0, 1.0, (num_envs, params.n_heaters))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    u, w, b = t(u), t(w), t(b)
    bottom = solver.heater_profile(t(actions)).contiguous()
    p_hy = k2d.hydrostatic_pressure(b, grid.dz, params.min_b).contiguous()
    return solver, dict(u=u, w=w, b=b, bottom=bottom, p_hy=p_hy)


def k1_run(solver, case, kernel: bool):
    fn = k2d.env_step_2d if kernel else k2d.env_step_2d_plain
    return fn(case["u"], case["w"], case["b"], case["bottom"], solver.spectral,
              solver.coeffs, solver.params.dt_solver, solver.params.substeps_per_env_step)


def k2_run(solver, case, kernel: bool):
    fn = k2d.tendencies_2d if kernel else k2d.tendencies_2d_plain
    return fn(case["u"], case["w"], case["b"], case["p_hy"], case["bottom"], solver.coeffs)


def abs_diffs(names, xs, ys) -> dict:
    """max |x - y| per output, compared in float64."""
    return {n: float((x.double() - y.double()).abs().max()) for n, x, y in zip(names, xs, ys)}


K1_OUT = ("u", "w", "b", "p_nhs")
K2_OUT = ("gu", "gw", "gb")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    start = time.perf_counter()
    lib, nvcc_s = _build.build()
    _build.load_library()
    return {"phase": "build", "library": lib.name, "nvcc_s": nvcc_s,
            "seconds": time.perf_counter() - start}


def kernel_parity(device, k1_envs=128, main_envs=1024, state_shape=(64, 96)) -> dict:
    """Each kernel against its plain version from the same inputs: K1 after
    6 substeps (heater_duration 0.18) at ``k1_envs`` and after the main
    path's 50 at ``main_envs``, K2 on one stage at ``main_envs``. Also the
    6-substep K1 and its plain version against a float64 plain run."""
    start = time.perf_counter()
    solver, case = make_case(device, k1_envs, state_shape, heater_duration=0.18)
    k1_out = k1_run(solver, case, True)
    plain = k1_run(solver, case, False)
    k1 = abs_diffs(K1_OUT, k1_out, plain)
    ref = k1_run(*make_case(device, k1_envs, state_shape, 0.18, dtype=torch.float64), False)
    solver, case = make_case(device, main_envs, state_shape, heater_duration=1.5, seed=1)
    k1_main = abs_diffs(K1_OUT, k1_run(solver, case, True), k1_run(solver, case, False))
    k2 = abs_diffs(K2_OUT, k2_run(solver, case, True), k2_run(solver, case, False))
    errs = {"env_step_2d": max(k1.values()), "env_step_2d_main": max(k1_main.values()),
            "tendencies_2d": max(k2.values())}
    atols = {"env_step_2d": K1_ATOL, "env_step_2d_main": K1_MAIN_ATOL, "tendencies_2d": K2_ATOL}
    failed = {k: (errs[k], atols[k]) for k in errs if not errs[k] <= atols[k]}
    if failed:
        raise AssertionError(f"kernel parity failed (error, atol): {failed}")
    return {"phase": "kernel_parity", "max_abs_err": errs, "atol": atols,
            "env_step_2d_by_field": k1, "env_step_2d_main_by_field": k1_main,
            "tendencies_2d_by_field": k2,
            "float64_plain_vs": {"kernel": abs_diffs(K1_OUT, ref, k1_out),
                                 "plain_float32": abs_diffs(K1_OUT, ref, plain)},
            "seconds": time.perf_counter() - start}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main_path(device, num_envs=1024, state_shape=(64, 96), observation_shape=(8, 48),
              heater_duration=1.5, steps=3, seed=0) -> dict:
    """The user's path: reset, ``steps`` env steps, one single substep."""
    device = torch.device(device)
    env = RBC2DVectorEnv(num_envs, state_shape=state_shape,
                         observation_shape=observation_shape,
                         heater_duration=heater_duration,
                         dtype=working_dtype(device), device=device)
    rng = np.random.default_rng(seed)
    actions = [rng.uniform(-1.0, 1.0, (num_envs, env.params.n_heaters)) for _ in range(steps)]

    k2d.env_step_2d.launches = 0
    k2d.tendencies_2d.launches = 0
    start = time.perf_counter()
    state, obs = env.reset(seed=seed)
    _sync(device)
    reset_s = time.perf_counter() - start
    start = time.perf_counter()
    for a in actions:
        state, ts = env.step(state, a)
    _sync(device)
    steps_s = time.perf_counter() - start
    sub = env.solver.substep(state.fields, env.solver.heater_profile(actions[-1]))
    _sync(device)
    launches = {"env_step_2d": k2d.env_step_2d.launches,
                "tendencies_2d": k2d.tendencies_2d.launches}

    nz_o, nx_o = observation_shape
    if tuple(ts.obs.shape) != (num_envs, 3, nz_o, nx_o):
        raise AssertionError(f"obs shape {tuple(ts.obs.shape)}")
    for name, x in [("obs", ts.obs), ("reward", ts.reward), *state.fields._asdict().items(),
                    *(("substep." + k, v) for k, v in sub._asdict().items())]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} is not finite")
    if not torch.equal(ts.reward, -ts.nusselt_obs):
        raise AssertionError("reward is not -Nu of the observation")
    g, p = env.grid, env.params
    f = state.fields
    w_c = 0.5 * (f.w[..., :-1] + f.w[..., 1:])
    nu_phys = nusselt_2d_physical(f.b, w_c, p.kappa, p.delta_b, g.lz, g.dz)
    nu_lo, nu_hi = float(nu_phys.min()), float(nu_phys.max())
    if not (NU_RANGE[0] <= nu_lo and nu_hi <= NU_RANGE[1]):
        raise AssertionError(f"Nu in [{nu_lo}, {nu_hi}], outside {NU_RANGE}")
    div_tol = DIVERGENCE_ATOL[env.dtype]
    div = max(max_divergence(f, g), max_divergence(sub, g))
    if div >= div_tol:
        raise AssertionError(f"max |div| {div} >= {div_tol}")
    if device.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"the main path missed a kernel: {launches}")
    return {"phase": "main_path", "num_envs": num_envs, "steps": steps,
            "reset_s": reset_s, "steps_s": steps_s,
            "env_steps_per_s": num_envs * steps / steps_s,
            "nusselt_physical": [nu_lo, nu_hi], "max_abs_div": div,
            "div_atol": div_tol, "launches": launches}


def _cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timing(device, num_envs=1024, state_shape=(64, 96), heater_duration=1.5) -> dict:
    """CUDA-event times at the main path's shapes, with the plain versions
    and the bounds; launches made here are not the main path's."""
    begin = time.perf_counter()
    solver, case = make_case(device, num_envs, state_shape, heater_duration, seed=2)
    nz, nx = state_shape
    n_sub = solver.params.substeps_per_env_step
    out = {}
    for name, run, work, reps in (
        ("env_step_2d", k1_run, env_step_work(num_envs, nx, nz, n_sub), 3),
        ("tendencies_2d", k2_run, tendencies_work(num_envs, nx, nz), 20),
    ):
        ms = _cuda_ms(lambda: run(solver, case, True), reps)
        plain_ms = _cuda_ms(lambda: run(solver, case, False), max(1, reps // 3))
        bound_ms, bound_by = bound(work)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, **work}
    return {"phase": "timing", "num_envs": num_envs, "kernels": out,
            "seconds": time.perf_counter() - begin}


def kernel_records(parity: dict, path: dict, times: dict) -> list:
    """One record per kernel: launches from the main path, the gated
    parity error at the main path's shapes, and this run's times and bounds."""
    return [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": path["launches"][name],
         "max_abs_err": parity["max_abs_err"][MAIN_SHAPE_CHECK[name]],
         **{k: times["kernels"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for name in ("env_step_2d", "tendencies_2d")
    ]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    wall = time.perf_counter()
    emit(phase_build())
    parity = kernel_parity(device)
    emit(parity)
    path = main_path(device)
    card = card_line()
    emit({**path, "card": card})
    times = timing(device)
    emit(times)
    emit({"kernels": kernel_records(parity, path, times)})
    emit({"phase": "total", "seconds": time.perf_counter() - wall})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
