"""On-card parity of the kernel paths against the plain PyTorch path.

Twin of ``rbc_gym_tpu/utils/parity.py``: a bench asserts, before it times
a path, that the path's kernels still compute what the plain path does on
the card it runs on, so that a kernel regression never ships inside a
headline number. Each check runs whole env steps of the forced kernel
path (2D ``fused=True``: K1; 3D ``fused="stage"`` or ``"stage_ew"``: K3
and K4, ``"stage_qp"``: K3's analysis instance and K4, ``"stage_xy"``: K5
and K4, ``"field"``: K6, K7 and K4) and of
``fused=False`` in float32 from the same seeded fields and actions, and
returns the largest field difference. ``env_steps_3d`` is the 3D run
itself, without the gate or the device check: ``chip_smoke.py`` takes its
whole-step comparisons (and their float64 side-checks) from it.

The gate is the JAX helper's: the two paths differ only in float32
summation order (the solves, pHY'), so they agree to ``ATOL_DEFAULT``
after a short run. The checks refuse any device but CUDA: on the CPU
both sides would run the plain versions, and their 0.0 would prove
nothing. ``poisson_precision`` goes to both solvers, as in the JAX helpers:
in 3D the precision of the solve's products (``ops.poisson.matmul``), in
2D the JAX 2D solver's names (``sim.solver2d.POISSON_PRECISIONS_2D``:
"bf16x3" holds K1's split-product instance against three TF32 products
of split operands in the plain path).
"""

from __future__ import annotations

import numpy as np
import torch

ATOL_DEFAULT = 5e-6


def max_abs_diff(fa, fb, names) -> float:
    """Largest |a - b| over the fields ``names`` of two field tuples."""
    return max(float((getattr(fa, n) - getattr(fb, n)).abs().max()) for n in names)


def _cuda_only(device, name: str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(
            f"{name} compares the kernel path with the plain path on a CUDA device; on "
            f"{device} the kernel wrappers run their plain versions, so both sides would "
            "run the same code and the difference would prove nothing")
    return device


def _actions(shape, device, seed: int) -> torch.Tensor:
    """Uniform actions in [-1, 1] from a generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return 2.0 * torch.rand(shape, generator=gen, device=device) - 1.0


def fused_parity_2d(
    num_envs: int = 128,
    steps: int = 1,
    ra: float = 10_000.0,
    state_shape=(64, 96),
    atol: float = ATOL_DEFAULT,
    check: bool = True,
    device="cuda",
    seed: int = 0,
    poisson_precision=None,
) -> float:
    """Max |u, w, b| difference of K1 (``fused=True``) against the plain
    path after ``steps`` env steps from the same random initial condition.
    ``heater_duration`` 0.18 (6 substeps) covers the kernel code the
    50-substep step runs. Raises AssertionError beyond ``atol`` when
    ``check``."""
    from rbc_gym_tpu_torch.sim.grid import Grid2D
    from rbc_gym_tpu_torch.sim.solver2d import SimParams2D, make_solver2d

    device = _cuda_only(device, "fused_parity_2d")
    nz, nx = state_shape
    grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
    params = SimParams2D(ra=ra, heater_duration=0.18)  # 6 substeps
    s_plain = make_solver2d(grid, params, dtype=torch.float32, device=device, fused=False,
                            poisson_precision=poisson_precision)
    s_fused = make_solver2d(grid, params, dtype=torch.float32, device=device, fused=True,
                            poisson_precision=poisson_precision)
    f = s_plain.init_random(torch.Generator(device=device).manual_seed(seed), (num_envs,))
    a = _actions((num_envs, params.n_heaters), device, seed + 1)
    fp, ff = f, f
    for _ in range(steps):
        fp, ff = s_plain.env_step(fp, a), s_fused.env_step(ff, a)
    err = max_abs_diff(fp, ff, ("u", "w", "b"))
    if check and not err < atol:
        raise AssertionError(f"2D fused/plain parity {err} >= {atol}")
    return err


def env_steps_3d(
    paths,
    num_envs: int = 128,
    steps: int = 1,
    ra: float = 2500.0,
    state_shape=(16, 32, 32),
    dt_solver: float = 0.01,
    heater_duration: float = 0.03,
    random_kick: float = 0.01,
    device="cuda",
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    poisson_precision=None,
) -> list:
    """The fields after ``steps`` env steps of each path of ``paths`` (a
    ``fused`` value of ``make_solver3d``: False is the plain path, None the
    solver's own choice) from one start: ``init_random`` of a float32 plain
    solver from a generator seeded ``seed`` and uniform actions in [-1, 1]
    from ``seed + 1``, both cast to ``dtype``, so that a float64 run starts
    from the float32 run's values; every path's solve at
    ``poisson_precision``. Any device; no gate."""
    from rbc_gym_tpu_torch.sim.grid import Grid3D
    from rbc_gym_tpu_torch.sim.solver3d import Fields3D, SimParams3D, make_solver3d

    device = torch.device(device)
    nz, ny, nx = state_shape
    grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    params = SimParams3D(ra=ra, dt_solver=dt_solver, heater_duration=heater_duration,
                         random_kick=random_kick)
    draw = make_solver3d(grid, params, dtype=torch.float32, device=device, fused=False)
    f0 = draw.init_random(torch.Generator(device=device).manual_seed(seed), (num_envs,))
    a = _actions((num_envs, params.n_heaters, params.n_heaters), device, seed + 1).to(dtype)
    f0 = Fields3D(*(x.to(dtype) for x in f0))
    out = []
    for path in paths:
        if path is False and dtype == torch.float32 and poisson_precision is None:
            solver = draw
        else:
            solver = make_solver3d(grid, params, dtype=dtype, device=device, fused=path,
                                   poisson_precision=poisson_precision)
        f = f0
        for _ in range(steps):
            f = solver.env_step(f, a)
        out.append(f)
    return out


def fused_parity_3d(
    num_envs: int = 128,
    steps: int = 1,
    ra: float = 2500.0,
    state_shape=(16, 32, 32),
    fused: str = "stage",
    dt_solver: float = 0.01,
    atol: float = ATOL_DEFAULT,
    check: bool = True,
    device="cuda",
    seed: int = 0,
    poisson_precision=None,
) -> float:
    """Max |u, v, w, b| difference of the 3D kernel path ``fused``
    (a ``sim.solver3d.KERNEL_PATHS`` value) against the plain path after
    ``steps`` env steps (``heater_duration`` 0.03: 3 substeps at
    ``dt_solver`` 0.01, 6 at the big grid's 0.005). A bench gates each path
    on the ``state_shape`` and ``dt_solver`` it times, so that the check
    runs the kernel instance the timing runs."""
    device = _cuda_only(device, "fused_parity_3d")
    plain, kernel = env_steps_3d((False, fused), num_envs, steps, ra, state_shape, dt_solver,
                                 device=device, seed=seed, poisson_precision=poisson_precision)
    err = max_abs_diff(plain, kernel, ("u", "v", "w", "b"))
    if check and not err < atol:
        raise AssertionError(f"3D {fused} fused/plain parity {err} >= {atol}")
    return err
