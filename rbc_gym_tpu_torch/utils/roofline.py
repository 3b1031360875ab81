"""Roofline model of the port: whole-step work, per-kernel work, H100 peaks.

Twin of ``rbc_gym_tpu/utils/roofline.py``. It holds two levels of work
count, which this module does not reconcile:

* **The whole-step model** (``cost_2d``, ``cost_3d``, ``roofline_metrics``),
  for a bench line. It counts an env step's work from its shapes alone,
  with the JAX package's figures, so that a port line and a JAX line count
  the same work however the step is implemented:
  - elementwise: ``ELEMENTWISE_FLOPS_PER_POINT_STAGE_2D`` = 211.4 and
    ``_3D`` = 410.0 FLOP per grid point and RK stage, counted from the
    Pallas kernels' jaxprs (``rbc_gym_tpu/utils/roofline.py:60-69``); they
    describe the function, not its implementation;
  - GEMM: the spectral solves' closed forms, one solve per RK stage, plus in
    2D the JAX kernel's hydrostatic contraction (2 nz per point and stage;
    K1 sums the same suffix in a scan);
  - HBM: the field state read and written once per env step, a lower bound.
* **The per-kernel bounds** (``env_step_work`` ... ``poisson_3d_flops``,
  ``bound``), which ``chip_smoke.py`` and ``scripts/kernel_variants.py``
  divide each kernel's time by: FLOP counted from ``csrc`` with each face
  flux once, each input read and each output written once. In 2D a
  cell-stage is 207 FLOP there, beside the model's 211.4; in 3D a K3
  or K5 stage is 381 (stage 0) or 389 (stages 1 and 2), beside 410.

Key names map the JAX module's: ``vpu`` becomes ``elementwise`` (or
``fp32`` for a rate) and ``mxu`` becomes ``gemm``: ``vpu_flops_per_env_step``
-> ``elementwise_flops_per_env_step``, ``achieved_vpu_tflops`` ->
``achieved_fp32_tflops``, ``vpu_utilization_pct`` -> ``fp32_utilization_pct``,
``achieved_mxu_tflops`` -> ``achieved_gemm_tflops``, ``mxu_utilization_pct``
-> ``gemm_utilization_pct``; the HBM keys and ``roofline_platform`` keep
their names. Shares are not rounded.

Peaks: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet:
float32 67 TFLOP/s on the CUDA cores, and HBM3 3.35 TB/s. TF32 is off in
the port (``rbc_gym_tpu_torch/__init__.py``), so cuBLAS SGEMM runs on the
same CUDA cores, and the GEMM share divides by the same 67 TFLOP/s. Only
the bounds of K1's TF32 instances (``env_step_work`` at a TF32
precision) take the tensor cores' dense TF32 peak, 495 TFLOP/s.
"""

from __future__ import annotations

import numpy as np
import torch

from rbc_gym_tpu_torch import default_device
from rbc_gym_tpu_torch.ops.kernels2d import K1_PASSES
from rbc_gym_tpu_torch.ops.poisson import (
    FACTORED_POISSON_MIN_NXNZ,
    make_poisson_solver_2d_bm,
    make_poisson_solver_3d,
)
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
from rbc_gym_tpu_torch.utils.flopcount import count_fn_flops

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3,
# and dense TF32 on the tensor cores (K1's TF32 instances' solve products).
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12

# Stamped into every bench record beside its shares.
ROOFLINE_PLATFORM = (
    "NVIDIA H100 80GB HBM3, 700 W (peaks from the NVIDIA data sheet: float32 "
    "67 TFLOP/s on the CUDA cores, also the GEMM peak since TF32 is off; HBM3 3.35 TB/s)"
)

POISSON_SOLVES_PER_SUBSTEP = 3  # one pressure projection per RK3 stage

# Elementwise work per grid point per RK stage, FLOP: the JAX package's
# counts of its Pallas kernels' jaxprs (2D whole-step kernel, direct count
# at 96x64; 3D stage kernel, the useful-work intercept over its x blocks).
ELEMENTWISE_FLOPS_PER_POINT_STAGE_2D = 211.4
ELEMENTWISE_FLOPS_PER_POINT_STAGE_3D = 410.0


def poisson_gemm_flops_per_point_2d(nx: int, nz: int) -> float:
    """(nx, nx) DFT forward, batched (nz, nz) modal inverse, (nx, nx)
    inverse DFT: 2 nx + 2 nz + 2 nx FLOP per point per solve."""
    return 2.0 * (2 * nx + nz)


def hydro_gemm_flops_per_point_stage_2d(nz: int) -> float:
    """The JAX whole-step kernel's hydrostatic suffix sum, an (nz, nz)
    triangular contraction once per RK stage: 2 nz FLOP per point."""
    return 2.0 * nz


def poisson_gemm_flops_per_point_3d(nx: int, ny: int, nz: int) -> float:
    """Per point per solve, in the form ``make_poisson_solver_3d`` picks:
    dense below ``FACTORED_POISSON_MIN_NXNZ`` (the (nx nz)^2 analysis and
    synthesis, 2 nx nz each, plus the y-DFT forward and inverse, 2 ny
    each); factored above it (the x-DFT and z-DCT as (nx, nx) and (nz, nz)
    products, 2 (nx + nz) each way). The modal reciprocal is elementwise."""
    if nx * nz >= FACTORED_POISSON_MIN_NXNZ:
        return 4.0 * (nx + nz) + 4.0 * ny
    return 4.0 * nx * nz + 4.0 * ny


def _metrics(elementwise_per_step, gemm_per_step, bytes_per_step, n_substeps) -> dict:
    return {
        "elementwise_flops_per_env_step": elementwise_per_step,
        "gemm_flops_per_env_step": gemm_per_step,
        "min_hbm_bytes_per_env_step": bytes_per_step,
        "n_substeps": n_substeps,
    }


def cost_2d(state_shape=(64, 96), heater_duration: float = 1.5,
            dt_solver: float = 0.03) -> dict:
    """The model's work of one 2D env step."""
    nz, nx = state_shape
    points = nx * nz
    n_sub = int(round(heater_duration / dt_solver))
    stages = 3 * n_sub
    elementwise = ELEMENTWISE_FLOPS_PER_POINT_STAGE_2D * points * stages
    gemm = (
        poisson_gemm_flops_per_point_2d(nx, nz)
        * points * POISSON_SOLVES_PER_SUBSTEP * n_sub
        + hydro_gemm_flops_per_point_stage_2d(nz) * points * stages
    )
    # u (nx, nz), w (nx, nz + 1), b, p_hy, p_nhs (nx, nz), float32, read
    # and written once per env step
    field_bytes = 4 * (4 * points + nx * (nz + 1))
    return _metrics(elementwise, gemm, 2.0 * field_bytes, n_sub)


def cost_3d(state_shape=(16, 32, 32), heater_duration: float = 0.125,
            dt_solver: float = 0.01) -> dict:
    """The model's work of one 3D env step, at the clipped substep count
    of ``SimParams3D.substep_dts`` (full steps, plus one for a remainder)."""
    nz, ny, nx = state_shape
    points = nx * ny * nz
    total, dt = heater_duration, dt_solver
    n_full = int(total / dt + 1e-9)
    n_sub = n_full + (1 if total - n_full * dt > 1e-12 else 0)
    stages = 3 * n_sub
    elementwise = ELEMENTWISE_FLOPS_PER_POINT_STAGE_3D * points * stages
    gemm = (
        poisson_gemm_flops_per_point_3d(nx, ny, nz)
        * points * POISSON_SOLVES_PER_SUBSTEP * n_sub
    )
    # u, v, b, p_hy, p_nhs (nx, ny, nz) and w (nx, ny, nz + 1), float32
    field_bytes = 4 * (5 * points + nx * ny * (nz + 1))
    return _metrics(elementwise, gemm, 2.0 * field_bytes, n_sub)


def roofline_metrics(cost: dict, env_steps_per_sec: float) -> dict:
    """Utilization fields for a bench record: the model's work at this
    rate against the card's peaks, in percent."""
    if not cost or not env_steps_per_sec:
        return {}
    elementwise = cost["elementwise_flops_per_env_step"] * env_steps_per_sec
    gemm = cost["gemm_flops_per_env_step"] * env_steps_per_sec
    bw = cost["min_hbm_bytes_per_env_step"] * env_steps_per_sec
    return {
        "model_elementwise_flops_per_env_step": cost["elementwise_flops_per_env_step"],
        "model_gemm_flops_per_env_step": cost["gemm_flops_per_env_step"],
        "achieved_fp32_tflops": elementwise / 1e12,
        "fp32_utilization_pct": 100.0 * elementwise / FP32_FLOPS,
        "achieved_gemm_tflops": gemm / 1e12,
        "gemm_utilization_pct": 100.0 * gemm / FP32_FLOPS,
        "min_hbm_gbps": bw / 1e9,
        "hbm_min_utilization_pct": 100.0 * bw / HBM_BYTES_PER_S,
        "roofline_platform": ROOFLINE_PLATFORM,
    }


# ---------------------------------------------------------------------------
# Per-kernel work counts (what each kernel must do on its inputs) and bounds
# ---------------------------------------------------------------------------

# FLOP per cell of one stage outside the spectral products, counted from
# csrc with each face flux counted once (the kernels recompute a flux on
# both of its cells; that repeat is not work the function needs): the
# tendencies gu 61 + gw 59 + gb 54 (one 19-FLOP C6/D5 flux per face and
# direction, the face interpolations, differences, Laplacians), pHY' 4,
# RK update 15, divergence 6, correction 8.
_TENDENCY_FLOPS_PER_CELL = 61 + 59 + 54
_STAGE_FLOPS_PER_CELL = _TENDENCY_FLOPS_PER_CELL + 4 + 15 + 6 + 8


def env_step_work(n_env: int, nx: int, nz: int, n_substeps: int, precision=None) -> dict:
    """FLOP and bytes of K1 on these shapes: u, w, b, bottom read and u, w,
    b, p written once per env; F, G and the modal inverses read once. At
    ``precision`` "high" or "default" (K1's TF32 instances,
    ``ops.kernels2d.K1_PASSES``) the solve's products run on the tensor
    cores: their FLOP are ``tf32_flops``, once for each pass (three at
    "high"), which ``bound`` takes at the TF32 peak; ``flops`` keeps the
    rest."""
    cells, faces = nx * nz, nx * (nz + 1)
    solve = 2 * (2 * nx * nx * nz + nx * nz * nz)  # F.rhs, inverse, G.p_hat
    stages = n_env * n_substeps * 3
    words = n_env * (5 * cells + 2 * faces + nx) + 2 * nx * nx + nx * nz * nz
    passes = K1_PASSES[precision]
    if passes == 0:
        return {"flops": stages * (_STAGE_FLOPS_PER_CELL * cells + solve), "bytes": 4 * words}
    return {"flops": stages * _STAGE_FLOPS_PER_CELL * cells,
            "tf32_flops": stages * solve * passes, "bytes": 4 * words}


def tendencies_work(n_env: int, nx: int, nz: int) -> dict:
    """FLOP and bytes of the Pallas tendency kernel's function, which reads
    p_hy: u, w, b, p_hy, bottom read and gu, gw, gb written once. K2's
    yardstick beside its own bound (``pallas_bound_ms``)."""
    cells = nx * nz
    words = n_env * (3 * cells + nx * (nz + 1) + nx + 2 * cells + nx * (nz + 1))
    return {"flops": n_env * _TENDENCY_FLOPS_PER_CELL * cells, "bytes": 4 * words}


def tendencies_own_work(n_env: int, nx: int, nz: int) -> dict:
    """FLOP and bytes of K2's own function, which takes b and no p_hy: u,
    w, b, bottom read and gu, gw, gb written once; pHY' adds its 4 FLOP a
    cell. K2's bound."""
    cells, faces = nx * nz, nx * (nz + 1)
    return {"flops": n_env * (_TENDENCY_FLOPS_PER_CELL + 4) * cells,
            "bytes": 4 * n_env * (4 * cells + 2 * faces + nx)}


def bound(work: dict) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time of ``work`` on the
    card, the larger of its bytes at the HBM rate and its operations at
    their peaks: float32 ``flops`` on the CUDA cores plus ``tf32_flops``
    (where a kernel has them) on the tensor cores, one after the other."""
    t_ops = work["flops"] / FP32_FLOPS + work.get("tf32_flops", 0) / TF32_FLOPS
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

# FLOP per cell of one K3 stage, counted from csrc/rbc3d.cu with each face
# flux once (as for K1): the tendencies gu 90 + gv 90 + gw 87 + gb 81 (per
# direction a 19-FLOP C6/D5 flux, the face velocity, the difference; three
# 4-FLOP second differences), the correction 9, pHY' 4, the RK update 3
# per field at stage 0 and 5 at stages 1-2, the divergence 8.
_TENDENCY_3D_FLOPS_PER_CELL = 90 + 90 + 87 + 81


def stage_rk_3d_work(n_env: int, nx: int, ny: int, nz: int, stage: int) -> dict:
    """FLOP and bytes of one K3 or K5 launch (one function): u, v, b, q,
    bottom and w read and
    u*, v*, b', div and w* written once per env; g_prev read at stages 1-2
    and g written at stages 0-1 (three cell slabs and one face slab each)."""
    cells, faces = nx * ny * nz, nx * ny * (nz + 1)
    slab4 = 3 * cells + faces
    words = 4 * cells + faces + nx * ny + 4 * cells + faces
    words += slab4 * ((stage > 0) + (stage < 2))
    per_cell = _TENDENCY_3D_FLOPS_PER_CELL + 9 + 4 + 8 + 4 * (3 if stage == 0 else 5)
    return {"flops": n_env * per_cell * cells, "bytes": 4 * n_env * words}


def stage_rk_3d_rhat_work(n_env: int, nx: int, ny: int, nz: int, stage: int) -> dict:
    """FLOP and bytes of one launch of K3's analysis instance: K3's bytes
    (rhat, of div's size, written in its place) and K3's FLOP plus the
    analysis rhat = kron(Fx, Cz) div at its least work, the factored
    2 (nx + nz) FLOP a cell (Cz along z, then Fx along x), whatever the
    kernel does."""
    work = stage_rk_3d_work(n_env, nx, ny, nz, stage)
    return {**work, "flops": work["flops"] + n_env * 2 * (nx + nz) * nx * ny * nz}


def correct_3d_work(n_env: int, nx: int, ny: int, nz: int) -> dict:
    """u, v, w, q read and u, v, w written once; 3 FLOP per velocity point."""
    cells, faces = nx * ny * nz, nx * ny * (nz + 1)
    return {"flops": n_env * 9 * cells, "bytes": 4 * n_env * (5 * cells + 2 * faces)}


# FLOP per cell of K6, counted as for K3 (the same tendency code); u and v
# add the 4 of their pHY' from b.
_FIELD_FLOPS_PER_CELL = {"u": 94, "v": 94, "w": 87, "b": 81}


def field_tendency_3d_work(n_env: int, nx: int, ny: int, nz: int, field: str) -> dict:
    """FLOP and bytes of one K6 launch: u, v, w and the field's own inputs
    (b for u, v and b, whose pHY' K6 computes; bottom for b) read once, g
    written once."""
    cells, faces = nx * ny * nz, nx * ny * (nz + 1)
    words = {"u": 4 * cells + faces, "v": 4 * cells + faces, "w": 2 * cells + 2 * faces,
             "b": 4 * cells + faces + nx * ny}[field]
    return {"flops": n_env * _FIELD_FLOPS_PER_CELL[field] * cells, "bytes": 4 * n_env * words}


def div_3d_work(n_env: int, nx: int, ny: int, nz: int) -> dict:
    """u, v, w read and div written once; three differences, three
    divisions and two sums per cell."""
    cells, faces = nx * ny * nz, nx * ny * (nz + 1)
    return {"flops": n_env * 8 * cells, "bytes": 4 * n_env * (3 * cells + faces)}


def poisson_3d_flops(n_env: int, nx: int, ny: int, nz: int, factored: bool) -> int:
    """Multiply-adds of one solve as ``make_poisson_solver_3d`` does it."""
    k = nx * nz
    xz = 2 * (nx + nz) if factored else k  # (x, z) transform, per output point
    return n_env * ny * (2 * 2 * k * xz + 2 * 2 * ny * k + k)


# ---------------------------------------------------------------------------
# The closed forms against a count of the port's solvers
# ---------------------------------------------------------------------------


def torch_poisson_flops_per_point(dim: str, state_shape, device="cuda", batch: int = 8) -> float:
    """GEMM FLOP per point of one solve of the port's Poisson solver on
    ``device``, counted by ``utils.flopcount``: ``make_poisson_solver_2d_bm``
    for ``dim="2d"`` (``state_shape`` (nz, nx)), ``make_poisson_solver_3d``
    for "3d" ((nz, ny, nx), its form picked as in the solvers). The twin
    of ``xla_poisson_flops_per_point``, which reads XLA's cost analysis."""
    device = default_device(device)
    if dim == "2d":
        nz, nx = state_shape
        grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
        solve = make_poisson_solver_2d_bm(nx, nz, grid.dx, grid.dz, torch.float32, device)
        rhs = torch.zeros((batch, nx, nz), dtype=torch.float32, device=device)
    elif dim == "3d":
        nz, ny, nx = state_shape
        grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
        solve = make_poisson_solver_3d(nx, ny, nz, grid.dx, grid.dy, grid.dz, torch.float32,
                                       device)
        rhs = torch.zeros((batch, ny, nx, nz), dtype=torch.float32, device=device)
    else:
        raise ValueError(f"dim must be '2d' or '3d', got {dim!r}")
    return count_fn_flops(solve, rhs)["gemm"] / rhs.numel()
