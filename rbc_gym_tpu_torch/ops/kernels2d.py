"""The 2D env-step kernels: wrappers, their plain PyTorch versions, counters.

``env_step_2d`` replaces ``rbc_gym_tpu/ops/pallas2d.py:_env_step_kernel``
(the whole env step; its float32 solve, and at ``precision`` "high" and
"default" the kernel's split-product branch as TF32 tensor-core instances,
counted on ``env_step_2d_tf32x3`` and ``env_step_2d_tf32``; on the grids
that take a thread-block cluster, ``limits.env_step_2d_cluster_size``, its
cluster instance at every precision, counted on ``env_step_2d_cluster``; on
the grids whose two solve slabs do not fit a block,
``limits.env_step_2d_slabs_on_chip``, its off-chip instance with the slabs
in global scratch at every precision, counted on ``env_step_2d_global``) and
``tendencies_2d`` replaces ``_tendency_kernel``
(one stage's gu, gw, gb; the Pallas kernel reads pHY', K2 takes b and
computes pHY' itself). Both kernels are CUDA C++ in ``csrc/rbc2d.cu``;
the source says what bounds each on an H100 and what its design does about
it. A wrapper launches its kernel for CUDA tensors (float32, contiguous,
batch-major (E, nx, nz[+1])) and raises on anything else; it takes its
plain version only for tensors on the CPU. Each wrapper counts its launches
in ``<wrapper>.launches``.

The plain versions are the JAX package's XLA path written in PyTorch:
``tendencies_2d_phy`` is the stencil composition of
``solver2d.tendencies_bm`` (it takes pHY'), ``tendencies_2d_plain`` the
same after ``hydrostatic_pressure`` of b, ``env_step_2d_plain`` the
solver's eager substep loop. They run on any device, so a test can hold a
kernel against its plain version on the same card.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Tuple

import torch

from rbc_gym_tpu_torch.ops import _build, limits
from rbc_gym_tpu_torch.ops import stencils as st
from rbc_gym_tpu_torch.ops.poisson import (Spectral2D, check_precision, k1_tf32_constants,
                                            poisson_solve_2d)

RK3_GAMMA = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETA = (0.0, -17.0 / 60.0, -5.0 / 12.0)

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class Coeffs2D(NamedTuple):
    """Scalars of the 2D tendencies."""

    dx: float
    dz: float
    nu: float
    kappa: float
    min_b: float


# ---------------------------------------------------------------------------
# Plain PyTorch versions (batch-major: x = dim -2, z = dim -1)
# ---------------------------------------------------------------------------


def hydrostatic_pressure(b: torch.Tensor, dz: float, min_b: float) -> torch.Tensor:
    """pHY'(z) = -integral_z^Lz b dz', cumulative from the top at centers.

    Discretely (p[k] - p[k-1])/dz equals the face-interpolated buoyancy, so
    the w-momentum cancellation with the buoyancy term is exact.
    """
    b_face = 0.5 * (b[..., :-1] + b[..., 1:])  # interior faces 1..nz-1
    # top half-cell: face value is the Dirichlet top BC min_b
    top = torch.full_like(b[..., :1], 0.5 * dz * min_b)
    increments = torch.cat([dz * b_face, top], dim=-1)
    # p[k] = -(sum of increments k+1..nz-1 + top half) -> reverse cumsum
    return -torch.flip(torch.cumsum(torch.flip(increments, (-1,)), dim=-1), (-1,))


def tendencies_2d_phy(
    u: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    p_hy: torch.Tensor,
    bottom: torch.Tensor,
    c: Coeffs2D,
) -> Tensors3:
    """gu, gw, gb of one RK3 stage (UB5 flux-form advection, diffusion,
    -d pHY'/dx), from pHY' as the JAX package's ``tendencies_bm`` takes it."""
    X, Z = -2, -1
    dx, dz = c.dx, c.dz

    # ---- u momentum --------------------------------------------------------
    u_c = st.interp_f2c_x(u, X)  # advecting u at centers
    adv_u = st.ddx_c2f(u_c * st.recon_f2c_periodic(u, u_c, X), dx, X)
    w_xf = st.interp_c2f_x(w, X)  # w at (x-face, z-face); walls stay 0
    adv_u = adv_u + st.ddz_f2c(w_xf * st.recon_c2f_z_fused(u, w_xf, Z), dz, Z)
    dphy_dx = st.ddx_c2f(p_hy, dx, X)
    lap_u = st.d2x_periodic(u, dx, X) + st.d2z_center_value_bc(u, dz, 0.0, 0.0, Z)
    gu = -adv_u - dphy_dx + c.nu * lap_u

    # ---- w momentum (buoyancy absorbed into pHY') --------------------------
    u_zf = st.interp_c2f_z_interior(u, Z)  # u at (x-face, z-face), walls 0
    adv_w = st.ddx_f2c(u_zf * st.recon_c2f_periodic(w, u_zf, X), dx, X)
    w_c = st.interp_f2c_z(w, Z)  # advecting w at centers
    adv_w = adv_w + st.ddz_c2f_interior(w_c * st.recon_f2c_z_fused(w, w_c, Z), dz, Z)
    lap_w = st.d2x_periodic(w, dx, X) + st.d2z_face_interior(w, dz, Z)
    gw = st.zero_z_walls(-adv_w + c.nu * lap_w, Z)  # wall faces stay w = 0

    # ---- buoyancy tracer ---------------------------------------------------
    adv_b = st.ddx_f2c(u * st.recon_c2f_periodic(b, u, X), dx, X)
    adv_b = adv_b + st.ddz_f2c(w * st.recon_c2f_z_fused(b, w, Z), dz, Z)
    lap_b = st.d2x_periodic(b, dx, X) + st.d2z_center_value_bc(b, dz, bottom, c.min_b, Z)
    gb = -adv_b + c.kappa * lap_b
    return gu, gw, gb


def tendencies_2d_plain(
    u: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bottom: torch.Tensor,
    c: Coeffs2D,
) -> Tensors3:
    """gu, gw, gb of one RK3 stage, pHY' computed from b in b's dtype, as
    the JAX package's XLA path does. (K1 and K2 sum pHY' in float64; a
    float32 sum rounds at every level, and its error grows by 1/dx in
    -d pHY'/dx, to ~1e-5 in gu at 96x64.)"""
    p_hy = hydrostatic_pressure(b, c.dz, c.min_b)
    return tendencies_2d_phy(u, w, b, p_hy, bottom, c)


def rk3_update(f: Tensors3, g: Tensors3, g_prev: Tensors3 | None, m: int,
               dt: float) -> Tensors3:
    """Stage ``m``'s low-storage RK3 update of (u, w, b) by its tendencies
    ``g`` and the previous stage's ``g_prev`` (None at stage 0)."""
    gamma, zeta = RK3_GAMMA[m], RK3_ZETA[m]
    if m == 0:
        return tuple(x + dt * gamma * gx for x, gx in zip(f, g))
    return tuple(x + dt * (gamma * gx + zeta * gp) for x, gx, gp in zip(f, g, g_prev))


def project_2d(
    u: torch.Tensor, w: torch.Tensor, spectral: Spectral2D, c: Coeffs2D, dt_stage: float,
    precision: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projection after a stage: p_nhs from div(u, w) / dt_stage (the
    solve's products at ``precision``, ``ops.poisson.matmul``), then u and
    w corrected by its gradient -> (u, w, p_nhs)."""
    div = st.ddx_f2c(u, c.dx) + st.ddz_f2c(w, c.dz)
    p_nhs = poisson_solve_2d(spectral, div / dt_stage, precision)
    return (u - dt_stage * st.ddx_c2f(p_nhs, c.dx),
            w - dt_stage * st.ddz_c2f_interior(p_nhs, c.dz), p_nhs)


def rk3_substep(
    u: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bottom: torch.Tensor,
    spectral: Spectral2D,
    c: Coeffs2D,
    dt: float,
    tendencies: Callable[..., Tensors3],
    precision: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One RK3 solver step of ``dt``: 3 stages, each projected at
    ``precision``; ``tendencies(u, w, b, bottom, c)`` computes pHY' from b
    itself.

    Returns (u, w, b, p_nhs); never writes to its inputs."""
    g_prev = None
    p_nhs = None
    for m in range(3):
        g = tendencies(u, w, b, bottom, c)
        u, w, b = rk3_update((u, w, b), g, g_prev, m, dt)
        g_prev = g
        u, w, p_nhs = project_2d(u, w, spectral, c, (RK3_GAMMA[m] + RK3_ZETA[m]) * dt,
                                 precision)
    return u, w, b, p_nhs


def env_step_2d_plain(
    u: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bottom: torch.Tensor,
    spectral: Spectral2D,
    c: Coeffs2D,
    dt: float,
    n_substeps: int,
    precision: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_substeps`` RK3 substeps of the eager path, the solve's products
    at ``precision`` -> (u, w, b, p_nhs)."""
    p_nhs = torch.zeros_like(u)
    for _ in range(n_substeps):
        u, w, b, p_nhs = rk3_substep(u, w, b, bottom, spectral, c, dt, tendencies_2d_plain,
                                     precision)
    return u, w, b, p_nhs


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(named: dict, shapes: dict) -> None:
    device = None
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")


def _field_shapes(u: torch.Tensor) -> Tuple[int, int, int]:
    if u.ndim != 3:
        raise ValueError(f"fields must be batch-major (E, nx, nz), got {tuple(u.shape)}")
    return tuple(u.shape)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def tendencies_2d(
    u: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bottom: torch.Tensor,
    c: Coeffs2D,
) -> Tensors3:
    """gu, gw, gb of one stage, pHY' from b: the CUDA kernel for CUDA
    tensors (its instance per grid: ``limits.tendencies_2d_instance``)."""
    if u.device.type == "cpu":
        return tendencies_2d_plain(u, w, b, bottom, c)
    e, nx, nz = _field_shapes(u)
    _check_cuda(
        dict(u=u, w=w, b=b, bottom=bottom),
        dict(u=(e, nx, nz), w=(e, nx, nz + 1), b=(e, nx, nz), bottom=(e, nx)),
    )
    gu, gw, gb = torch.empty_like(u), torch.empty_like(w), torch.empty_like(b)
    scratch = torch.empty(e * limits.tendencies_2d_scratch_floats(nx, nz), dtype=u.dtype,
                          device=u.device)
    lib = _build.load_library()
    with torch.cuda.device(u.device):
        err = lib.launch_tendencies_2d(
            u.data_ptr(), w.data_ptr(), b.data_ptr(), bottom.data_ptr(),
            gu.data_ptr(), gw.data_ptr(), gb.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            e, nx, nz, c.dx, c.dz, c.nu, c.kappa, c.min_b,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(err, "tendencies_2d")
    tendencies_2d.launches += 1
    return gu, gw, gb


tendencies_2d.launches = 0


# K1's instances by the precision of the solve's products (``ops.poisson.
# matmul``'s names): the TF32 passes each product takes, 0 for the float32
# solve on the CUDA cores (None and "highest"), 3 for the split-product
# instance ("high": hi . hi + hi . lo + lo . hi), 1 for the one-pass one
# ("default"). The launcher's ``passes`` argument.
K1_PASSES = {None: 0, "highest": 0, "high": 3, "default": 1}

def tf32_constants(spectral: Spectral2D, passes: int) -> torch.Tensor:
    """``poisson.k1_tf32_constants`` of ``spectral`` at ``passes``, packed
    on its first use and kept on the solver's ``dinv`` tensor (so for as
    long as the solver's constants live), one a pass count."""
    packs = spectral.dinv.__dict__.setdefault("_k1_tf32_constants", {})
    if passes not in packs:
        packs[passes] = k1_tf32_constants(spectral, passes)
    return packs[passes]


def env_step_2d(
    u: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bottom: torch.Tensor,
    spectral: Spectral2D,
    c: Coeffs2D,
    dt: float,
    n_substeps: int,
    precision: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A whole env step (n_substeps RK3 substeps) -> (u, w, b, p_nhs):
    the CUDA kernel for CUDA tensors, in the instance for ``precision``
    (``K1_PASSES``). Each instance counts its launches on its own wrapper:
    the float32 one here, the others on ``env_step_2d_tf32x3`` and
    ``env_step_2d_tf32``, the cluster instance (a grid the on-chip
    instance cannot hold, on ``limits.env_step_2d_cluster_size`` CTAs) at
    any precision on ``env_step_2d_cluster``, and the off-chip instance
    with its slabs in global scratch (``limits.env_step_2d_slabs_on_chip``
    false) at any precision on ``env_step_2d_global``. A launch the card
    refuses raises, naming the instance; nothing falls back to another."""
    check_precision(precision)
    passes = K1_PASSES[precision]
    if u.device.type == "cpu":
        return env_step_2d_plain(u, w, b, bottom, spectral, c, dt, n_substeps, precision)
    e, nx, nz = _field_shapes(u)
    _check_cuda(
        dict(u=u, w=w, b=b, bottom=bottom, f=spectral.f, g=spectral.g, dct=spectral.dct,
             idct=spectral.idct, dinv=spectral.dinv),
        dict(u=(e, nx, nz), w=(e, nx, nz + 1), b=(e, nx, nz), bottom=(e, nx),
             f=(nx, nx), g=(nx, nx), dct=(nz, nz), idct=(nz, nz), dinv=(nx, nz)),
    )
    if n_substeps < 1:
        raise ValueError(f"n_substeps must be >= 1, got {n_substeps}")
    cluster = limits.env_step_2d_cluster_size(nx, nz) > 0
    global_slabs = not limits.env_step_2d_slabs_on_chip(nx, nz)
    tf32 = (tf32_constants(spectral, passes) if limits.env_step_2d_wgmma(nx, nz, passes)
            else None)
    u_out, w_out, b_out, p_out = (torch.empty_like(t) for t in (u, w, b, u))
    scratch = torch.empty(e * limits.env_step_2d_scratch_floats(nx, nz), dtype=u.dtype,
                          device=u.device)
    lib = _build.load_library()
    with torch.cuda.device(u.device):  # the launch goes to the current device
        err = lib.launch_env_step_2d(
            u.data_ptr(), w.data_ptr(), b.data_ptr(), bottom.data_ptr(),
            spectral.f.data_ptr(), spectral.g.data_ptr(), spectral.dct.data_ptr(),
            spectral.idct.data_ptr(), spectral.dinv.data_ptr(),
            u_out.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), p_out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            e, nx, nz, n_substeps, dt, c.dx, c.dz, c.nu, c.kappa, c.min_b, passes,
            None if tf32 is None else tf32.data_ptr(),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    counter = (env_step_2d_cluster if cluster else
               env_step_2d_global if global_slabs else K1_INSTANCES[passes])
    _raise_on(err, counter.__name__)
    counter.launches += 1
    return u_out, w_out, b_out, p_out


def env_step_2d_tf32x3(u, w, b, bottom, spectral, c, dt, n_substeps):
    """K1's split-product instance: ``env_step_2d`` at "high", each of the
    solve's products three TF32 tensor-core passes over hi and lo parts."""
    return env_step_2d(u, w, b, bottom, spectral, c, dt, n_substeps, "high")


def env_step_2d_tf32(u, w, b, bottom, spectral, c, dt, n_substeps):
    """K1's one-pass instance: ``env_step_2d`` at "default", each of the
    solve's products one TF32 tensor-core pass."""
    return env_step_2d(u, w, b, bottom, spectral, c, dt, n_substeps, "default")


def env_step_2d_cluster(u, w, b, bottom, spectral, c, dt, n_substeps, precision=None):
    """K1's cluster instance: ``env_step_2d`` on a grid that
    ``limits.env_step_2d_cluster_size`` gives a cluster of CTAs (each
    holding nx / c columns in the on-chip layout); raises ``ValueError``
    on any other grid."""
    nx, nz = u.shape[-2:]
    if limits.env_step_2d_cluster_size(nx, nz) == 0:
        raise ValueError(f"K1's cluster instance does not take {nx}x{nz}: "
                         "limits.env_step_2d_cluster_size is 0 there")
    return env_step_2d(u, w, b, bottom, spectral, c, dt, n_substeps, precision)


def env_step_2d_global(u, w, b, bottom, spectral, c, dt, n_substeps, precision=None):
    """K1's off-chip instance with its two solve slabs in per-env global
    scratch: ``env_step_2d`` on a grid where neither the on-chip instance
    nor a cluster takes it and 8 nx nz bytes exceed a block
    (``limits.env_step_2d_slabs_on_chip`` false: 256x128, 2048x64); raises
    ``ValueError`` on any other grid."""
    nx, nz = u.shape[-2:]
    if limits.env_step_2d_slabs_on_chip(nx, nz):
        raise ValueError(f"K1's off-chip instance keeps its slabs on the chip at {nx}x{nz}: "
                         "limits.env_step_2d_slabs_on_chip holds there")
    return env_step_2d(u, w, b, bottom, spectral, c, dt, n_substeps, precision)


def env_step_2d_occupancy(nx: int, nz: int, precision: str | None = None) -> dict:
    """What the card gives the K1 instance ``env_step_2d`` launches on an
    ``nx`` x ``nz`` grid at ``precision`` (the launcher's selection):
    "instance" ("on_chip", "cluster", "off_chip" or, with its slabs in
    global scratch, "off_chip_global_slabs"), "cluster_ctas",
    "blocks_per_sm", "max_active_clusters" (``cudaOccupancyMaxActiveClusters``
    on the card; 0 off a cluster), "registers", "local_bytes" (stack and
    spills a thread) and "shared_bytes" a block. Needs a card."""
    check_precision(precision)
    out = (ctypes.c_int * 7)()
    _raise_on(_build.load_library().env_step_2d_occupancy(nx, nz, K1_PASSES[precision],
                                                          ctypes.addressof(out)),
              "env_step_2d_occupancy")
    keys = ("instance", "cluster_ctas", "blocks_per_sm", "max_active_clusters", "registers",
            "local_bytes", "shared_bytes")
    rec = dict(zip(keys, out))
    rec["instance"] = ("on_chip", "cluster", "off_chip", "off_chip_global_slabs")[rec["instance"]]
    return rec


env_step_2d.launches = 0
env_step_2d_tf32x3.launches = 0
env_step_2d_tf32.launches = 0
env_step_2d_cluster.launches = 0
env_step_2d_global.launches = 0
# the wrapper that counts each instance's launches, by its passes
K1_INSTANCES = {0: env_step_2d, 3: env_step_2d_tf32x3, 1: env_step_2d_tf32}
