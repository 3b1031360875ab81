"""The 3D stage kernels: wrappers, their plain PyTorch versions, counters.

``stage_rk_3d`` replaces ``rbc_gym_tpu/ops/pallas3d.py:_stage_rk_kernel``
(one whole RK3 stage of the lazy-projection loop on x-blocked whole-y
slabs), ``stage_rk_3d_xy`` replaces ``_stage_rk_kernel_xy`` (the same
stage on (x, y)-blocked slabs, for grids whose whole-y slab does not fit a
block's shared memory) and ``correct_3d`` replaces ``_correct_kernel``
(the velocity correction u -= grad q). The kernels are CUDA C++ in
``csrc/rbc3d.cu``; the source says what bounds each on an H100 and what
its design does about it. A wrapper launches its kernel for CUDA tensors
(float32, contiguous) and raises on anything else; it takes its plain
version only for tensors on the CPU. Each wrapper counts its launches in
``<wrapper>.launches``.

Layouts: the fields u, v, b (E, nx, ny, nz) and w (E, nx, ny, nz + 1) are
in the public batch-major layout, bottom is (E, nx, ny). The divergence a
stage emits and the Poisson solve ``q`` it reads are in the solve layout
(E, ny, nx, nz) of ``ops/poisson.make_poisson_solver_3d``.

Lazy projection (the JAX package's contract, pallas3d.py:597-660): a stage
takes the UNPROJECTED fields of the previous stage and ``q``, the solve of
their unscaled divergence; it corrects u, v, w by grad q (the solve is
linear, so dt_stage cancels), computes pHY' from b, the four UB5
tendencies g, the RK update f* = f + dt (gamma g + zeta g_prev) and the
divergence of the updated fields. Stage 0 reads no g_prev (zeta = 0) and
stage 2 emits no g (the next substep's stage 0 does not read it).

The plain versions are the JAX package's XLA path written in PyTorch
(``solver3d.tendencies_bm``); they run on any device, so a test can hold
a kernel against its plain version on the same card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rbc_gym_tpu_torch.ops import _build
from rbc_gym_tpu_torch.ops import stencils as st
from rbc_gym_tpu_torch.ops.kernels2d import (
    RK3_GAMMA,
    RK3_ZETA,
    _check_cuda,
    _raise_on,
    hydrostatic_pressure,
)

Tensors4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# public-layout axes of (E, nx, ny, nz[+1]) fields
X, Y, Z = -3, -2, -1


class Coeffs3D(NamedTuple):
    """Scalars of the 3D tendencies."""

    dx: float
    dy: float
    dz: float
    nu: float
    kappa: float
    min_b: float


def to_solve_layout(q: torch.Tensor) -> torch.Tensor:
    """(E, nx, ny, nz) -> the solve layout (E, ny, nx, nz), contiguous."""
    return q.transpose(X, Y).contiguous()


def from_solve_layout(q: torch.Tensor) -> torch.Tensor:
    """(E, ny, nx, nz) -> the public layout (E, nx, ny, nz), contiguous."""
    return q.transpose(X, Y).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def tendencies_3d_plain(
    u: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    p_hy: torch.Tensor,
    bottom: torch.Tensor,
    c: Coeffs3D,
) -> Tensors4:
    """gu, gv, gw, gb: UB5 flux-form advection, diffusion, pHY' gradient."""
    dx, dy, dz = c.dx, c.dy, c.dz

    def lap_h(q):
        return st.d2x_periodic(q, dx, X) + st.d2x_periodic(q, dy, Y)

    # ---- u at (fx, cy, cz) -------------------------------------------------
    u_cx = st.interp_f2c_x(u, X)
    adv = st.ddx_c2f(u_cx * st.recon_f2c_periodic(u, u_cx, X), dx, X)
    v_fxfy = st.interp_c2f_x(v, X)
    adv = adv + st.ddx_f2c(v_fxfy * st.recon_c2f_periodic(u, v_fxfy, Y), dy, Y)
    w_fx = st.interp_c2f_x(w, X)  # wall faces stay 0
    adv = adv + st.ddz_f2c(w_fx * st.recon_c2f_z_fused(u, w_fx, Z), dz, Z)
    gu = (-adv - st.ddx_c2f(p_hy, dx, X)
          + c.nu * (lap_h(u) + st.d2z_center_value_bc(u, dz, 0.0, 0.0, Z)))

    # ---- v at (cx, fy, cz) -------------------------------------------------
    u_fxfy = st.interp_c2f_x(u, Y)
    adv = st.ddx_f2c(u_fxfy * st.recon_c2f_periodic(v, u_fxfy, X), dx, X)
    v_cy = st.interp_f2c_x(v, Y)
    adv = adv + st.ddx_c2f(v_cy * st.recon_f2c_periodic(v, v_cy, Y), dy, Y)
    w_fy = st.interp_c2f_x(w, Y)
    adv = adv + st.ddz_f2c(w_fy * st.recon_c2f_z_fused(v, w_fy, Z), dz, Z)
    gv = (-adv - st.ddx_c2f(p_hy, dy, Y)
          + c.nu * (lap_h(v) + st.d2z_center_value_bc(v, dz, 0.0, 0.0, Z)))

    # ---- w at (cx, cy, fz); buoyancy absorbed into pHY' --------------------
    u_fz = st.interp_c2f_z_interior(u, Z)
    adv = st.ddx_f2c(u_fz * st.recon_c2f_periodic(w, u_fz, X), dx, X)
    v_fz = st.interp_c2f_z_interior(v, Z)
    adv = adv + st.ddx_f2c(v_fz * st.recon_c2f_periodic(w, v_fz, Y), dy, Y)
    w_cz = st.interp_f2c_z(w, Z)
    adv = adv + st.ddz_c2f_interior(w_cz * st.recon_f2c_z_fused(w, w_cz, Z), dz, Z)
    gw = st.zero_z_walls(-adv + c.nu * (lap_h(w) + st.d2z_face_interior(w, dz, Z)), Z)

    # ---- buoyancy tracer ---------------------------------------------------
    adv = st.ddx_f2c(u * st.recon_c2f_periodic(b, u, X), dx, X)
    adv = adv + st.ddx_f2c(v * st.recon_c2f_periodic(b, v, Y), dy, Y)
    adv = adv + st.ddz_f2c(w * st.recon_c2f_z_fused(b, w, Z), dz, Z)
    gb = -adv + c.kappa * (lap_h(b) + st.d2z_center_value_bc(b, dz, bottom, c.min_b, Z))
    return gu, gv, gw, gb


def divergence_3d(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, c: Coeffs3D) -> torch.Tensor:
    """Staggered div(u, v, w) at cell centers, public layout."""
    return st.ddx_f2c(u, c.dx, X) + st.ddx_f2c(v, c.dy, Y) + st.ddz_f2c(w, c.dz, Z)


def correct_3d_plain(
    u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, q: torch.Tensor, c: Coeffs3D
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u -= ddx(q), v -= ddy(q), w -= ddz(q) at interior faces; q in the
    solve layout."""
    qp = from_solve_layout(q)
    return (u - st.ddx_c2f(qp, c.dx, X), v - st.ddx_c2f(qp, c.dy, Y),
            w - st.ddz_c2f_interior(qp, c.dz, Z))


def stage_rk_3d_plain(
    u: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    q: torch.Tensor,
    bottom: torch.Tensor,
    c: Coeffs3D,
    dt: float,
    stage: int,
    g_prev: Optional[Tensors4] = None,
):
    """One lazy-projection RK3 stage -> (u*, v*, w*, b', div, g).

    ``div`` is in the solve layout; ``g`` is the stage's tendencies, None
    at stage 2."""
    gamma, zeta = RK3_GAMMA[stage], RK3_ZETA[stage]
    u, v, w = correct_3d_plain(u, v, w, q, c)
    g = tendencies_3d_plain(u, v, w, b, hydrostatic_pressure(b, c.dz, c.min_b), bottom, c)
    if stage == 0:
        new = [f + dt * gamma * gf for f, gf in zip((u, v, w, b), g)]
    else:
        new = [f + dt * (gamma * gf + zeta * gp) for f, gf, gp in zip((u, v, w, b), g, g_prev)]
    div = to_solve_layout(divergence_3d(new[0], new[1], new[2], c))
    return (*new, div, g if stage < 2 else None)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _shapes(u: torch.Tensor) -> Tuple[int, int, int, int]:
    if u.ndim != 4:
        raise ValueError(f"fields must be batch-major (E, nx, ny, nz), got {tuple(u.shape)}")
    return tuple(u.shape)


def _launch_stage(name: str, u, v, w, b, q, bottom, c: Coeffs3D, dt: float, stage: int,
                  g_prev: Optional[Tensors4]):
    """Check a stage's CUDA tensors, allocate its outputs, launch ``name``."""
    e, nx, ny, nz = _shapes(u)
    cells, faces = (e, nx, ny, nz), (e, nx, ny, nz + 1)
    named = dict(u=u, v=v, w=w, b=b, q=q, bottom=bottom)
    shapes = dict(u=cells, v=cells, w=faces, b=cells, q=(e, ny, nx, nz), bottom=(e, nx, ny))
    if g_prev is not None:
        named.update(zip(("gu_prev", "gv_prev", "gw_prev", "gb_prev"), g_prev))
        shapes.update(gu_prev=cells, gv_prev=cells, gw_prev=faces, gb_prev=cells)
    _check_cuda(named, shapes)
    outs = [torch.empty_like(t) for t in (u, v, w, b, q)]
    g = [torch.empty_like(t) for t in (u, v, w, b)] if stage < 2 else None
    gp = g_prev if g_prev is not None else (None,) * 4
    go = g if g is not None else (None,) * 4

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load_library()
    with torch.cuda.device(u.device):
        err = getattr(lib, "launch_" + name)(
            *(t.data_ptr() for t in (u, v, w, b, q, bottom)),
            *map(ptr, gp), *(t.data_ptr() for t in outs), *map(ptr, go),
            e, nx, ny, nz, stage, dt, RK3_GAMMA[stage], RK3_ZETA[stage],
            c.dx, c.dy, c.dz, c.nu, c.kappa, c.min_b,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(err, name)
    return (*outs, g)


def _stage_wrapper(name: str, doc: str):
    """The wrapper of stage kernel ``name``: K3 and K5 compute one function,
    so both take ``stage_rk_3d_plain`` for CPU tensors."""

    def wrapper(
        u: torch.Tensor,
        v: torch.Tensor,
        w: torch.Tensor,
        b: torch.Tensor,
        q: torch.Tensor,
        bottom: torch.Tensor,
        c: Coeffs3D,
        dt: float,
        stage: int,
        g_prev: Optional[Tensors4] = None,
    ):
        if stage not in (0, 1, 2):
            raise ValueError(f"stage must be 0, 1 or 2, got {stage}")
        if (g_prev is None) != (stage == 0):
            raise ValueError("stages 1 and 2 take g_prev, stage 0 does not")
        if u.device.type == "cpu":
            return stage_rk_3d_plain(u, v, w, b, q, bottom, c, dt, stage, g_prev)
        out = _launch_stage(name, u, v, w, b, q, bottom, c, dt, stage, g_prev)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


stage_rk_3d = _stage_wrapper(
    "stage_rk_3d", "One lazy-projection RK3 stage: K3 for CUDA tensors.")
stage_rk_3d_xy = _stage_wrapper(
    "stage_rk_3d_xy", "The same stage on (x, y)-blocked slabs: K5 for CUDA tensors.")


def correct_3d(
    u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, q: torch.Tensor, c: Coeffs3D
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u -= grad q on the three velocities: the CUDA kernel for CUDA tensors."""
    if u.device.type == "cpu":
        return correct_3d_plain(u, v, w, q, c)
    e, nx, ny, nz = _shapes(u)
    _check_cuda(dict(u=u, v=v, w=w, q=q),
                dict(u=(e, nx, ny, nz), v=(e, nx, ny, nz), w=(e, nx, ny, nz + 1),
                     q=(e, ny, nx, nz)))
    outs = [torch.empty_like(t) for t in (u, v, w)]
    lib = _build.load_library()
    with torch.cuda.device(u.device):
        err = lib.launch_correct_3d(
            *(t.data_ptr() for t in (u, v, w, q, *outs)),
            e, nx, ny, nz, c.dx, c.dy, c.dz,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(err, "correct_3d")
    correct_3d.launches += 1
    return tuple(outs)


correct_3d.launches = 0
