"""The 3D kernels: wrappers, their plain PyTorch versions, counters.

``stage_rk_3d`` replaces ``rbc_gym_tpu/ops/pallas3d.py:_stage_rk_kernel``
(one whole RK3 stage of the lazy-projection loop, a block per env holding
all of periodic y), ``stage_rk_3d_xy`` replaces ``_stage_rk_kernel_xy``
(the same stage, a block per env and 8 y rows, for grids outside the
whole-y paths; on a column one block cannot hold, nz >= 107, its z split,
a thread-block cluster of CTAs a block, counted on
``stage_rk_3d_xy_split``); both march along x over a ring of x-planes,
from one kernel template. ``stage_rk_3d_rhat`` replaces the same Pallas body with
its ``emit_rhat`` option (``fused="stage_qp"``): K3's instance that
writes the Poisson analysis rhat = T_A div (``ops/poisson.py``
``poisson_analysis_matrix_3d``) in place of div, so that the solve's tail
alone runs after it. ``correct_3d`` replaces ``_correct_kernel`` (the
velocity correction u -= grad q), ``field_tendency_3d`` replaces
``_field_stage_kernel`` (one field's tendency, of the per-field path; its
u and v instances compute pHY' from b themselves) and
``div_3d`` replaces ``_div_kernel`` (the staggered divergence). The
kernels are CUDA C++ in ``csrc/rbc3d.cu``; the source says what bounds
each on an H100 and what its design does about it. A wrapper launches its
kernel for CUDA tensors (float32, contiguous) and raises on anything else;
it takes its plain version only for tensors on the CPU. Each wrapper
counts its launches in ``<wrapper>.launches``.

Layouts: the fields u, v, b, pHY' (E, nx, ny, nz) and w (E, nx, ny,
nz + 1) are in the public batch-major layout, bottom is (E, nx, ny). The
divergence that a stage or ``div_3d`` emits and the Poisson solve ``q``
that a stage or ``correct_3d`` reads are in the solve layout (E, ny, nx,
nz) of ``ops/poisson.make_poisson_solver_3d``.

Lazy projection (the JAX package's contract, pallas3d.py:597-660): a stage
takes the UNPROJECTED fields of the previous stage and ``q``, the solve of
their unscaled divergence; it corrects u, v, w by grad q (the solve is
linear, so dt_stage cancels), computes pHY' from b, the four UB5
tendencies g, the RK update f* = f + dt (gamma g + zeta g_prev) and the
divergence of the updated fields. Stage 0 reads no g_prev (zeta = 0) and
stage 2 emits no g (the next substep's stage 0 does not read it). The
per-field path computes the same stage from K6's tendencies (pHY' inside
the u and v launches), with the RK update and the solve in PyTorch between
the launches, and projects each stage right away
(``sim/solver3d.field_substeps``).

The plain versions are the JAX package's XLA path written in PyTorch
(``solver3d.tendencies_bm``); they run on any device, so a test can hold
a kernel against its plain version on the same card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rbc_gym_tpu_torch.ops import _build, limits
from rbc_gym_tpu_torch.ops.poisson import make_poisson_analysis_3d, poisson_analysis_factors_3d
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


def _lap_h(q: torch.Tensor, c: Coeffs3D) -> torch.Tensor:
    return st.d2x_periodic(q, c.dx, X) + st.d2x_periodic(q, c.dy, Y)


def tendency_u_plain(u, v, w, p_hy, c: Coeffs3D) -> torch.Tensor:
    """gu at (fx, cy, cz): UB5 flux-form advection, -d(pHY')/dx, nu Laplacian
    with no-slip value ghosts."""
    u_cx = st.interp_f2c_x(u, X)
    adv = st.ddx_c2f(u_cx * st.recon_f2c_periodic(u, u_cx, X), c.dx, X)
    v_fxfy = st.interp_c2f_x(v, X)
    adv = adv + st.ddx_f2c(v_fxfy * st.recon_c2f_periodic(u, v_fxfy, Y), c.dy, Y)
    w_fx = st.interp_c2f_x(w, X)  # wall faces stay 0
    adv = adv + st.ddz_f2c(w_fx * st.recon_c2f_z_fused(u, w_fx, Z), c.dz, Z)
    return (-adv - st.ddx_c2f(p_hy, c.dx, X)
            + c.nu * (_lap_h(u, c) + st.d2z_center_value_bc(u, c.dz, 0.0, 0.0, Z)))


def tendency_v_plain(u, v, w, p_hy, c: Coeffs3D) -> torch.Tensor:
    """gv at (cx, fy, cz)."""
    u_fxfy = st.interp_c2f_x(u, Y)
    adv = st.ddx_f2c(u_fxfy * st.recon_c2f_periodic(v, u_fxfy, X), c.dx, X)
    v_cy = st.interp_f2c_x(v, Y)
    adv = adv + st.ddx_c2f(v_cy * st.recon_f2c_periodic(v, v_cy, Y), c.dy, Y)
    w_fy = st.interp_c2f_x(w, Y)
    adv = adv + st.ddz_f2c(w_fy * st.recon_c2f_z_fused(v, w_fy, Z), c.dz, Z)
    return (-adv - st.ddx_c2f(p_hy, c.dy, Y)
            + c.nu * (_lap_h(v, c) + st.d2z_center_value_bc(v, c.dz, 0.0, 0.0, Z)))


def tendency_w_plain(u, v, w, c: Coeffs3D) -> torch.Tensor:
    """gw at (cx, cy, fz), zero on the wall faces; buoyancy is absorbed
    into pHY'."""
    u_fz = st.interp_c2f_z_interior(u, Z)
    adv = st.ddx_f2c(u_fz * st.recon_c2f_periodic(w, u_fz, X), c.dx, X)
    v_fz = st.interp_c2f_z_interior(v, Z)
    adv = adv + st.ddx_f2c(v_fz * st.recon_c2f_periodic(w, v_fz, Y), c.dy, Y)
    w_cz = st.interp_f2c_z(w, Z)
    adv = adv + st.ddz_c2f_interior(w_cz * st.recon_f2c_z_fused(w, w_cz, Z), c.dz, Z)
    return st.zero_z_walls(-adv + c.nu * (_lap_h(w, c) + st.d2z_face_interior(w, c.dz, Z)), Z)


def tendency_b_plain(u, v, w, b, bottom, c: Coeffs3D) -> torch.Tensor:
    """gb at centers: value ghosts ``bottom`` below and min_b above."""
    adv = st.ddx_f2c(u * st.recon_c2f_periodic(b, u, X), c.dx, X)
    adv = adv + st.ddx_f2c(v * st.recon_c2f_periodic(b, v, Y), c.dy, Y)
    adv = adv + st.ddz_f2c(w * st.recon_c2f_z_fused(b, w, Z), c.dz, Z)
    return -adv + c.kappa * (_lap_h(b, c)
                             + st.d2z_center_value_bc(b, c.dz, bottom, c.min_b, Z))


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
    return (tendency_u_plain(u, v, w, p_hy, c), tendency_v_plain(u, v, w, p_hy, c),
            tendency_w_plain(u, v, w, c), tendency_b_plain(u, v, w, b, bottom, c))


def _from_b(tendency):
    """The u or v ``tendency`` from b, through its pHY'."""
    return lambda u, v, w, b, c: tendency(u, v, w, hydrostatic_pressure(b, c.dz, c.min_b), c)


# The inputs of each field's tendency, in the order of the JAX package's
# make_field_stage_3d (pallas3d.py:1631-1637), except that u and v take b
# where it takes pHY' (K6 computes pHY' from b), and its plain version.
FIELD_INPUTS = {"u": ("u", "v", "w", "b"), "v": ("u", "v", "w", "b"),
                "w": ("u", "v", "w"), "b": ("u", "v", "w", "b", "bottom")}
_FIELD_PLAIN = {"u": _from_b(tendency_u_plain), "v": _from_b(tendency_v_plain),
                "w": tendency_w_plain, "b": tendency_b_plain}


def _check_field_args(field: str, arrays) -> None:
    if field not in FIELD_INPUTS:
        raise ValueError(f"field must be one of {tuple(FIELD_INPUTS)}, got {field!r}")
    if len(arrays) != len(FIELD_INPUTS[field]):
        raise ValueError(f"the {field} tendency takes {', '.join(FIELD_INPUTS[field])}; "
                         f"got {len(arrays)} arrays")


def field_tendency_3d_plain(field: str, *arrays: torch.Tensor, c: Coeffs3D) -> torch.Tensor:
    """One field's tendency from the inputs ``FIELD_INPUTS[field]``; u and v
    compute pHY' from b with ``hydrostatic_pressure``."""
    _check_field_args(field, arrays)
    return _FIELD_PLAIN[field](*arrays, c)


def divergence_3d(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, c: Coeffs3D) -> torch.Tensor:
    """Staggered div(u, v, w) at cell centers, public layout."""
    return st.ddx_f2c(u, c.dx, X) + st.ddx_f2c(v, c.dy, Y) + st.ddz_f2c(w, c.dz, Z)


def div_3d_plain(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, c: Coeffs3D) -> torch.Tensor:
    """``divergence_3d`` in the solve layout (E, ny, nx, nz), as K7 emits it."""
    return to_solve_layout(divergence_3d(u, v, w, c))


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
    return (*new, div_3d_plain(new[0], new[1], new[2], c), g if stage < 2 else None)


@functools.lru_cache(maxsize=None)
def _analysis(nx: int, nz: int, dtype: torch.dtype, device: torch.device):
    return make_poisson_analysis_3d(nx, nz, dtype, device)


def stage_rk_3d_rhat_plain(
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
    """``stage_rk_3d_plain`` followed by the dense analysis product (full
    precision in the working dtype) -> (u*, v*, w*, b', rhat, g), rhat
    (E, ny, nx nz) with (kx, kz) merged x-major."""
    *fields, div, g = stage_rk_3d_plain(u, v, w, b, q, bottom, c, dt, stage, g_prev)
    nx, nz = u.shape[X], u.shape[Z]
    return (*fields, _analysis(nx, nz, div.dtype, div.device)(div), g)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _analysis_factors(nx: int, nz: int, device: torch.device) -> torch.Tensor:
    """Fx (nx, nx) row-major then Cz^T (nz, nz), float32 on ``device``: the
    buffer K3's analysis instance reads."""
    fx, cz = poisson_analysis_factors_3d(nx, nz)
    both = np.concatenate([fx.ravel(), np.ascontiguousarray(cz.T).ravel()])
    return torch.as_tensor(both, dtype=torch.float32, device=device)


def _shapes(u: torch.Tensor) -> Tuple[int, int, int, int]:
    if u.ndim != 4:
        raise ValueError(f"fields must be batch-major (E, nx, ny, nz), got {tuple(u.shape)}")
    return tuple(u.shape)


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for ctypes; NULL for None."""
    return None if t is None else t.data_ptr()


def _launch_stage(name: str, u, v, w, b, q, bottom, c: Coeffs3D, dt: float, stage: int,
                  g_prev: Optional[Tensors4], rhat: bool = False):
    """Check a stage's CUDA tensors, allocate its outputs, launch ``name``
    (``rhat``: K3's analysis instance, which writes rhat (E, ny, nx nz) in
    place of div and takes the analysis factors)."""
    e, nx, ny, nz = _shapes(u)
    cells, faces = (e, nx, ny, nz), (e, nx, ny, nz + 1)
    named = dict(u=u, v=v, w=w, b=b, q=q, bottom=bottom)
    shapes = dict(u=cells, v=cells, w=faces, b=cells, q=(e, ny, nx, nz), bottom=(e, nx, ny))
    if g_prev is not None:
        named.update(zip(("gu_prev", "gv_prev", "gw_prev", "gb_prev"), g_prev))
        shapes.update(gu_prev=cells, gv_prev=cells, gw_prev=faces, gb_prev=cells)
    _check_cuda(named, shapes)
    outs = [torch.empty_like(t) for t in (u, v, w, b, q)]
    if rhat:
        outs[4] = outs[4].view(e, ny, nx * nz)
    extra = (_analysis_factors(nx, nz, u.device).data_ptr(),) if rhat else ()
    g = [torch.empty_like(t) for t in (u, v, w, b)] if stage < 2 else None
    gp = g_prev if g_prev is not None else (None,) * 4
    go = g if g is not None else (None,) * 4
    lib = _build.load_library()
    with torch.cuda.device(u.device):
        err = getattr(lib, "launch_" + name)(
            *(t.data_ptr() for t in (u, v, w, b, q, bottom)),
            *map(_ptr, gp), *(t.data_ptr() for t in outs), *map(_ptr, go),
            e, nx, ny, nz, stage, dt, RK3_GAMMA[stage], RK3_ZETA[stage],
            c.dx, c.dy, c.dz, c.nu, c.kappa, c.min_b, *extra,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(err, name)
    return (*outs, g)


def _stage_wrapper(name: str, doc: str, rhat: bool = False):
    """The wrapper of stage kernel ``name``: K3 and K5 compute one function,
    so both take ``stage_rk_3d_plain`` for CPU tensors; K3's analysis
    instance (``rhat``) takes ``stage_rk_3d_rhat_plain``."""
    plain = stage_rk_3d_rhat_plain if rhat else stage_rk_3d_plain

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
            return plain(u, v, w, b, q, bottom, c, dt, stage, g_prev)
        out = _launch_stage(name, u, v, w, b, q, bottom, c, dt, stage, g_prev, rhat)
        split = name == "stage_rk_3d_xy" and limits.stage_xy_split_size(u.shape[-1]) > 0
        (stage_rk_3d_xy_split if split else wrapper).launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


stage_rk_3d = _stage_wrapper(
    "stage_rk_3d", "One lazy-projection RK3 stage: K3 for CUDA tensors.")
stage_rk_3d_xy = _stage_wrapper(
    "stage_rk_3d_xy", "The same stage, y-blocked and marching along x: K5 for CUDA tensors "
    "(its z split on a column that one CTA cannot hold, counted on stage_rk_3d_xy_split).")
stage_rk_3d_rhat = _stage_wrapper(
    "stage_rk_3d_rhat",
    "The same stage writing rhat = T_A div (E, ny, nx nz) in place of div: K3's analysis "
    "instance for CUDA tensors.", rhat=True)


def stage_rk_3d_xy_split(u, v, w, b, q, bottom, c, dt, stage, g_prev=None):
    """K5's z split: ``stage_rk_3d_xy`` on a column of nz levels that one CTA
    cannot hold (``limits.stage_xy_split_size`` > 0: nz >= 107), each block
    of K5 a thread-block cluster of CTAs that own parts of the column;
    raises ``ValueError`` on any other nz."""
    nz = u.shape[-1]
    if limits.stage_xy_split_size(nz) == 0:
        raise ValueError(f"K5's z split does not take nz={nz}: "
                         "limits.stage_xy_split_size is 0 there")
    return stage_rk_3d_xy(u, v, w, b, q, bottom, c, dt, stage, g_prev)


stage_rk_3d_xy_split.launches = 0


def stage_xy_occupancy(nz: int) -> dict:
    """What the card gives the K5 instance ``stage_rk_3d_xy`` launches on a
    column of ``nz`` levels: "instance" ("one_cta" or "split"),
    "cluster_ctas", "blocks_per_sm", "max_active_clusters"
    (``cudaOccupancyMaxActiveClusters``; 0 off the split), "registers",
    "local_bytes" (stack and spills a thread) and "shared_bytes" a block.
    Needs a card."""
    out = (ctypes.c_int * 7)()
    _raise_on(_build.load_library().stage_xy_occupancy(nz, ctypes.addressof(out)),
              "stage_xy_occupancy")
    keys = ("instance", "cluster_ctas", "blocks_per_sm", "max_active_clusters", "registers",
            "local_bytes", "shared_bytes")
    rec = dict(zip(keys, out))
    rec["instance"] = ("one_cta", "split")[rec["instance"]]
    return rec


def march_occupancy(nx: int, ny: int, nz: int, rhat: bool = False) -> dict:
    """What K3, or with ``rhat`` its analysis instance, asks of an SM of the
    current CUDA device on the grid, for the instance its launcher picks:
    resident blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at its threads and shared memory), registers and local memory a thread
    (stack frame, spills included) and shared memory a block in bytes."""
    out = (ctypes.c_int * 4)()
    err = _build.load_library().march_occupancy(int(rhat), nx, ny, nz, ctypes.addressof(out))
    _raise_on(err, "march_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "smem_bytes"), out))


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


def field_tendency_3d(field: str, *arrays: torch.Tensor, c: Coeffs3D) -> torch.Tensor:
    """One field's tendency from ``FIELD_INPUTS[field]``: K6 for CUDA
    tensors, its march instance where ``limits.field_tendency_on_march``
    holds and its general instance elsewhere (the launcher picks from the
    grid). Counts its launches in ``.launches`` and, per field, in
    ``.launches_by_field``."""
    _check_field_args(field, arrays)
    if arrays[0].device.type == "cpu":
        return field_tendency_3d_plain(field, *arrays, c=c)
    e, nx, ny, nz = _shapes(arrays[0])
    cells, faces = (e, nx, ny, nz), (e, nx, ny, nz + 1)
    named = dict(zip(FIELD_INPUTS[field], arrays))
    _check_cuda(named, dict(u=cells, v=cells, w=faces, b=cells, bottom=(e, nx, ny)))
    g = torch.empty(faces if field == "w" else cells, dtype=torch.float32,
                    device=arrays[0].device)
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        err = lib.launch_field_tendency_3d(
            "uvwb".index(field), *map(_ptr, (named["u"], named["v"], named["w"],
                                             named.get("b"), named.get("bottom"), g)),
            e, nx, ny, nz, c.dx, c.dy, c.dz, c.nu, c.kappa, c.min_b,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(err, "field_tendency_3d")
    field_tendency_3d.launches += 1
    field_tendency_3d.launches_by_field[field] += 1
    return g


field_tendency_3d.launches = 0
field_tendency_3d.launches_by_field = dict.fromkeys(FIELD_INPUTS, 0)


def div_3d(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, c: Coeffs3D) -> torch.Tensor:
    """div(u, v, w) in the solve layout: K7 for CUDA tensors."""
    if u.device.type == "cpu":
        return div_3d_plain(u, v, w, c)
    e, nx, ny, nz = _shapes(u)
    _check_cuda(dict(u=u, v=v, w=w),
                dict(u=(e, nx, ny, nz), v=(e, nx, ny, nz), w=(e, nx, ny, nz + 1)))
    out = torch.empty((e, ny, nx, nz), dtype=torch.float32, device=u.device)
    lib = _build.load_library()
    with torch.cuda.device(u.device):
        err = lib.launch_div_3d(
            *(t.data_ptr() for t in (u, v, w, out)), e, nx, ny, nz, c.dx, c.dy, c.dz,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(err, "div_3d")
    div_3d.launches += 1
    return out


div_3d.launches = 0
