"""Upwind-biased 5th-order (UB5) reconstruction and staggered-grid stencils.

Port of the 2D functions of ``rbc_gym_tpu.ops.stencils``: flux-form
advection with face values reconstructed by a 5th-order upwind-biased
interpolation (Oceananigans' ``UpwindBiasedFifthOrder()``, reference
sim/rbc_sim2D.jl:151), order-reduced UB5 -> UB3 -> UB1 near the bounded-z
walls.

These are the plain PyTorch stencils: the eager solver path and the plain
versions of the CUDA kernels are built from them. Periodic directions use
one halo pad plus static slices; the bounded z direction selects per row
between candidate stencils (``_z_upwind``).

Classic UB5 face reconstruction (uniform grid), positive advecting velocity
through the face between cells m-1 (upstream) and m:

    q_face = (2 q[m-3] - 13 q[m-2] + 47 q[m-1] + 27 q[m] - 3 q[m+1]) / 60

The negative-velocity stencil is the mirror image.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# (offset relative to downwind cell m, coefficient) for LEFT-biased (positive
# velocity) stencils; RIGHT-biased is the point reflection about the face.
_UB5_LEFT = ((-3, 2 / 60), (-2, -13 / 60), (-1, 47 / 60), (0, 27 / 60), (1, -3 / 60))
_UB3_LEFT = ((-2, -1 / 6), (-1, 5 / 6), (0, 2 / 6))
_UB1_LEFT = ((-1, 1.0),)


def _mirror(stencil):
    """Reflect a left-biased stencil about the face (cells m-1 | m)."""
    return tuple((-1 - off, c) for off, c in stencil)


_UB5_RIGHT = _mirror(_UB5_LEFT)
_UB3_RIGHT = _mirror(_UB3_LEFT)
_UB1_RIGHT = _mirror(_UB1_LEFT)


def _slice(q: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    return q.narrow(dim, start, stop - start)


# ---------------------------------------------------------------------------
# Periodic reconstructions along a given axis
# ---------------------------------------------------------------------------


def _pad_periodic(q: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """One materialized halo pad; every stencil tap is then a slice."""
    n = q.shape[dim]
    lo = _slice(q, dim, n - before, n)
    hi = _slice(q, dim, 0, after)
    return torch.cat([lo, q, hi], dim=dim)


def _upwind_periodic(q: torch.Tensor, vel: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    """UB5 upwind reconstruction: one halo pad, shared taps, select."""
    n = q.shape[dim]
    before, after = 3 - m, 2 + m  # taps span [m-3, m+2]
    p = _pad_periodic(q, dim, before, after)

    def tap(off):
        o = before + m + off
        return _slice(p, dim, o, o + n)

    t_m3, t_m2, t_m1 = tap(-3), tap(-2), tap(-1)
    t_0, t_1, t_2 = tap(0), tap(1), tap(2)
    left = (2 * t_m3 - 13 * t_m2 + 47 * t_m1 + 27 * t_0 - 3 * t_1) / 60
    right = (2 * t_2 - 13 * t_1 + 47 * t_0 + 27 * t_m1 - 3 * t_m2) / 60
    return torch.where(vel > 0, left, right)


def recon_c2f_periodic(q: torch.Tensor, vel_face: torch.Tensor, axis: int) -> torch.Tensor:
    """Centered field -> faces along a periodic axis (face i between cells
    i-1 and i; downwind cell m = i for positive velocity)."""
    return _upwind_periodic(q, vel_face, axis, m=0)


def recon_f2c_periodic(q: torch.Tensor, vel_center: torch.Tensor, axis: int) -> torch.Tensor:
    """Face field -> centers along a periodic axis (center i between faces
    i and i+1; downwind face m = i+1 for positive velocity)."""
    return _upwind_periodic(q, vel_center, axis, m=1)


# ---------------------------------------------------------------------------
# Bounded-z stencil ladder
# ---------------------------------------------------------------------------


def _z_order_ladder(n_src: int, n_dst: int, split: int, biased: str) -> np.ndarray:
    """Per-destination-row stencil order (5/3/1/0) for the bounded direction.

    Destination point j lies between source points j+split-1 and j+split
    (split=0: centers->faces, split=1: faces->centers). The highest-order
    stencil whose support fits in [0, n_src) is used per row; rows with no
    valid stencil (wall faces) get order 0: their advective fluxes are
    multiplied by a wall-normal velocity that is exactly zero.
    """
    ladder = (
        (5, _UB5_LEFT, _UB5_RIGHT),
        (3, _UB3_LEFT, _UB3_RIGHT),
        (1, _UB1_LEFT, _UB1_RIGHT),
    )
    orders = np.zeros(n_dst, np.int64)
    for j in range(n_dst):
        m = j + split
        for order, left, right in ladder:
            stencil = left if biased == "left" else right
            idx = [m + off for off, _ in stencil]
            if min(idx) >= 0 and max(idx) < n_src:
                orders[j] = order
                break
    return orders


def _pad_zeros(q: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    dim = dim % q.ndim
    pad = [0, 0] * (q.ndim - 1 - dim) + [before, after]
    return torch.nn.functional.pad(q, pad)


def _expand_at(value, dim: int, like: torch.Tensor):
    """Insert the (removed) stencil axis into a wall value."""
    if not torch.is_tensor(value):
        return torch.tensor(value, dtype=like.dtype, device=like.device)
    return value.unsqueeze(dim)


def _mask_at(mask: np.ndarray, dim: int, like: torch.Tensor) -> torch.Tensor:
    """Per-row (n_dst,) mask as a tensor broadcasting along ``dim`` < 0."""
    m = torch.as_tensor(mask, device=like.device)
    return m.reshape(m.shape + (1,) * (-1 - dim))


def _z_stencil_candidates(q: torch.Tensor, n_dst: int, split: int, biased: str, dim: int = -1):
    """UB5/UB3/UB1 values at every destination row via slices.

    Pads 3 zeros each side: out-of-range taps are read only by rows whose
    ladder order excludes them, or rows whose advective flux is multiplied
    by an exactly-zero wall velocity.
    """
    p = _pad_zeros(q, dim, 3, 3)

    def tap(off):  # value q[m + off] for dst row j (m = j + split)
        start = 3 + split + off
        return _slice(p, dim, start, start + n_dst)

    out = {}
    for name, stencil in (
        ("5", _UB5_LEFT if biased == "left" else _UB5_RIGHT),
        ("3", _UB3_LEFT if biased == "left" else _UB3_RIGHT),
        ("1", _UB1_LEFT if biased == "left" else _UB1_RIGHT),
    ):
        acc = None
        for off, c in stencil:
            term = c * tap(off)
            acc = term if acc is None else acc + term
        out[name] = acc
    return out


@functools.lru_cache(maxsize=None)
def _z_order_masks(n_src: int, n_dst: int, split: int):
    masks = {}
    for biased in ("left", "right"):
        orders = _z_order_ladder(n_src, n_dst, split, biased)
        masks[biased] = (orders == 5, orders == 3)
    return masks


def _z_upwind(q: torch.Tensor, vel: torch.Tensor, n_dst: int, split: int, dim: int = -1) -> torch.Tensor:
    """Upwind-biased z reconstruction with near-wall order reduction."""
    n_src = q.shape[dim]
    masks = _z_order_masks(n_src, n_dst, split)

    def pick(biased):
        c = _z_stencil_candidates(q, n_dst, split, biased, dim)
        m5, m3 = masks[biased]
        m5, m3 = _mask_at(m5, dim, q), _mask_at(m3, dim, q)
        return torch.where(m5, c["5"], torch.where(m3, c["3"], c["1"]))

    return torch.where(vel > 0, pick("left"), pick("right"))


def recon_c2f_z_fused(q: torch.Tensor, vel_face: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Centered field (nz along ``axis``) -> z-faces (nz+1), upwind by vel_face."""
    return _z_upwind(q, vel_face, n_dst=q.shape[axis] + 1, split=0, dim=axis)


def recon_f2c_z_fused(q: torch.Tensor, vel_center: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """z-face field (nz+1 along ``axis``) -> centers (nz), upwind by vel_center."""
    return _z_upwind(q, vel_center, n_dst=q.shape[axis] - 1, split=1, dim=axis)


# ---------------------------------------------------------------------------
# Simple staggered differences / interpolations
# ---------------------------------------------------------------------------


def ddx_f2c(q: torch.Tensor, dx: float, axis: int = -2) -> torch.Tensor:
    """d/dx of an x-face field, result at x-centers: (q[i+1] - q[i]) / dx."""
    return (torch.roll(q, -1, dims=axis) - q) / dx


def ddx_c2f(q: torch.Tensor, dx: float, axis: int = -2) -> torch.Tensor:
    """d/dx of an x-center field, result at x-faces: (q[i] - q[i-1]) / dx."""
    return (q - torch.roll(q, 1, dims=axis)) / dx


def interp_f2c_x(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """x-face -> x-center linear interpolation: (q[i] + q[i+1]) / 2."""
    return 0.5 * (q + torch.roll(q, -1, dims=axis))


def interp_c2f_x(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """x-center -> x-face linear interpolation: (q[i-1] + q[i]) / 2."""
    return 0.5 * (torch.roll(q, 1, dims=axis) + q)


def _lo(q: torch.Tensor, dim: int) -> torch.Tensor:
    return _slice(q, dim, 0, q.shape[dim] - 1)


def _hi(q: torch.Tensor, dim: int) -> torch.Tensor:
    return _slice(q, dim, 1, q.shape[dim])


def ddz_f2c(q: torch.Tensor, dz: float, axis: int = -1) -> torch.Tensor:
    """d/dz of a z-face field (nz+1 along ``axis``) -> centers (nz)."""
    return (_hi(q, axis) - _lo(q, axis)) / dz


def ddz_c2f_interior(q: torch.Tensor, dz: float, axis: int = -1) -> torch.Tensor:
    """d/dz of a z-center field -> z-faces (nz+1), the two wall rows zero."""
    return _pad_zeros((_hi(q, axis) - _lo(q, axis)) / dz, axis, 1, 1)


def interp_f2c_z(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """z-face (nz+1 along ``axis``) -> z-center (nz) linear interpolation."""
    return 0.5 * (_lo(q, axis) + _hi(q, axis))


def interp_c2f_z_interior(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """z-center -> z-faces with zero on the wall faces (nz+1 along ``axis``)."""
    return _pad_zeros(0.5 * (_lo(q, axis) + _hi(q, axis)), axis, 1, 1)


def d2x_periodic(q: torch.Tensor, dx: float, axis: int = -2) -> torch.Tensor:
    """Second derivative along a periodic axis (one pad, sliced taps)."""
    n = q.shape[axis]
    p = _pad_periodic(q, axis, 1, 1)
    qm = _slice(p, axis, 0, n)
    qp = _slice(p, axis, 2, n + 2)
    return (qp - 2.0 * q + qm) / (dx * dx)


def d2z_center_value_bc(
    q: torch.Tensor, dz: float, bottom_value, top_value, axis: int = -1
) -> torch.Tensor:
    """d2/dz2 of a z-centered field with Dirichlet wall values via ghost cells.

    ghost = 2*value - first interior cell (linear extrapolation through the
    wall value), matching Oceananigans' ValueBoundaryCondition halo fill.
    ``bottom_value``/``top_value`` broadcast against q with the z axis removed
    (scalars or per-column tensors).
    """
    n = q.shape[axis]
    q0 = _slice(q, axis, 0, 1)
    qn = _slice(q, axis, n - 1, n)
    ghost_b = 2.0 * _expand_at(bottom_value, axis, q) - q0
    ghost_t = 2.0 * _expand_at(top_value, axis, q) - qn
    qm = torch.cat([ghost_b.expand_as(q0), _lo(q, axis)], dim=axis)
    qp = torch.cat([_hi(q, axis), ghost_t.expand_as(qn)], dim=axis)
    return (qp - 2.0 * q + qm) / (dz * dz)


def d2z_face_interior(q: torch.Tensor, dz: float, axis: int = -1) -> torch.Tensor:
    """d2/dz2 of a z-face field at interior faces; wall rows zero."""
    n = q.shape[axis]
    qm = _slice(q, axis, 0, n - 2)
    qc = _slice(q, axis, 1, n - 1)
    qp = _slice(q, axis, 2, n)
    return _pad_zeros((qp - 2.0 * qc + qm) / (dz * dz), axis, 1, 1)


def zero_z_walls(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Set the two wall rows of a z-face field to exactly zero."""
    return _pad_zeros(_slice(q, axis, 1, q.shape[axis] - 1), axis, 1, 1)
