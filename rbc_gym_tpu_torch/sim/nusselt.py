"""Nusselt-number diagnostics and observation extraction.

Port of ``rbc_gym_tpu.sim.nusselt``. Replicates the reference's 2D Nusselt
definition *exactly*, including its index-spacing quirk, because it defines
the reward (reference sim/rbc_sim2D_api.jl:142-163):

    Nu = ( mean(T * w) - kappa * mean(grad_index(mean_x T)) ) / (kappa db / H)

where ``grad_index`` is a unit-spacing finite-difference gradient over the
*array index* (NOT divided by dz), T is the buoyancy tracer and w is sampled
at the bottom z-face of each cell. ``nusselt_2d_physical`` is the
dimensionally consistent definition used for physics validation.
``nusselt_3d`` is the reference's 3D definition (convective flux of the
anomaly from the conductive profile).
"""

from __future__ import annotations

import torch


def index_gradient(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """np.gradient with unit spacing (reference array_gradient)."""
    a = a.movedim(dim, -1)
    interior = 0.5 * (a[..., 2:] - a[..., :-2])
    first = (a[..., 1] - a[..., 0]).unsqueeze(-1)
    last = (a[..., -1] - a[..., -2]).unsqueeze(-1)
    return torch.cat([first, interior, last], dim=-1).movedim(-1, dim)


def nusselt_2d(
    t: torch.Tensor, w: torch.Tensor, kappa: float, delta_b: float, height: float
) -> torch.Tensor:
    """Reference 2D Nusselt. t, w: (..., nx, nz) in solver (x, z) order."""
    q1 = (t * w).mean(dim=(-2, -1))
    t_profile = t.mean(dim=-2)  # horizontal mean -> (..., nz)
    q2 = kappa * index_gradient(t_profile).mean(dim=-1)
    return (q1 - q2) / (kappa * delta_b / height)


def nusselt_2d_physical(
    t: torch.Tensor,
    w_center: torch.Tensor,
    kappa: float,
    delta_b: float,
    height: float,
    dz: float,
) -> torch.Tensor:
    """Volume-averaged Nu = (<w T> - kappa d<T>/dz) / (kappa delta_b / H),
    with w at cell centers and a dz-spaced vertical gradient."""
    q1 = (t * w_center).mean(dim=(-2, -1))
    t_profile = t.mean(dim=-2)
    q2 = kappa * (index_gradient(t_profile) / dz).mean(dim=-1)
    return (q1 - q2) / (kappa * delta_b / height)


def nusselt_3d(
    b: torch.Tensor, w: torch.Tensor, kappa: float, min_b: float, delta_b: float
) -> torch.Tensor:
    """Reference 3D Nusselt. b, w: (..., nx, ny, nz) in solver order, w the
    bottom-face sample (first nz face points).

    The conductive profile is taken at unit-height midpoints
    z = (k + 0.5) / nz whatever the domain height, as the reference does.
    """
    nz = b.shape[-1]
    z = (torch.arange(nz, dtype=b.dtype, device=b.device) + 0.5) / nz
    t_conductive = (1.0 - z) * delta_b + min_b
    q_conv = ((b - t_conductive) * w).mean(dim=(-3, -2, -1))
    return 1.0 + q_conv / kappa


def sensor_subsample_2d(field: torch.Tensor, n_obs_x: int, n_obs_z: int) -> torch.Tensor:
    """Strided sensor sampling (reference rbc_sim2D_api.jl:123-129).

    field (..., nx, nz) -> (..., n_obs_x, n_obs_z); stride = n // n_obs,
    starting at index 0 (Julia's 1:stride:N).
    """
    nx, nz = field.shape[-2], field.shape[-1]
    sx, sz = nx // n_obs_x, nz // n_obs_z
    return field[..., ::sx, ::sz][..., :n_obs_x, :n_obs_z]
