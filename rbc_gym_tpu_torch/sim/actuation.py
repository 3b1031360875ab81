"""Heater actuation: agent action -> bottom-plate temperature profile.

2D: port of ``rbc_gym_tpu.sim.actuation.heater_profile_2d`` (reference
sim/rbc_sim2D.jl:87-133, ``collate_actions_colin``): 12 heater segments
over x in (0, Lx). Actions are scaled by the heater limit, mean-subtracted
(energy-neutral heating), renormalized so no segment exceeds the limit,
offset by the bottom rest temperature 2, and blended with smooth cubic
transitions of half-width 0.03 at segment boundaries (periodic wrap-around).
The profile is computed once per env step as a dense (..., nx) tensor.

3D: port of ``preprocess_action_3d`` and ``heater_profile_3d`` (reference
sim/rbc_sim3D.jl:111-141): an (S, S) action becomes per-tile temperatures,
looked up piecewise-constant over the (nx, ny) bottom plate.
"""

from __future__ import annotations

import numpy as np
import torch


def heater_profile_2d(
    action: torch.Tensor,
    x_centers: np.ndarray,
    lx: float,
    n_segments: int,
    limit: float,
    rest_temperature: float = 2.0,
    transition_halfwidth: float = 0.03,
) -> torch.Tensor:
    """Bottom-plate temperature at cell centers. action (..., S) -> (..., nx)."""
    values = limit * action
    centered = values - values.mean(dim=-1, keepdim=True)
    k2 = torch.clamp(
        centered.abs().amax(dim=-1, keepdim=True) / limit, min=1.0
    )
    t_seg = rest_temperature + centered / k2  # (..., S)

    seg_len = lx / n_segments
    seg = np.clip(np.floor(x_centers / seg_len).astype(np.int64), 0, n_segments - 1)
    x_pos = torch.as_tensor(
        x_centers - seg * seg_len, dtype=action.dtype, device=action.device
    )  # (nx,)

    def take(idx: np.ndarray) -> torch.Tensor:
        return t_seg[..., torch.as_tensor(idx, device=action.device)]

    t0 = take((seg - 1) % n_segments)  # left neighbor
    t1 = take(seg)  # own segment
    t2 = take((seg + 1) % n_segments)  # right neighbor

    dxw = transition_halfwidth
    cubic_l = t0 + ((t0 - t1) / (4 * dxw**3)) * (x_pos - 2 * dxw) * (x_pos + dxw) ** 2
    xr = x_pos - seg_len
    cubic_r = t1 + ((t1 - t2) / (4 * dxw**3)) * (xr - 2 * dxw) * (xr + dxw) ** 2

    return torch.where(x_pos < dxw, cubic_l, torch.where(xr >= -dxw, cubic_r, t1))


def preprocess_action_3d(
    action: torch.Tensor, limit: float, min_b: float, delta_b: float
) -> torch.Tensor:
    """Action (..., S, S) -> per-tile bottom temperatures (..., S, S).

    Mean-subtract, normalize by K = max(1, max|a|), scale by the limit,
    offset by min_b + delta_b.
    """
    centered = action - action.mean(dim=(-2, -1), keepdim=True)
    k = torch.clamp(centered.abs().amax(dim=(-2, -1), keepdim=True), min=1.0)
    return (min_b + delta_b) + (centered / k) * limit


def heater_profile_3d(
    tile_temps: torch.Tensor,
    x_centers: np.ndarray,
    y_centers: np.ndarray,
    lx: float,
    ly: float,
    n_segments: int,
) -> torch.Tensor:
    """Tile temperatures (..., S, S) -> bottom-plate field (..., nx, ny).

    Tile i = clamp(floor(x / Lx * S)), likewise j; x indexes the first
    tile axis.
    """
    def tiles(centers: np.ndarray, length: float) -> torch.Tensor:
        idx = np.clip(np.floor(centers / length * n_segments).astype(np.int64),
                      0, n_segments - 1)
        return torch.as_tensor(idx, device=tile_temps.device)

    field = tile_temps.index_select(-2, tiles(x_centers, lx))  # (..., nx, S)
    return field.index_select(-1, tiles(y_centers, ly))  # (..., nx, ny)
