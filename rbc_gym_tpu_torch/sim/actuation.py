"""Heater actuation: agent action -> bottom-plate temperature profile.

Port of ``rbc_gym_tpu.sim.actuation.heater_profile_2d`` (reference
sim/rbc_sim2D.jl:87-133, ``collate_actions_colin``): 12 heater segments
over x in (0, Lx). Actions are scaled by the heater limit, mean-subtracted
(energy-neutral heating), renormalized so no segment exceeds the limit,
offset by the bottom rest temperature 2, and blended with smooth cubic
transitions of half-width 0.03 at segment boundaries (periodic wrap-around).
The profile is computed once per env step as a dense (..., nx) tensor.
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
