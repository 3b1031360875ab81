"""Batched, on-device equivalents of the gym wrappers.

Port of ``rbc_gym_tpu.wrappers.functional``. They run inside the PPO loop
on the env's device; the semantics mirror the gym wrappers. The
cell-distance computation re-derives scipy.signal.find_peaks' core rule
(strict local maxima above a height threshold) as a masked O(nx^2)
reduction, so it batches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Hill fit of the 3D max |w| against Ra (reference
# wrappers/rbc_normalize_observation.py:77-81; rbc_gym_tpu/wrappers/
# rbc_normalize_observation.py:23-30), kept verbatim.
W_INF = 0.96549382
RA_C = 654.37063331
HILL_N = 1.06741877


def u_limit_3d(ra: float) -> float:
    return W_INF * ra**HILL_N / (ra**HILL_N + RA_C**HILL_N)


class ObsNorm(NamedTuple):
    """Per-channel affine normalization constants."""

    min_vals: torch.Tensor  # (C,) float32
    max_vals: torch.Tensor  # (C,) float32
    maxval: float = 1.0
    clip: bool = False


def make_obs_norm_2d(
    heater_limit: float,
    u_limit: float = 1.3,
    maxval: float = 1.0,
    clip: bool = False,
    min_t: float = 1.0,
    max_t: float = 2.0,
    n_channels: int = 3,
) -> ObsNorm:
    mins = [min_t] + [-u_limit] * (n_channels - 1)
    maxs = [max_t + heater_limit] + [u_limit] * (n_channels - 1)
    return ObsNorm(torch.tensor(mins, dtype=torch.float32),
                   torch.tensor(maxs, dtype=torch.float32), maxval, clip)


def make_obs_norm_3d(
    ra: float,
    heater_limit: float = 0.9,
    u_limit: Optional[float] = None,
    maxval: float = 1.0,
    clip: bool = False,
    min_t: float = 1.0,
    max_t: float = 2.0,
) -> ObsNorm:
    if u_limit is None:
        u_limit = u_limit_3d(ra)
    mins = [min_t, -u_limit, -u_limit, -u_limit]
    maxs = [max_t + heater_limit, u_limit, u_limit, u_limit]
    return ObsNorm(torch.tensor(mins, dtype=torch.float32),
                   torch.tensor(maxs, dtype=torch.float32), maxval, clip)


def normalize_observation(obs: torch.Tensor, cfg: ObsNorm, channel_axis: int = -3) -> torch.Tensor:
    """obs (..., C, *spatial) -> normalized; ``channel_axis`` locates C.

    The constants are float32, as in the JAX package; the arithmetic runs
    in the wider of their dtype and the observation's."""
    nd = obs.ndim
    shape = [1] * nd
    shape[channel_axis % nd] = cfg.min_vals.shape[0]
    mins = cfg.min_vals.to(obs.device).reshape(shape)
    maxs = cfg.max_vals.to(obs.device).reshape(shape)
    out = cfg.maxval * (2.0 * (obs - mins) / (maxs - mins) - 1.0)
    if cfg.clip:
        out = torch.clamp(out, -cfg.maxval, cfg.maxval)
    return out


def reward_scale(ra: float, three_d: bool) -> float:
    """Nu_max power law (reference rbc_normalize_reward.py:13-25)."""
    s, a = (0.22, 0.27) if three_d else (0.1, 0.4)
    return float(s * ra**a)


def normalize_reward(reward: torch.Tensor, scale: float) -> torch.Tensor:
    return (reward + scale) / (scale - 1.0)


def cell_distance_2d(uy: torch.Tensor, lx: float = 2 * np.pi) -> torch.Tensor:
    """Batched Bénard-cell distance from a mid-height w line.

    uy: (..., nx) vertical velocity along x. Returns (...,) max pairwise
    periodic distance between peaks, with same-cell pairs (no down-welling
    between them) zeroed, matching the gym wrapper and the reference's
    compute_cell_distances.
    """
    nx = uy.shape[-1]
    dev = uy.device
    x = torch.as_tensor(np.linspace(0.0, lx, nx, endpoint=False), dtype=uy.dtype, device=dev)

    left = torch.roll(uy, 1, dims=-1)
    right = torch.roll(uy, -1, dims=-1)
    interior = torch.ones(nx, dtype=torch.bool, device=dev)
    interior[0] = interior[-1] = False
    peaks = (uy > left) & (uy > right) & (uy >= 0.001) & interior  # (..., nx)

    # prefix counts of non-positive samples: c[k] = #(uy[..., :k] <= 0)
    c = torch.cumsum((uy <= 0).to(torch.int64), dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)  # (..., nx+1)
    total = c[..., -1:]

    d1 = torch.abs(x[None, :] - x[:, None])  # (nx, nx)
    d2 = lx - d1
    d = torch.minimum(d1, d2)

    iu = torch.triu(torch.ones((nx, nx), dtype=torch.bool, device=dev), diagonal=1)
    pair_mask = peaks[..., :, None] & peaks[..., None, :] & iu

    # all(uy[i:j] > 0)  <=>  c[j] - c[i] == 0
    ci = c[..., :-1][..., :, None]
    cj = c[..., :-1][..., None, :]
    inner_updraft = (cj - ci) == 0
    # wrap: all(uy[j:] > 0) and all(uy[:i] > 0)
    wrap_updraft = ((total[..., None] - cj) + ci) == 0

    same_cell = torch.where(d1 < d2, inner_updraft, wrap_updraft)
    dist = torch.where(pair_mask & ~same_cell, d, torch.zeros_like(d))
    return dist.amax(dim=(-2, -1))


def shaped_reward(reward: torch.Tensor, cell_dist: torch.Tensor,
                  shaping_weight: float) -> torch.Tensor:
    cd_normalized = (-cell_dist + np.pi) / np.pi
    return (1.0 - shaping_weight) * reward + shaping_weight * cd_normalized
