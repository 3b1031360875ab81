"""Bénard-cell-distance reward shaping (2D; host-only: needs gymnasium).

Port of ``rbc_gym_tpu.wrappers.rbc_reward_shaping``; behavioural parity
with the reference wrappers/rbc_reward_shaping.py — find peaks of
the mid-height vertical-velocity line (scipy.signal.find_peaks, height
threshold 0.001), compute the maximum pairwise periodic distance over
x in [0, 2 pi), zeroing pairs with no down-welling between them (such pairs
belong to the same convection cell), then shape

    reward <- (1 - w) reward + w (pi - cell_distance) / pi

and expose info["cell_dist"]. A batched on-device implementation of the
same computation lives in ``rbc_gym_tpu_torch.wrappers.functional`` for the
vector env pipeline.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import gymnasium as gym
import numpy as np
from scipy.signal import find_peaks

from rbc_gym_tpu_torch.envs.rbc2d import RBCField


def compute_cell_distances(
    state: np.ndarray,
    state_shape,
    use_avg: bool = False,
    return_peaks: bool = False,
):
    """Max pairwise periodic distance between Bénard cells (host-side).

    ``state``: (C, nz, nx) as found in the 2D env's info dict. With
    ``use_avg`` the column-averaged vertical velocity is the peak signal
    instead of the mid-height line (reference rbc_reward_shaping.py
    compute_cell_distances kwarg).
    """
    if use_avg:
        uy = state[RBCField.UY].mean(axis=0)
    else:
        uy = state[RBCField.UY][int(state_shape[0] / 2) - 1]

    peaks, _ = find_peaks(uy, height=0.001)
    nx = state_shape[1]
    domain_x = np.linspace(0, 2 * np.pi, nx, endpoint=False)

    def result(d):
        return (d, peaks, uy) if return_peaks else d

    if len(peaks) <= 1:
        return result(0.0)

    best = 0.0
    for i in range(len(peaks)):
        for j in range(i + 1, len(peaks)):
            d1 = abs(domain_x[peaks[j]] - domain_x[peaks[i]])
            d2 = 2 * np.pi - d1
            d = min(d1, d2)
            # pairs with no down-welling between them are the same cell
            if d1 < d2:
                if np.all(uy[peaks[i] : peaks[j]] > 0):
                    d = 0.0
            else:
                if np.all(uy[peaks[j] :] > 0) and np.all(uy[: peaks[i]] > 0):
                    d = 0.0
            best = max(best, d)
    return result(float(best))


class RBCRewardShaping(gym.Wrapper):
    """Shape the reward with the distance between Bénard cells.

    ``debug_cell_dist`` enables the reference's interactive matplotlib
    debug view (rbc_reward_shaping.py update()): mid-height temperature,
    vertical velocity, their centered product, and the detected cell
    peaks, redrawn at reset and every step.
    """

    def __init__(
        self, env: gym.Env, shaping_weight: float, debug_cell_dist: bool = False
    ):
        super().__init__(env)
        self.logger = logging.getLogger(__name__)
        self.shaping_weight = shaping_weight
        self.debug_cell_dist = debug_cell_dist
        self.size_state = env.unwrapped.state_shape
        if debug_cell_dist:
            from matplotlib import pyplot as plt

            self._plt = plt
            self.fig_anim, self.ax_anim = plt.subplots()
            self.ax_anim.set_xlim(0, 2 * np.pi)
            self.ax_anim.set_ylim(-2, 2)
            x0 = np.linspace(0, 2 * np.pi, self.size_state[1], endpoint=False)
            (self.line,) = self.ax_anim.plot(x0, np.zeros_like(x0), "b-")
            (self.line_uy,) = self.ax_anim.plot(x0, np.zeros_like(x0), "r-")
            (self.line_TuY,) = self.ax_anim.plot(x0, np.zeros_like(x0), "g-")
            (self.line_cells,) = self.ax_anim.plot([], [], "x")

    def reset(
        self,
        seed: int | None = None,
        options: Dict[str, Any] | None = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        out = self.env.reset(seed=seed, options=options)
        if self.debug_cell_dist:
            self.update()
            self._plt.show(block=False)
        return out

    def step(self, action):
        if self.debug_cell_dist:
            self.update()
        obs, reward, terminated, truncated, info = self.env.step(action)
        cd, peaks, uy = compute_cell_distances(
            info["state"], self.size_state, return_peaks=True
        )
        reward = self.__apply_reward_shaping(cd, reward)
        info["cell_dist"] = cd
        if self.debug_cell_dist:
            domain_x = np.linspace(
                0, 2 * np.pi, self.size_state[1], endpoint=False
            )
            self.line_cells.set_data(domain_x[peaks], uy[peaks])
            self.logger.info(
                "Distance between cells: %s. Number of peaks: %d",
                cd, len(peaks),
            )
        return obs, reward, terminated, truncated, info

    def update(self):
        """Redraw the debug view from the env's current diagnostic state
        (reference rbc_reward_shaping.py update())."""
        state = self.env.unwrapped._diag_state
        mid = int(self.size_state[0] / 2) - 1
        t_mid = state[RBCField.T][mid]
        uy = state[RBCField.UY][mid]
        xdata = np.linspace(0, 2 * np.pi, self.size_state[1], endpoint=False)
        self.line.set_data(xdata, t_mid)
        self.line_uy.set_data(xdata, uy)
        self.line_TuY.set_data(xdata, (t_mid - 1.5) * uy)
        self.fig_anim.canvas.draw()
        self.fig_anim.canvas.flush_events()

    def __apply_reward_shaping(self, cell_distances, reward) -> float:
        w = self.shaping_weight
        cd_normalized = (-cell_distances + np.pi) / np.pi
        reward = (1 - w) * reward + w * cd_normalized
        if np.isnan(reward):
            self.logger.error("Reward is NaN")
        return reward
