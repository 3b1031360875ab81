"""Host-side rendering helpers, off the device path.

The port's copy of ``rbc_gym_tpu.envs.rendering``'s array renderers:
``colormap`` maps a scalar field to RGB through a matplotlib colormap,
``render_volume_slices`` makes a montage of horizontal slices of a 3D
field. They take and return numpy arrays; matplotlib is imported when a
field is rendered, never at import.
"""

from __future__ import annotations

import numpy as np


def colormap(value: np.ndarray, vmin: float = 1.0, vmax: float = 2.0,
             name: str = "turbo") -> np.ndarray:
    """Map a 2D scalar field to uint8 RGB via a matplotlib colormap."""
    import matplotlib

    cmap = matplotlib.colormaps[name]
    norm = (value - vmin) / (vmax - vmin)
    return cmap(norm, bytes=True)[..., :3]


def render_volume_slices(temperature_zyx: np.ndarray, vmin: float, vmax: float,
                         n_slices: int = 4) -> np.ndarray:
    """Montage of ``n_slices`` horizontal slices, bottom to top, side by side.

    temperature_zyx: (nz, ny, nx). Returns an RGB uint8 image (ny, n_slices * nx, 3).
    """
    nz = temperature_zyx.shape[0]
    idx = np.linspace(0, nz - 1, n_slices).round().astype(int)
    tiles = [colormap(temperature_zyx[k], vmin, vmax) for k in idx]
    return np.concatenate(tiles, axis=1)
