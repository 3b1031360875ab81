"""Host-side rendering helpers, off the device path.

The port's copy of ``rbc_gym_tpu.envs.rendering``: ``colormap`` maps a
scalar field to RGB through a matplotlib colormap, ``PygameRenderer2D``
draws the 2D env's temperature (an array, or a pygame window in "human"
mode), ``render_volume_slices`` makes a montage of horizontal slices of a
3D field. They take and return numpy arrays; matplotlib is imported when
a field is rendered and pygame when a window is first opened, never at
import.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def colormap(value: np.ndarray, vmin: float = 1.0, vmax: float = 2.0,
             name: str = "turbo") -> np.ndarray:
    """Map a 2D scalar field to uint8 RGB via a matplotlib colormap."""
    import matplotlib

    cmap = matplotlib.colormaps[name]
    norm = (value - vmin) / (vmax - vmin)
    return cmap(norm, bytes=True)[..., :3]


class PygameRenderer2D:
    """Heat-map window / rgb_array renderer for the 2D env."""

    def __init__(self, width: int = 768, height: int = 512, fps: int = 10):
        self.width = width
        self.height = height
        self.fps = fps
        self._screen = None
        self._clock = None

    def render(self, temperature_zx: np.ndarray, vmin: float, vmax: float,
               mode: str) -> Optional[np.ndarray]:
        """temperature_zx: (nz, nx) with z increasing upward."""
        # image rows top->bottom = z decreasing
        img = colormap(temperature_zx[::-1, :], vmin=vmin, vmax=vmax)
        if mode == "rgb_array":
            return img

        import pygame

        if self._screen is None:
            pygame.init()
            pygame.display.init()
            self._screen = pygame.display.set_mode((self.width, self.height))
            pygame.display.set_caption("Rayleigh Benard Convection (CUDA)")
        if self._clock is None:
            self._clock = pygame.time.Clock()

        # pygame surfarray expects (w, h, 3)
        canvas = pygame.surfarray.make_surface(np.transpose(img, (1, 0, 2)))
        canvas = pygame.transform.scale(canvas, (self.width, self.height))
        self._screen.blit(canvas, (0, 0))
        pygame.event.pump()
        self._clock.tick(self.fps)
        pygame.display.flip()
        return None

    def close(self) -> None:
        if self._screen is not None:
            import pygame

            pygame.display.quit()
            pygame.quit()
            self._screen = None


def render_volume_slices(temperature_zyx: np.ndarray, vmin: float, vmax: float,
                         n_slices: int = 4) -> np.ndarray:
    """Montage of ``n_slices`` horizontal slices, bottom to top, side by side.

    temperature_zyx: (nz, ny, nx). Returns an RGB uint8 image (ny, n_slices * nx, 3).
    """
    nz = temperature_zyx.shape[0]
    idx = np.linspace(0, nz - 1, n_slices).round().astype(int)
    tiles = [colormap(temperature_zyx[k], vmin, vmax) for k in idx]
    return np.concatenate(tiles, axis=1)
