"""Staggered Arakawa-C grid metadata (the port's own copy of
``rbc_gym_tpu.sim.grid``; numpy only).

Layout matches the reference solver's Oceananigans RectilinearGrid
(reference sim/rbc_sim2D.jl:75-84, sim/rbc_sim3D.jl:99-108):

2D: topology (Periodic-x, Bounded-z), domain x in (0, Lx), z in (0, Lz).
  - ``u`` lives at (x-faces, z-centers)        shape (nx, nz)
  - ``w`` lives at (x-centers, z-faces)        shape (nx, nz + 1)
  - ``b`` (buoyancy tracer) at cell centers    shape (nx, nz)
  - pressures at cell centers                  shape (nx, nz)
  The z-face count nz+1 matches the reference checkpoint HDF5 layout where
  ``w`` has Nz+1 points (SURVEY §2.6).

3D: topology (Periodic-x, Periodic-y, Bounded-z).
  - ``u``: (x-faces, y-centers, z-centers)     (nx, ny, nz)
  - ``v``: (x-centers, y-faces, z-centers)     (nx, ny, nz)
  - ``w``: (x-centers, y-centers, z-faces)     (nx, ny, nz + 1)
  - ``b``: centers                             (nx, ny, nz)

Arrays in this package are indexed ``[..., x, z]`` / ``[..., x, y, z]`` with
any leading batch (environment) axes; the trailing axis is always z, so an
env's (x, z) slab is contiguous with z fastest.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Static 2D staggered grid (hashable)."""

    nx: int
    nz: int
    lx: float
    lz: float

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dz(self) -> float:
        return self.lz / self.nz

    # --- coordinate arrays (numpy; used at trace/setup time only) ---
    def x_centers(self) -> np.ndarray:
        return (np.arange(self.nx) + 0.5) * self.dx

    def x_faces(self) -> np.ndarray:
        return np.arange(self.nx) * self.dx

    def z_centers(self) -> np.ndarray:
        return (np.arange(self.nz) + 0.5) * self.dz

    def z_faces(self) -> np.ndarray:
        return np.arange(self.nz + 1) * self.dz

    # --- field shapes (without batch axes) ---
    @property
    def shape_c(self) -> Tuple[int, int]:
        """Cell-centered fields (b, pressures) and u (x-face == nx points)."""
        return (self.nx, self.nz)

    @property
    def shape_w(self) -> Tuple[int, int]:
        return (self.nx, self.nz + 1)


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Static 3D staggered grid."""

    nx: int
    ny: int
    nz: int
    lx: float
    ly: float
    lz: float

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def dz(self) -> float:
        return self.lz / self.nz

    def x_centers(self) -> np.ndarray:
        return (np.arange(self.nx) + 0.5) * self.dx

    def y_centers(self) -> np.ndarray:
        return (np.arange(self.ny) + 0.5) * self.dy

    def z_centers(self) -> np.ndarray:
        return (np.arange(self.nz) + 0.5) * self.dz

    @property
    def shape_c(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def shape_w(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz + 1)
