"""What each hand-written kernel asks of a block, and what the card gives.

The selection rules of ``sim/solver2d.py`` and ``sim/solver3d.py`` decide
from these numbers alone whether a kernel can take a configuration. The
launchers in ``csrc/`` compute the same byte counts and refuse a launch
that does not fit; ``tests/test_torch_kernels3d_host.py`` holds the 3D
formulas against the compiled launchers.
"""

from __future__ import annotations

# Shared memory one block may ask for on an H100 (sm_90): 227 KB.
SMEM_PER_BLOCK = 232_448

X_BLK = 4  # x columns a K3 or K5 block owns (csrc/rbc3d.cu kXBlk)
Y_BLK = 8  # y rows a K5 block owns (kYBlk)


def env_step_2d_smem_bytes(nx: int, nz: int) -> int:
    """K1: the solve's right-hand side and its modal coefficients, (nx, nz)
    float32 each (``csrc/rbc2d.cu``)."""
    return 2 * 4 * nx * nz


def stage_smem_bytes(ny: int, nz: int) -> int:
    """K3's slabs: q, u, v, b of x_blk + 8, + 7, + 6, + 6 whole-y columns of
    nz, w of x_blk + 6 columns of nz + 1 (``stage_smem_floats``)."""
    return 4 * ((4 * X_BLK + 27) * ny * nz + (X_BLK + 6) * ny * (nz + 1))


def stage_xy_smem_bytes(nz: int) -> int:
    """K5's slabs: (columns, rows) of q (x_blk + 8, y_blk + 8), u (x_blk + 7,
    y_blk + 6), v (x_blk + 6, y_blk + 7), b (x_blk + 6, y_blk + 6) of nz, w
    (x_blk + 6, y_blk + 6) of nz + 1 (``stage_xy_smem_floats``)."""
    cells = ((X_BLK + 8) * (Y_BLK + 8) + (X_BLK + 7) * (Y_BLK + 6)
             + (X_BLK + 6) * (Y_BLK + 7) + (X_BLK + 6) * (Y_BLK + 6))
    return 4 * (cells * nz + (X_BLK + 6) * (Y_BLK + 6) * (nz + 1))
