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

X_BLK = 4  # x columns a K3 block owns (csrc/rbc3d.cu kXBlk)
Y_BLK = 8  # y rows a K5 block owns (kYT)
XY_MIN_NX = 4  # K5's plane indices -4..nx+3 wrap x once (kXYMinNx)
XY_RING = 8  # x-planes of u, v, w, b a K5 block holds (kRing)


def env_step_2d_smem_bytes(nx: int, nz: int) -> int:
    """K1: the solve's right-hand side and its modal coefficients, (nx, nz)
    float32 each (``csrc/rbc2d.cu``)."""
    return 2 * 4 * nx * nz


def stage_smem_bytes(ny: int, nz: int) -> int:
    """K3's slabs: q, u, v, b of x_blk + 8, + 7, + 6, + 6 whole-y columns of
    nz, w of x_blk + 6 columns of nz + 1 (``stage_smem_floats``)."""
    return 4 * ((4 * X_BLK + 27) * ny * nz + (X_BLK + 6) * ny * (nz + 1))


def stage_xy_smem_bytes(nz: int) -> int:
    """K5's x-plane rings: ``XY_RING`` planes of u (y_blk + 6 rows), v
    (y_blk + 7) and b (y_blk + 6) of nz and of w (y_blk + 6) of nz + 1, two
    planes of q (y_blk + 8 rows), four of pHY' (y_blk + 2), and v* (y_blk + 1
    rows) and w* (y_blk) of one plane (``stage_xy_smem_floats``)."""
    rows_nz = XY_RING * (3 * Y_BLK + 19) + 2 * (Y_BLK + 8) + 4 * (Y_BLK + 2) + Y_BLK + 1
    rows_nw = XY_RING * (Y_BLK + 6) + Y_BLK
    return 4 * (rows_nz * nz + rows_nw * (nz + 1))
