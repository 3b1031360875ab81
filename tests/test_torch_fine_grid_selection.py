"""The path rules over sweeps of grids, on the CPU: on CUDA in float32 the
port puts every grid on which the JAX package runs a Pallas kernel onto a
hand-written kernel, never the plain path and never a refusal.

The JAX package's rules are restated here from their source, so that the
sweeps need no JAX solver: in 2D it runs its fused kernels on every float32
grid off the CPU (rbc_gym_tpu/sim/solver2d.py:247-250); in 3D its stage
kernels inside the VMEM boundary (nz + 1) ny <= 1088 and, outside it, its
(x, y)-blocked stage kernel where nx % 8 == 0 and ny % 8 == 0 (the default
x_blk of 8 outside that boundary, rbc_gym_tpu/sim/solver3d.py:145-151 and
:323-348).
"""

import pytest
import torch

from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.sim import solver2d as s2
from rbc_gym_tpu_torch.sim import solver3d as s3

F32 = torch.float32


def jax_runs_a_pallas_kernel_3d(nx: int, ny: int, nz: int) -> bool:
    """Whether the JAX package's auto rule picks a Pallas path for a float32
    grid off the CPU."""
    return (nz + 1) * ny <= 2 * 17 * 32 or (nx % 8 == 0 and ny % 8 == 0)


@pytest.mark.parametrize("nx", [4, 8, 12, 32, 64, 128, 256])
@pytest.mark.parametrize("ny", [8, 16, 24, 64, 128, 256])
def test_3d_auto_selection_takes_a_kernel_wherever_the_jax_package_does(nx, ny):
    """nz from 2 to 512 at nx % 4 == 0, ny % 8 == 0: auto on CUDA never
    raises, and where the JAX package runs a Pallas kernel it picks a kernel
    path; outside the whole-y boundary that is K5, on one CTA or, where one
    CTA cannot hold the column (nz >= 107), on its z split."""
    for nz in range(2, 513):
        path = s3.select_stage_path(F32, nx, ny, nz, "cuda")
        if jax_runs_a_pallas_kernel_3d(nx, ny, nz):
            assert path in s3.KERNEL_PATHS, (nx, ny, nz, path)
        if not limits.whole_y_fits(ny, nz):
            assert path == "stage_xy", (nx, ny, nz, path)
            assert (limits.stage_xy_split_size(nz) > 0) == (nz >= 107), nz
        assert s3.stage_kernel_limit(path, F32, nx, ny, nz) is None


@pytest.mark.parametrize("nx_lo,nx_hi", [(3, 512), (512, 1024), (1024, 1536), (1536, 2049)])
def test_2d_auto_selection_takes_k1_on_every_grid(nx_lo, nx_hi):
    """nx from 3 to 2048 and nz from 1 to 256: auto on CUDA in float32
    picks K1 ("fused") everywhere, as the JAX package runs its fused kernels
    on every float32 grid, and the instance that takes each grid asks a
    block for no more shared memory than the card has."""
    for nx in range(nx_lo, nx_hi):
        for nz in range(1, 257):
            assert s2.select_env_step_path(F32, nx, nz, "cuda") == "fused", (nx, nz)
    for nx in range(nx_lo, nx_hi, 7):
        for nz in range(1, 257, 5):
            assert limits.env_step_2d_smem_bytes(nx, nz) <= limits.SMEM_PER_BLOCK, (nx, nz)
