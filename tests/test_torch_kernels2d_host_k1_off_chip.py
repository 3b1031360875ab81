"""Float32 K1's off-chip instance (the grids that neither the on-chip
instance nor a cluster of 2, 4 or 8 CTAs takes; forced here on every case,
so that 128x64 and 200x20 keep it), compiled for the host and held
against the plain version on the CPU
(``torch_kernels2d_host``)."""

import pytest

from torch_kernels2d_host import check_k1, host_binary  # noqa: F401 (host_binary: a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


@pytest.mark.parametrize("n_env,nx,nz", [
    (1, 128, 64),  # the on-chip state does not fit: 296,448 bytes
    (1, 20, 80),  # three chunks of 32 levels in pHY', the last part-filled
    (1, 200, 20),  # nx > 128, a part-filled chunk
    (1, 3, 8),  # the fewest columns the x stencils take
    (1, 16, 1),  # one level
    (1, 150, 33),  # ragged: two row tiles of the products, the second 22 rows; strips of 10
])
def test_host_build_of_k1_matches_plain(host_binary, tmp_path, n_env, nx, nz):
    """K1 after 6 substeps (heater_duration 0.18) against
    ``env_step_2d_plain`` at the smoke's gate, forced onto the off-chip
    instance (the launcher gives 128x64 and 200x20 its cluster instance)."""
    check_k1(host_binary, tmp_path, n_env, nx, nz, 0.18, None, force_global=True,
             instance="global 1")


def test_host_build_of_k1_off_the_chip_on_a_tall_grid(host_binary, tmp_path):
    """The off-chip instance at 128x224 as the launcher runs it (its two
    slabs, 229,376 bytes, and its products' ring do not fit a block, so they
    are in global scratch; seven chunks of 32 levels in the march), 6
    substeps at a dt_solver that keeps the explicit diffusion stable at dz =
    2 / 224."""
    check_k1(host_binary, tmp_path, 1, 128, 224, 0.012, 0.002, instance="global_slabs 1")
