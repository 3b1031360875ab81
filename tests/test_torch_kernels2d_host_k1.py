"""Float32 K1 on the chip (its compile-time and runtime on-chip
instances), compiled for the host and held against the plain version on
the CPU (``torch_kernels2d_host``)."""

import pytest

from torch_kernels2d_host import check_k1, host_binary  # noqa: F401 (host_binary: a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


@pytest.mark.parametrize("n_env,nx,nz", [
    (2, 96, 64),  # the reference grid: the compile-time instance
    (1, 20, 12),  # the runtime instance: two columns a warp, the last warps idle,
                  # one level a lane, the z ladder's walls meeting mid-column
    (1, 128, 40),  # the runtime instance at its edge: 8 columns a warp, two levels a lane
])
def test_host_build_of_k1_matches_plain(host_binary, tmp_path, n_env, nx, nz):
    """K1 after 6 substeps (heater_duration 0.18) against
    ``env_step_2d_plain`` at the smoke's gate."""
    check_k1(host_binary, tmp_path, n_env, nx, nz, 0.18, None)
