"""K1's off-chip instance with its two solve slabs in per-env global
scratch (the grids whose slabs, 8 nx nz bytes, exceed a block: 256x128,
512x256, 2048x64), forced here onto small grids, compiled for the host and
held against the plain version on the CPU (``torch_kernels2d_host``)."""

import subprocess

import pytest

from rbc_gym_tpu_torch.ops import limits

from torch_kernels2d_host import check_k1, host_binary  # noqa: F401 (host_binary: a fixture)


@pytest.mark.parametrize("n_env,nx,nz", [
    (2, 20, 80),  # three chunks of 32 levels in pHY'; the slabs of two envs side by side
    (1, 3, 8),  # the fewest columns the x stencils take
])
def test_host_build_of_k1_with_global_slabs_matches_plain(host_binary, tmp_path, n_env, nx, nz):
    """Float32 K1 after 6 substeps (heater_duration 0.18) against
    ``env_step_2d_plain`` at the smoke's gate."""
    check_k1(host_binary, tmp_path, n_env, nx, nz, 0.18, None, force_global="global_slabs",
             instance="global_slabs 1")


@pytest.mark.parametrize("precision", ["high", "default"])
def test_host_build_of_k1_tf32_with_global_slabs_matches_plain(host_binary, tmp_path,
                                                               precision):
    """The split-product ("high", 3 passes) and one-pass ("default")
    instances with global slabs at 20x80 after 2 substeps (heater_duration
    0.06: every product of every stage) against ``env_step_2d_plain`` at
    that precision: "high" at the smoke's gate, "default" against the
    float64 plain version within phase 39's bound."""
    check_k1(host_binary, tmp_path, 1, 20, 80, 0.06, None, precision, n_sub=2,
             force_global="global_slabs", instance="global_slabs 1")


@pytest.mark.parametrize("nx,nz", [(127, 64), (128, 224), (256, 128), (512, 256), (2048, 64),
                                   (128, 227), (129, 225), (20, 80), (3, 8)])
def test_slab_residency_matches_the_launcher(host_binary, nx, nz):
    """``limits.env_step_2d_slabs_on_chip``, ``env_step_2d_smem_bytes``,
    ``env_step_2d_scratch_floats`` and ``env_step_2d_offsets_fit`` are the
    launcher's own; the launcher without a force picks global slabs exactly
    where the off-chip slabs exceed a block."""
    out = subprocess.run([str(host_binary), "smem", str(nx), str(nz)], check=True,
                         capture_output=True, text=True).stdout.split()
    assert 4 * int(out[0]) == limits.env_step_2d_smem_bytes(nx, nz)
    assert int(out[1]) == limits.env_step_2d_scratch_floats(nx, nz)
    assert bool(int(out[8])) == limits.env_step_2d_slabs_on_chip(nx, nz)
    assert bool(int(out[9])) == limits.env_step_2d_offsets_fit(nx, nz)
    off_chip = not (limits.env_step_2d_on_chip(nx, nz) or limits.env_step_2d_cluster_size(nx, nz))
    assert limits.env_step_2d_slabs_on_chip(nx, nz) == (not off_chip or 8 * nx * nz <= 232_448)
