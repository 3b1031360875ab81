"""K1's runtime-size buckets (the instances of every grid off the
compile-time ones, each compiled for the fewest columns a warp and levels a
lane that hold its block), compiled for the host and held against the plain
version on the CPU (``torch_kernels2d_host``), and the launcher's choice of
bucket held to ``limits.env_step_2d_bucket`` over a sweep of grids."""

import subprocess

import pytest

from rbc_gym_tpu_torch.ops import limits

from torch_kernels2d_host import check_k1, host_binary  # noqa: F401 (host_binary: a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


@pytest.mark.parametrize("nx,nz,bucket,instance,dt_solver", [
    (128, 32, (8, 1, 32), "on_chip 1", None),  # the edge: 8 columns a warp, 32 levels
    (45, 30, (8, 1, 32), "on_chip 1", None),  # odd nx, padded columns, L one value at a time
    (128, 40, (8, 2, 48), "on_chip 1", None),  # 8 columns a warp, 40 of 48 levels
    (33, 48, (8, 2, 48), "on_chip 1", None),  # odd nx, the stride's edge
    (64, 64, (4, 2, 64), "on_chip 1", None),  # the edge: 4 columns a warp, 64 levels
    (33, 53, (4, 2, 64), "on_chip 1", None),  # odd nx and nz
    (80, 64, (8, 2, 0), "on_chip 1", None),  # 5 columns a warp of 64 levels at stride nz
    (127, 50, (8, 2, 0), "on_chip 1", None),  # odd nx, 8 columns a warp at stride nz
    (256, 32, (8, 1, 0), "cluster 2", None),  # 128 columns a CTA: 8 a warp, one level a lane
    (160, 64, (8, 2, 0), "cluster 2", None),  # 80 columns a CTA, 64 levels
    (200, 20, (8, 1, 0), "cluster 2", None),  # 100 columns a CTA, its last warps part-filled
])
def test_host_build_of_k1_buckets_matches_plain(host_binary, tmp_path, nx, nz, bucket, instance,
                                                dt_solver):
    """Float32 K1 in its runtime-size bucket after 6 substeps
    (heater_duration 0.18) against ``env_step_2d_plain`` at the smoke's
    gate (``chip_smoke.K1_ATOL``); the host program ran ``instance`` in
    ``bucket`` (columns a warp, levels a lane, column stride: 0 is nz),
    which is ``limits.env_step_2d_bucket``'s."""
    check_k1(host_binary, tmp_path, 1, nx, nz, 0.18, dt_solver, instance=instance,
             bucket=bucket)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("nx,nz", [(45, 30), (100, 50)])
def test_host_build_of_k1_tf32_bucket_matches_plain(host_binary, tmp_path, nx, nz, precision):
    """K1's TF32 bucket (8 columns a warp of two levels a lane at stride nz)
    after 2 substeps against ``env_step_2d_plain`` at the same precision, at the
    smoke's gates (as ``test_torch_kernels2d_host_tf32.py``): odd nx at nz
    <= 32 (the second level past nz), and 7 columns a warp."""
    check_k1(host_binary, tmp_path, 1, nx, nz, 0.06, None, precision, n_sub=2,
             instance="on_chip 1", bucket=(8, 2, 0))


def _bucket_code(bucket):
    return 0 if bucket is None else 10000 * bucket[0] + 100 * bucket[2] + bucket[1]


@pytest.mark.parametrize("nx_lo,nx_hi", [(3, 90), (90, 180), (180, 270)])
def test_bucket_selection_matches_the_launcher(host_binary, nx_lo, nx_hi):
    """nx from 3 to 269 and nz from 1 to 69: the launcher's runtime-size
    bucket at 0, 1 and 3 TF32 passes is ``limits.env_step_2d_bucket``'s,
    its shared memory ``limits.env_step_2d_smem_bytes``', in float32 one
    level a lane exactly where nz <= 32, and never more columns a warp than
    the bucket's."""
    out = subprocess.run([str(host_binary), "buckets", str(nx_lo), str(nx_hi), "1", "70"],
                         check=True, capture_output=True, text=True).stdout.splitlines()
    assert len(out) == (nx_hi - nx_lo) * 69
    for line in out:
        nx, nz, b0, b1, b3, floats = map(int, line.split())
        for passes, got in ((0, b0), (1, b1), (3, b3)):
            bucket = limits.env_step_2d_bucket(nx, nz, passes)
            assert got == _bucket_code(bucket), (nx, nz, passes, got, bucket)
            if bucket is not None:
                c = limits.env_step_2d_cluster_size(nx, nz) or 1
                if passes == 0:  # TF32: two levels a lane at every nz
                    assert (bucket[1] == 1) == (nz <= 32), (nx, nz, passes)
                assert -(-(nx // c) // 16) <= bucket[0], (nx, nz, passes)
        assert 4 * floats == limits.env_step_2d_smem_bytes(nx, nz), (nx, nz)
