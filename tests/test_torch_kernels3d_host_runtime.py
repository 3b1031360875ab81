"""K3's and K5's runtime-size buckets (a grid off the compile-time
instances on the runtime-size layout, nz lanes a row, with its rings' rows
a compile-time stride apart, each z flux once; K3 at nz = 16 and 32 on the
compile-time column with ny at run time), compiled for the host and held
against the plain stage on the CPU (``torch_kernels3d_host``) at K3's and
K5's gates, each bucket at its edges and the runtime-size instances beside
them; and the launchers' buckets and shared memory against
``ops/limits.py`` over every grid the rules take.

Past 32 levels the case's noise (``make_case``) makes a divergence of
~20-60 (~10^4 at nz = 200), whose float32 spacing is ~2e-6-4e-6: the
float32 plain version is itself 3e-6-1.2e-5 off float64 there, so those
columns are held as K5's z split's are (``run_stage(vs_float64=True)``):
each output against the plain version run in float64, within the gate or
``SPLIT_VS_PLAIN`` times the float32 plain version's own error, whichever is
larger."""

import subprocess

import pytest

from rbc_gym_tpu_torch.ops import limits

from torch_kernels3d_host import host_binary, run_stage  # noqa: F401 (a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("shape,stride", [
    ((1, 4, 24, 16), 16),  # the compile-time column of 16 with ny at run time
    ((1, 4, 8, 32), 32),  # the compile-time column of 32 with ny at run time
    ((1, 4, 12, 33), 48),  # 33 lanes a row: a column touches two or three warps
    ((1, 4, 13, 33), None),  # the bucket would take fewer blocks an SM
    ((1, 4, 8, 48), 48),
    ((1, 4, 10, 65), 96),  # a column touches three or four warps
    ((1, 4, 8, 97), 128),
    ((1, 4, 8, 128), 128),  # the widest stride, full: five pHY' segments a column
    ((1, 4, 8, 24), None),  # the runtime-size instance beside them
    ((1, 4, 5, 7), None),
    ((1, 4, 32, 30), None),
    ((1, 4, 4, 200), None),
])
def test_host_build_of_k3_buckets_matches_plain(host_binary, tmp_path, shape, stride, stage):
    """K3 in the instance its launcher picks, at K3's gates (fields 5e-6,
    tendencies 1e-5; to 32 levels also w's walls exactly 0)."""
    _, _, ny, nz = shape
    assert limits.stage_bucket(ny, nz) == stride
    run_stage(host_binary, tmp_path, shape, stage, "x", vs_float64=nz > 32)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("nz,stride", [
    (40, 48), (48, 48), (96, 96),
    # the runtime-nz instance beside them, at the buckets' edges too
    (24, None), (33, None), (36, None), (50, None), (70, None), (95, None), (106, None),
])
def test_host_build_of_k5_buckets_matches_plain(host_binary, tmp_path, nz, stride, stage):
    """K5 on (1, 4, 8, nz), one y tile whose halos wrap onto itself, in the
    instance its launcher picks, at K5's gates."""
    assert limits.stage_xy_bucket(nz) == stride
    run_stage(host_binary, tmp_path, (1, 4, 8, nz), stage, "xy", "one 1", vs_float64=nz > 32)


def test_launchers_buckets_match_limits(host_binary):
    """Every grid K3's rule takes at ny 4..64 (ny nz <= 1024, nz <= 256) and
    every nz one K5 CTA takes: the launchers' bucket and shared memory are
    ``limits.py``'s, and fit a block."""
    out = subprocess.run([str(host_binary), "buckets"], check=True, capture_output=True,
                         text=True).stdout.splitlines()
    k3 = [list(map(int, line.split()[1:])) for line in out if line.startswith("k3 ")]
    k5 = [list(map(int, line.split()[1:])) for line in out if line.startswith("k5 ")]
    assert len(k3) == sum(min(256, 1024 // ny) - 1 for ny in range(4, 65))
    assert [r[0] for r in k5] == list(range(2, 107))
    for ny, nz, stride, floats in k3:
        assert (stride or None) == limits.stage_bucket(ny, nz), (ny, nz)
        assert 4 * floats == limits.stage_launch_smem_bytes(ny, nz), (ny, nz)
        assert limits.stage_smem_bytes(ny, nz) > limits.SMEM_PER_BLOCK or (
            4 * floats <= limits.SMEM_PER_BLOCK), (ny, nz)
    for nz, stride, floats in k5:
        assert (stride or None) == limits.stage_xy_bucket(nz), nz
        assert 4 * floats == limits.stage_xy_launch_smem_bytes(nz) <= limits.SMEM_PER_BLOCK, nz
