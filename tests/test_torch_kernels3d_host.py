"""K3 to K7's CUDA source, compiled for the host and held against the
plain versions, on the CPU (``torch_kernels3d_host``)."""

import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from rbc_gym_tpu_torch.ops import kernels3d as k3
from rbc_gym_tpu_torch.ops import limits

from torch_kernels3d_host import host_binary, make_case, run_stage  # noqa: F401 (a fixture)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("shape", [
    (3, 32, 32, 16),  # the training grid: the specialised instance, 512 threads
    (2, 8, 8, 8),  # runtime sizes
    (1, 12, 8, 5),  # runtime sizes, nz where the z ladder meets in the middle
    (1, 6, 32, 16),  # the specialised instance at nx % 4 != 0: every plane wraps once
    (1, 4, 5, 7),  # the smallest nx; odd ny and nz: every y tap and x plane wraps
])
def test_host_build_of_k3_and_k4_matches_plain(host_binary, tmp_path, shape, stage):
    case, c, got = run_stage(host_binary, tmp_path, shape, stage, "x")
    plain = k3.correct_3d_plain(*(torch.as_tensor(case[n], dtype=torch.float32)
                                  for n in ("u", "v", "w", "q")), c)
    for name, x in zip(("cu", "cv", "cw"), plain):
        np.testing.assert_allclose(got(name, x), x.numpy(), rtol=0, atol=chip_smoke.K4_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("shape", [
    (2, 8, 16, 8),  # 2 x blocks and 2 y blocks
    (1, 4, 8, 5),  # ny = y_blk: the one y block's halos wrap onto itself
    (1, 8, 24, 6),  # 3 y blocks, nz where the z ladder meets in the middle
    (1, 8, 16, 32),  # the specialised nz = 32 (a warp per column), two y tiles
    (1, 4, 16, 16),  # the specialised nz = 16; nx = 4: every x tap and plane wraps
    (1, 6, 8, 7),  # runtime nz, nx % 4 != 0, one y tile whose halos wrap onto itself
])
def test_host_build_of_k5_matches_plain(host_binary, tmp_path, shape, stage):
    run_stage(host_binary, tmp_path, shape, stage, "xy")


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("shape", [
    (2, 32, 32, 16),  # the training grid: the specialised instance, 512 threads
    (1, 8, 8, 8),  # runtime sizes
    (1, 4, 5, 7),  # the smallest nx; odd ny and nz
])
def test_host_build_of_k3_analysis_instance_matches_plain(host_binary, tmp_path, shape, stage):
    """K3's analysis instance: the fields and g at K3's gates, rhat against
    the plain version run in float64 within ``RHAT_VS_PLAIN`` times the
    float32 plain version's own error there."""
    run_stage(host_binary, tmp_path, shape, stage, "qp")


def test_host_build_of_k3_analysis_instance_at_nx_64(host_binary, tmp_path):
    """Stage 1 of the specialised instance at nx = 64, a grid whose shared
    rhat accumulator the instance's first design could not hold: t goes
    through its staged x-factor, at the same gates."""
    assert limits.stage_qp_smem_bytes(64, 32, 16) <= limits.SMEM_PER_BLOCK
    run_stage(host_binary, tmp_path, (1, 64, 32, 16), 1, "qp")


@pytest.mark.parametrize("nx,ny,nz", [
    (32, 32, 16), (64, 32, 16), (4, 5, 7), (48, 16, 24),
    (16, 4, 256),  # Cz^T outgrows the block where K3 fits
    (50_000, 4, 2), (60_000, 4, 2),  # one thread's t, nx floats, sets the footprint
])
def test_analysis_instance_smem_formula_matches_the_launcher(host_binary, nx, ny, nz):
    """``limits.stage_qp_smem_bytes`` is the analysis launcher's own count,
    and the selection rule refuses "stage_qp" exactly where it exceeds the
    card's shared memory."""
    from rbc_gym_tpu_torch.sim import solver3d as s3

    out = subprocess.run([str(host_binary), "smem_qp", str(nx), str(ny), str(nz)], check=True,
                         capture_output=True, text=True).stdout.split()
    assert 4 * int(out[0]) == limits.stage_qp_smem_bytes(nx, ny, nz)
    fits = limits.stage_qp_smem_bytes(nx, ny, nz) <= limits.SMEM_PER_BLOCK
    limit = s3.stage_kernel_limit("stage_qp", torch.float32, nx, ny, nz)
    assert (limit is None) == fits, limit


@pytest.mark.parametrize("ny,nz", [(32, 16), (64, 32), (8, 8), (4, 256), (33, 31)])
def test_smem_formulas_match_the_launchers(host_binary, ny, nz):
    """The selection rule's byte counts are the launchers' own."""
    out = subprocess.run([str(host_binary), "smem", str(ny), str(nz)], check=True,
                         capture_output=True, text=True).stdout.split()
    assert [4 * int(n) for n in out] == [limits.stage_smem_bytes(ny, nz),
                                         limits.stage_xy_smem_bytes(nz),
                                         limits.field_smem_bytes(ny, nz)]


@pytest.mark.parametrize("shape,instance", [
    ((2, 6, 8, 8), "march"),  # odd nx / 2: the grids where auto takes the field path
    ((1, 32, 32, 16), "march"),  # the training grid: the specialised instance, 512 threads
    ((1, 30, 32, 16), "march"),  # the specialised instance at nx % 4 != 0 (16x32x30)
    ((2, 5, 8, 8), "march"),  # runtime sizes, odd nx: every plane wraps once
    ((1, 6, 12, 20), "march"),  # runtime sizes, nz neither 16 nor 32 (K7 too)
    ((1, 3, 5, 4), "general"),  # nx = 3, the smallest nx the field kernels take
    ((1, 4, 34, 32), "general"),  # ny * nz = 1088: whole-y, beyond the march's 1024 threads
])
def test_host_build_of_k6_and_k7_matches_plain(host_binary, tmp_path, shape, instance):
    """K6 for each field, in the instance its launcher picks for the grid,
    and K7 against ``field_tendency_3d_plain`` and ``div_3d_plain`` at the
    smoke's gates. K6's u and v read b and compute pHY' themselves (float64),
    the plain version's pHY' is a float32 suffix sum."""
    e, nx, ny, nz = shape
    assert limits.field_tendency_on_march(nx, ny, nz) == (instance == "march")
    case = make_case(*shape, seed=1)
    for name, a in case.items():
        a.astype(np.float32).tofile(tmp_path / name)
    c = k3.Coeffs3D(4 * np.pi / nx, 4 * np.pi / ny, 2.0 / nz, float(np.sqrt(0.7 / 2500)),
                    float(1 / np.sqrt(0.7 * 2500)), 1.0)
    ran = subprocess.run([str(host_binary), "field", f"{tmp_path}/", *map(str, shape),
                          *(repr(float(x)) for x in c)], check=True, capture_output=True,
                         text=True).stdout.split()
    assert ran == [instance]
    t = {n: torch.as_tensor(a, dtype=torch.float32) for n, a in case.items()}
    for field in "uvwb":
        want = k3.field_tendency_3d_plain(field, *(t[n] for n in k3.FIELD_INPUTS[field]), c=c)
        got = np.fromfile(tmp_path / f"g{field}", np.float32).reshape(want.shape)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=chip_smoke.K6_ATOL,
                                   err_msg=f"g{field}")
        if field == "w":
            assert np.all(got[..., 0] == 0) and np.all(got[..., -1] == 0)
    want = k3.div_3d_plain(t["u"], t["v"], t["w"], c)
    got = np.fromfile(tmp_path / "div", np.float32).reshape(want.shape)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=chip_smoke.K7_ATOL)
