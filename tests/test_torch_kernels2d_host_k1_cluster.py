"""K1's cluster instance (the grids the on-chip instance cannot hold, on a
thread-block cluster of 2, 4 or 8 CTAs that each keep nx / c columns in
the on-chip layout), compiled for the host and held against the plain
version on the CPU (``torch_kernels2d_host``): the CTAs of a cluster run
together as host threads, each with its own shared memory, reading their
neighbours' through ``cluster_map`` and meeting at ``cluster_barrier``."""

import subprocess

import pytest

from rbc_gym_tpu_torch.ops import limits

from torch_kernels2d_host import check_k1, host_binary  # noqa: F401 (host_binary: a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


@pytest.mark.parametrize("n_env,nx,nz,c,dt_solver", [
    (1, 128, 64, 2, None),  # the compile-time instance: 64 x 64 a CTA
    (1, 200, 20, 2, None),  # the runtime instance: 100 columns a CTA, the last warps part-filled
    # four CTAs: three slabs copied in for each x product; at dx = 2 pi / 320
    # the explicit diffusion needs a smaller dt_solver than the default 0.03
    (1, 320, 16, 4, 0.01),
])
def test_host_build_of_k1_cluster_matches_plain(host_binary, tmp_path, n_env, nx, nz, c,
                                                dt_solver):
    """The cluster instance after 6 substeps against ``env_step_2d_plain``
    at the smoke's gate; the launcher's selection gave the grid a cluster
    of ``c``."""
    assert limits.env_step_2d_cluster_size(nx, nz) == c
    check_k1(host_binary, tmp_path, n_env, nx, nz, 6 * (dt_solver or 0.03), dt_solver,
             instance=f"cluster {c}")


@pytest.mark.parametrize("nx,nz,precision,instance", [
    (128, 64, "high", "cluster_wgmma 2"),  # 64 x 64 a CTA: the solve on wgmma
    (128, 64, "default", "cluster_wgmma 2"),
    (200, 20, "high", "cluster 2"),  # 100 x 20 a CTA: the runtime-size instance's mma.sync
])
def test_host_build_of_k1_cluster_tf32_instance_matches_plain(host_binary, tmp_path, nx, nz,
                                                              precision, instance):
    """The split-product ("high", 3 passes) and one-pass ("default")
    cluster instances after 2 substeps (heater_duration 0.06: every product
    of every stage, the previous stage's tendencies across a substep, p
    out) against ``env_step_2d_plain`` at the same precision, at the
    smoke's gates for 6 substeps: at 128x64 the solve on wgmma, its x
    products over chunks of F's and G's rows staged by bulk copies, A from
    the neighbour's slab through ``cluster_map``; at 200x20 the runtime-size
    instance's tiles over the copied slabs. Each emulated mma meets its
    warp twice (a wgmma its warpgroup), so a substep here costs several
    times one of float32 K1 (as in ``test_torch_kernels2d_host_tf32.py``)."""
    check_k1(host_binary, tmp_path, 1, nx, nz, 0.06, None, precision, n_sub=2,
             instance=instance)


@pytest.mark.parametrize("nx,nz", [(96, 64), (128, 64), (127, 64), (192, 64), (194, 64),
                                   (256, 64), (200, 20), (320, 16), (130, 2), (128, 1),
                                   (512, 64), (1024, 16), (520, 64), (2048, 8), (128, 65),
                                   (16, 1), (3, 8)])
def test_cluster_selection_matches_the_launcher(host_binary, nx, nz):
    """``limits.env_step_2d_cluster_size`` and ``env_step_2d_cluster_fg``
    are the launcher's own, and a grid takes at most one of the on-chip
    instance and a cluster."""
    out = subprocess.run([str(host_binary), "smem", str(nx), str(nz)], check=True,
                         capture_output=True, text=True).stdout.split()
    c = limits.env_step_2d_cluster_size(nx, nz)
    assert int(out[6]) == c
    assert bool(int(out[7])) == limits.env_step_2d_cluster_fg(nx, nz)
    assert not (c and limits.env_step_2d_on_chip(nx, nz))
    assert limits.env_step_2d_cluster_fg(nx, nz) == ((nx, nz) in FG_ROWS)


@pytest.mark.parametrize("nx,nz", [(96, 64), (64, 64), (128, 32), (128, 64), (192, 64),
                                   (256, 64), (384, 64), (512, 64), (128, 40), (96, 32),
                                   (200, 20), (127, 64), (64, 32), (128, 224), (3, 8)])
def test_wgmma_selection_matches_the_launcher(host_binary, nx, nz):
    """``limits.env_step_2d_wgmma`` and ``env_step_2d_packed`` at 1 and 3
    TF32 passes are the launcher's own choices (``csrc/rbc2d.cu``), never at
    float32; the grids on wgmma are the on-chip ``K1_WGMMA_GRIDS`` and the
    clusters whose CTAs hold ``K1_CLUSTER_WGMMA_SLABS``; on them
    ``limits.k1_wgmma_chunk``, by which the host packs F and G, is the
    kernel's ``k1_wg_chunk``."""
    out = subprocess.run([str(host_binary), "smem", str(nx), str(nz)], check=True,
                         capture_output=True, text=True).stdout.split()
    c = limits.env_step_2d_cluster_size(nx, nz) or 1
    for passes, got, packed, chunk in ((1, out[10], out[12], out[14]),
                                       (3, out[11], out[13], out[15])):
        assert bool(int(got)) == limits.env_step_2d_wgmma(nx, nz, passes), passes
        assert limits.env_step_2d_wgmma(nx, nz, passes) == ((nx, nz) in WGMMA), passes
        assert bool(int(packed)) == limits.env_step_2d_packed(nx, nz, passes), passes
        want = limits.k1_wgmma_chunk(nx // c, nz, passes) if (nx, nz) in WGMMA else 0
        assert int(chunk) == want, passes
    assert not limits.env_step_2d_wgmma(nx, nz, 0) and not limits.env_step_2d_packed(nx, nz, 0)


# the grids above whose TF32 instances run on wgmma
WGMMA = {(96, 64), (64, 64), (128, 32), (128, 64), (192, 64), (256, 64), (384, 64), (512, 64)}


# the grids above whose cluster CTAs hold their rows of F and G
FG_ROWS = {(128, 64), (200, 20), (130, 2)}
