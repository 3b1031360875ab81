"""The port's kernel-selection rule, every branch, on the CPU.

``select_stage_path`` (3D) and ``select_env_step_path`` (2D) are pure
functions of the dtype, the grid and the device type, so the CUDA
branches run here with ``device_type="cuda"``. The byte counts they name
are the launchers' own (``tests/test_torch_kernels3d_host.py`` checks the
3D formulas against the compiled source).
"""

import numpy as np
import pytest
import torch

from rbc_gym_tpu_torch.ops import kernels2d as k2
from rbc_gym_tpu_torch.ops import kernels3d as k3
from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.sim import solver2d as s2
from rbc_gym_tpu_torch.sim import solver3d as s3
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D

F32, F64 = torch.float32, torch.float64
TRAINING = (32, 32, 16)  # (nx, ny, nz) of the 16x32x32 training grid
BIG = (64, 64, 32)  # the 32x64x64 big grid


@pytest.mark.parametrize("dtype,shape,device_type,want", [
    (F32, TRAINING, "cuda", "stage"),  # K3: 512 threads, 99,456 bytes
    (F32, BIG, "cuda", "stage_xy"),  # outside the whole-y boundary; K5 70,240 bytes
    (F32, (16, 16, 8), "cuda", "stage"),
    (F64, TRAINING, "cuda", "plain"),  # the JAX package's XLA path for float64
    (F64, BIG, "cuda", "plain"),
    (F32, (64, 60, 32), "cuda", "plain"),  # K3 too large, ny % 8 != 0: JAX's XLA path
    (F32, (66, 64, 32), "cuda", "plain"),  # K3 too large, nx % 4 != 0: the same
    # K3's slab fits but nx % 4 != 0: the JAX package's per-field path
    (F32, (6, 32, 16), "cuda", "field"),
    (F32, (30, 16, 8), "cuda", "field"),
    # inside the whole-y boundary but ny * nz = 1056 > 1024 threads: K3 cannot
    # take it, the per-field path does (it took K3's first design)
    (F32, (32, 33, 32), "cuda", "field"),
    (F32, (8, 3, 16), "cuda", "field"),  # ny = 3 < 4: K3 refuses, the field path takes it
    # whole-y where ny * nz <= 1096: the x-planes the rule moved there from
    # the tiled side (K5, or the plain path where K5 cannot take them)
    (F32, (32, 64, 17), "cuda", "field"),
    (F32, (30, 64, 17), "cuda", "field"),
    (F32, (16, 512, 2), "cuda", "stage"),  # 1024 points: K3 takes it
    (F32, (32, 8, 137), "cuda", "field"),  # K5's rings would need 299,140 bytes
    (F32, (32, 3, 365), "cuda", "field"),  # the largest x-plane the rule held whole-y before
    (F32, (32, 3, 366), "cuda", "plain"),  # 1098 points: tiled, and K5 needs ny % 8 == 0
    (F32, (6, 32, 16), "cpu", "plain"),
    (F32, TRAINING, "cpu", "plain"),
    (F32, BIG, "cpu", "plain"),
])
def test_auto_selection(dtype, shape, device_type, want):
    assert s3.select_stage_path(dtype, *shape, device_type) == want


@pytest.mark.parametrize("shape,want", [
    # K3 too large, K5's constraints hold but one CTA's x-plane rings would
    # need 233,740 bytes (nz = 107) or more: K5's z split takes the column
    ((64, 64, 107), "stage_xy"),  # two CTAs of 54 and 53 levels
    ((32, 64, 112), "stage_xy"),  # 112x64x32
    ((128, 128, 128), "stage_xy"),  # 128x128x128
    ((256, 256, 128), "stage_xy"),  # 128x256x256
    ((64, 64, 512), "stage_xy"),  # eight CTAs of 64 levels
    # past the split's reach: eight CTAs of 99 levels would need 233,900 bytes
    ((64, 64, 785), "stage_xy kernel needs 233,900 bytes.*8 CTAs.*232,448"),
])
def test_auto_selection_raises_where_only_the_jax_package_has_a_kernel(shape, want):
    """Auto never puts the plain path on the card where the JAX package
    runs a kernel: the grids where single-CTA K5 cannot hold the column
    take its z split, and the port raises only where that cannot either."""
    if want == "stage_xy":
        assert s3.select_stage_path(F32, *shape, "cuda") == want
        assert limits.stage_xy_split_size(shape[2]) > 0
    else:
        with pytest.raises(NotImplementedError, match=want):
            s3.select_stage_path(F32, *shape, "cuda")
    assert s3.select_stage_path(F64, *shape, "cuda") == "plain"


@pytest.mark.parametrize("fused,shape,want", [
    ("stage", TRAINING, "stage"),
    ("stage", (6, 32, 16), "stage"),  # K3 marches along x: any nx >= 4
    ("stage_xy", BIG, "stage_xy"),
    ("stage_xy", TRAINING, "stage_xy"),  # ny = 32: four y blocks
    ("field", TRAINING, "field"),
    (True, TRAINING, "field"),  # the JAX package maps True to "field"
    ("field", BIG, "field"),  # K6's general instance and K7 take any such grid
    (False, TRAINING, "plain"),
    (False, BIG, "plain"),
])
@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_forced_selection_that_fits(fused, shape, want, device_type):
    assert s3.select_stage_path(F32, *shape, device_type, fused) == want


@pytest.mark.parametrize("fused,dtype,shape,message", [
    ("stage", F32, BIG, r"ny \* nz <= 1024, one thread per point"),
    ("stage", F64, TRAINING, "float32"),
    ("stage", F32, (3, 32, 16), "nx >= 4, ny >= 4 and nz >= 2"),
    ("stage_xy", F32, (64, 60, 32), "ny % 8 == 0"),
    ("stage_xy", F32, (64, 64, 785), "233,900 bytes"),  # past the z split's 8 CTAs
    ("stage_xy", F32, (3, 64, 32), "nx >= 4"),
    ("stage_xy", F64, BIG, "float32"),
    ("field", F64, TRAINING, "float32, not torch.float64"),
    (True, F64, (6, 32, 16), "float32, not torch.float64"),
    ("field", F32, (2, 32, 16), "nx, ny >= 3"),
    ("field", F32, (3, 3, 238_609_294), "32-bit offsets"),  # 2,147,483,655 points an env
])
def test_forced_selection_that_cannot_fit_raises(fused, dtype, shape, message):
    for device_type in ("cuda", "cpu"):
        with pytest.raises(ValueError, match=message) as err:
            s3.select_stage_path(dtype, *shape, device_type, fused)
        if "bytes" in message:
            assert "232,448" in str(err.value)


# Every grid the (x, y)-blocked K5 of the first design took, as (nx, ny, nz),
# with the path auto picked for it then: K5's x march keeps taking each.
K5_GRIDS = [
    (BIG, "stage_xy"),  # the big grid, the main path of K5
    (TRAINING, "stage"),  # forced to K5 by the smoke's kernel_parity_big
    ((16, 16, 8), "stage"),  # the CPU tests' forced stage_xy grid
    ((4, 8, 5), "stage"),  # the host build's one-tile grid
]


@pytest.mark.parametrize("shape,auto", K5_GRIDS)
def test_k5_still_takes_every_grid_it_took(shape, auto):
    assert s3.stage_kernel_limit("stage_xy", F32, *shape) is None
    assert s3.select_stage_path(F32, *shape, "cuda", "stage_xy") == "stage_xy"
    assert s3.select_stage_path(F32, *shape, "cuda") == auto
    assert s3.select_stage_path(F32, *shape, "cpu") == "plain"


@pytest.mark.parametrize("fused,shape,dtype,reason", [
    ("stage_x", TRAINING, F32, "unknown fused"),
    # K3's analysis instance: K3 takes ny = 4, nz = 256, but the instance's
    # Cz^T (nz^2) outgrows a block's shared memory there
    ("stage_qp", (16, 4, 256), F32, "462,992 bytes of shared memory"),
    ("stage_qp", BIG, F32, r"ny \* nz <= 1024"),
    ("stage_ew", BIG, F32, r"ny \* nz <= 1024"),
    ("stage_qp", TRAINING, F64, "float32"),
])
def test_refused_fused_values_are_named(fused, shape, dtype, reason):
    with pytest.raises(ValueError, match=reason):
        s3.select_stage_path(dtype, *shape, "cuda", fused)


@pytest.mark.parametrize("fused,shape", [
    ("stage_qp", TRAINING),  # 102,528 bytes: two blocks an SM, as K3
    ("stage_qp", (64, 32, 16)),  # nx = 64: no shared memory grows with nx
    ("stage_qp", (16, 16, 8)),
    ("stage_qp", (48, 16, 24)),
    ("stage_ew", TRAINING),  # K3 itself
    ("stage_ew", (6, 32, 16)),  # K3 takes nx % 4 != 0 when forced
])
def test_stage_qp_and_stage_ew_are_accepted_where_their_kernel_fits(fused, shape):
    assert s3.select_stage_path(F32, *shape, "cuda", fused) == fused
    assert s3.select_stage_path(F32, *shape, "cpu", fused) == fused
    assert s3.stage_kernel_limit(fused, F32, *shape) is None
    assert s3.select_stage_path(F32, *shape, "cuda") != fused  # opt-in only


def test_solver3d_exposes_its_path_and_runs_it():
    """A forced kernel path on the CPU runs the wrappers, which take the
    plain versions there: the same numbers as the plain path."""
    grid = Grid3D(nx=16, ny=16, nz=8, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    params = s3.SimParams3D(heater_duration=0.0125)
    solvers = {p: s3.make_solver3d(grid, params, dtype=F32, device="cpu",
                                   fused=None if p == "auto" else p)
               for p in ("auto", "stage", "stage_xy")}
    assert {k: s.path for k, s in solvers.items()} == {
        "auto": "plain", "stage": "stage", "stage_xy": "stage_xy"}
    f = solvers["auto"].init_random(torch.Generator().manual_seed(0), (2,))
    actions = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (2, 8, 8)))
    before = (k3.stage_rk_3d.launches, k3.stage_rk_3d_xy.launches, k3.correct_3d.launches)
    outs = {k: s.env_step(f, actions) for k, s in solvers.items()}
    assert (k3.stage_rk_3d.launches, k3.stage_rk_3d_xy.launches,
            k3.correct_3d.launches) == before
    for name in ("stage", "stage_xy"):
        assert all(torch.equal(a, b) for a, b in zip(outs[name], outs["auto"]))
    with pytest.raises(ValueError, match=r"ny \* nz <= 1024"):
        s3.make_solver3d(Grid3D(nx=64, ny=64, nz=32, lx=4 * np.pi, ly=4 * np.pi, lz=2.0),
                         params, dtype=F32, device="cpu", fused="stage")


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,nx,nz,device_type,want", [
    (F32, 96, 64, "cuda", "fused"),  # K1 on the chip: 230,528 bytes
    (F32, 128, 16, "cuda", "fused"),  # on the chip: 8 columns a warp, one level a lane
    (F32, 128, 224, "cuda", "fused"),  # off the chip: two slabs, 229,376 bytes
    (F32, 128, 64, "cuda", "fused"),  # a cluster of two: the on-chip state does not fit
    (F32, 256, 32, "cuda", "fused"),  # a cluster of two: nx > 128
    (F32, 64, 128, "cuda", "fused"),  # off the chip: nz > 64
    (F32, 96, 65, "cuda", "fused"),
    (F32, 132, 16, "cuda", "fused"),  # a cluster of two
    (F32, 3, 8, "cuda", "fused"),  # the fewest columns the x stencils take
    (F32, 8, 1, "cuda", "fused"),
    (F64, 96, 64, "cuda", "plain"),
    (F64, 256, 256, "cuda", "plain"),
    (F32, 96, 64, "cpu", "plain"),
    (F32, 256, 256, "cpu", "plain"),
])
def test_2d_auto_selection(dtype, nx, nz, device_type, want):
    assert s2.select_env_step_path(dtype, nx, nz, device_type) == want


@pytest.mark.parametrize("nx,nz,on_chip", [
    (96, 64, True), (20, 12, True), (128, 16, True), (128, 40, True), (4, 2, True),
    (128, 64, False), (128, 224, False), (256, 32, False), (64, 128, False), (96, 65, False),
    (132, 16, False), (3, 8, False), (8, 1, False),
    (256, 128, False), (2048, 64, False),  # off the chip, the slabs in global scratch
])
def test_2d_kernel_instance(nx, nz, on_chip):
    """Which instance of K1 takes a grid: on the chip within its lane map
    and shared memory; else a thread-block cluster where 2, 4 or 8 CTAs of
    the on-chip layout take nx (``CLUSTERS``); off the chip (the two slabs
    alone in shared memory, the rest in global scratch) elsewhere, its
    slabs in global scratch too where they do not fit a block
    (``GLOBAL_SLABS``)."""
    assert limits.env_step_2d_on_chip(nx, nz) == on_chip
    c = limits.env_step_2d_cluster_size(nx, nz)
    assert c == CLUSTERS.get((nx, nz), 0)
    global_slabs = (nx, nz) in GLOBAL_SLABS
    assert limits.env_step_2d_slabs_on_chip(nx, nz) == (not global_slabs)
    assert limits.env_step_2d_scratch_floats(nx, nz) == (
        0 if on_chip or c else
        (7 if global_slabs else 5) * nx * nz + 2 * nx * (nz + 1))
    if global_slabs:
        assert limits.env_step_2d_smem_bytes(nx, nz) == 0
    assert limits.env_step_2d_smem_bytes(nx, nz) <= limits.SMEM_PER_BLOCK


# the grids of test_2d_kernel_instance whose off-chip slabs, 8 nx nz bytes,
# do not fit a block
GLOBAL_SLABS = {(256, 128), (2048, 64)}


# the grids of test_2d_kernel_instance that K1's cluster instance takes, and
# its CTAs a cluster
CLUSTERS = {(128, 64): 2, (256, 32): 2, (132, 16): 2}


@pytest.mark.parametrize("nx,nz,instance", [
    (96, 64, "specialised"),  # the compile-time march: 99,072 bytes, two blocks an SM
    (20, 12, "runtime"), (128, 16, "runtime"), (4, 2, "runtime"),
    (128, 64, "runtime"),  # the march at its edge: 132,096 bytes, where K1 runs off the chip
    (128, 40, "runtime"),
    (96, 80, "general"),  # nz > 64
    (128, 224, "general"), (256, 32, "general"), (64, 128, "general"), (96, 65, "general"),
    (132, 16, "general"),  # nx > 128
    (3, 8, "general"),  # nx = 3 < 4
    (8, 1, "general"),  # nz = 1 < 2
])
def test_2d_tendency_kernel_instance(nx, nz, instance):
    """Which instance of K2 takes a grid that the 2D path sends to the
    kernels: the march where K1's warp and lane layout holds (compile-time
    sizes at 96x64), the general instance (pHY' in global scratch)
    elsewhere."""
    assert s2.select_env_step_path(F32, nx, nz, "cuda") == "fused"
    assert limits.tendencies_2d_instance(nx, nz) == instance
    march = instance != "general"
    assert limits.tendencies_2d_on_march(nx, nz) == march
    assert limits.tendencies_2d_scratch_floats(nx, nz) == (0 if march else nx * nz)
    assert limits.tendencies_2d_smem_bytes(nx, nz) == (
        4 * (3 * nx * nz + nx * (nz + 1) + nx) if march else 0)
    assert limits.tendencies_2d_smem_bytes(nx, nz) <= 132_096


@pytest.mark.parametrize("shape,march", [
    (TRAINING, True),  # the specialised march instance: 512 threads, 78,848 bytes
    ((30, 32, 16), True),  # 16x32x30, where auto takes the field path
    ((6, 32, 16), True), ((5, 8, 8), True), ((6, 12, 20), True),
    ((4, 4, 2), True),  # the smallest grid of K3's rule
    ((16, 512, 2), True),  # 1024 points an x-plane
    ((3, 32, 16), False),  # nx = 3 < 4
    ((8, 3, 16), False),  # ny = 3 < 4
    ((32, 33, 32), False), ((4, 34, 32), False), ((32, 3, 365), False),  # ny * nz > 1024
    (BIG, False),  # the big grid, forced
])
def test_field_kernel_instance(shape, march):
    """Which instance of K6 takes a grid of the field path: the march where
    K3's whole-y rule holds, the general one (one thread per point)
    elsewhere; the field path takes every one of these grids."""
    assert s3.stage_kernel_limit("field", F32, *shape) is None
    assert limits.field_tendency_on_march(*shape) == march
    assert march == (s3.stage_kernel_limit("stage", F32, *shape) is None)
    if march:
        assert limits.field_smem_bytes(*shape[1:]) <= limits.SMEM_PER_BLOCK


@pytest.mark.parametrize("nx,nz", [(256, 128), (512, 256), (2048, 64), (256, 256)])
def test_2d_auto_selection_raises_where_k1_does_not_fit(nx, nz):
    """The JAX package runs its fused kernels for every float32 grid; where
    K1's two slabs (262,144 bytes at 256x128) exceed a block, its off-chip
    instance keeps them in global scratch, so auto takes K1 there too. It
    refuses only an env past K1's 32-bit offsets."""
    assert limits.env_step_2d_slabs_on_chip(nx, nz) is False
    assert s2.select_env_step_path(F32, nx, nz, "cuda") == "fused"
    with pytest.raises(NotImplementedError, match="32-bit offsets"):
        s2.select_env_step_path(F32, 65_536, 4096, "cuda")


@pytest.mark.parametrize("nx,nz", [(2, 64), (1, 8)])
def test_2d_auto_selection_raises_outside_k1s_grid_rule(nx, nz):
    """K1's x stencils wrap once, so it needs nx >= 3 (as does the plain
    version, whose stencils slice three columns)."""
    with pytest.raises(NotImplementedError, match=r"nx >= 3"):
        s2.select_env_step_path(F32, nx, nz, "cuda")
    assert s2.select_env_step_path(F64, nx, nz, "cuda") == "plain"


def test_2d_forced_selection():
    for device_type in ("cuda", "cpu"):
        assert s2.select_env_step_path(F32, 96, 64, device_type, True) == "fused"
        assert s2.select_env_step_path(F32, 128, 224, device_type, True) == "fused"
        assert s2.select_env_step_path(F32, 96, 64, device_type, False) == "plain"
        assert s2.select_env_step_path(F32, 256, 256, device_type, True) == "fused"
        with pytest.raises(ValueError, match="32-bit offsets") as err:
            s2.select_env_step_path(F32, 65_536, 4096, device_type, True)
        assert "2,147,483,647" in str(err.value)
        with pytest.raises(ValueError, match="float32"):
            s2.select_env_step_path(F64, 96, 64, device_type, True)
        with pytest.raises(ValueError, match="unknown fused"):
            s2.select_env_step_path(F32, 96, 64, device_type, "stage")
    assert limits.env_step_2d_smem_bytes(96, 64) == 230_528
    # a CTA of two: 64 columns and its rows of F and G
    assert limits.env_step_2d_smem_bytes(128, 64) == 230_144
    assert limits.env_step_2d_smem_bytes(128, 224) == 229_376  # off the chip: 8 nx nz


def test_solver2d_exposes_its_path_and_runs_it():
    grid = Grid2D(nx=32, nz=16, lx=2 * np.pi, lz=2.0)
    params = s2.SimParams2D(heater_duration=0.06)
    fused = s2.make_solver2d(grid, params, dtype=F32, device="cpu", fused=True)
    plain = s2.make_solver2d(grid, params, dtype=F32, device="cpu")
    assert (fused.path, plain.path) == ("fused", "plain")
    f = plain.init_random(torch.Generator().manual_seed(1), (2,))
    actions = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (2, 12)))
    before = (k2.env_step_2d.launches, k2.tendencies_2d.launches)
    for a, b in zip(fused.env_step(f, actions), plain.env_step(f, actions)):
        assert torch.equal(a, b)
    bottom = plain.heater_profile(actions)
    for a, b in zip(fused.substep(f, bottom), plain.substep(f, bottom)):
        assert torch.equal(a, b)
    assert (k2.env_step_2d.launches, k2.tendencies_2d.launches) == before
