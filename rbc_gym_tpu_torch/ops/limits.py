"""What each hand-written kernel asks of a block, and what the card gives.

The selection rules of ``sim/solver2d.py`` and ``sim/solver3d.py`` decide
from these numbers alone whether a kernel can take a configuration. The
launchers in ``csrc/`` compute the same byte counts and refuse a launch
that does not fit; ``tests/test_torch_kernels2d_host.py`` and
``tests/test_torch_kernels3d_host.py`` hold the formulas against the
compiled launchers.
"""

from __future__ import annotations

# Shared memory one block may ask for on an H100 (sm_90): 227 KB.
SMEM_PER_BLOCK = 232_448

MAX_THREADS = 1024  # threads a block may have; K3 runs one per point of an x-plane
MAX_ENV_POINTS = 2**31 - 1  # K6's and K7's offsets within an env are 32-bit (INT_MAX)
Y_BLK = 8  # y rows a K5 block owns (kYT)
XY_MIN_NX = 4  # K3's and K5's plane indices -4..nx+3 wrap x once (kXYMinNx)
XY_RING = 8  # x-planes of u, v, w, b a K3 or K5 block holds (kRing)


K1_MIN_NX = 3  # K1's x stencils wrap once (csrc/rbc2d.cu kK1MinNx)
K1_MAX_NZ = 64  # z levels of an on-chip K1 column: two per lane (kK1MaxNz)
K1_MAX_NX = 128  # x columns on the chip: at most 8 per warp of 16 (kK1MaxCols)


def _on_chip_smem_bytes(nx: int, nz: int) -> int:
    return 4 * (2 * (2 * nx * nz + nx * (nz + 1)) + 2 * nx * nz + 2 * nz * nz + nx)


def env_step_2d_on_chip(nx: int, nz: int) -> bool:
    """Whether K1's on-chip instance takes the grid (``env_step_2d_on_chip``
    in ``csrc/rbc2d.cu``): 4 <= nx <= 128, 2 <= nz <= 64 and its shared
    memory in a block; every other grid runs the off-chip instance."""
    return (4 <= nx <= K1_MAX_NX and 2 <= nz <= K1_MAX_NZ
            and _on_chip_smem_bytes(nx, nz) <= SMEM_PER_BLOCK)


K1_WGMMA_GRID = (96, 64)  # (nx, nz) of K1's TF32 instances whose solve runs on wgmma


def env_step_2d_wgmma(nx: int, nz: int, passes: int) -> bool:
    """Whether K1's instance with ``passes`` TF32 passes runs its solve on
    wgmma (``k1_wgmma`` in ``csrc/rbc2d.cu``): the on-chip TF32 instances at
    96x64, which read their constants packed by
    ``ops.poisson.k1_tf32_constants``."""
    return passes in (1, 3) and (nx, nz) == K1_WGMMA_GRID


K1_MAX_CLUSTER = 8  # CTAs of K1's cluster instance: the portable cluster size (kK1MaxCluster)


def env_step_2d_cluster_size(nx: int, nz: int) -> int:
    """The CTAs of K1's cluster instance on a grid the on-chip instance
    cannot hold (``env_step_2d_cluster_size`` in ``csrc/rbc2d.cu``): the
    smallest c of 2, 4 and 8 that divides nx and whose slab of nx / c
    columns the on-chip layout takes (at least 4 columns, at most 8 a warp,
    2 <= nz <= 64, its shared memory in a block); 0 on the on-chip
    instance's grids and where no c does (the off-chip instance's)."""
    if env_step_2d_on_chip(nx, nz):
        return 0
    c = 2
    while c <= K1_MAX_CLUSTER:
        if (nx % c == 0 and 4 <= nx // c <= K1_MAX_NX and 2 <= nz <= K1_MAX_NZ
                and _on_chip_smem_bytes(nx // c, nz) <= SMEM_PER_BLOCK):
            return c
        c *= 2
    return 0


def env_step_2d_cluster_fg(nx: int, nz: int) -> bool:
    """Whether a CTA of K1's cluster instance also holds its rows of F and G
    (2 (nx / c) nx floats) beside its state (``env_step_2d_cluster_fg``):
    where they fit a block (128x64; not 192x64 or 256x64)."""
    c = env_step_2d_cluster_size(nx, nz)
    return bool(c) and _on_chip_smem_bytes(nx // c, nz) + 8 * (nx // c) * nx <= SMEM_PER_BLOCK


def env_step_2d_slabs_on_chip(nx: int, nz: int) -> bool:
    """Whether K1 keeps its two (nx, nz) slabs in shared memory
    (``env_step_2d_slabs_on_chip`` in ``csrc/rbc2d.cu``): on the chip and on
    a cluster always; the off-chip instance where 8 nx nz bytes fit a block
    (127x64, 128x224), in per-env global scratch elsewhere (256x128,
    2048x64)."""
    return (env_step_2d_on_chip(nx, nz) or bool(env_step_2d_cluster_size(nx, nz))
            or 8 * nx * nz <= SMEM_PER_BLOCK)


def env_step_2d_smem_bytes(nx: int, nz: int) -> int:
    """K1's shared memory per block (``env_step_2d_smem_floats``), float32:
    on the chip two copies of u, b (nx, nz) and w (nx, nz + 1), two (nx, nz)
    slabs, the z analysis and synthesis (nz, nz) and the bottom profile; on
    a cluster of c CTAs the same over nx / c columns a CTA, and the CTA's
    rows of F and G where they fit (``env_step_2d_cluster_fg``); off both
    the two slabs alone where they fit (``env_step_2d_slabs_on_chip``),
    else none."""
    if env_step_2d_on_chip(nx, nz):
        return _on_chip_smem_bytes(nx, nz)
    c = env_step_2d_cluster_size(nx, nz)
    if not c:
        return 8 * nx * nz if env_step_2d_slabs_on_chip(nx, nz) else 0
    return _on_chip_smem_bytes(nx // c, nz) + (8 * (nx // c) * nx
                                               if env_step_2d_cluster_fg(nx, nz) else 0)


def env_step_2d_scratch_floats(nx: int, nz: int) -> int:
    """K1's global scratch per env (``env_step_2d_scratch_floats``): none on
    the chip or a cluster; off both gu, gw, gb of this stage and the
    previous one, and pHY', then the two slabs where they do not fit a
    block."""
    if env_step_2d_on_chip(nx, nz) or env_step_2d_cluster_size(nx, nz):
        return 0
    slabs = 0 if env_step_2d_slabs_on_chip(nx, nz) else 2 * nx * nz
    return 5 * nx * nz + 2 * nx * (nz + 1) + slabs


MAX_INT32 = 2**31 - 1


def env_step_2d_offsets_fit(nx: int, nz: int) -> bool:
    """Whether K1's 32-bit offsets reach an env's fields and scratch
    (``env_step_2d_offsets_fit``): 9 nx (nz + 1) <= INT_MAX."""
    return 9 * nx * (nz + 1) <= MAX_INT32


K2_SPECIALISED = (96, 64)  # (nx, nz) of K2's compile-time march instance


def _tendencies_march_smem_bytes(nx: int, nz: int) -> int:
    return 4 * (3 * nx * nz + nx * (nz + 1) + nx)


def tendencies_2d_on_march(nx: int, nz: int) -> bool:
    """Whether K2's march takes the grid (``tendencies_on_march`` in
    ``csrc/rbc2d.cu``): K1's warp and lane layout, 4 <= nx <= 128 and
    2 <= nz <= 64, and its shared memory in a block."""
    return (4 <= nx <= K1_MAX_NX and 2 <= nz <= K1_MAX_NZ
            and _tendencies_march_smem_bytes(nx, nz) <= SMEM_PER_BLOCK)


def tendencies_2d_instance(nx: int, nz: int) -> str:
    """The instance of K2 that its launcher runs on a grid: "specialised"
    (the march at 96x64), "runtime" (the march at runtime sizes) or
    "general" (pHY' in global scratch, one point a thread)."""
    if not tendencies_2d_on_march(nx, nz):
        return "general"
    return "specialised" if (nx, nz) == K2_SPECIALISED else "runtime"


def tendencies_2d_smem_bytes(nx: int, nz: int) -> int:
    """K2's shared memory per block (``tendencies_2d_smem_floats``), float32:
    on the march b, pHY', u (nx, nz), w (nx, nz + 1) and the bottom
    profile; none for the general instance."""
    return _tendencies_march_smem_bytes(nx, nz) if tendencies_2d_on_march(nx, nz) else 0


def tendencies_2d_scratch_floats(nx: int, nz: int) -> int:
    """K2's global scratch per env (``tendencies_2d_scratch_floats``): none
    on the march, pHY' (nx, nz) for the general instance."""
    return 0 if tendencies_2d_on_march(nx, nz) else nx * nz


def stage_smem_bytes(ny: int, nz: int) -> int:
    """K3's x-plane rings, every plane all ny rows: ``XY_RING`` planes of u,
    v, b of nz and of w of nz + 1, two planes of q, four of pHY', v* and w*
    of one plane, and the y fluxes of u, v, w, b of two planes
    (``stage_smem_floats``): 4 ny (48 nz + 9)."""
    return 4 * ny * ((3 * XY_RING + 2 + 4 + 1 + 8) * nz + (XY_RING + 1) * (nz + 1))


def stage_qp_smem_bytes(nx: int, ny: int, nz: int) -> int:
    """K3's analysis instance: K3's rings, then the divergence of one
    x-plane and Cz^T (nz, nz), and at least one thread's nx values of t for
    the x-factor after the march (``stage_qp_smem_floats``): max(K3's + 4
    (ny nz + nz^2), 4 nx)."""
    return max(stage_smem_bytes(ny, nz) + 4 * (ny * nz + nz * nz), 4 * nx)


def field_smem_bytes(ny: int, nz: int) -> int:
    """K6's march instance, for every field: ``XY_RING`` x-planes of u, v, b
    of nz and of w of nz + 1, four of pHY' and the field's y fluxes of two
    planes, every plane all ny rows (``field_smem_floats``): 4 ny (38 nz + 8)."""
    return 4 * ny * ((3 * XY_RING + 4 + 2) * nz + XY_RING * (nz + 1))


def field_tendency_on_march(nx: int, ny: int, nz: int) -> bool:
    """Whether K6 takes the grid with its march instance (``field_on_march``
    in ``csrc/rbc3d.cu``): K3's whole-y rule, nx >= 4, ny >= 4, nz >= 2,
    ny * nz <= 1024 and its shared memory in a block. Every other grid of
    the field path runs K6's general instance (one thread per point)."""
    return (nx >= XY_MIN_NX and ny >= 4 and nz >= 2 and ny * nz <= MAX_THREADS
            and field_smem_bytes(ny, nz) <= SMEM_PER_BLOCK)


# The largest x-plane, ny * nz points, that the 3D path rule gives a whole-y
# path (K3, or the per-field path where K3 cannot take it). It stands where
# the JAX package's VMEM ceiling, (nz + 1) ny <= 1088
# (rbc_gym_tpu/sim/solver3d.py:335), stands in its rule, and it is the
# largest ny * nz the port's rule has taken whole-y (3 x 365), so that no
# grid leaves the whole-y paths.
WHOLE_Y_MAX_POINTS = 1096


def whole_y_fits(ny: int, nz: int) -> bool:
    """Where the path rule takes a whole-y path: ny * nz <= ``WHOLE_Y_MAX_POINTS``."""
    return ny * nz <= WHOLE_Y_MAX_POINTS


def stage_xy_smem_bytes(nz: int) -> int:
    """K5's x-plane rings: ``XY_RING`` planes of u (y_blk + 6 rows), v
    (y_blk + 7) and b (y_blk + 6) of nz and of w (y_blk + 6) of nz + 1, two
    planes of q (y_blk + 8 rows), four of pHY' (y_blk + 2), and v* (y_blk + 1
    rows) and w* (y_blk) of one plane (``stage_xy_smem_floats``)."""
    rows_nz = XY_RING * (3 * Y_BLK + 19) + 2 * (Y_BLK + 8) + 4 * (Y_BLK + 2) + Y_BLK + 1
    rows_nw = XY_RING * (Y_BLK + 6) + Y_BLK
    return 4 * (rows_nz * nz + rows_nw * (nz + 1))


XY_SPLIT_HALO = 4  # levels a CTA of K5's z split holds past its own on each inner side (kSplitHalo)
XY_MAX_SPLIT = 8  # CTAs of K5's z split: the portable cluster size (kXYMaxSplit)
XY_PH_ROWS = Y_BLK + 2  # rows of K5's pHY' planes, one column each (kPRows)


def _split_part(nz: int, c: int) -> int:
    return -(-nz // c)


def stage_xy_split_levels(nz: int, c: int) -> int:
    """The most levels a CTA of K5's z split over ``c`` CTAs holds
    (``split_levels``): CTA r owns [r p, (r + 1) p) of the column (p =
    ceil(nz / c), the last part shorter) and holds ``XY_SPLIT_HALO`` more on
    each inner side."""
    part = _split_part(nz, c)
    return max(min(min(z0 + part, nz) + XY_SPLIT_HALO, nz) - max(z0 - XY_SPLIT_HALO, 0)
               for z0 in range(0, c * part, part))


def stage_xy_split_threads(nz: int, c: int) -> int:
    """Threads of a split CTA (``split_threads``): rows 0..y_blk of p + 1
    levels, the last the face above its part."""
    return (Y_BLK + 1) * (_split_part(nz, c) + 1)


def stage_xy_split_smem_bytes(nz: int, c: int) -> int:
    """A split CTA's shared memory (``stage_xy_split_smem_floats``): two
    planes' partial sums of pHY' (``XY_PH_ROWS`` float64 each), then K5's
    rings over the levels it holds."""
    return 16 * XY_PH_ROWS + stage_xy_smem_bytes(stage_xy_split_levels(nz, c))


def stage_xy_split_size(nz: int) -> int:
    """The CTAs of K5's z split for a column of nz levels
    (``stage_xy_split_size`` in ``csrc/rbc3d.cu``): 0 where one CTA holds it
    (its rings in a block and (y_blk + 1) nz <= 1024 threads: nz <= 106),
    else the smallest c of 2, 4 and 8 whose parts are all non-empty and
    whose CTAs' threads and shared memory fit; 0 where none does (nz >
    784)."""
    if stage_xy_smem_bytes(nz) <= SMEM_PER_BLOCK and (Y_BLK + 1) * nz <= MAX_THREADS:
        return 0
    c = 2
    while c <= XY_MAX_SPLIT:
        if ((c - 1) * _split_part(nz, c) < nz and stage_xy_split_threads(nz, c) <= MAX_THREADS
                and stage_xy_split_smem_bytes(nz, c) <= SMEM_PER_BLOCK):
            return c
        c *= 2
    return 0
