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


def _on_chip_smem_bytes(nx: int, nz: int, ld: int | None = None, g: int = 0) -> int:
    """K1's on-chip layout (``on_chip_smem_floats``); with ``ld`` its columns
    ld floats apart (w's ld + 1), the z transforms' rows ld apart and g ghost
    columns each side of the state's fields (``k1_padded_smem_floats``)."""
    ld = nz if ld is None else ld
    return 4 * (2 * (2 * (nx + 2 * g) * ld + (nx + 2 * g) * (ld + 1)) + 2 * nx * ld
                + 2 * nz * ld + nx)


def env_step_2d_on_chip(nx: int, nz: int) -> bool:
    """Whether K1's on-chip instance takes the grid (``env_step_2d_on_chip``
    in ``csrc/rbc2d.cu``): 4 <= nx <= 128, 2 <= nz <= 64 and its shared
    memory in a block; every other grid runs the off-chip instance."""
    return (4 <= nx <= K1_MAX_NX and 2 <= nz <= K1_MAX_NZ
            and _on_chip_smem_bytes(nx, nz) <= SMEM_PER_BLOCK)


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


def env_step_2d_bucket(nx: int, nz: int, passes: int) -> tuple[int, int, int] | None:
    """The runtime-size bucket K1's launcher runs a grid on (``k1_bucket`` in
    ``csrc/rbc2d.cu``), as (columns a warp, levels a lane, column stride)
    of a block of nxl columns (nx on the chip, nx / c a CTA on a cluster);
    a stride of 0 is nz, at runtime, and a compile-time one pads each
    column past nz. In float32 (``passes`` 0) on the chip: nz <= 32 (8, 1,
    32); nz <= 48 (8, 2, 48); nz <= 64 (4, 2, 64) where nx <= 64; else (8,
    2, 0); on a cluster (8, 1, 0) where nz <= 32, else (8, 2, 0). At TF32
    (8, 2, 0) on the chip and on a cluster. None where a compile-time instance takes
    the grid (float32 96x64 and a cluster's 64 or 96 columns of 64 levels;
    at TF32 the wgmma grids) or the off-chip instance does."""
    c = env_step_2d_cluster_size(nx, nz)
    if not c and not env_step_2d_on_chip(nx, nz):
        return None
    nxl = nx // c if c else nx
    if passes:
        compiled = ((nxl, nz) in K1_CLUSTER_WGMMA_SLABS if c else (nx, nz) in K1_WGMMA_GRIDS)
    else:
        compiled = (nxl, nz) in ((64, 64), (96, 64)) if c else (nx, nz) == (96, 64)
    if compiled:
        return None
    if c or passes:
        return (8, 1 if not passes and nz <= 32 else 2, 0)
    if nz <= 32:
        return (8, 1, 32)
    if nz <= 48:
        return (8, 2, 48)
    return (4, 2, 64) if nx <= 64 else (8, 2, 0)


# K1's TF32 instances whose solve runs on wgmma (``k1_wgmma`` and
# ``k1_cluster_wgmma`` in ``csrc/rbc2d.cu``): the on-chip grids (nx, nz), and
# a cluster CTA's columns and levels (nx / c, nz)
K1_WGMMA_GRIDS = ((96, 64), (64, 64), (128, 32))
K1_CLUSTER_WGMMA_SLABS = ((64, 64), (96, 64))


def env_step_2d_wgmma(nx: int, nz: int, passes: int) -> bool:
    """Whether K1's instance with ``passes`` TF32 passes runs its solve on
    wgmma (``env_step_2d_wgmma`` in ``csrc/rbc2d.cu``), reading its constants
    packed by ``ops.poisson.k1_tf32_constants``: the on-chip instance at
    96x64, 64x64 and 128x32 (``K1_WGMMA_GRIDS``), the cluster's where a
    CTA's columns are 64 or 96 of 64 levels (``K1_CLUSTER_WGMMA_SLABS``:
    128x64 and 256x64, 192x64)."""
    if passes not in (1, 3):
        return False
    c = env_step_2d_cluster_size(nx, nz)
    if c:
        return (nx // c, nz) in K1_CLUSTER_WGMMA_SLABS
    return env_step_2d_on_chip(nx, nz) and (nx, nz) in K1_WGMMA_GRIDS


def env_step_2d_packed(nx: int, nz: int, passes: int) -> bool:
    """Whether K1's instance with ``passes`` TF32 passes reads its solve's
    constants packed on the host by ``ops.poisson.k1_tf32_constants``
    (``env_step_2d_packed`` in ``csrc/rbc2d.cu``): the wgmma instances
    (``env_step_2d_wgmma``) and the on-chip runtime-size TF32 one, whose x
    products stage F's and G's packs through shared memory."""
    return env_step_2d_wgmma(nx, nz, passes) or (passes in (1, 3)
                                                  and env_step_2d_on_chip(nx, nz))


def k1_wgmma_chunk(nxl: int, nz: int, passes: int) -> int:
    """F's or G's columns a chunk of a wgmma instance's ring over ``nxl``
    columns of ``nz`` levels a block (``k1_wg_chunk``): the widest of nxl,
    nxl / 2, ... whose eight slots (two a warpgroup) fit the dead state copy
    or a region of their own beside the rest of the block's shared memory."""
    parts = 2 if passes == 3 else 1
    nc = nxl * nz
    base = 4 * (2 * (2 * nc + nxl * (nz + 1)) + 2 * nc + nxl) + 8 * 8  # and 8 mbarriers
    kc = nxl
    while kc > 8:
        ring = 8 * parts * (nxl // 4) * kc
        if ring <= nxl * (3 * nz + 1) or base + 4 * ring <= SMEM_PER_BLOCK:
            break
        kc //= 2
    return kc


def env_step_2d_cluster_fg(nx: int, nz: int) -> bool:
    """Whether a CTA of K1's cluster instance also holds its rows of F and G
    (2 (nx / c) nx floats) beside its state (``env_step_2d_cluster_fg``):
    where they fit a block (128x64; not 192x64 or 256x64)."""
    c = env_step_2d_cluster_size(nx, nz)
    return bool(c) and _on_chip_smem_bytes(nx // c, nz) + 8 * (nx // c) * nx <= SMEM_PER_BLOCK


# K1's off-chip instance's own shared memory (``kGSmemFloats`` in
# ``csrc/rbc2d.cu``): its products' ring of two stages, each the larger of
# its two tiles' (``GTile``: a 256 x 16 chunk of the left operand and a 16 x
# 128 one of the right in padded rows, 256 x 20 + 16 x 136 floats; the
# narrow 128 x 36 + 32 x 72), and each warp's carries (84 floats) and ring
# of eight columns of u, w and b, 40 levels each, of its march (16 warps).
K1_OFF_CHIP_SMEM_BYTES = 4 * (2 * (256 * 20 + 16 * 136) + 16 * (84 + 8 * 3 * 40))


def env_step_2d_slabs_on_chip(nx: int, nz: int) -> bool:
    """Whether K1 keeps its two (nx, nz) slabs in shared memory
    (``env_step_2d_slabs_on_chip`` in ``csrc/rbc2d.cu``): on the chip and on
    a cluster always; the off-chip instance where 8 nx nz bytes fit a block
    beside its own ``K1_OFF_CHIP_SMEM_BYTES`` (nx nz <= 13,408: 127x64), in
    per-env global scratch elsewhere (128x224, 256x128, 2048x64)."""
    return (env_step_2d_on_chip(nx, nz) or bool(env_step_2d_cluster_size(nx, nz))
            or K1_OFF_CHIP_SMEM_BYTES + 8 * nx * nz <= SMEM_PER_BLOCK)


def env_step_2d_smem_bytes(nx: int, nz: int) -> int:
    """K1's shared memory per block (``env_step_2d_smem_floats``), float32:
    on the chip two copies of u, b (nx, nz) and w (nx, nz + 1), two (nx, nz)
    slabs, the z analysis and synthesis (nz, nz) and the bottom profile,
    each column padded to its bucket's stride (``env_step_2d_bucket``) and,
    at a compile-time stride, three ghost columns each side of the state's
    fields; on
    a cluster of c CTAs the same over nx / c columns a CTA, and the CTA's
    rows of F and G where they fit (``env_step_2d_cluster_fg``); off both
    ``K1_OFF_CHIP_SMEM_BYTES`` and the two slabs where they fit
    (``env_step_2d_slabs_on_chip``)."""
    if env_step_2d_on_chip(nx, nz):
        ld = (env_step_2d_bucket(nx, nz, 0) or (0, 0, 0))[2]
        return _on_chip_smem_bytes(nx, nz, ld or nz, 3 if ld else 0)
    c = env_step_2d_cluster_size(nx, nz)
    if not c:
        return K1_OFF_CHIP_SMEM_BYTES + (8 * nx * nz if env_step_2d_slabs_on_chip(nx, nz) else 0)
    return _on_chip_smem_bytes(nx // c, nz) + (8 * (nx // c) * nx
                                               if env_step_2d_cluster_fg(nx, nz) else 0)


def env_step_2d_scratch_floats(nx: int, nz: int) -> int:
    """K1's global scratch per env (``env_step_2d_scratch_floats``): none on
    the chip or a cluster; off both a second copy of u, w, b and the
    tendencies gu, gw, gb, then the two slabs where they are not in shared
    memory."""
    if env_step_2d_on_chip(nx, nz) or env_step_2d_cluster_size(nx, nz):
        return 0
    slabs = 0 if env_step_2d_slabs_on_chip(nx, nz) else 2 * nx * nz
    return 4 * nx * nz + 2 * nx * (nz + 1) + slabs


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


# K3's and K5's runtime-size buckets (``stage_bucket``, ``stage_xy_bucket``
# and ``kPhSegs`` in ``csrc/rbc3d.cu``): a grid off the compile-time
# instances runs the runtime-size layout (nz lanes a row) with its rings'
# rows a compile-time stride apart, where that measured faster than the
# runtime-size instance (PERF.md, section 6); K3's buckets keep
# ``K3_PH_SEGS`` float64 pHY' totals a row
K3_PH_SEGS = 5
SMEM_PER_SM = 233_472  # an H100 SM's shared memory, each block reserving 1 KB of it


def smem_blocks(nbytes: int) -> int:
    """The blocks an SM a launch of ``nbytes`` of shared memory leaves room
    for (``smem_blocks``)."""
    return SMEM_PER_SM // (nbytes + 1024)


def stage_blocks(ny: int, nz: int, nbytes: int) -> int:
    """The blocks an SM a K3 launch on ny x nz takes with ``nbytes`` of
    shared memory (``stage_blocks``): its ny nz threads hold 64 registers
    each, so 32 warps of an SM's registers."""
    return min(32 // -(-ny * nz // 32), smem_blocks(nbytes))


def stage_bucket_smem_bytes(ny: int, stride: int) -> int:
    """K3's shared memory on a bucket of ``stride`` (``stage_bucket_smem_floats``):
    its rings at the stride, then the pHY' totals (doubles, one float of
    alignment)."""
    return stage_smem_bytes(ny, stride) + 4 * (2 * K3_PH_SEGS * ny + 1)


def stage_bucket(ny: int, nz: int) -> int | None:
    """The bucket K3's launcher runs a grid of its rule on, its stride
    (``stage_bucket`` in ``csrc/rbc3d.cu``): nz itself at nz = 16 and 32
    (the compile-time column with ny at run time) but on the training
    grid's 32 rows of 16 (None: the compile-time instance), else 48 at nz
    33..48, 96 at 65..96 and 128 at 97..128 where its shared memory
    (``stage_bucket_smem_bytes``) fits a block and leaves as many blocks an
    SM (``stage_blocks``) as the runtime-size instance takes; None elsewhere
    (the runtime-size instance)."""
    if nz in (16, 32):
        return None if (ny, nz) == (32, 16) else nz
    stride = 48 if 32 < nz <= 48 else 96 if 64 < nz <= 96 else 128 if 96 < nz <= 128 else None
    if stride is None:
        return None
    nbytes = stage_bucket_smem_bytes(ny, stride)
    fits = nbytes <= SMEM_PER_BLOCK and (
        stage_blocks(ny, nz, nbytes) == stage_blocks(ny, nz, stage_smem_bytes(ny, nz)))
    return stride if fits else None


def stage_xy_bucket(nz: int) -> int | None:
    """The bucket K5's launcher runs a column of nz levels on, its stride
    (``stage_xy_bucket``): 48 at nz 40..48, 96 at 96; None elsewhere (the
    compile-time nz = 16 and 32, the runtime-nz instance, the z split)."""
    return 48 if 40 <= nz <= 48 else 96 if nz == 96 else None


def stage_launch_smem_bytes(ny: int, nz: int) -> int:
    """The shared memory K3's launcher asks for on a grid of its rule
    (``stage_launch_smem_floats``): ``stage_bucket_smem_bytes`` on a bucket
    of a padded stride, else ``stage_smem_bytes``."""
    stride = stage_bucket(ny, nz)
    return stage_smem_bytes(ny, nz) if stride in (None, nz) else stage_bucket_smem_bytes(ny, stride)


def stage_xy_launch_smem_bytes(nz: int) -> int:
    """The shared memory a one-CTA K5 launch asks for
    (``stage_xy_launch_smem_floats``): ``stage_xy_smem_bytes`` at the
    bucket's stride, else at nz."""
    return stage_xy_smem_bytes(stage_xy_bucket(nz) or nz)


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


XY_SPLIT_PART = 32  # levels a CTA of K5's z split owns, a warp's lanes (kSplitPart)
XY_SPLIT_HALO = 4  # levels a CTA of K5's z split holds past its own on each side (kSplitHalo)
XY_SPLIT_WARPS = Y_BLK + 3  # warps of a split CTA: rows 0..y_blk, face z1, pHY' (kSplitWarps)
XY_PH_ROWS = Y_BLK + 2  # rows of K5's pHY' planes, one column each (kPRows)
XY_SPLIT_STAGE = 3 * XY_SPLIT_PART + 1  # levels of a split CTA's staged pHY' rows (kSplitStage)


def stage_xy_split_levels(nz: int, c: int) -> int:
    """The levels a CTA of K5's z split holds, its rings' rows
    (``kSplitLevels``): CTA r owns [32 r, 32 r + 32) of the column (the last
    part shorter) and holds ``XY_SPLIT_HALO`` more on each side, whatever
    nz and c."""
    return XY_SPLIT_PART + 2 * XY_SPLIT_HALO


def stage_xy_split_threads(nz: int, c: int) -> int:
    """Threads of a split CTA (``kSplitThreads``): ``XY_SPLIT_WARPS`` warps."""
    return 32 * XY_SPLIT_WARPS



def stage_xy_split_smem_bytes(nz: int, c: int) -> int:
    """A split CTA's shared memory (``stage_xy_split_smem_floats``): K5's
    rings over the levels it holds, then two planes of its pHY' warp's
    staged rows (``XY_PH_ROWS`` columns of ``XY_SPLIT_STAGE`` levels)."""
    return (stage_xy_smem_bytes(stage_xy_split_levels(nz, c))
            + 4 * 2 * XY_PH_ROWS * XY_SPLIT_STAGE)


def stage_xy_split_size(nz: int) -> int:
    """The CTAs of K5's z split for a column of nz levels
    (``stage_xy_split_size`` in ``csrc/rbc3d.cu``): 0 where one CTA holds it
    (its rings in a block and (y_blk + 1) nz <= 1024 threads: nz <= 106),
    else one a ``XY_SPLIT_PART`` levels, ceil(nz / 32), with no upper bound:
    each CTA's threads and shared memory are the same at every nz."""
    if stage_xy_smem_bytes(nz) <= SMEM_PER_BLOCK and (Y_BLK + 1) * nz <= MAX_THREADS:
        return 0
    return -(-nz // XY_SPLIT_PART)
