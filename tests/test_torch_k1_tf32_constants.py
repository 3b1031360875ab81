"""The packed constants of K1's TF32 instances (``ops.poisson.
k1_tf32_constants``): those on wgmma (on the chip 96x64, 64x64 and 128x32,
on a cluster 64 or 96 columns of 64 levels a CTA) and the on-chip
runtime-size one, held to the layout their kernel reads (``k1_tf32_*``,
``k1_wg_chunk``, ``k1_bcore_index``, ``k1_afrag_index`` and ``k1_rt_step``
in ``csrc/rbc2d.cu``, written out again here) and to the
rounding rule of its products: at 3 passes hi is the value with its low 13
mantissa bits cleared and lo = x - hi rounded to TF32, at 1 pass the value
rounded to TF32, to nearest with ties away from zero (``cvt.rna.tf32.f32``).
Pure torch and numpy, no kernel."""

import numpy as np
import pytest
import torch

from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.ops.poisson import k1_tf32_constants, spectral_constants_2d
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

# (nx, nz, CTAs a cluster (1: on the chip), a chunk's columns at 1 and 3 passes)
GRIDS = [(96, 64, 1, {1: 96, 3: 48}), (64, 64, 1, {1: 64, 3: 64}),
         (128, 32, 1, {1: 64, 3: 32}), (128, 64, 2, {1: 64, 3: 64}),
         (192, 64, 2, {1: 96, 3: 48})]


def spectral(nx, nz):
    return spectral_constants_2d(nx, nz, 2 * np.pi / nx, 2.0 / nz, torch.float32, "cpu")


def rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32: add half of the dropped bits' unit to the
    magnitude's bits, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def parts(x: torch.Tensor, passes: int) -> list:
    if passes == 1:
        return [rna(x)]
    hi = (x.view(torch.int32) & -0x2000).view(torch.float32)
    return [hi, rna(x - hi)]


def core(n, k, depth):
    """B^T's element (n, k): 8 x 4 core matrices of 128 bytes, K-adjacent
    ones 32 floats apart, 8-row groups 8 depth floats apart."""
    return (n // 8) * 8 * depth + (k // 4) * 32 + (n % 8) * 4 + k % 4


def frag(row, k, h, mw):
    """A's element (row, k), lane 4 (row % 8) + k % 4 of warp row // 16 (of
    mw) at k-step k // 8, register (row % 16) // 8 + 2 ((k % 8) // 4), each
    lane's h parts of four values in a row."""
    lane = 4 * (row % 8) + k % 4
    return ((((k // 8) * mw + row // 16) * 32 + lane) * 4 * h + (row % 16) // 8
            + 2 * ((k % 8) // 4))


def unpack(packed: torch.Tensor, nx, nz, c, kc, passes: int) -> dict:
    """Each constant's parts read back from the pack at the kernel's offsets."""
    h = 2 if passes == 3 else 1
    v = packed.numpy()
    nxl = nx // c
    nw, sub, slot = nxl // 4, nxl // kc, h * (nx // c // 4) * kc
    a, b = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")  # (row, column) of F, G
    r, q, n = a // nxl, (a % nxl) // nw, a % nw  # the row's CTA, warpgroup, row of the group
    src = b // nxl  # the column's CTA: chunk j of CTA r holds CTA (r + j // sub) % c's
    j = ((src - r) % c) * sub + (b % nxl) // kc
    at = ((r * (c * sub) + j) * 4 + q) * slot + core(n, b % kc, kc)
    f_at = [at + p * nw * kc for p in range(h)]
    g_at = [h * nx * nx + x for x in f_at]
    jz, z = np.meshgrid(np.arange(nz), np.arange(nz), indexing="ij")
    mw = nz // 16
    ct_at, st_at = 2 * h * nx * nx, 2 * h * nx * nx + nz * nz * h
    out = {"f": [v[i] for i in f_at], "g": [v[i] for i in g_at],
           # A of product 2 is ct^T, row j and k z: read at [j][z], it is ct^T;
           # A of product 3 is st^T, row z and k j: read at [j][z], it is st
           "ct": [v[ct_at + frag(jz, z, h, mw) + 4 * p].T for p in range(h)],
           "st": [v[st_at + frag(z, jz, h, mw) + 4 * p] for p in range(h)]}
    # dinv in product 2's accumulator order: [r][g][w][lane][4 jb + 2 hh + e]
    rr, gg, w, lane, acc = np.meshgrid(np.arange(c), np.arange(4), np.arange(mw), np.arange(32),
                                       np.arange(nw // 2), indexing="ij")
    m = rr * nxl + nw * gg + 8 * (acc // 4) + 2 * (lane % 4) + acc % 2
    level = 16 * w + lane // 4 + 8 * ((acc // 2) % 2)
    d = np.full((nx, nz), np.nan, np.float32)
    d[m, level] = v[st_at + nz * nz * h + (((rr * 4 + gg) * mw + w) * 32 + lane) * (nw // 2) + acc]
    out["dinv"] = d
    assert packed.numel() == st_at + nz * nz * h + nx * nz
    return out


@pytest.mark.parametrize("nx,nz,c,chunk", GRIDS)
@pytest.mark.parametrize("passes", [1, 3])
def test_k1_tf32_constants_layout_and_rounding(passes, nx, nz, c, chunk):
    """Unpacked at the kernel's offsets, F, G, ct, st come back as their
    TF32 parts bit for bit, and dinv as it is; the launcher's cluster and
    chunk are the test's."""
    assert (limits.env_step_2d_cluster_size(nx, nz) or 1) == c
    kc = chunk[passes]
    assert limits.k1_wgmma_chunk(nx // c, nz, passes) == kc
    sp = spectral(nx, nz)
    packed = k1_tf32_constants(sp, passes)
    assert packed.dtype == torch.float32 and packed.device == sp.f.device
    got = unpack(packed, nx, nz, c, kc, passes)
    for name, x in (("f", sp.f), ("g", sp.g), ("ct", sp.dct), ("st", sp.idct)):
        want = parts(x, passes)
        assert len(got[name]) == len(want)
        for p, (y, ref) in enumerate(zip(got[name], want)):
            assert np.array_equal(np.asarray(y).view(np.int32), ref.numpy().view(np.int32)), \
                (name, p)
        # every part TF32-exact, and the parts within TF32's rounding of x
        total = sum(torch.as_tensor(np.ascontiguousarray(y)).double() for y in got[name])
        assert all(not (np.asarray(y).view(np.int32) & 0x1FFF).any() for y in got[name])
        tol = 2.0**-22 if passes == 3 else 2.0**-11
        assert torch.all((total - x.double()).abs() <= tol * x.double().abs()), name
    assert np.array_equal(got["dinv"], sp.dinv.numpy())


def test_k1_tf32_constants_refuses_other_grids_and_passes():
    """Only the instances that read packed constants (the wgmma grids and
    the on-chip runtime-size TF32 instance), at 1 or 3 passes, have a pack:
    not the cluster's runtime-size instance (200x20) nor the off-chip one
    (127x64)."""
    for nx, nz, *_ in GRIDS:
        assert limits.env_step_2d_wgmma(nx, nz, 3) and limits.env_step_2d_wgmma(nx, nz, 1)
        assert not limits.env_step_2d_wgmma(nx, nz, 0)
    assert not limits.env_step_2d_wgmma(128, 40, 3) and not limits.env_step_2d_wgmma(200, 20, 1)
    with pytest.raises(ValueError, match="passes"):
        k1_tf32_constants(spectral(96, 64), 0)
    for nx, nz in ((200, 20), (127, 64)):
        assert not limits.env_step_2d_packed(nx, nz, 3)
        with pytest.raises(ValueError, match=f"no instance with packed constants at {nx}x{nz}"):
            k1_tf32_constants(spectral(nx, nz), 3)


@pytest.mark.parametrize("nx,nz", [(128, 40), (20, 12), (40, 4)])
@pytest.mark.parametrize("passes", [1, 3])
def test_k1_tf32_constants_runtime_layout(passes, nx, nz):
    """The on-chip runtime-size instance's pack (``k1_rt_step`` in
    ``csrc/rbc2d.cu``): F and then G, each [k-step][16-row tile][part]
    [lane][4] in mma.sync's A-fragment order, read back at the kernel's
    offsets as their TF32 parts bit for bit, zero past nx."""
    assert limits.env_step_2d_packed(nx, nz, passes)
    assert not limits.env_step_2d_wgmma(nx, nz, passes)
    h = 2 if passes == 3 else 1
    tiles, steps = -(-nx // 16), -(-nx // 8)
    sp = spectral(nx, nz)
    v = k1_tf32_constants(sp, passes).numpy()
    step = tiles * 128 * h  # floats of a k-step (k1_rt_step)
    assert v.size == 2 * steps * step
    # element (row, k): k-step k // 8, tile row // 16, lane 4 (row % 8) + k % 4,
    # register (row % 16) // 8 + 2 ((k % 8) // 4)
    row, k = np.meshgrid(np.arange(16 * tiles), np.arange(8 * steps), indexing="ij")
    at = ((k // 8) * step + (row // 16) * 128 * h + (4 * (row % 8) + k % 4) * 4
          + (row % 16) // 8 + 2 * ((k % 8) // 4))
    for i, mat in enumerate((sp.f, sp.g)):
        for p, ref in enumerate(parts(mat, passes)):
            got = v[i * steps * step + at + 128 * p]
            assert not got[nx:].any() and not got[:, nx:].any()
            assert np.array_equal(got[:nx, :nx].view(np.int32), ref.numpy().view(np.int32)), \
                (i, p)
