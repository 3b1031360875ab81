"""The packed constants of K1's TF32 instances at 96x64
(``ops.poisson.k1_tf32_constants``), held to the layout their kernel reads
(``k1_tf32_*``, ``k1_bcore_index`` and ``k1_afrag_index`` in
``csrc/rbc2d.cu``, written out again here) and to the rounding rule of its
products: at 3 passes hi is the value with its low 13 mantissa bits
cleared and lo = x - hi rounded to TF32, at 1 pass the value rounded to
TF32, to nearest with ties away from zero (``cvt.rna.tf32.f32``). Pure
torch and numpy, no kernel."""

import numpy as np
import pytest
import torch

from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.ops.poisson import k1_tf32_constants, spectral_constants_2d
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

NX, NZ, N = 96, 64, 24  # the grid, and a warpgroup's modes or columns
ROWS = N * NX  # one part of a warpgroup's rows of F or G


def spectral():
    return spectral_constants_2d(NX, NZ, 2 * np.pi / NX, 2.0 / NZ, torch.float32, "cpu")


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


def frag(row, k, h):
    """A's element (row, k), lane 4 (row % 8) + k % 4 of warp row // 16 at
    k-step k // 8, register (row % 16) // 8 + 2 ((k % 8) // 4), each lane's
    h parts of four values in a row."""
    lane = 4 * (row % 8) + k % 4
    return (((k // 8) * 4 + row // 16) * 32 + lane) * 4 * h + (row % 16) // 8 + 2 * ((k % 8) // 4)


def unpack(packed: torch.Tensor, passes: int) -> dict:
    """Each constant's parts read back from the pack at the kernel's offsets."""
    h = 2 if passes == 3 else 1
    v = packed.numpy()
    a, b = np.meshgrid(np.arange(NX), np.arange(NX), indexing="ij")  # (row, k) of F and G
    g, r = a // N, a % N
    if passes == 1:  # [g][F_g | G_g]
        f_at = [g * 2 * ROWS + core(r, b, NX)]
        g_at = [g * 2 * ROWS + ROWS + core(r, b, NX)]
    else:  # [g][F_g hi | F_g lo], then [g][G_g hi | G_g lo]
        f_at = [g * 2 * ROWS + p * ROWS + core(r, b, NX) for p in range(2)]
        g_at = [8 * ROWS + g * 2 * ROWS + p * ROWS + core(r, b, NX) for p in range(2)]
    j, z = np.meshgrid(np.arange(NZ), np.arange(NZ), indexing="ij")
    ct_at, st_at = 8 * ROWS * h, 8 * ROWS * h + NZ * NZ * h
    out = {"f": [v[i] for i in f_at], "g": [v[i] for i in g_at],
           # A of product 2 is ct^T, row j and k z: read at [j][z], it is ct^T;
           # A of product 3 is st^T, row z and k j: read at [j][z], it is st
           "ct": [v[ct_at + frag(j, z, h) + 4 * p].T for p in range(h)],
           "st": [v[st_at + frag(z, j, h) + 4 * p] for p in range(h)]}
    # dinv in product 2's accumulator order: [g][w][lane][4 jb + 2 hh + e]
    gg, w, lane, acc = np.meshgrid(np.arange(4), np.arange(4), np.arange(32), np.arange(12),
                                   indexing="ij")
    m = N * gg + 8 * (acc // 4) + 2 * (lane % 4) + acc % 2
    jj = 16 * w + lane // 4 + 8 * ((acc // 2) % 2)
    d = np.zeros((NX, NZ), np.float32)
    d[m, jj] = v[st_at + NZ * NZ * h + ((gg * 4 + w) * 32 + lane) * 12 + acc]
    out["dinv"] = d
    assert packed.numel() == st_at + NZ * NZ * h + NX * NZ
    return out


@pytest.mark.parametrize("passes", [1, 3])
def test_k1_tf32_constants_layout_and_rounding(passes):
    """Unpacked at the kernel's offsets, F, G, ct, st come back as their
    TF32 parts bit for bit, and dinv as it is."""
    sp = spectral()
    packed = k1_tf32_constants(sp, passes)
    assert packed.dtype == torch.float32 and packed.device == sp.f.device
    got = unpack(packed, passes)
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
    """Only the 96x64 grid at 1 or 3 passes has a wgmma instance."""
    assert limits.env_step_2d_wgmma(NX, NZ, 3) and limits.env_step_2d_wgmma(NX, NZ, 1)
    assert not limits.env_step_2d_wgmma(NX, NZ, 0) and not limits.env_step_2d_wgmma(128, 64, 3)
    with pytest.raises(ValueError, match="passes"):
        k1_tf32_constants(spectral(), 0)
    other = spectral_constants_2d(128, 64, 2 * np.pi / 128, 2.0 / 64, torch.float32, "cpu")
    with pytest.raises(ValueError, match="96x64"):
        k1_tf32_constants(other, 3)
