"""Pressure-Poisson solves for the nonhydrostatic fractional step.

Port of ``rbc_gym_tpu.ops.poisson``: each RK3 stage solves

    laplace(p) = div(u*) / dt_stage

with periodic x (and y in 3D) and homogeneous Neumann z.

2D: A real-DFT matrix F along x
diagonalizes the horizontal part; the per-mode vertical operators
A_m = D2z_neumann + lambda_m I are inverted once at setup in float64 numpy
(the singular mean mode takes the pseudo-inverse, i.e. the zero-mean
solution). The solve is then three products: F.rhs, the per-mode inverse,
and the synthesis G.p_hat. The constants are the same float64 formulas as
the JAX package's, so both packages start from identical numbers.

3D: fully spectral (real DFT in x and y, DCT-II in z), so the vertical
solve is an elementwise reciprocal in (kx, ky, kz) space. The solve works
in the *solve layout* (E, ny, nx, nz): y is a row index and the merged
(x, z) axis is contiguous, so each (x, z) transform is one GEMM over
E * ny rows and each y transform one batched product. The stage kernel
writes its divergence in this layout and reads the solve's result in it,
so no field is permuted between stages.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Products at a precision (both solves)
# ---------------------------------------------------------------------------

# The precisions of a solve's products (``matmul``): the JAX package's
# ``jax.lax.Precision`` names of its XLA-side products, which its 3D solver
# takes as ``poisson_precision`` and its 2D solver maps its own names onto
# (sim/solver2d.py); None and "highest" are one.
MATMUL_PRECISIONS = (None, "highest", "high", "default")

# The low mantissa bits that TF32 (10 explicit bits) drops from a float32 (23).
_TF32_DROPPED_BITS = 13


def check_precision(precision) -> None:
    """Refuse a name that is not one of ``MATMUL_PRECISIONS``."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"unknown poisson_precision={precision!r}: one of "
                         + ", ".join(map(repr, MATMUL_PRECISIONS)))


def tf32_split(a: torch.Tensor):
    """(hi, lo) with hi + lo == a exactly: hi is ``a`` with its low 13
    mantissa bits cleared, so TF32-exact, and lo = a - hi (exact in
    float32: it is those 13 bits)."""
    hi = (a.view(torch.int32) & -(1 << _TF32_DROPPED_BITS)).view(torch.float32)
    return hi, a - hi


@contextlib.contextmanager
def _tf32_matmul():
    """cuBLAS TF32 products inside, the global flag as it was afterwards
    (also on error)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """``torch.matmul(a, b)`` at one of ``MATMUL_PRECISIONS``, the H100's
    counterparts of the TPU matrix unit's passes (the JAX package's
    ``jax.lax.Precision`` of its XLA-side solve products; every product of
    the 2D and 3D solves here goes through this function):

    * None or "highest": full float32, TF32 off (HIGHEST, 6 bf16 passes);
    * "high": three TF32 tensor-core products of the split operands,
      hi a . hi b + hi a . lo b + lo a . hi b (``tf32_split``), the
      counterpart of HIGH's bf16x3 (8 + 8 bits): |lo| < 2^-10 |a|, so the
      dropped lo . lo term and TF32's rounding of lo are each under 2^-20
      of a product's magnitude;
    * "default": one TF32 product (DEFAULT, one bf16 pass). TF32 keeps 10
      mantissa bits where bf16 keeps 8, so "default" is more exact on the
      card than on a TPU.

    TF32 is on only around these products. float64 operands (and the CPU,
    which has no TF32, for "default") take the full-precision product."""
    check_precision(precision)
    if precision in (None, "highest") or a.dtype != torch.float32:
        return torch.matmul(a, b)
    with _tf32_matmul():
        if precision == "default":
            return torch.matmul(a, b)
        a_hi, a_lo = tf32_split(a)
        b_hi, b_lo = tf32_split(b)
        return (torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)) + torch.matmul(a_hi, b_hi)


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


def _dft_eigenvalues(n: int, d: float) -> np.ndarray:
    """Eigenvalues of the periodic 1D second-difference for rfft modes."""
    m = np.arange(n // 2 + 1)
    return -(2.0 - 2.0 * np.cos(2.0 * np.pi * m / n)) / (d * d)


def _neumann_d2(nz: int, dz: float) -> np.ndarray:
    """D2z_neumann, (nz, nz)."""
    # Neumann ghost: p[-1] = p[0], p[nz] = p[nz-1] -> first/last diagonal -1.
    d2 = (
        np.diag(np.full(nz, -2.0))
        + np.diag(np.ones(nz - 1), 1)
        + np.diag(np.ones(nz - 1), -1)
    )
    d2[0, 0] = -1.0
    d2[-1, -1] = -1.0
    return d2 / (dz * dz)


def _vertical_inverses(lams: np.ndarray, nz: int, dz: float) -> np.ndarray:
    """Stack of inverses of (D2z_neumann + lam I), shape (M, nz, nz)."""
    d2 = _neumann_d2(nz, dz)
    inv = np.empty((lams.size, nz, nz), dtype=np.float64)
    eye = np.eye(nz)
    for i, lam in enumerate(lams):
        a = d2 + lam * eye
        if abs(lam) < 1e-14:
            inv[i] = np.linalg.pinv(a)  # zero-mean solution for the mean mode
        else:
            inv[i] = np.linalg.inv(a)
    return inv


def _real_dft_matrices(n: int):
    """Real DFT analysis F (n, n) and synthesis G (n, n) with G @ F = I.

    Rows interleave cos/sin per wavenumber; mode 0 (and the Nyquist mode
    for even n) contribute a single cosine row."""
    i = np.arange(n)
    rows = []
    row_modes = []
    for m in range(n // 2 + 1):
        rows.append(np.cos(2.0 * np.pi * m * i / n))
        row_modes.append(m)
        if m != 0 and not (n % 2 == 0 and m == n // 2):
            rows.append(np.sin(2.0 * np.pi * m * i / n))
            row_modes.append(m)
    f = np.stack(rows)
    modes = np.asarray(row_modes)
    # synthesis = scaled transpose: 1/n for the single (mode-0 / Nyquist)
    # rows, 2/n for paired cos/sin rows
    scale = np.full(f.shape[0], 2.0 / n)
    scale[modes == 0] = 1.0 / n
    if n % 2 == 0:
        scale[modes == n // 2] = 1.0 / n
    g = (f * scale[:, None]).T
    if not np.allclose(g @ f, np.eye(n), atol=1e-10):
        raise ArithmeticError("real DFT synthesis is not the inverse of analysis")
    return f, g, modes


class Spectral2D(NamedTuple):
    """Constants of the 2D spectral solve, on the working device and dtype.

    ``inv`` is the JAX package's dense form, which the plain solve uses;
    the env-step kernel takes each mode's inverse in the DCT-II basis that
    diagonalises it, inv[m] = idct^T diag(dinv[m]) dct^T."""

    f: torch.Tensor  # (nx, nx) real-DFT analysis, [m, x]
    g: torch.Tensor  # (nx, nx) synthesis, [x, m]
    inv: torch.Tensor  # (nx, nz, nz) per-DFT-row vertical inverse, [m, z, f]
    dct: torch.Tensor  # (nz, nz) z analysis, transposed: [z, j]
    idct: torch.Tensor  # (nz, nz) z synthesis, transposed: [j, z]
    dinv: torch.Tensor  # (nx, nz) the diagonal of each inverse in that basis, [m, j]


def spectral_constants_2d(
    nx: int, nz: int, dx: float, dz: float, dtype=torch.float32, device="cuda"
) -> Spectral2D:
    """Build F, G, the per-row inverses and their DCT-II factors in
    float64, then cast once."""
    f_mat, g_mat, row_modes = _real_dft_matrices(nx)
    lams = _dft_eigenvalues(nx, dx)
    inv_rows = _vertical_inverses(lams, nz, dz)[row_modes]
    cz, sz, _ = _dct2_matrices(nz, dz)
    # mu_j: D2z_neumann in the DCT-II basis that diagonalises it, taken from
    # the matrix the dense stack inverts (at nz = 1 that matrix is -1 / dz^2)
    mu = np.einsum("zj,zf,jf->j", sz, _neumann_d2(nz, dz), cz)
    lam = lams[row_modes][:, None] + mu[None, :]
    with np.errstate(divide="ignore"):
        dinv = np.where(np.abs(lam) < 1e-14, 0.0, 1.0 / lam)

    def cast(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Spectral2D(cast(f_mat), cast(g_mat), cast(inv_rows), cast(cz.T), cast(sz.T),
                      cast(dinv))


def tf32_parts(x: np.ndarray, passes: int) -> list:
    """The TF32 operands K1's tensor-core products take for the float32
    values ``x``, as float32 arrays: at 3 passes [hi, lo], hi ``x`` with its
    low 13 mantissa bits cleared and lo = x - hi rounded to TF32; at 1 pass
    [x rounded to TF32]. Rounding is to nearest, ties away from zero
    (``cvt.rna.tf32.f32``)."""
    x = np.ascontiguousarray(x, np.float32)

    def rna(v):
        return ((v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    if passes == 1:
        return [rna(x)]
    hi = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return [hi, rna(x - hi)]


def k1_b_core(block: np.ndarray) -> np.ndarray:
    """A block of rows (N, K) as a B^T operand of wgmma in the K-major
    core-matrix layout without swizzle (``k1_bcore_index`` in
    ``csrc/rbc2d.cu``): 8 x 4 core matrices, each row-major, ordered by
    8-row group and then by K, flattened."""
    n, k = block.shape
    return block.reshape(n // 8, 8, k // 4, 4).transpose(0, 2, 1, 3).reshape(-1)


def k1_a_fragments(a: np.ndarray) -> np.ndarray:
    """An A operand of wgmma with 16 mw rows (mw = rows / 16, the warps that
    hold them) as K1 reads it from registers, (K / 8, mw, 32, 4): k-step s,
    warp w, lane 4 g + t, register i holds A[16 w + g + 8 (i % 2)][8 s + t
    + 4 (i // 2)] (``wgmma_tf32``)."""
    rows, k = a.shape
    mw = rows // 16
    return a.reshape(mw, 2, 8, k // 8, 2, 4).transpose(3, 0, 2, 5, 4, 1).reshape(k // 8, mw, 32,
                                                                                   4)


def k1_tf32_constants(spectral: Spectral2D, passes: int) -> torch.Tensor:
    """The solve's constants of K1's TF32 instances that read them packed
    (``limits.env_step_2d_packed``), packed once in the order their kernel
    reads them, a float32 tensor on the constants' device. Each value is
    TF32-exact as the products take it (``tf32_parts``: at 3 passes hi and
    lo, at 1 the value rounded), so the kernel splits and rounds no packed
    constant.

    The instances on wgmma (``limits.env_step_2d_wgmma``: on the chip
    96x64, 64x64, 128x32; on a cluster of c CTAs 64 or 96 columns of 64
    levels a CTA; ``k1_tf32_*`` in ``csrc/rbc2d.cu``): F's chunks and then
    G's, each [CTA r][chunk j][warpgroup g][part] the B^T operand
    (``k1_b_core``) of the warpgroup's NW = nx / (4 c) rows (F's the modes r
    nx / c + g NW .., G's the columns) over the chunk's KC columns
    (``limits.k1_wgmma_chunk``): chunk j those of CTA (r + j // (nx / c /
    KC)) % c from (j % (nx / c / KC)) KC on, in the order CTA r takes them;
    ct^T and st^T, the A operands of products 2 and 3, in the fragment order
    of nz / 16 warps (``k1_a_fragments``; at 3 passes a lane's hi and then
    lo values of a k-step); dinv in the order of product 2's accumulators:
    [r][g][w][lane][4 j + 2 h + e] is dinv[r nx / c + g NW + 8 j + 2 t +
    e][16 w + g' + 8 h] for lane 4 g' + t.

    The on-chip runtime-size instance (``k1_rt_step``): F and then G, each
    zero-padded to whole 16-row tiles and 8-deep k-steps, in mma.sync's A
    fragment order [k-step][tile][part][lane][4] (``k1_a_fragments`` of the
    padded matrix, its parts side by side)."""
    from rbc_gym_tpu_torch.ops import limits  # (limits imports nothing of this module)

    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    f, g, ct, st, dinv = (np.asarray(t.detach().to("cpu", torch.float32))
                          for t in (spectral.f, spectral.g, spectral.dct, spectral.idct,
                                    spectral.dinv))
    nx, nz = dinv.shape
    if not limits.env_step_2d_packed(nx, nz, passes):
        raise ValueError(f"K1 has no instance with packed constants at {nx}x{nz} and {passes} "
                         "passes (limits.env_step_2d_packed)")
    if not limits.env_step_2d_wgmma(nx, nz, passes):
        rows, depth = -(-nx // 16) * 16, -(-nx // 8) * 8

        def runtime(m):
            padded = [np.pad(part, ((0, rows - nx), (0, depth - nx))) for part in
                      tf32_parts(m, passes)]
            return np.stack([k1_a_fragments(part) for part in padded], axis=2).reshape(-1)

        return torch.as_tensor(np.concatenate([runtime(f), runtime(g)]),
                               device=spectral.f.device)
    c = limits.env_step_2d_cluster_size(nx, nz) or 1
    nxl = nx // c
    nw, kc = nxl // 4, limits.k1_wgmma_chunk(nxl, nz, passes)
    sub = nxl // kc

    def chunks(parts):
        out = []
        for r in range(c):
            for j in range(c * sub):
                col = ((r + j // sub) % c) * nxl + (j % sub) * kc
                for q in range(4):
                    rows = slice(r * nxl + q * nw, r * nxl + (q + 1) * nw)
                    out += [k1_b_core(part[rows, col:col + kc]) for part in parts]
        return out

    consts = [np.concatenate([k1_a_fragments(part) for part in tf32_parts(a, passes)], axis=-1)
              for a in (ct.T, st.T)]
    rr, gg, w, lane, i = np.meshgrid(np.arange(c), np.arange(4), np.arange(nz // 16),
                                     np.arange(32), np.arange(nw // 2), indexing="ij")
    d = dinv[rr * nxl + gg * nw + 8 * (i // 4) + 2 * (lane % 4) + i % 2,
             16 * w + lane // 4 + 8 * ((i // 2) % 2)]
    packed = np.concatenate([*chunks(tf32_parts(f, passes)), *chunks(tf32_parts(g, passes)),
                             *(x.reshape(-1) for x in consts), d.reshape(-1)])
    return torch.as_tensor(packed, device=spectral.f.device)


def poisson_solve_2d(consts: Spectral2D, rhs: torch.Tensor,
                     precision: str | None = None) -> torch.Tensor:
    """Zero-mean solution of laplace(p) = rhs for rhs (E, nx, nz), each of
    its three products a ``matmul`` at ``precision`` (None: full float32)."""
    rhat = matmul(consts.f, rhs, precision)  # (E, m, z)
    # per-mode (z, f) inverse: batch over m, rows over envs
    phat = matmul(rhat.transpose(0, 1), consts.inv, precision).transpose(0, 1)
    return matmul(consts.g, phat, precision)  # (E, x, f)


def make_poisson_solver_2d_bm(
    nx: int, nz: int, dx: float, dz: float, dtype=torch.float32, device="cuda",
    precision: str | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Solver for a batch-major (E, nx, nz) cell-centered RHS -> pressure.

    The JAX package's batch-minor ``make_poisson_solver_2d_bm`` with the
    port's public (E, nx, nz) layout: three products at ``precision``."""
    check_precision(precision)
    consts = spectral_constants_2d(nx, nz, dx, dz, dtype, device)
    return lambda rhs: poisson_solve_2d(consts, rhs, precision)


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------

# Above this nx * nz the dense (x, z) transform loses to the factored one
# (the JAX package's rule, rbc_gym_tpu/ops/poisson.py:183): dense costs
# 4 nx nz FLOP per point and solve, factored 4 (nx + nz).
FACTORED_POISSON_MIN_NXNZ = 1024


def _dct2_matrices(nz: int, dz: float):
    """DCT-II eigenbasis of the Neumann vertical second difference.

    The tridiagonal operator of ``_vertical_inverses`` (ghosts p[-1] = p[0],
    p[nz] = p[nz-1]) is diagonalized by v_k[j] = cos(pi k (j + 1/2) / nz)
    with eigenvalues -(2 - 2 cos(pi k / nz)) / dz^2. Returns analysis C
    (nz, nz), synthesis S (nz, nz) with S @ C = I, and the eigenvalues.
    """
    j = np.arange(nz)
    k = np.arange(nz)
    c = np.cos(np.pi * np.outer(k, j + 0.5) / nz)  # (k, j)
    scale = np.full(nz, 2.0 / nz)
    scale[0] = 1.0 / nz
    s = (c * scale[:, None]).T  # (j, k)
    if not np.allclose(s @ c, np.eye(nz), atol=1e-10):
        raise ArithmeticError("DCT-II synthesis is not the inverse of analysis")
    lam = -(2.0 - 2.0 * np.cos(np.pi * k / nz)) / (dz * dz)
    return c, s, lam


def poisson_analysis_factors_3d(nx: int, nz: int):
    """Fx (nx, nx) and Cz (nz, nz), float64: the factors of the (x, z)-modal
    analysis ``poisson_analysis_matrix_3d`` = kron(Fx, Cz)."""
    fx, _, _ = _real_dft_matrices(nx)
    cz, _, _ = _dct2_matrices(nz, 1.0)  # dz only enters the eigenvalues
    return fx, cz


def poisson_analysis_matrix_3d(nx: int, nz: int) -> np.ndarray:
    """T_A = kron(Fx, Cz), (nx nz, nx nz) float64, row (kx kz) and column
    (x z) merged x-major: ``rhat[e, y] = T_A @ rhs[e, y].reshape(nx nz)``,
    the first product of the dense solve (the JAX package's function of
    this name). K3's analysis instance applies it in its two factors: Cz
    plane by plane in its x march, Fx after it."""
    fx, cz = poisson_analysis_factors_3d(nx, nz)
    return np.kron(fx, cz)


def _solve_constants_3d(nx, ny, nz, dx, dy, dz):
    """Float64 constants of the 3D solve: Fx, Gx, Fy, Gy, Cz, Sz and the
    modal reciprocal (kx, kz, ky) (zero for the singular mean mode)."""
    fx, gx, rows_x = _real_dft_matrices(nx)
    lx = _dft_eigenvalues(nx, dx)[rows_x]
    fy, gy, rows_y = _real_dft_matrices(ny)
    ly = _dft_eigenvalues(ny, dy)[rows_y]
    cz, sz, lz = _dct2_matrices(nz, dz)
    lam = lx[:, None, None] + lz[None, :, None] + ly[None, None, :]  # (kx, kz, ky)
    with np.errstate(divide="ignore"):
        dinv = np.where(np.abs(lam) < 1e-12, 0.0, 1.0 / lam)
    return fx, gx, fy, gy, cz, sz, dinv


def _cast(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _make_modal(ny, k, fy, gy, dinv, dtype, device, precision):
    """(E, ny, K) (x, z)-modal rows -> y-DFT, reciprocal, inverse y-DFT."""
    fy_t, gy_t = _cast(fy, dtype, device), _cast(gy, dtype, device)
    dinv_t = _cast(dinv.reshape(k, ny).T, dtype, device)  # (ky, kx kz)

    def modal(r: torch.Tensor) -> torch.Tensor:
        return matmul(gy_t, matmul(fy_t, r, precision) * dinv_t, precision)

    return modal


def make_poisson_analysis_3d(
    nx: int, nz: int, dtype=torch.float32, device="cuda", precision: str | None = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The dense solve's analysis: rhs (E, ny, nx, nz) in the solve layout
    -> rhat (E, ny, K), K = nx nz merged x-major: one GEMM over E * ny rows
    with ``poisson_analysis_matrix_3d``."""
    k = nx * nz
    t_a_t = _cast(poisson_analysis_matrix_3d(nx, nz).T, dtype, device)

    def analysis(rhs: torch.Tensor) -> torch.Tensor:
        e, ny = rhs.shape[:2]
        return matmul(rhs.reshape(e * ny, k), t_a_t, precision).reshape(e, ny, k)

    return analysis


def make_poisson_tail_3d(
    nx: int,
    ny: int,
    nz: int,
    dx: float,
    dy: float,
    dz: float,
    dtype=torch.float32,
    device="cuda",
    precision: str | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rest of the dense solve for a caller that holds ``rhat`` (E, ny,
    K) (``make_poisson_analysis_3d``, or K3's analysis instance): the
    y-DFT, the modal reciprocal, the inverse y-DFT and the synthesis
    kron(Gx, Sz), whatever nx nz is -> p (E, ny, nx, nz). The JAX
    package's ``make_poisson_tail_3d_bm`` in the solve layout."""
    fx, gx, fy, gy, cz, sz, dinv = _solve_constants_3d(nx, ny, nz, dx, dy, dz)
    k = nx * nz
    modal = _make_modal(ny, k, fy, gy, dinv, dtype, device, precision)
    t_s_t = _cast(np.kron(gx, sz).T, dtype, device)

    def tail(rhat: torch.Tensor) -> torch.Tensor:
        e = rhat.shape[0]
        p = matmul(modal(rhat).reshape(e * ny, k), t_s_t, precision)
        return p.reshape(e, ny, nx, nz)

    return tail


def make_poisson_solver_3d(
    nx: int,
    ny: int,
    nz: int,
    dx: float,
    dy: float,
    dz: float,
    dtype=torch.float32,
    device="cuda",
    factored: bool | None = None,
    precision: str | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Zero-mean solve of laplace(p) = rhs, rhs and p in the solve layout
    (E, ny, nx, nz).

    The JAX package's ``make_poisson_solver_3d_bm`` in both of its forms:
    * dense (default below ``FACTORED_POISSON_MIN_NXNZ``): the x-DFT and the
      z-DCT combine into one (nx nz, nx nz) matrix kron(Fx, Cz), applied
      as one GEMM over E * ny rows; the solve is
      ``make_poisson_tail_3d`` after ``make_poisson_analysis_3d``;
    * factored: the x and z transforms stay (nx, nx) and (nz, nz) products.
    Constants are built in float64 numpy and cast once; every product is
    ``matmul`` at ``precision`` (None: full float32, TF32 off).
    """
    check_precision(precision)
    if factored is None:
        factored = nx * nz >= FACTORED_POISSON_MIN_NXNZ
    if not factored:
        analysis = make_poisson_analysis_3d(nx, nz, dtype, device, precision)
        tail = make_poisson_tail_3d(nx, ny, nz, dx, dy, dz, dtype, device, precision)
        return lambda rhs: tail(analysis(rhs))

    fx, gx, fy, gy, cz, sz, dinv = _solve_constants_3d(nx, ny, nz, dx, dy, dz)
    k = nx * nz
    modal = _make_modal(ny, k, fy, gy, dinv, dtype, device, precision)
    fx_t, gx_t = _cast(fx, dtype, device), _cast(gx, dtype, device)
    czt, szt = _cast(cz.T, dtype, device), _cast(sz.T, dtype, device)

    def solve(rhs: torch.Tensor) -> torch.Tensor:
        e = rhs.shape[0]
        r = matmul(fx_t, matmul(rhs, czt, precision), precision)  # (E, ny, kx, kz)
        r = modal(r.reshape(e, ny, k)).reshape(e, ny, nx, nz)
        return matmul(matmul(gx_t, r, precision), szt, precision)

    return solve
