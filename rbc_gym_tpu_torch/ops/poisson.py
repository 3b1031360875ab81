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

from typing import Callable, NamedTuple

import numpy as np
import torch


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


def poisson_solve_2d(consts: Spectral2D, rhs: torch.Tensor) -> torch.Tensor:
    """Zero-mean solution of laplace(p) = rhs for rhs (E, nx, nz)."""
    rhat = torch.matmul(consts.f, rhs)  # (E, m, z)
    # per-mode (z, f) inverse: batch over m, rows over envs
    phat = torch.matmul(rhat.transpose(0, 1), consts.inv).transpose(0, 1)
    return torch.matmul(consts.g, phat)  # (E, x, f)


def make_poisson_solver_2d_bm(
    nx: int, nz: int, dx: float, dz: float, dtype=torch.float32, device="cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Solver for a batch-major (E, nx, nz) cell-centered RHS -> pressure.

    The JAX package's batch-minor ``make_poisson_solver_2d_bm`` with the
    port's public (E, nx, nz) layout: three ``torch.matmul`` calls."""
    consts = spectral_constants_2d(nx, nz, dx, dz, dtype, device)
    return lambda rhs: poisson_solve_2d(consts, rhs)


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
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Zero-mean solve of laplace(p) = rhs, rhs and p in the solve layout
    (E, ny, nx, nz).

    The JAX package's ``make_poisson_solver_3d_bm`` in both of its forms:
    * dense (default below ``FACTORED_POISSON_MIN_NXNZ``): the x-DFT and the
      z-DCT combine into one (nx nz, nx nz) matrix kron(Fx, Cz), applied
      as one GEMM over E * ny rows; its tail is the y-DFT, the modal
      reciprocal, the inverse y-DFT and the synthesis kron(Gx, Sz);
    * factored: the x and z transforms stay (nx, nx) and (nz, nz) products.
    Constants are built in float64 numpy and cast once; every product is
    ``torch.matmul`` in the working dtype (TF32 is off).
    """
    if factored is None:
        factored = nx * nz >= FACTORED_POISSON_MIN_NXNZ
    fx, gx, rows_x = _real_dft_matrices(nx)
    lx = _dft_eigenvalues(nx, dx)[rows_x]
    fy, gy, rows_y = _real_dft_matrices(ny)
    ly = _dft_eigenvalues(ny, dy)[rows_y]
    cz, sz, lz = _dct2_matrices(nz, dz)
    lam = lx[:, None, None] + lz[None, :, None] + ly[None, None, :]  # (kx, kz, ky)
    with np.errstate(divide="ignore"):
        dinv = np.where(np.abs(lam) < 1e-12, 0.0, 1.0 / lam)
    k = nx * nz

    def cast(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    fy_t, gy_t = cast(fy), cast(gy)
    dinv_t = cast(dinv.reshape(k, ny).T)  # (ky, kx kz)

    def modal(r: torch.Tensor) -> torch.Tensor:
        """(E, ny, K) (x, z)-modal rows -> y-DFT, reciprocal, inverse y-DFT."""
        return torch.matmul(gy_t, torch.matmul(fy_t, r) * dinv_t)

    if factored:
        fx_t, gx_t = cast(fx), cast(gx)
        czt, szt = cast(cz.T), cast(sz.T)

        def solve(rhs: torch.Tensor) -> torch.Tensor:
            e = rhs.shape[0]
            r = torch.matmul(fx_t, torch.matmul(rhs, czt))  # (E, ny, kx, kz)
            r = modal(r.reshape(e, ny, k)).reshape(e, ny, nx, nz)
            return torch.matmul(torch.matmul(gx_t, r), szt)

        return solve

    # row (kx kz), column (x z): the x-major merge of the solve layout
    t_a_t = cast(np.kron(fx, cz).T)
    t_s_t = cast(np.kron(gx, sz).T)

    def solve(rhs: torch.Tensor) -> torch.Tensor:
        e = rhs.shape[0]
        r = torch.matmul(rhs.reshape(e * ny, k), t_a_t).reshape(e, ny, k)
        p = torch.matmul(modal(r).reshape(e * ny, k), t_s_t)
        return p.reshape(e, ny, nx, nz)

    return solve
