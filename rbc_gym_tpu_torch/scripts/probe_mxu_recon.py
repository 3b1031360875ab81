"""Probe: UB5 upwind reconstruction as GEMMs against shift-and-FMA.

Twin of ``scripts/probe_mxu_recon.py``. The JAX probe asked whether the
TPU's matrix unit (MXU) beats its vector unit at the UB5 reconstructions
of the 3D tendencies; on the card the matrix unit's counterpart is cuBLAS
SGEMM (``torch.matmul`` in float32, TF32 off). A reconstruction along x
or y is a dense periodic (n, n) stencil matrix per upwind side, applied
by one ``torch.matmul`` (~2n FLOP a point against ~20 for the shifts),
then the upwind select; the port's own reconstruction is the shift and
FMA form of ``ops/stencils.recon_c2f_periodic``. The probe prints their
max abs difference and the time of each, as 39 dependent applications
(one env step's stage units) timed by CUDA events, on the 3D training
shape (E, nx, ny, nz) = (E, 32, 32, 16) in float32. The JAX probe's
DEFAULT-precision (one bf16 pass) rows are not carried over: TF32 stays
off in the port. Both forms are plain PyTorch that no kernel path runs:
K3, K5 and K6 reconstruct in their own bodies, so the probe says nothing
of the kernel paths' time.

Usage:
  python -m rbc_gym_tpu_torch.scripts.probe_mxu_recon [E] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

NX, NY, NZ = 32, 32, 16
N_ITER = 39
_TAPS_LEFT = ((-3, 2 / 60), (-2, -13 / 60), (-1, 47 / 60), (0, 27 / 60), (1, -3 / 60))
_TAPS_RIGHT = ((2, 2 / 60), (1, -13 / 60), (0, 47 / 60), (-1, 27 / 60), (-2, -3 / 60))


def periodic_recon_matrices(n: int, m: int):
    """(left, right) (n, n) UB5 periodic reconstruction matrices: row j
    holds the stencil of destination j with downwind cell j + m."""
    left, right = np.zeros((n, n)), np.zeros((n, n))
    for j in range(n):
        for off, c in _TAPS_LEFT:
            left[j, (j + m + off) % n] += c
        for off, c in _TAPS_RIGHT:
            right[j, (j + m + off) % n] += c
    return left, right


def _both_sides(n: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """The two matrices stacked, (2, n, n), in ``like``'s dtype and device."""
    return torch.as_tensor(np.stack(periodic_recon_matrices(n, m)), dtype=like.dtype,
                           device=like.device)


def recon_gemm_x(q: torch.Tensor, vel: torch.Tensor, m: int = 0) -> torch.Tensor:
    """UB5 upwind reconstruction along x (dim 1 of (E, nx, ny, nz)) by GEMM."""
    e, n = q.shape[:2]
    both = torch.matmul(_both_sides(n, m, q)[:, None], q.reshape(e, n, -1)[None])
    both = both.reshape((2,) + tuple(q.shape))
    return torch.where(vel > 0, both[0], both[1])


def recon_gemm_y(q: torch.Tensor, vel: torch.Tensor, m: int = 0) -> torch.Tensor:
    """The same along y (dim 2 of (E, nx, ny, nz))."""
    both = torch.matmul(_both_sides(q.shape[2], m, q)[:, None, None], q[None])
    return torch.where(vel > 0, both[0], both[1])


def probe(num_envs: int = 1024, device="cuda", n_iter: int = N_ITER, seed: int = 0,
          log=print) -> dict:
    """Max abs differences and ms per reconstruction of each form."""
    from rbc_gym_tpu_torch.ops import stencils as st
    from rbc_gym_tpu_torch.utils.profiling import device_ms

    device = torch.device(device)
    clock = "cuda events" if device.type == "cuda" else "host clock"
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((num_envs, NX, NY, NZ), generator=gen, device=device)
    vel = torch.randn(q.shape, generator=gen, device=device)
    log(f"(E, nx, ny, nz) = ({num_envs}, {NX}, {NY}, {NZ}), float32, {clock}")

    forms = {"x": (lambda c, v: st.recon_c2f_periodic(c, v, 1), recon_gemm_x),
             "y": (lambda c, v: st.recon_c2f_periodic(c, v, 2), recon_gemm_y)}
    out = {"max_abs_q": float(q.abs().max()), "max_abs_err": {}, "ms": {}}
    for axis, (fma, gemm) in forms.items():
        err = float((gemm(q, vel) - fma(q, vel)).abs().max())
        out["max_abs_err"][axis] = err
        log(f"{axis}-recon GEMM vs shift-and-FMA: max abs err {err:.3e}")
    for axis, (fma, gemm) in forms.items():
        for label, fn in ((f"shift-and-FMA {axis}-recon (stencils)", fma),
                          (f"GEMM {axis}-recon (torch.matmul, float32)", gemm)):
            def chained(fn=fn):
                c = q
                for _ in range(n_iter):
                    c = fn(c, vel) * 0.999 + 0.001 * c
                return c

            ms = device_ms(chained, 1, device) / n_iter
            out["ms"][label] = ms
            log(f"{label:44}: {ms:7.3f} ms/recon")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("envs", nargs="?", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return probe(args.envs, args.device, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
