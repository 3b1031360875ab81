"""Build the port's CUDA sources with nvcc and load them through ctypes.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles
each source into an object; one more links them into a shared library with
a plain C interface (no PyTorch headers, no ``cpp_extension``), written to
``rbc_gym_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so it is built once and reused until a source changes. Nothing
here runs at import time: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

TARGET = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*TARGET, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every exported function: pointers (and the stream) as c_void_p,
# so ctypes never truncates them to 32-bit ints.
ARGTYPES = {
    "launch_env_step_2d": [
        _P, _P, _P, _P,  # u, w, b, bottom
        _P, _P, _P, _P, _P,  # F, G, z analysis, z synthesis, modal reciprocals
        _P, _P, _P, _P,  # u_out, w_out, b_out, p_out
        _P,  # per-env scratch of the off-chip instance (NULL on the chip)
        _I, _I, _I, _I,  # n_env, nx, nz, n_substeps
        _F, _F, _F, _F, _F, _F,  # dt, dx, dz, nu, kappa, min_b
        _I,  # TF32 passes of the solve's products: 0 (float32), 1 or 3
        _P,  # the wgmma instances' packed constants (NULL elsewhere)
        _P,  # stream
    ],
    "env_step_2d_occupancy": [
        _I, _I, _I,  # nx, nz, passes
        _P,  # int out[7]: instance, CTAs a cluster, blocks an SM, clusters resident,
             # registers, local bytes a thread, shared bytes a block
    ],
    "launch_tendencies_2d": [
        _P, _P, _P, _P,  # u, w, b, bottom
        _P, _P, _P,  # gu, gw, gb
        _P,  # per-env pHY' scratch of the general instance (NULL on the march)
        _I, _I, _I,  # n_env, nx, nz
        _F, _F, _F, _F, _F,  # dx, dz, nu, kappa, min_b
        _P,  # stream
    ],
    "launch_stage_rk_3d": [
        _P, _P, _P, _P, _P, _P,  # u, v, w, b, q, bottom
        _P, _P, _P, _P,  # gu_prev, gv_prev, gw_prev, gb_prev (NULL at stage 0)
        _P, _P, _P, _P, _P,  # u_out, v_out, w_out, b_out, div_out
        _P, _P, _P, _P,  # gu, gv, gw, gb (NULL at stage 2)
        _I, _I, _I, _I, _I,  # n_env, nx, ny, nz, stage
        _F, _F, _F,  # dt, gamma, zeta
        _F, _F, _F, _F, _F, _F,  # dx, dy, dz, nu, kappa, min_b
        _P,  # stream
    ],
    "launch_stage_rk_3d_rhat": [
        _P, _P, _P, _P, _P, _P,  # u, v, w, b, q, bottom
        _P, _P, _P, _P,  # gu_prev, gv_prev, gw_prev, gb_prev (NULL at stage 0)
        _P, _P, _P, _P, _P,  # u_out, v_out, w_out, b_out, rhat_out
        _P, _P, _P, _P,  # gu, gv, gw, gb (NULL at stage 2)
        _I, _I, _I, _I, _I,  # n_env, nx, ny, nz, stage
        _F, _F, _F,  # dt, gamma, zeta
        _F, _F, _F, _F, _F, _F,  # dx, dy, dz, nu, kappa, min_b
        _P,  # Fx (nx, nx) then Cz^T (nz, nz)
        _P,  # stream
    ],
    "march_occupancy": [
        _I, _I, _I, _I,  # rhat (0: K3, 1: its analysis instance), nx, ny, nz
        _P,  # int out[4]: blocks an SM, registers, local bytes a thread, shared bytes
    ],
    "launch_stage_rk_3d_xy": [
        _P, _P, _P, _P, _P, _P,  # u, v, w, b, q, bottom
        _P, _P, _P, _P,  # gu_prev, gv_prev, gw_prev, gb_prev (NULL at stage 0)
        _P, _P, _P, _P, _P,  # u_out, v_out, w_out, b_out, div_out
        _P, _P, _P, _P,  # gu, gv, gw, gb (NULL at stage 2)
        _I, _I, _I, _I, _I,  # n_env, nx, ny, nz, stage
        _F, _F, _F,  # dt, gamma, zeta
        _F, _F, _F, _F, _F, _F,  # dx, dy, dz, nu, kappa, min_b
        _P,  # stream
    ],
    "stage_xy_occupancy": [
        _I,  # nz
        _P,  # int out[7]: instance, CTAs a cluster, blocks an SM, clusters resident,
             # registers, local bytes a thread, shared bytes a block
    ],
    "launch_correct_3d": [
        _P, _P, _P, _P,  # u, v, w, q
        _P, _P, _P,  # u_out, v_out, w_out
        _I, _I, _I, _I,  # n_env, nx, ny, nz
        _F, _F, _F,  # dx, dy, dz
        _P,  # stream
    ],
    "launch_field_tendency_3d": [
        _I,  # field: 0 u, 1 v, 2 w, 3 b
        _P, _P, _P, _P, _P,  # u, v, w, b (NULL for w), bottom (b only)
        _P,  # g
        _I, _I, _I, _I,  # n_env, nx, ny, nz
        _F, _F, _F, _F, _F, _F,  # dx, dy, dz, nu, kappa, min_b
        _P,  # stream
    ],
    "launch_div_3d": [
        _P, _P, _P,  # u, v, w
        _P,  # div_out
        _I, _I, _I, _I,  # n_env, nx, ny, nz
        _F, _F, _F,  # dx, dy, dz
        _P,  # stream
    ],
}


HOST_SHIM = CSRC_DIR / "host_shim.h"


def host_source(name: str) -> str:
    """``csrc/<name>``'s device code for a host C++20 build (the CPU tests'
    rehearsal of the kernels): the C launchers, which need nvcc, cut off,
    the CUDA headers replaced by ``csrc/host_shim.h`` and the anonymous
    namespace named ``host``."""
    src = (CSRC_DIR / name).read_text()
    src = src[: src.index('extern "C" {')]
    src = src.replace("#include <cuda_runtime.h>", f'#include "{HOST_SHIM}"')
    src = src.replace("#include <cuda_pipeline.h>\n", "")
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src = src.replace(f'#include "{header.name}"', f'#include "{header}"')
    return src.replace("namespace {", "namespace host {", 1)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def compile_command(source: Path, obj: Path) -> list[str]:
    """nvcc of one source into an object."""
    return [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(source)]


def link_command(output: Path, objects: list[Path]) -> list[str]:
    return [nvcc_path(), *TARGET, "-shared", "-o", str(output), *map(str, objects)]


def library_path() -> Path:
    return BUILD_DIR / f"librbc_gym_kernels_{_source_hash()}.so"


def _check(returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{log}")


def build() -> tuple[Path, float]:
    """Compile the sources unless this hash is already built.

    Returns the library's path and the seconds spent compiling (0 if cached).
    """
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    start = time.perf_counter()
    procs = [subprocess.Popen(compile_command(src, obj), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objects)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for proc, log in zip(procs, logs):
            _check(proc.returncode, log)
        proc = subprocess.run(link_command(tmp, objects), capture_output=True, text=True)
        _check(proc.returncode, proc.stdout + proc.stderr)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every export's signature."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
