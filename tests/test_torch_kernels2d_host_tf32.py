"""K1's TF32 instances (2D ``poisson_precision`` "bf16x3" and "default"),
compiled for the host and held against the plain version at the same
precision on the CPU (``torch_kernels2d_host``)."""

import pytest

from rbc_gym_tpu_torch.ops import limits

from torch_kernels2d_host import check_k1, host_binary  # noqa: F401 (host_binary: a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("n_env,nx,nz", [
    (1, 96, 64),  # the reference grid: the compile-time instance, its solve on wgmma
    (1, 64, 64),  # wgmma at m64n16k8, F's and G's rows in one chunk each
    (1, 128, 32),  # wgmma at m64n32k8, the rows past nz = 32 zero, F and G in chunks
    (1, 20, 12),  # the runtime instance: partial tiles in m, n and k, plain slabs
    (1, 96, 32),  # the runtime instance on swizzled slabs (nz a multiple of 32)
    (1, 128, 40),  # the runtime instance: F and G in chunks through the dead state copy
    (1, 40, 4),  # the runtime instance: F and G through a ring of their own
    (1, 128, 64),  # the off-chip instance (forced: the launcher gives it a cluster)
    (1, 3, 8),  # the fewest columns: one partial tile, 3 of 8 deep in F and G
    (1, 16, 1),  # one level: the z products 1 deep
])
def test_host_build_of_k1_tf32_instances_match_plain(host_binary, tmp_path, n_env, nx, nz,
                                                     precision):
    """K1's split-product ("high", 3 passes) and one-pass ("default")
    instances after 2 substeps (heater_duration 0.06: every product of
    every stage, the previous stage's tendencies across a substep, p out)
    against ``env_step_2d_plain`` at the same precision, at the smoke's
    gates for 6 substeps (``chip_smoke.k1_tf32_errors``). Each emulated
    mma meets its warp twice (a wgmma its warpgroup), so a substep here
    costs several times one of float32 K1. At 96x64, 64x64 and 128x32 the
    instance runs its solve on wgmma from the packed constants."""
    on_chip = limits.env_step_2d_on_chip(nx, nz)
    wgmma = on_chip and limits.env_step_2d_wgmma(nx, nz, 3 if precision == "high" else 1)
    check_k1(host_binary, tmp_path, n_env, nx, nz, 0.06, None, precision, n_sub=2,
             force_global=not on_chip,
             instance="on_chip_wgmma 1" if wgmma else ("on_chip 1" if on_chip else "global 1"))
