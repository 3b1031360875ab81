"""K5's z split (the grids whose column single-CTA K5 cannot hold: a
thread-block cluster of 2, 4 or 8 CTAs for each of its blocks, each CTA
owning a part of the levels), compiled for the host and held against the
plain stage on the CPU (``torch_kernels3d_host``): the CTAs of a cluster
run together as host threads, each with its own shared memory, reading
the partial sums of pHY' of the CTAs above through ``cluster_map`` and
meeting them at ``cluster_barrier``. The gates are K5's (gu, gv, gw, gb
1e-5; the fields and the divergence 5e-6)."""

import subprocess

import pytest
import torch

from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.sim import solver3d as s3

from torch_kernels3d_host import host_binary, run_stage  # noqa: F401 (host_binary: a fixture)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("shape,kernel,instance", [
    # forced onto two CTAs of 12 levels: each holds its part and 4 levels of
    # the other's, and the top CTA's partial sum of pHY' crosses to the bottom
    ((1, 4, 16, 24), "split2", "split 2"),
    # four CTAs of 8, 8, 8 and 6 levels: the middle ones hold halos on both
    # sides, the last part is short and its CTA's threads past it only copy
    ((1, 4, 8, 30), "split4", "split 4"),
])
def test_host_build_of_k5_split_matches_plain(host_binary, tmp_path, shape, kernel, instance,
                                              stage):
    """The forced split against the plain stage at K5's gates."""
    run_stage(host_binary, tmp_path, shape, stage, kernel, instance)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_host_build_of_k5_split_where_the_launcher_takes_it(host_binary, tmp_path, stage):
    """nz = 112: single-CTA K5 would need 244,640 bytes, so the launcher's
    own rule takes two CTAs of 56 levels. The case's noise makes outputs of
    ~10^3 there (div, gw, gb), where the float32 plain version itself is
    ~1e-4 off float64: each output is held against the float64 plain
    version, within ``SPLIT_VS_PLAIN`` times the float32 plain version's
    error or K5's gate (the smoke's rule, phase 41)."""
    run_stage(host_binary, tmp_path, (1, 4, 16, 112), stage, "xy", "split 2", vs_float64=True)


@pytest.mark.parametrize("shape,c", [((1, 4, 16, 24), 2), ((1, 4, 8, 30), 4)])
def test_host_build_of_k5_split_is_single_cta_k5_bit_for_bit(host_binary, tmp_path, shape, c):
    """Where one CTA holds the column, the split computes each point with
    the runtime-nz instance's own operations: its stage 1 outputs equal
    single-CTA K5's bit for bit (on the host, which contracts no FMA)."""
    outs = {}
    for kernel in ("xy", f"split{c}"):
        d = tmp_path / kernel
        d.mkdir()
        _, _, got = run_stage(host_binary, d, shape, 1, kernel)
        outs[kernel] = {n: (d / n).read_bytes()
                        for n in ("u_out", "v_out", "w_out", "b_out", "div", "gu", "gv", "gw",
                                  "gb")}
    assert outs["xy"] == outs[f"split{c}"]


@pytest.mark.parametrize("nz", [2, 32, 106, 107, 112, 128, 198, 199, 392, 393, 512, 784, 785])
def test_split_formulas_match_the_launcher(host_binary, nz):
    """``limits.stage_xy_split_size``, the split's shared memory, threads
    and held levels are the launcher's own, and the selection rule takes
    stage_xy exactly where one CTA or a split holds the column."""
    out = subprocess.run([str(host_binary), "split", str(nz)], check=True, capture_output=True,
                         text=True).stdout.split()
    c = limits.stage_xy_split_size(nz)
    assert int(out[0]) == c
    if c:
        assert 4 * int(out[1]) == limits.stage_xy_split_smem_bytes(nz, c)
        assert int(out[2]) == limits.stage_xy_split_threads(nz, c)
        assert int(out[3]) == limits.stage_xy_split_levels(nz, c)
    else:
        assert 4 * int(out[1]) == limits.stage_xy_smem_bytes(nz)
    one_cta = limits.stage_xy_smem_bytes(nz) <= limits.SMEM_PER_BLOCK
    assert (c > 0) == (not one_cta and nz <= 784)
    limit = s3.stage_kernel_limit("stage_xy", torch.float32, 64, 64, nz)
    assert (limit is None) == (one_cta or c > 0), limit
