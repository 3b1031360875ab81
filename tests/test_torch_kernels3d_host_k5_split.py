"""K5's z split (the grids whose column single-CTA K5 cannot hold:
ceil(nz / 32) CTAs for each of its blocks, each CTA owning 32 levels of
the column, a level a lane of its rows' warps), compiled for the host and
held against the plain stage on the CPU (``torch_kernels3d_host``): each
CTA runs as a block of its own, since nothing crosses CTAs (each sums pHY'
of the parts above it from b itself). The gates are K5's (gu, gv, gw, gb
1e-5; the fields and the divergence 5e-6)."""

import subprocess

import pytest
import torch

from rbc_gym_tpu_torch.ops import limits
from rbc_gym_tpu_torch.sim import solver3d as s3

from torch_kernels3d_host import host_binary, run_stage  # noqa: F401 (host_binary: a fixture)
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("shape,kernel,instance,vs_float64", [
    # forced onto two CTAs of 32 and 8 levels: each holds its part and 4
    # levels of the other's, the bottom one sums the top part's pHY' total
    ((1, 4, 16, 40), "split2", "split 2", False),
    # four CTAs of 32, 32, 32 and 4 levels: the middle ones hold halos on
    # both sides, the last part is short and its rows' lanes past it only
    # copy. At 100 levels the case's outputs reach ~10^2 (div), whose
    # float32 spacing is ~1e-5: no float32 code meets K5's absolute gates
    # there, so each output is held against the float64 plain version,
    # within SPLIT_VS_PLAIN times the float32 plain version's error or
    # K5's gate, as at nz = 112 below
    ((1, 4, 8, 100), "split4", "split 4", True),
])
def test_host_build_of_k5_split_matches_plain(host_binary, tmp_path, shape, kernel, instance,
                                              vs_float64, stage):
    """The forced split against the plain stage at K5's gates."""
    run_stage(host_binary, tmp_path, shape, stage, kernel, instance, vs_float64=vs_float64)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_host_build_of_k5_split_where_the_launcher_takes_it(host_binary, tmp_path, stage):
    """nz = 112: single-CTA K5 would need 244,640 bytes, so the launcher's
    own rule takes four CTAs of 32, 32, 32 and 16 levels. The case's noise makes outputs of
    ~10^3 there (div, gw, gb), where the float32 plain version itself is
    ~1e-4 off float64: each output is held against the float64 plain
    version, within ``SPLIT_VS_PLAIN`` times the float32 plain version's
    error or K5's gate (the smoke's rule, phase 41)."""
    run_stage(host_binary, tmp_path, (1, 4, 16, 112), stage, "xy", "split 4", vs_float64=True)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_host_build_of_k5_split_on_a_tall_column(host_binary, tmp_path, stage):
    """nz = 400: thirteen CTAs, the last of 16 levels. A CTA's pHY' warp
    sums the three parts right above its own from rows staged a plane
    ahead, and those further up (CTAs 0..8) from global memory; the first
    design's reach ended at nz = 784 with eight CTAs. Held to the float64
    plain version as at nz = 112."""
    run_stage(host_binary, tmp_path, (1, 4, 8, 400), stage, "xy", "split 13", vs_float64=True)


@pytest.mark.parametrize("shape,c,vs_float64", [((1, 4, 16, 40), 2, False),
                                              ((1, 4, 8, 100), 4, True)])
def test_host_build_of_k5_split_is_single_cta_k5_bit_for_bit(host_binary, tmp_path, shape, c,
                                                             vs_float64):
    """Where one CTA holds the column, the split computes each point with
    single-CTA K5's own operations: its stage 1 outputs equal single-CTA
    K5's bit for bit (on the host, which contracts no FMA). Each run holds
    its gates first (at 100 levels the float64 rule above, which single-CTA
    K5 needs there too)."""
    outs = {}
    for kernel in ("xy", f"split{c}"):
        d = tmp_path / kernel
        d.mkdir()
        _, _, got = run_stage(host_binary, d, shape, 1, kernel, vs_float64=vs_float64)
        outs[kernel] = {n: (d / n).read_bytes()
                        for n in ("u_out", "v_out", "w_out", "b_out", "div", "gu", "gv", "gw",
                                  "gb")}
    assert outs["xy"] == outs[f"split{c}"]


@pytest.mark.parametrize("nz", [2, 32, 106, 107, 112, 128, 198, 199, 392, 393, 512, 784, 785,
                                1000, 4096])
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
    assert c == (0 if one_cta else -(-nz // 32))
    limit = s3.stage_kernel_limit("stage_xy", torch.float32, 64, 64, nz)
    assert (limit is None) == (one_cta or c > 0), limit
