#!/usr/bin/env python3
"""Time the stage kernels of several source trees on one CUDA card.

    python3 scripts/kernel_variants.py
        [--kernels k1,k1c,k1c_times,k1r,k1r_times,k1o,k1g,k1g_times,k1t,k1t_times,
                   k2,k3,k3r,k3r_times,k3qp,k5_training,k5,k5r,k5r_times,k5z,k5z_times,
                   k6,k7,field_step]
        TREE [TREE ...]

Each TREE is a checkout of this repo (for example a ``git archive`` of a
commit unpacked under the git-ignored ``rbc_gym_tpu_torch/_build/``).
The script builds every tree's kernels at once (one nvcc each, in
parallel, plus one ``-Xptxas -v`` compile of each ``csrc/*.cu`` for the
registers, spills and shared memory of K1 to K7, a count of the SASS
opcodes of their main instances from ``cuobjdump``, and one ``-ptx``
compile whose every kernel's PTX, with the file's hash and label numbers
taken out, each later tree holds against the first's: a ``ptx`` line of
the kernels that differ and those only one tree has), then runs each
tree in a process of its own, one after the other, importing that tree's
own ``chip_smoke``. Per tree and kernel, CUDA events after a warm-up, the
share of the bound (``chip_smoke.bound``) and the errors at the smoke's
gates:

- ``k1``: K1 (``env_step_2d``) at 1024 envs on 96x64, one env step of 50
  substeps; its gates (6 substeps at 128 envs, 50 at 1024 envs) and a
  50-substep step at 64 envs against a float64 plain run, beside the
  float32 plain version's own error;
- ``k1c``: K1 at 1024 envs, one env step of 50 substeps, at each
  precision (float32, "high", "default") on ``K1C_GRIDS``: 128x64 and
  192x64 (its cluster instance where the tree has one, else its off-chip
  instance) and 128x32, 64x64 and 128x40 (on the chip), with float32 K1
  on 96x64 timed first and last; the gates at 6 substeps and 128 envs at
  each precision, and ``env_step_2d_occupancy``; and the TF32 times of
  builds of the tree's ``csrc/rbc2d.cu`` cut for timing only
  (``ablate_k1c``; outputs wrong, never gated): without the products,
  without the march, and on the wgmma design without the z or the x
  products' wgmma; and of two variants (``K1C_VARIANTS``): a
  neighbour's slab staged in shared memory in place of distributed
  shared memory, three k-steps in flight; ``k1c_times`` the same without
  the cut builds;
- ``k1r``: K1's runtime-size instances at 1024 envs, one env step of 50
  substeps, at each precision on ``K1R_GRIDS``: 64x64, 128x32, 128x40,
  96x32 and 48x32 on the chip, 256x32 and 160x64 on a cluster of two
  CTAs, with float32 K1 on 96x64 timed first and last; the gates at 6
  substeps and 128 envs at each precision, and ``env_step_2d_occupancy``;
  and every time again from builds of the tree's ``csrc/rbc2d.cu`` cut for
  timing only (``ablate_k1r``; outputs wrong, never gated): without the
  solve's products (float32 and TF32) and without the march;
  ``k1r_times`` the same without the cut builds;
- ``k3r``, ``k5r``: K3 on ``K3R_GRIDS`` and K5 on ``K5R_GRIDS``
  (``chip_smoke.py`` phase 43's grids, K5's with more heights about its
  buckets' lower edges), each stage at 1024 envs (a case of 8 envs tiled),
  its bound, ps a cell, plain version and the card's occupancy of the
  instance; phase 43's gates at 8 envs (past ``RUNTIME_ABS_GATE_MAX_NZ``
  levels against float64; a tree without phase 43 holds every grid to the
  absolute gates) and stage 0 beside float64; and the first grid's times
  again from builds of the
  tree's ``csrc/rbc3d.cu`` cut for timing only (``ablate_k3r``,
  ``ablate_k5r``; outputs wrong, never gated): "noz2" the second z-flux
  evaluations of the runtime-size code taken by shuffle, "nophy" without
  the plane loop's pHY', "bounds" the runtime-size instance's launch bounds
  at its launched threads, and their sum; K5 also "split" (its z split
  from nz = 97, timed on 106x64x16), "noedge" (the z fluxes a bucket's
  warp-edge lanes compute themselves left out) and "bounds1" (every
  bucket's launch bounds at one block an SM); ``k3r_times`` and
  ``k5r_times`` the same without the cut builds;
- ``k1o``: K1's off-chip instance (its slabs in shared memory) at 1024
  envs on 127x64, one env step of 50 substeps, float32 and "high", with
  float32 K1 on 96x64 timed first and last; its gates at 6 substeps and
  128 envs;
- ``k1g``: K1's off-chip instance, one env step of 6 substeps, float32
  at 1024 envs on 256x128 (dt_solver 0.005, its slabs in global scratch)
  and on 127x64 (its slabs in shared memory) and at 64 envs on 512x256
  (dt_solver 0.0015), "high" and "default" on 256x128, with float32 K1 on
  96x64 timed first and last, the occupancy of each grid's instance; and
  the split of the float32 times: the same instance built three times
  more from the tree's ``csrc/rbc2d.cu`` cut for timing only
  (``ablate_k1g``; outputs wrong, never gated), without the solve's four
  products, without the march (pHY', the tendencies and the RK update),
  and without both (what is left: the divergence, the correction and the
  barriers); on the fused-march design also without parts of the march:
  pHY', the z fluxes, the x fluxes, the previous stage's tendencies. Its gates at 6
  substeps and 8 envs on 256x128 (float32, "high", "default") and 127x64;
  ``k1g_times`` the same without the cuts;
- ``k1t``: K1's TF32 instances at 96x64 ("high": 3 passes, "default": 1)
  at 1024 envs, one env step of 50 substeps, with float32 K1 timed first
  and last, and the split of each instance's time: the same instances
  built twice more from the tree's ``csrc/rbc2d.cu`` cut for timing only
  (``ablate_k1``; their outputs are wrong and never gated), once without
  the solve's four products (and the bulk copies of their constants where
  the tree has them) and once without the march (phase 2, which float32
  K1 shares): products = whole - no products, march = whole - no march,
  the rest what is left. Their gates at 6 substeps and 128 envs, and
  ``env_step_2d_occupancy`` of the three instances; ``k1t_times`` the
  same without the cuts (for trees whose solve was changed by hand);
- ``k2``: K2 (``tendencies_2d``) at 1024 envs on 96x64, 128x64 and 96x80
  (in this tree's design: the specialised and runtime march and the general
  instance), with its share of its own bound and of the Pallas kernel's;
  its gate on 96x64 (against the plain version run in float64 where the
  tree's K2 takes b, beside the float32 plain version), and one
  ``Solver2D.substep`` at 1024 envs on 96x64;
- ``k3``: K3 (``stage_rk_3d``) at 1024 envs on 16x32x32, stages 0, 1, 2;
  its gates at 1024 envs (each stage fed the plain outputs of the one
  before) and stage 0 at 32 envs against a float64 plain run;
- ``k3qp``: K3's analysis instance (``stage_rk_3d_rhat``, ``fused=
  "stage_qp"``) at 1024 envs on 16x32x32, stages 0, 1, 2, beside K3 on the
  same inputs in the same process; its gates (``k3_analysis_parity``), and
  where the tree has it, ``march_occupancy`` of both. Each tree's rhat of
  the three stages on one seeded case is compared with the first tree's
  (a line ``k3qp_rhat``: max |difference| a stage, and whether bit for bit);
- ``k5_training``: K5 (``stage_rk_3d_xy``) forced on the same grid and
  inputs, K3's yardstick;
- ``k5``: K5 at 1024 envs on the 32x64x64 big grid, as ``k3``, with stage
  0 at 8 envs against float64;
- ``k5z``: K5's z split at 16 envs on 128x128x128 (``chip_smoke.FINE_SHAPE_3D``,
  dt_solver ``FINE_DT_3D``), stages 0, 1, 2, and at one env (the flow
  statistics' launch), with ``stage_xy_occupancy``; its gates
  (``chip_smoke.split_stage_parity``); and the split of its time: the same
  instance built from the tree's ``csrc/rbc3d.cu`` cut for timing only
  (``ablate_k5z``; outputs wrong, never gated), once a cut of ``K5Z_CUTS``:
  "sync" the plane's cluster barrier as a CTA barrier (one cluster barrier
  kept before exit), "nophy" the loop's pHY' passes skipped, "c4" the
  launcher's rule forced onto four CTAs or more, and their combinations;
  ``k5z_times`` the same without the cuts;
- ``k6``: K6 (``field_tendency_3d``), each field, at 1024 envs on 16x32x32
  and on 16x32x30 (its march instance in this tree) and at 128 envs on
  32x64x64 (its general instance); its gates there, and each field at 32
  envs on 16x32x32 against a float64 plain run;
- ``k7``: K7 (``div_3d``) on the same grids, with its gates;
- ``field_step``: one env step of ``fused="field"`` at 1024 envs on
  16x32x32 (``Solver3D.env_step``, CUDA events).

One JSON line per tree and kernel, then the card's name and power limit.
A tree that does not build is reported and skipped. Exits non-zero
without a card or if any tree fails.
"""

from __future__ import annotations

import difflib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

MEASURE = r"""
import json, os, sys
import torch
import chip_smoke as cs
from rbc_gym_tpu_torch.ops import kernels3d as k3d
from rbc_gym_tpu_torch.sim.solver2d import Fields2D

device = torch.device("cuda")
tree, kernels = sys.argv[1], sys.argv[2].split(",")
ok = True


def gated(errs):
    return {k: {"error": v[0], "atol": v[1]} for k, v in errs.items()}


def outs(o):
    return (*o[:5], *o[5])


def k1():
    solver, case = cs.make_case(device, 1024, (64, 96), 1.5, seed=2)
    n_sub = solver.params.substeps_per_env_step
    ms = cs._cuda_ms(lambda: cs.k1_run(solver, case, True), 3)
    bound_ms, by = cs.bound(cs.env_step_work(1024, 96, 64, n_sub))
    rec = {"ms": ms, "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / ms}
    errs = {"env_step_50": (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(solver, case, True),
                                             cs.k1_run(solver, case, False)).values()),
                            cs.K1_MAIN_ATOL)}
    del case
    s6, c6 = cs.make_case(device, 128, (64, 96), 0.18)
    errs["env_step_6"] = (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(s6, c6, True),
                                           cs.k1_run(s6, c6, False)).values()), cs.K1_ATOL)
    s32, c32 = cs.make_case(device, 64, (64, 96), 1.5, seed=3)
    ref = cs.k1_run(*cs.make_case(device, 64, (64, 96), 1.5, seed=3, dtype=torch.float64), False)
    rec["float64_50_substeps_vs"] = {
        "kernel": cs.abs_diffs(cs.K1_OUT, ref, cs.k1_run(s32, c32, True)),
        "plain_float32": cs.abs_diffs(cs.K1_OUT, ref, cs.k1_run(s32, c32, False))}
    return rec, errs


K1C_CUTS, K1C_DIR = (("products", "march", "noz", "nox", "staged", "wait2"),
                     "rbc_gym_tpu_torch/_build/k1c")
K1C_VARIANTS = ("staged", "wait2")  # builds that change the design, not cut it
# k1c's grids (nz, nx): the cluster instance's 128x64 and 192x64, the
# on-chip instance's 128x32 and 64x64 (off 96x64: its runtime-size TF32
# instances where the tree has no other) and 128x40 (its runtime-size one)
K1C_GRIDS = ((64, 128), (64, 192), (32, 128), (64, 64), (40, 128))
K1C_PRECISIONS = (("float32", None), ("bf16x3", "high"), ("default", "default"))


def k1c(cuts=True):
    # K1 on K1C_GRIDS at each precision, float32 K1 on 96x64 timed first and
    # last in the same process, and with cuts the TF32 launches from the
    # ablated libraries main() built beside the tree's own
    import ctypes
    from rbc_gym_tpu_torch.ops import _build, kernels2d as k2d, limits

    def k1_ms(shape, prec=None, reps=3):
        solver, case = cs.make_case(device, 1024, shape, 1.5, seed=2)
        ms = cs._cuda_ms(lambda: cs.k1_run(solver, case, True, prec), reps)
        del case
        torch.cuda.empty_cache()
        return solver, ms

    rec, errs = {"k1_96x64_first_ms": k1_ms((64, 96))[1]}, {}
    for shape in K1C_GRIDS:
        nz, nx = shape
        c = getattr(limits, "env_step_2d_cluster_size", lambda *_: 0)(nx, nz)
        on_chip = limits.env_step_2d_on_chip(nx, nz)
        r = {"instance": f"cluster {c}" if c else ("on_chip" if on_chip else "off_chip")}
        for name, prec in K1C_PRECISIONS:
            solver, ms = k1_ms(shape, prec)
            bound_ms, by = cs.bound(cs.env_step_work(1024, nx, nz,
                                                     solver.params.substeps_per_env_step, prec))
            r[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                       "share_of_bound": bound_ms / ms}
            if hasattr(k2d, "env_step_2d_occupancy"):
                r[name]["occupancy"] = k2d.env_step_2d_occupancy(nx, nz, prec)
        s6, c6 = cs.make_case(device, 128, shape, 0.18, seed=4)
        errs[f"{nx}x{nz}_6"] = (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(s6, c6, True),
                                                 cs.k1_run(s6, c6, False)).values()), cs.K1_ATOL)
        errs[f"{nx}x{nz}_6_bf16x3"] = (max(cs.abs_diffs(
            cs.K1_OUT, cs.k1_run(s6, c6, True, "high"),
            cs.k1_run(s6, c6, False, "high")).values()), cs.K1_ATOL)
        one = cs.k1_tf32_errors(s6, c6, cs.k1_run(s6, c6, True, "default"))
        errs[f"{nx}x{nz}_6_default"] = (one["kernel"], one["bound"])
        rec[f"{nx}x{nz}"] = r
        del c6
    real = _build.load_library
    for what in K1C_CUTS if cuts else ():
        if not os.path.exists(f"{K1C_DIR}/{what}/lib.so"):  # a cut the tree's design has not
            continue
        lib = ctypes.CDLL(f"{K1C_DIR}/{what}/lib.so")
        for fn_name, argtypes in _build.ARGTYPES.items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        _build.load_library = lambda lib=lib: lib
        try:
            for nz, nx in K1C_GRIDS:
                for name, prec in K1C_PRECISIONS[1:]:
                    key = f"{what}_ms" if what in K1C_VARIANTS else f"no_{what}_ms"
                    rec[f"{nx}x{nz}"][name][key] = k1_ms((nz, nx), prec)[1]
        finally:
            _build.load_library = real
    for nz, nx in K1C_GRIDS:
        for name, _ in K1C_PRECISIONS[1:] if cuts else ():
            r = rec[f"{nx}x{nz}"][name]
            if "no_products_ms" in r and "no_march_ms" in r:
                products, march = r["ms"] - r["no_products_ms"], r["ms"] - r["no_march_ms"]
                r["split_ms"] = {"products": products, "march": march,
                                 "rest": r["ms"] - products - march}
    rec["k1_96x64_last_ms"] = k1_ms((64, 96))[1]
    return rec, errs


# k1r's grids (nz, nx): the on-chip runtime-size instance's 64x64, 128x32,
# 128x40, 96x32 and 48x32, and the cluster's 256x32 (2 x 128x32) and 160x64
# (2 x 80x64)
K1R_GRIDS = ((64, 64), (32, 128), (40, 128), (32, 96), (32, 48), (32, 256), (64, 160))
K1R_CUTS, K1R_DIR = ("products", "march"), "rbc_gym_tpu_torch/_build/k1r"


def k1r(cuts=True):
    # K1 on K1R_GRIDS at each precision, float32 K1 on 96x64 timed first and
    # last in the same process, and with cuts every launch again from the
    # ablated libraries main() built beside the tree's own
    import ctypes
    from rbc_gym_tpu_torch.ops import _build, kernels2d as k2d, limits

    def k1_ms(shape, prec=None, reps=3):
        solver, case = cs.make_case(device, 1024, shape, 1.5, seed=2)
        ms = cs._cuda_ms(lambda: cs.k1_run(solver, case, True, prec), reps)
        del case
        torch.cuda.empty_cache()
        return solver, ms

    rec, errs = {"k1_96x64_first_ms": k1_ms((64, 96))[1]}, {}
    for shape in K1R_GRIDS:
        nz, nx = shape
        c = limits.env_step_2d_cluster_size(nx, nz)
        r = {"instance": f"cluster {c}" if c else "on_chip"}
        for name, prec in K1C_PRECISIONS:
            solver, ms = k1_ms(shape, prec)
            bound_ms, by = cs.bound(cs.env_step_work(1024, nx, nz,
                                                     solver.params.substeps_per_env_step, prec))
            r[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                       "share_of_bound": bound_ms / ms,
                       "occupancy": k2d.env_step_2d_occupancy(nx, nz, prec)}
        s6, c6 = cs.make_case(device, 128, shape, 0.18, seed=4)
        errs[f"{nx}x{nz}_6"] = (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(s6, c6, True),
                                                 cs.k1_run(s6, c6, False)).values()), cs.K1_ATOL)
        errs[f"{nx}x{nz}_6_bf16x3"] = (max(cs.abs_diffs(
            cs.K1_OUT, cs.k1_run(s6, c6, True, "high"),
            cs.k1_run(s6, c6, False, "high")).values()), cs.K1_ATOL)
        one = cs.k1_tf32_errors(s6, c6, cs.k1_run(s6, c6, True, "default"))
        errs[f"{nx}x{nz}_6_default"] = (one["kernel"], one["bound"])
        rec[f"{nx}x{nz}"] = r
        del c6
    real = _build.load_library
    for what in K1R_CUTS if cuts else ():
        if not os.path.exists(f"{K1R_DIR}/{what}/lib.so"):
            continue
        lib = ctypes.CDLL(f"{K1R_DIR}/{what}/lib.so")
        for fn_name, argtypes in _build.ARGTYPES.items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        _build.load_library = lambda lib=lib: lib
        try:
            for nz, nx in K1R_GRIDS:
                for name, prec in K1C_PRECISIONS:
                    rec[f"{nx}x{nz}"][name][f"no_{what}_ms"] = k1_ms((nz, nx), prec)[1]
        finally:
            _build.load_library = real
    for nz, nx in K1R_GRIDS:
        for name, _ in K1C_PRECISIONS if cuts else ():
            r = rec[f"{nx}x{nz}"][name]
            if "no_products_ms" in r and "no_march_ms" in r:
                products, march = r["ms"] - r["no_products_ms"], r["ms"] - r["no_march_ms"]
                r["split_ms"] = {"products": products, "march": march,
                                 "rest": r["ms"] - products - march}
    rec["k1_96x64_last_ms"] = k1_ms((64, 96))[1]
    return rec, errs


# k3r's and k5r's grids (nz, ny, nx), each at 1024 envs, the first of each
# the one its cuts are timed on: chip_smoke's phase 43 grids
K3R_GRIDS = ((16, 24, 24), (20, 16, 8), (7, 36, 12), (12, 32, 16), (32, 32, 16), (40, 16, 16),
             (80, 8, 16), (120, 8, 8), (33, 16, 16), (33, 13, 16), (65, 8, 16), (65, 7, 16),
             (97, 8, 8), (97, 5, 8))
# K5's: phase 43's, then more heights about its buckets' lower edges
K5R_GRIDS = ((48, 64, 64), (24, 64, 64), (50, 64, 32), (80, 64, 32), (96, 64, 16),
             (106, 64, 16), (40, 64, 16), (36, 64, 32), (95, 64, 16), (33, 64, 32),
             (44, 64, 16), (46, 64, 16), (47, 64, 16), (81, 64, 16), (88, 64, 16), (92, 64, 16),
             (94, 64, 16))
K3R_CUTS, K3R_DIR = ("noz2", "nophy", "bounds", "noz2_nophy_bounds"), "rbc_gym_tpu_torch/_build/k3r"
K5R_CUTS = ("noz2", "nophy", "bounds", "noz2_nophy_bounds", "split", "noedge", "bounds1",
            "nophy_noedge")
K5R_DIR = "rbc_gym_tpu_torch/_build/k5r"
if not hasattr(cs, "tiled_case"):  # a tree from before chip_smoke's phase 43
    cs.tiled_case = lambda case, n: {
        k: v.repeat(-(-n // case["u"].shape[0]), *([1] * (v.dim() - 1)))[:n].contiguous()
        for k, v in case.items()}


def runtime_times(wrapper, grids, cut_dir, cut_names, cuts, dt_solver=0.01):
    # each grid: the stages' times at 1024 envs (a case of 8 envs tiled),
    # bound, plain version and occupancy, phase 43's gates at 8 envs and
    # stage 0 beside float64; with cuts, the first grid's times (the "split" cut: the
    # last grid's) again from the ablated libraries main() built beside the
    # tree's own
    import ctypes
    from rbc_gym_tpu_torch.ops import _build

    def times(solver, case, reps=5):
        g_prev = cs.k3_run(solver, case, 0, None, False)[5]
        out = [cs._cuda_ms(lambda: cs.k3_run(solver, case, m, g_prev if m else None, True,
                                             wrapper), reps) for m in range(3)]
        del g_prev
        return out

    def big(shape):
        solver, case = cs.make_case_3d(device, 8, shape, seed=5, dt_solver=dt_solver)
        return solver, cs.tiled_case(case, 1024)

    def parity(solver, case, nz, prefix):
        # phase 43's gates: the absolute ones to RUNTIME_ABS_GATE_MAX_NZ levels,
        # against float64 past them (a tree from before phase 43: the absolute
        # ones at every nz)
        if nz > getattr(cs, "RUNTIME_ABS_GATE_MAX_NZ", nz):
            return cs.split_stage_parity(solver, case, prefix, wrapper)
        return cs.stage_parity(solver, case, wrapper, prefix=prefix)

    rec, errs = {}, {}
    for shape in grids:
        nz, ny, nx = shape
        name = "x".join(map(str, shape))
        solver, case = big(shape)
        r = {"stage_ms": times(solver, case)}
        g_prev = cs.k3_run(solver, case, 0, None, False)[5]
        r["plain_ms"] = [cs._cuda_ms(lambda: cs.k3_run(solver, case, m, g_prev if m else None,
                                                       False), 1) for m in range(3)]
        del case, g_prev
        torch.cuda.empty_cache()
        r["bound_ms"] = [cs.bound(cs.stage_rk_3d_work(1024, nx, ny, nz, m))[0] for m in range(3)]
        r["share_of_bound"] = [b / t for b, t in zip(r["bound_ms"], r["stage_ms"])]
        r["ps_a_cell"] = [1e9 * t / (1024 * nx * ny * nz) for t in r["stage_ms"]]
        r["occupancy"] = (k3d.march_occupancy(nx, ny, nz) if wrapper is k3d.stage_rk_3d
                          else k3d.stage_xy_occupancy(nz))
        solver, case = cs.make_case_3d(device, 8, shape, seed=10, dt_solver=dt_solver)
        _, e = parity(solver, case, nz, f"{name}_")
        errs.update(e)
        r["stage0_float64_vs"] = cs.stage0_float64(solver, case, wrapper)
        del case
        rec[name] = r
    real = _build.load_library
    for what in cut_names if cuts else ():
        if not os.path.exists(f"{cut_dir}/{what}/lib.so"):  # a cut the tree's design has not
            continue
        lib = ctypes.CDLL(f"{cut_dir}/{what}/lib.so")
        for fn_name, argtypes in _build.ARGTYPES.items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        _build.load_library = lambda lib=lib: lib
        shape = grids[-1] if what == "split" else grids[0]
        try:
            solver, case = big(shape)
            rec["x".join(map(str, shape))][f"{what}_stage_ms"] = times(solver, case)
            del case
        finally:
            _build.load_library = real
        torch.cuda.empty_cache()
    first = "x".join(map(str, grids[0]))
    solver, case = big(grids[0])
    rec[first]["stage_ms_last"] = times(solver, case)
    return rec, errs


def k1o():
    # K1's off-chip instance on 127x64 (no cluster divides nx = 127)
    def k1_ms(shape, prec=None):
        solver, case = cs.make_case(device, 1024, shape, 1.5, seed=2)
        ms = cs._cuda_ms(lambda: cs.k1_run(solver, case, True, prec), 3)
        del case
        torch.cuda.empty_cache()
        return solver, ms

    rec, errs = {"k1_96x64_first_ms": k1_ms((64, 96))[1]}, {}
    solver, ms = k1_ms((64, 127))
    bound_ms, by = cs.bound(cs.env_step_work(1024, 127, 64, solver.params.substeps_per_env_step))
    rec["127x64"] = {"ms": ms, "ms_high": k1_ms((64, 127), "high")[1], "bound_ms": bound_ms,
                     "bound_by": by, "share_of_bound": bound_ms / ms}
    s6, c6 = cs.make_case(device, 128, (64, 127), 0.18, seed=4)
    errs["127x64_6"] = (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(s6, c6, True),
                                         cs.k1_run(s6, c6, False)).values()), cs.K1_ATOL)
    rec["k1_96x64_last_ms"] = k1_ms((64, 96))[1]
    return rec, errs


ABLATIONS, K1T_DIR = ("products", "march"), "rbc_gym_tpu_torch/_build/k1t"
K5Z_CUTS = ("sync", "nophy", "sync_nophy", "c4", "c4_sync_nophy", "noface", "noedge",
            "nophy_noface_noedge")
K5Z_DIR = "rbc_gym_tpu_torch/_build/k5z"


def k1t(cuts=True):
    # K1's TF32 instances at 96x64 and, with cuts, their split from the
    # ablated libraries main() built beside the tree's own
    import ctypes
    from rbc_gym_tpu_torch.ops import _build, kernels2d as k2d

    solver, case = cs.make_case(device, 1024, (64, 96), 1.5, seed=2)
    n_sub = solver.params.substeps_per_env_step
    names = (("float32", None), ("bf16x3", "high"), ("default", "default"))

    def ms(prec):
        return cs._cuda_ms(lambda: cs.k1_run(solver, case, True, prec), 10)

    rec = {"float32_first_ms": ms(None)}
    for name, prec in names[1:]:
        bound_ms, by = cs.bound(cs.env_step_work(1024, 96, 64, n_sub, prec))
        t = ms(prec)
        rec[name] = {"ms": t, "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / t}
    real = _build.load_library
    for what in ABLATIONS if cuts else ():
        lib = ctypes.CDLL(f"{K1T_DIR}/{what}/lib.so")
        for fn_name, argtypes in _build.ARGTYPES.items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        _build.load_library = lambda lib=lib: lib
        try:
            for name, prec in names:
                if name != "float32" or what == "march":
                    rec.setdefault(name, {})[f"no_{what}_ms"] = ms(prec)
        finally:
            _build.load_library = real
    for name in ("bf16x3", "default") if cuts else ():
        r = rec[name]
        products, march = r["ms"] - r["no_products_ms"], r["ms"] - r["no_march_ms"]
        r["split_ms"] = {"products": products, "march": march,
                         "rest": r["ms"] - products - march}
    rec["float32_last_ms"] = ms(None)
    rec["occupancy"] = {name: k2d.env_step_2d_occupancy(96, 64, prec) for name, prec in names}
    del case
    s6, c6 = cs.make_case(device, 128, (64, 96), 0.18, seed=4)
    errs = {"bf16x3_6": (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(s6, c6, True, "high"),
                                          cs.k1_run(s6, c6, False, "high")).values()),
                         cs.K1_ATOL)}
    one = cs.k1_tf32_errors(s6, c6, cs.k1_run(s6, c6, True, "default"))
    errs["default_6"] = (one["kernel"], one["bound"])
    return rec, errs


def k5z(cuts=True):
    # K5's z split on 128x128x128 at 16 envs and at one env, and with cuts
    # the same launches from the ablated libraries main() built beside the
    # tree's own
    import ctypes
    from rbc_gym_tpu_torch.ops import _build, limits

    shape = cs.FINE_SHAPE_3D
    nz, ny, nx = shape
    wrapper = k3d.stage_rk_3d_xy

    def times(n_env, reps):
        solver, case = cs.make_case_3d(device, n_env, shape, seed=41, dt_solver=cs.FINE_DT_3D)
        g_prev = cs.k3_run(solver, case, 0, None, False)[5]
        out = []
        for m in range(3):
            gp = g_prev if m else None
            out.append(cs._cuda_ms(lambda: cs.k3_run(solver, case, m, gp, True, wrapper), reps))
        return out

    rec = {"ctas": limits.stage_xy_split_size(nz), "stage_ms": times(16, 5)}
    rec["bound_ms"] = [cs.bound(cs.stage_rk_3d_work(16, nx, ny, nz, m))[0] for m in range(3)]
    rec["share_of_bound"] = [b / t for b, t in zip(rec["bound_ms"], rec["stage_ms"])]
    rec["one_env_stage_ms"] = times(1, 20)
    if hasattr(k3d, "stage_xy_occupancy"):
        rec["occupancy"] = k3d.stage_xy_occupancy(nz)
    real = _build.load_library
    for what in K5Z_CUTS if cuts else ():
        if not os.path.exists(f"{K5Z_DIR}/{what}/lib.so"):  # a cut the tree's design has not
            continue
        lib = ctypes.CDLL(f"{K5Z_DIR}/{what}/lib.so")
        for fn_name, argtypes in _build.ARGTYPES.items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        _build.load_library = lambda lib=lib: lib
        try:
            rec[f"{what}_stage_ms"] = times(16, 5)
            rec[f"{what}_occupancy"] = k3d.stage_xy_occupancy(nz)
        finally:
            _build.load_library = real
    rec["stage_ms_last"] = times(16, 5)
    solver, case = cs.make_case_3d(device, 16, shape, seed=41, dt_solver=cs.FINE_DT_3D)
    rec["by_stage"], errs = cs.split_stage_parity(solver, case)
    return rec, errs


K1G_CUTS = ("noproducts", "nomarch", "noproducts_nomarch", "nophy", "noz", "nox", "nog")
K1G_DIR = "rbc_gym_tpu_torch/_build/k1g"
# k1g's grids, each one env step of 6 substeps: (name, (nz, nx), envs,
# dt_solver): 256x128 and 512x256 take the off-chip instance with its slabs
# in global scratch, 127x64 the one with its slabs in shared memory
K1G_GRIDS = (("256x128", (128, 256), 1024, 0.005), ("127x64", (64, 127), 1024, 0.03),
             ("512x256", (256, 512), 64, 0.0015))


def k1g(cuts=True):
    # K1's off-chip instance on K1G_GRIDS, float32 (and on 256x128 "high" and
    # "default"), float32 K1 on 96x64 timed first and last, and with cuts the
    # same float32 launches from the ablated libraries main() built beside the
    # tree's own
    import ctypes
    from rbc_gym_tpu_torch.ops import _build, kernels2d as k2d

    def case(shape, n_env, dt, seed=2):
        return cs.make_case(device, n_env, shape, 6 * dt, seed=seed, dt_solver=dt)

    def times(prec=None, grids=K1G_GRIDS):
        out = {}
        for name, shape, n_env, dt in grids:
            solver, c = case(shape, n_env, dt)
            assert solver.params.substeps_per_env_step == 6
            out[name] = cs._cuda_ms(lambda: cs.k1_run(solver, c, True, prec), 3)
            del c
            torch.cuda.empty_cache()
        return out

    def k1_96x64():
        solver, c = cs.make_case(device, 1024, (64, 96), 1.5, seed=2)
        return cs._cuda_ms(lambda: cs.k1_run(solver, c, True), 3)

    rec = {"k1_96x64_first_ms": k1_96x64(), "ms": times()}
    for name, shape, n_env, dt in K1G_GRIDS:
        nz, nx = shape
        bound_ms, by = cs.bound(cs.env_step_work(n_env, nx, nz, 6))
        rec[name] = {"envs": n_env, "dt_solver": dt, "bound_ms": bound_ms, "bound_by": by,
                     "share_of_bound": bound_ms / rec["ms"][name],
                     "occupancy": k2d.env_step_2d_occupancy(nx, nz)}
    for prec in ("high", "default"):
        rec[f"ms_{prec}"] = times(prec, K1G_GRIDS[:1])
    real = _build.load_library
    for what in K1G_CUTS if cuts else ():
        if not os.path.exists(f"{K1G_DIR}/{what}/lib.so"):  # a cut the tree's design has not
            continue
        lib = ctypes.CDLL(f"{K1G_DIR}/{what}/lib.so")
        for fn_name, argtypes in _build.ARGTYPES.items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        _build.load_library = lambda lib=lib: lib
        try:
            rec[f"{what}_ms"] = times()
        finally:
            _build.load_library = real
    if cuts and all(f"{w}_ms" in rec for w in K1G_CUTS):
        rec["split_ms"] = {}
        for name, *_ in K1G_GRIDS:
            whole = rec["ms"][name]
            products = whole - rec["noproducts_ms"][name]
            march = whole - rec["nomarch_ms"][name]
            rec["split_ms"][name] = {"products": products, "march": march,
                                     "rest": rec["noproducts_nomarch_ms"][name]}
    rec["ms_last"] = times()
    rec["k1_96x64_last_ms"] = k1_96x64()
    errs = {}
    for name, shape, _, dt in K1G_GRIDS[:2]:
        s6, c6 = case(shape, 8, dt, seed=4)
        errs[f"{name}_6"] = (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(s6, c6, True),
                                              cs.k1_run(s6, c6, False)).values()), cs.K1_ATOL)
        if name == "256x128":
            errs[f"{name}_6_bf16x3"] = (max(cs.abs_diffs(
                cs.K1_OUT, cs.k1_run(s6, c6, True, "high"),
                cs.k1_run(s6, c6, False, "high")).values()), cs.K1_ATOL)
            one = cs.k1_tf32_errors(s6, c6, cs.k1_run(s6, c6, True, "default"))
            errs[f"{name}_6_default"] = (one["kernel"], one["bound"])
    return rec, errs


def k2():
    rec = {}
    for shape in ((64, 96), (64, 128), (80, 96)):
        nz, nx = shape
        solver, case = cs.make_case(device, 1024, shape, 1.5, seed=2)
        ms = cs._cuda_ms(lambda: cs.k2_run(solver, case, True), 50, warmup=3)
        pallas_ms, by = cs.bound(cs.tendencies_work(1024, nx, nz))
        rec[f"{nx}x{nz}"] = {"ms": ms, "pallas_bound_ms": pallas_ms, "bound_by": by,
                             "share_of_pallas_bound": pallas_ms / ms}
        if hasattr(cs, "tendencies_own_work"):  # K2 that takes b: its own bound
            bound_ms, by = cs.bound(cs.tendencies_own_work(1024, nx, nz))
            rec[f"{nx}x{nz}"].update(bound_ms=bound_ms, bound_by=by,
                                     share_of_bound=bound_ms / ms)
        if shape == (64, 96):
            got = cs.k2_run(solver, case, True)
            if hasattr(cs, "k2_errors"):  # K2 sums pHY' in float64: gated in float64
                e = cs.k2_errors(solver, case, got)
                rec["float64_vs"] = {k: e[k] for k in ("kernel", "plain_float32")}
                rec["vs_plain_float32"] = e["kernel_vs_plain_float32"]
            else:  # a K2 that reads p_hy, against its plain version from the same p_hy
                plain = cs.k2_run(solver, case, False)
                e = {"kernel": cs.abs_diffs(cs.K2_OUT, got, plain)}
            errs = {"tendencies_2d": (max(e["kernel"].values()), cs.K2_ATOL)}
            zeros = torch.zeros_like(case["u"])
            f = Fields2D(case["u"], case["w"], case["b"], zeros, zeros)
            rec["substep_ms"] = cs._cuda_ms(lambda: solver.substep(f, case["bottom"]), 10)
            del got
        del case
        torch.cuda.empty_cache()
    return rec, errs


def stage(wrapper, shape, dt_solver, f64_envs, reps):
    nz, ny, nx = shape
    solver, case = cs.make_case_3d(device, 1024, shape, seed=5, dt_solver=dt_solver)
    g_prev = cs.k3_run(solver, case, 0, None, False)[5]
    rec = {}
    for m in range(3):
        gp = g_prev if m else None
        ms = cs._cuda_ms(lambda: cs.k3_run(solver, case, m, gp, True, wrapper), reps)
        bound_ms, by = cs.bound(cs.stage_rk_3d_work(1024, nx, ny, nz, m))
        rec[f"stage{m}"] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                            "share_of_bound": bound_ms / ms}
    rec["mean_ms"] = sum(rec[f"stage{m}"]["ms"] for m in range(3)) / 3
    del g_prev
    _, errs = cs.stage_parity(solver, case, wrapper)
    del case
    solver, case = cs.make_case_3d(device, f64_envs, shape, seed=10, dt_solver=dt_solver)
    case64 = {k: v.double() for k, v in case.items()}
    ref = outs(cs.k3_run(solver, case64, 0, None, False))
    names = cs.K3_OUT + cs.G_OUT
    rec["stage0_float64_vs"] = {
        "kernel": cs.abs_diffs(names, ref, outs(cs.k3_run(solver, case, 0, None, True, wrapper))),
        "plain_float32": cs.abs_diffs(names, ref, outs(cs.k3_run(solver, case, 0, None, False)))}
    return rec, errs


# K6's and K7's grids: the field path's, the grid auto sends there (both
# K6's march instance) and the big grid forced (K6's general instance)
FIELD_GRIDS = (("training", (16, 32, 32), 1024, 0.01), ("odd_nx", (16, 32, 30), 1024, 0.01),
               ("big", cs.BIG_SHAPE, 128, cs.BIG_DT_SOLVER))


def k6():
    rec, errs = {}, {}
    for name, shape, n_env, dt_solver in FIELD_GRIDS:
        nz, ny, nx = shape
        solver, case = cs.make_case_3d(device, n_env, shape, seed=14, dt_solver=dt_solver)
        r = {}
        for f in "uvwb":
            ms = cs._cuda_ms(lambda: cs.k6_run(solver, case, f, True), 20, warmup=3)
            bound_ms, by = cs.bound(cs.field_tendency_3d_work(n_env, nx, ny, nz, f))
            r[f] = {"ms": ms, "bound_ms": bound_ms, "share_of_bound": bound_ms / ms}
            errs[f"{name}_g{f}"] = (cs.abs_diffs(["g"], [cs.k6_run(solver, case, f, True)],
                                                 [cs.k6_run(solver, case, f, False)])["g"],
                                    cs.K6_ATOL)
        r["mean_ms"] = sum(r[f]["ms"] for f in "uvwb") / 4
        rec[name] = r
        del case
        torch.cuda.empty_cache()
    solver, case = cs.make_case_3d(device, 32, (16, 32, 32), seed=16)
    case64 = {k: v.double() for k, v in case.items()}
    rec["float64_vs"] = {}
    for f in "uvwb":
        ref = [cs.k6_run(solver, case64, f, False)]
        rec["float64_vs"][f"g{f}"] = {
            "kernel": cs.abs_diffs(["g"], ref, [cs.k6_run(solver, case, f, True)])["g"],
            "plain_float32": cs.abs_diffs(["g"], ref, [cs.k6_run(solver, case, f, False)])["g"]}
    return rec, errs


def k7():
    rec, errs = {}, {}
    for name, shape, n_env, dt_solver in FIELD_GRIDS:
        nz, ny, nx = shape
        solver, case = cs.make_case_3d(device, n_env, shape, seed=14, dt_solver=dt_solver)
        ms = cs._cuda_ms(lambda: cs.k7_run(solver, case, True), 20)
        bound_ms, by = cs.bound(cs.div_3d_work(n_env, nx, ny, nz))
        rec[name] = {"ms": ms, "bound_ms": bound_ms, "share_of_bound": bound_ms / ms}
        errs[f"{name}_div"] = (cs.abs_diffs(["d"], [cs.k7_run(solver, case, True)],
                                            [cs.k7_run(solver, case, False)])["d"], cs.K7_ATOL)
        del case
        torch.cuda.empty_cache()
    return rec, errs


# where a tree's k3qp run leaves its rhat (the tree's git-ignored build
# directory), for the comparison across trees
K3QP_RHAT = "rbc_gym_tpu_torch/_build/k3qp_rhat.pt"


def k3qp():
    shape = (16, 32, 32)
    nz, ny, nx = shape
    solver, case = cs.make_case_3d(device, 1024, shape, seed=11, dtype=torch.float32,
                                   fused="stage_qp")
    inputs = cs.stage_inputs(case)
    g_prev = k3d.stage_rk_3d_plain(*inputs, solver.coeffs, 0.04, 0)[5]
    rec, rhat = {}, []
    for m in range(3):
        gp = g_prev if m else None

        def run(wrapper, m=m, gp=gp):
            return wrapper(*inputs, solver.coeffs, 0.04, m, gp)

        ms = cs._cuda_ms(lambda: run(k3d.stage_rk_3d_rhat), 20)
        bound_ms, by = cs.bound(cs.stage_rk_3d_rhat_work(1024, nx, ny, nz, m))
        rec[f"stage{m}"] = {"ms": ms, "k3_ms": cs._cuda_ms(lambda: run(k3d.stage_rk_3d), 20),
                            "bound_ms": bound_ms, "bound_by": by,
                            "share_of_bound": bound_ms / ms}
        rhat.append(run(k3d.stage_rk_3d_rhat)[4].cpu())
    rec["mean_ms"] = sum(rec[f"stage{m}"]["ms"] for m in range(3)) / 3
    torch.save(rhat, K3QP_RHAT)
    del g_prev, rhat
    if hasattr(k3d, "march_occupancy"):
        rec["occupancy"] = {name: k3d.march_occupancy(nx, ny, nz, rhat=r)
                            for name, r in (("stage_rk_3d_rhat", True), ("stage_rk_3d", False))}
    _, errs = cs.k3_analysis_parity(solver, case)
    return rec, errs


def field_step():
    solver, case = cs.make_case_3d(device, 1024, (16, 32, 32), seed=14, fused="field")
    zeros = torch.zeros_like(case["u"])
    f = cs.s3d.Fields3D(case["u"], case["v"], case["w"], case["b"], zeros, zeros)
    actions = torch.zeros((1024, 8, 8), dtype=zeros.dtype, device=zeros.device)
    ms = cs._cuda_ms(lambda: solver.env_step(f, actions), 3)
    return {"path": solver.path, "env_step_ms": ms, "env_steps_per_s": 1024e3 / ms}, {}


RUNS = {
    "k1": k1,
    "k1c": k1c,
    "k1c_times": lambda: k1c(cuts=False),
    "k1r": k1r,
    "k1r_times": lambda: k1r(cuts=False),
    "k3r": lambda: runtime_times(k3d.stage_rk_3d, K3R_GRIDS, K3R_DIR, K3R_CUTS, True),
    "k3r_times": lambda: runtime_times(k3d.stage_rk_3d, K3R_GRIDS, K3R_DIR, K3R_CUTS, False),
    "k5r": lambda: runtime_times(k3d.stage_rk_3d_xy, K5R_GRIDS, K5R_DIR, K5R_CUTS, True,
                                 cs.BIG_DT_SOLVER),
    "k5r_times": lambda: runtime_times(k3d.stage_rk_3d_xy, K5R_GRIDS, K5R_DIR, K5R_CUTS, False,
                                       cs.BIG_DT_SOLVER),
    "k1o": k1o,
    "k1t": k1t,
    "k1t_times": lambda: k1t(cuts=False),
    "k1g": k1g,
    "k1g_times": lambda: k1g(cuts=False),
    "k2": k2,
    "k3": lambda: stage(k3d.stage_rk_3d, (16, 32, 32), 0.01, 32, 20),
    "k3qp": k3qp,
    "k5_training": lambda: stage(k3d.stage_rk_3d_xy, (16, 32, 32), 0.01, 32, 20),
    "k5": lambda: stage(k3d.stage_rk_3d_xy, cs.BIG_SHAPE, cs.BIG_DT_SOLVER, 8, 5),
    "k5z": k5z,
    "k5z_times": lambda: k5z(cuts=False),
    "k6": k6,
    "k7": k7,
    "field_step": field_step,
}
for name in kernels:
    rec, errs = RUNS[name]()
    torch.cuda.empty_cache()
    rec = {"tree": tree, "kernel": name, **rec, "gated": gated(errs),
           "gates_pass": all(v[0] <= v[1] for v in errs.values())}
    ok &= rec["gates_pass"]
    print(json.dumps(rec), flush=True)
sys.exit(0 if ok else 1)
"""

# K1's timing-only cuts of ``k1t`` (MEASURE's ABLATIONS and K1T_DIR, under
# the tree): each a library of ``csrc/rbc2d.cu`` alone, cut by ``ablate_k1``
ABLATIONS = ("products", "march")
K1T_DIR = Path("rbc_gym_tpu_torch") / "_build" / "k1t"


def ablate_k1(src: str, what: str) -> str:
    """``csrc/rbc2d.cu`` with a part of the on-chip K1's stage cut, for
    timing only: "march" empties phase 2's block (the tendencies and the RK
    update, which every instance shares), "products" drops the lines of the
    first TF32 solve between its "// ---- 4. the solve on the tensor cores"
    and "// ---- 5. correct" markers (the four products, and the waits for
    their constants) and, before them, the line that issues the bulk copy of
    F and G (``stage_fg(``) where the tree has one."""
    lines = src.split("\n")
    head = next(i for i, line in enumerate(lines) if "env_step_2d_kernel(const float*" in line)

    def find(text, start):
        return next(i for i in range(start, len(lines)) if text in lines[i])

    if what == "march":
        m = find("// ---- 2. tendencies and the RK update, marching along x", head)
        if lines[m + 1].strip() != "{":
            raise ValueError("phase 2 of K1 is not one block")
        depth, j = 0, m + 1
        while True:
            depth += lines[j].count("{") - lines[j].count("}")
            if depth == 0:
                break
            j += 1
        return "\n".join(lines[:m + 1] + ["      {}"] + lines[j + 1:])
    a = find("// ---- 4. the solve on the tensor cores", head)
    b = find("// ---- 5. correct", a)
    return "\n".join([line for line in lines[:a + 1] if "stage_fg(" not in line] + lines[b:])


# K1's TF32 cuts and variants of ``k1c`` (MEASURE's K1C_CUTS, K1C_VARIANTS and K1C_DIR)
K1C_CUTS = ("products", "march", "noz", "nox", "staged", "wait2")
K1C_DIR = Path("rbc_gym_tpu_torch") / "_build" / "k1c"


def ablate_k1c(src: str, what: str) -> str:
    """``csrc/rbc2d.cu`` with a part of K1's on-chip and cluster instances
    cut, for timing only: "march" empties phase 2's block of each kernel
    (the tendencies and the RK update), "products" drops, in each kernel,
    the lines of every TF32 solve from its "// ---- 4. the solve on the
    tensor cores" marker to the next "// ---- 5. correct" but the cluster
    barriers among them, and the lines that issue the bulk copies of F and
    G (``stage_fg(``) before them. "staged" is a variant, not a cut: the
    cluster's wgmma instances at 64 columns a CTA read a neighbour's slab
    from a copy in their own shared memory (``stage_slabs``, after the
    dead copy's first 2 nc floats, between block barriers) in place of
    distributed shared memory; its outputs hold the gates. The wgmma
    design's cuts: "noz" drops the z products' wgmma (products 2 and 3, and
    their constants' loads), "nox" the x products' (products 1 and 4; their
    bulk copies and waits stay); "wait2", a variant, lets three k-steps of
    a product be in flight (``wgmma_wait<2>``) in place of two."""
    wg_cuts = {"noz": (r"\n *wg_mma<kPasses, NW, NZ / 8>\(acc, consts\([^;]*;", ""),
               "nox": (r"\n *wg_mma<kPasses, NW, KC / 8>\(acc, WgSlabA[^;]*;", ""),
               "wait2": (r"wgmma_wait<1>\(\);  // k-step s - 1 is done",
                         "wgmma_wait<2>();  // k-step s - 2 is done")}
    if what in wg_cuts:
        old, new = wg_cuts[what]
        if not re.search(old, src):
            raise ValueError(f"{what}: no {old!r} in K1's wgmma solve")
        return re.sub(old, new, src)
    if what == "staged":
        old = ("            return q == r ? (const float*)slab : "
               "(const float*)cluster_map(slab, q);")
        if old not in src:
            raise ValueError("no wgmma slab source in the cluster instance")
        new = """            if (q == r || NXL != 64) {
              return q == r ? (const float*)slab : (const float*)cluster_map(slab, q);
            }
            __syncthreads();
            stage_slabs(D + 2 * nc, slab, (q - r + c) % c, 1);
            __syncthreads();
            return (const float*)(D + 2 * nc);"""
        return src.replace(old, new)
    lines = src.split("\n")
    heads = [i for i, line in enumerate(lines)
             if "env_step_2d_kernel(const float*" in line
             or "env_step_2d_cluster_kernel(const float*" in line]
    if len(heads) != 2:
        raise ValueError("K1's on-chip and cluster kernels are not where k1c looks")

    def find(text, start):
        i = next((i for i in range(start, len(lines)) if text in lines[i]), None)
        if i is None:
            raise ValueError(f"no {text!r} in K1")
        return i

    for head in reversed(heads):  # the later kernel first: the earlier's lines stay put
        end = next((i for i in range(head + 1, len(lines)) if lines[i].startswith("}")),
                   len(lines))
        if what == "march":
            m = find("// ---- 2. tendencies and the RK update, marching along x", head)
            if lines[m + 1].strip() != "{":
                raise ValueError("phase 2 of K1 is not one block")
            lines = lines[:m + 1] + ["      {}"] + lines[_block_end(lines, m + 1) + 1:]
        elif what == "products":
            out, i = lines[:head], head
            while i < end:
                if "// ---- 4. the solve on the tensor cores" in lines[i]:
                    b = find("// ---- 5. correct", i)
                    out += [lines[i]] + [x for x in lines[i + 1:b] if "cluster_barrier(" in x]
                    i = b
                else:
                    out.append(lines[i])
                    i += 1
            lines = [x for x in out[:head] ] + [x for x in out[head:] if "stage_fg(" not in x] \
                + lines[end:]
        else:
            raise ValueError(f"unknown cut {what}")
    return "\n".join(lines)


# K1's runtime-size cuts of ``k1r`` (MEASURE's K1R_CUTS and K1R_DIR)
K1R_CUTS = ("products", "march")
K1R_DIR = Path("rbc_gym_tpu_torch") / "_build" / "k1r"


def ablate_k1r(src: str, what: str) -> str:
    """``csrc/rbc2d.cu`` with a part of K1's on-chip and cluster instances
    cut, for timing only: "march" as ``ablate_k1c``; "products" the TF32
    solves as ``ablate_k1c`` and, in each kernel, the float32 solve: the
    lines from its "// ---- 4. the solve: " marker to the next "// ---- 5.
    correct" but its ``if constexpr (kPasses == 0) {`` and the cluster
    barriers among them."""
    if what == "march":
        return ablate_k1c(src, what)
    lines = ablate_k1c(src, "products").split("\n")
    out, i, found = [], 0, 0
    while i < len(lines):
        if "// ---- 4. the solve: " in lines[i]:
            b = next(j for j in range(i, len(lines)) if "// ---- 5. correct" in lines[j])
            out += [lines[i]] + [x for x in lines[i + 1:b] if "cluster_barrier(" in x
                                 or x.strip() == "if constexpr (kPasses == 0) {"]
            i, found = b, found + 1
        else:
            out.append(lines[i])
            i += 1
    if found < 2:
        raise ValueError("K1's float32 solves are not where k1r looks")
    return "\n".join(out)


# K1's off-chip instance's timing-only cuts of ``k1g`` (MEASURE's K1G_CUTS and K1G_DIR)
K1G_CUTS = ("noproducts", "nomarch", "noproducts_nomarch", "nophy", "noz", "nox", "nog")
K1G_DIR = Path("rbc_gym_tpu_torch") / "_build" / "k1g"


def _block_end(lines: list, start: int) -> int:
    """The line that closes the brace block opened on line ``start`` (an
    ``else`` chain's braces included)."""
    depth = 0
    for j in range(start, len(lines)):
        depth += lines[j].count("{") - lines[j].count("}")
        if depth == 0:
            return j
    raise ValueError(f"the block on line {start} is not closed")


# ablate_k1g's cuts of parts of the fused march: (pattern, replacement) pairs
# over the off-chip instance's text
MARCH_CUTS = {
    "nophy": ((r"float pm = phy_at\([^;]*;", "float pm = 0.0f;"),
              (r"const float phy = phy_at\([^;]*;", "const float phy = 0.0f;")),
    "noz": ((r"const float zu = z_upwind\([^;]*;", "const float zu = 0.0f;"),
            (r"const float zb = z_upwind\([^;]*;", "const float zb = 0.0f;"),
            (r"const float zw = zflux_w\([^;]*;", "const float zw = 0.0f;"),
            (r"if \(lane == 0\) zw_dn = [^;]*;", "")),
    "nox": ((r"float fu = xflux_u\([^;]*;", "float fu = 0.0f, fw = 0.0f, fb = 0.0f;"),
            (r"const float f_new = xflux_[uwb]\([^;]*;", "const float f_new = 0.0f;")),
    "nog": ((r"stage > 0 && kk < nz \? G\.[uwb]\[[^]]*\] : 0\.0f", "0.0f"),
            (r"\n *G\.[uwb]\[i \* n[zw] \+ kk\] = g[uwb];", "")),
}


def ablate_k1g(src: str, what: str) -> str:
    """``csrc/rbc2d.cu`` with a part of K1's off-chip instance
    (``env_step_2d_global_kernel``) cut, for timing only; "_" joins cuts,
    and a design the cuts do not know raises ``ValueError``. "noproducts"
    drops the solve's four products, "nomarch" pHY', the tendencies and the
    RK update (and in the fused-march design the divergence it fuses). The
    first design: each phase its loops between barriers, found by their
    text. The fused-march design: the march is the call or block after its
    "// ---- 1. the march" comment, the products the lines from "// ---- 3.
    the solve" to "// ---- 4. correct"; and parts of its march, each found
    by its text: "nophy" pHY'
    as 0 (no scan), "noz" the z fluxes as 0, "nox" the x fluxes as 0, "nog"
    the previous stage's tendencies neither read nor stored."""
    lines = src.split("\n")
    head = next(i for i, line in enumerate(lines)
                if "env_step_2d_global_kernel(const float*" in line)

    def find(text, start):
        i = next((i for i in range(start, len(lines)) if text in lines[i]), None)
        if i is None:
            raise ValueError(f"no {text!r} in the off-chip instance")
        return i

    new_design = any("// ---- 1. the march" in line for line in lines[head:])
    for cut in what.split("_"):
        if cut == "nomarch" and new_design:
            m = find("// ---- 1. the march", head)
            b = next(j for j in range(m, len(lines)) if not lines[j].strip().startswith("//"))
            if lines[b].strip().startswith("g_march("):  # the march a function of its own
                lines = lines[:b] + lines[b + 1:]
            elif lines[b].strip() == "{":
                lines = lines[:b] + ["      {}"] + lines[_block_end(lines, b) + 1:]
            else:
                raise ValueError("the march is neither a block nor a call")
        elif cut == "nomarch":
            a = find("for (int i = warp; i < nx; i += kK1Warps) {", head)
            d = find("const float div = (u[wrap_x(i + 1, nx) * nz + k] - u[q]) * P.idx +", a)
            lines = lines[:a] + lines[d - 2:]  # from the divergence loop on
        elif cut in MARCH_CUTS and new_design:
            start = next((i for i, line in enumerate(lines) if "void g_march(" in line), head)
            end = find("env_step_global_kernel_for(int passes", head)
            body = "\n".join(lines[start:end])
            for old, rep in MARCH_CUTS[cut]:
                if not re.search(old, body):
                    raise ValueError(f"{cut}: no {old!r} in the off-chip instance")
                body = re.sub(old, rep, body)
            lines = lines[:start] + body.split("\n") + lines[end:]
        elif cut == "noproducts" and new_design:
            a = find("// ---- 3. the solve", head)
            lines = lines[:a + 1] + lines[find("// ---- 4. correct", a):]
        elif cut == "noproducts":
            a = find("if constexpr (kPasses == 0) {", head)
            if "auto as_is" not in lines[a + 1]:
                raise ValueError("the products are not where the first design put them")
            lines = lines[:a] + lines[_block_end(lines, a) + 1:]
        else:
            raise ValueError(f"unknown cut {cut}")
    return "\n".join(lines)


# K5's z split's timing-only cuts of ``k5z`` (MEASURE's K5Z_CUTS and K5Z_DIR)
K5Z_CUTS = ("sync", "nophy", "sync_nophy", "c4", "c4_sync_nophy", "noface", "noedge",
            "nophy_noface_noedge")
K5Z_DIR = Path("rbc_gym_tpu_torch") / "_build" / "k5z"


def ablate_k5z(src: str, what: str) -> str:
    """``csrc/rbc3d.cu`` with a part of K5's z split cut or changed, for
    timing only; "_" joins cuts, and a cut the tree's design has not raises
    ``ValueError``. PR 24's cluster design: "sync" makes the cluster
    barrier of the plane loop a CTA barrier and adds one cluster barrier
    before the kernel ends (no CTA's shared memory is read after it exits),
    "nophy" drops the pHY' passes of the plane loop, "c4" starts the
    launcher's rule at four CTAs. PR 25's design: "nophy" drops the pHY'
    warp's sum in the plane loop, "noface" the face warp's w* at face z1,
    "noedge" the z fluxes that a part's edge lanes compute themselves."""
    for cut in what.split("_"):
        if cut == "sync":
            a = src.index("    // every CTA's partial sums of plane i + 3)")
            old = "      cluster_barrier();"
            b = src.index(old, a)
            src = src[:b] + "      __syncthreads();" + src[b + len(old):]
            tail = "  if constexpr (kRhat) {  // the last plane's z-factor, then the x-factor"
            src = src.replace(tail, "  if constexpr (kSplit) cluster_barrier();\n" + tail, 1)
        elif cut == "nophy":
            olds = ("        phy_column(i + 2);\n        phy_total(i + 3);\n",
                    "      if (phy_warp) phy_split(i + 2);\n")
            old = next((o for o in olds if o in src), None)
            if old is None:
                raise ValueError("no pHY' passes in the plane loop")
            src = src.replace(old, "")
        elif cut == "c4":
            old = "for (int c = 2; c <= kXYMaxSplit; c *= 2) {"
            if old not in src:
                raise ValueError("no split rule to force")
            src = src.replace(old, "for (int c = 4; c <= kXYMaxSplit; c *= 2) {")
        elif cut == "noface":
            old = "jw < kYT || (face_warp && kl < kYT)"
            if old not in src:
                raise ValueError("no face warp")
            src = src.replace(old, "jw < kYT")
        elif cut == "noedge":
            olds = ("z1 == nzg ? 0.0f : z_upwind(t1, t2, t3, t4, t5, t6, zc1, vel_kp)",
                    "            if (kz == z0) fz_m = z_upwind(t0, t1, t2, t3, t4, t5, zw0, 0.5f * (t2 + t3));\n")
            if not all(o in src for o in olds):
                raise ValueError("no edge lanes")
            src = src.replace(olds[0], "0.0f").replace(olds[1], "")
        else:
            raise ValueError(f"unknown cut {cut}")
    return src


# K3's and K5's runtime-size timing-only cuts of ``k3r`` and ``k5r``
# (MEASURE's K3R_CUTS, K5R_CUTS and their directories)
K3R_CUTS = ("noz2", "nophy", "bounds", "noz2_nophy_bounds")
K3R_DIR = Path("rbc_gym_tpu_torch") / "_build" / "k3r"
K5R_CUTS = ("noz2", "nophy", "bounds", "noz2_nophy_bounds", "split", "noedge", "bounds1",
            "nophy_noedge")
K5R_DIR = Path("rbc_gym_tpu_torch") / "_build" / "k5r"
# the runtime-size instances' launched threads on k3r's and k5r's first
# grids (16x24x24: 24 x 16; 48x64x64: 9 x 48)
K3R_THREADS, K5R_THREADS = 384, 432


def _ablate_runtime(src: str, what: str, k5: bool) -> str:
    """``csrc/rbc3d.cu`` with a part of the runtime-size march instances
    (K3's ``<0, 0>``, K5's ``<0, -1>``) or of the buckets cut or changed, for
    timing only; "_" joins cuts, and a cut the tree's design has not raises
    ``ValueError``. "noz2": the runtime-size code's z flux through face k +
    1 and w's at center k - 1 taken from the neighbouring lane by a shuffle,
    as the compile-time instances do, in place of computed a second time
    (the values are wrong where a column straddles warps); "nophy": the
    plane loop's pHY' dropped; "bounds": the runtime-size instance's launch
    bounds at its launched threads on the first grid and two blocks an SM,
    in place of 1024 threads and one (K5's alone, or K3's alone). K5 only:
    "split" its z split from nz = 97 (in place of nz = 107); "noedge" the z
    fluxes a bucket's warp-edge lanes compute themselves (the face above
    lane 31, w's center below lane 0) left out; "bounds1" every bucket's
    launch bounds at one block an SM (more registers)."""
    for cut in what.split("_"):
        if cut == "noz2":
            olds = ("    } else {\n      f_kp = z_upwind(t1, t2, t3, t4, t5, t6, zc1, vel_kp);\n",
                    "        } else {\n          fz_m = z_upwind(t0, t1, t2, t3, t4, t5, zw0, "
                    "0.5f * (t2 + t3));\n")
            if not all(o in src for o in olds):
                raise ValueError("no second z flux to cut")
            src = src.replace(olds[0], "    } else {\n      f_kp = __shfl_down_sync("
                              "__activemask(), f_k, 1);\n")
            src = src.replace(olds[1], "        } else {\n          fz_m = __shfl_up_sync("
                              "__activemask(), fz, 1);\n")
        elif cut == "nophy":
            old = "    } else if (kPhy && (kWhole || !own)) {\n      hydrostatic(i + 2);\n"
            if old not in src:
                raise ValueError("no pHY' pass in the plane loop")
            src = src.replace(old, "    } else if (kPhy && (kWhole || !own)) {\n")
        elif cut == "bounds":
            old_t = ": (NZ > 0 && NY != 0 ? march_threads(NZ, NY) : kMaxThreads),"
            old_b = "(NY < 0 ? (NZ == 32 ? 3 : 1) : (NZ > 0 && NY > 0 ? 2 : 1))"
            if old_t not in src or old_b not in src:
                raise ValueError("no runtime-size launch bounds to set")
            if k5:
                mine = "NZ == 0 && NY < 0"
                src = src.replace(old_t, f": (NZ > 0 && NY != 0 ? march_threads(NZ, NY) : "
                                  f"({mine} ? {K5R_THREADS} : kMaxThreads)),")
                src = src.replace(old_b, "(NY < 0 ? (NZ == 32 ? 3 : (NZ == 0 ? 2 : 1)) : "
                                  "(NZ > 0 && NY > 0 ? 2 : 1))")
            else:
                mine = "NZ == 0 && NY == 0 && kField == kStage && !kRhat"
                src = src.replace(old_t, f": (NZ > 0 && NY != 0 ? march_threads(NZ, NY) : "
                                  f"({mine} ? {K3R_THREADS} : kMaxThreads)),")
                src = src.replace(old_b, f"(NY < 0 ? (NZ == 32 ? 3 : 1) : "
                                  f"(NZ > 0 && NY > 0 ? 2 : ({mine} ? 2 : 1)))")
        elif cut == "split" and k5:
            old = "march_threads(nz, -1) <= kMaxThreads) {"
            if old not in src:
                raise ValueError("no split rule to move")
            src = src.replace(old, "march_threads(nz, -1) <= kMaxThreads && nz < 97) {")
        elif cut == "noedge" and k5:
            olds = ("      } else if (lane == 31) {  // face k + 1 is the next warp's\n"
                    "        f_kp = z_upwind(t1, t2, t3, t4, t5, t6, zc1, vel_kp);\n",
                    "          if (lane == 0 && k > 0) fz_m = z_upwind(t0, t1, t2, t3, t4, t5, zw0, "
                    "0.5f * (t2 + t3));\n")
            if not all(o in src for o in olds):
                raise ValueError("no bucket edge lanes")
            src = src.replace(olds[0], "      } else if (lane == 31) {\n        f_kp = 0.0f;\n")
            src = src.replace(olds[1], "")
        elif cut == "bounds1" and k5:
            old = "  return (int)(kSmemPerSM / (sizeof(float) * stage_xy_smem_floats(stride) + 1024));\n"
            if old not in src:
                raise ValueError("no K5 buckets")
            src = src.replace(old, "  return 1;\n")
        else:
            raise ValueError(f"unknown cut {cut}")
    return src


def ablate_k3r(src: str, what: str) -> str:
    """``_ablate_runtime`` on K3's runtime-size instance."""
    return _ablate_runtime(src, what, k5=False)


def ablate_k5r(src: str, what: str) -> str:
    """``_ablate_runtime`` on K5's runtime-nz instance."""
    return _ablate_runtime(src, what, k5=True)


def build_ablations(tree: Path, nvcc: str, kernels: str) -> list:
    """Start one nvcc a cut: for ``k1t`` each of ``ABLATIONS``
    (``K1T_DIR/<what>/lib.so`` from the tree's own ``csrc/rbc2d.cu``), for
    ``k5z`` each of ``K5Z_CUTS`` (``K5Z_DIR/<what>/lib.so`` from its
    ``csrc/rbc3d.cu``), for ``k1g`` each of ``K1G_CUTS`` (``K1G_DIR``, from
    its ``csrc/rbc2d.cu``), each with the tree's headers."""
    csrc = tree / "rbc_gym_tpu_torch" / "csrc"
    names = kernels.split(",")
    cuts = [(K1T_DIR, what, "rbc2d.cu", ablate_k1) for what in ABLATIONS if "k1t" in names]
    cuts += [(K5Z_DIR, what, "rbc3d.cu", ablate_k5z) for what in K5Z_CUTS if "k5z" in names]
    cuts += [(K1G_DIR, what, "rbc2d.cu", ablate_k1g) for what in K1G_CUTS if "k1g" in names]
    cuts += [(K1C_DIR, what, "rbc2d.cu", ablate_k1c) for what in K1C_CUTS if "k1c" in names]
    cuts += [(K1R_DIR, what, "rbc2d.cu", ablate_k1r) for what in K1R_CUTS if "k1r" in names]
    cuts += [(K3R_DIR, what, "rbc3d.cu", ablate_k3r) for what in K3R_CUTS if "k3r" in names]
    cuts += [(K5R_DIR, what, "rbc3d.cu", ablate_k5r) for what in K5R_CUTS if "k5r" in names]
    procs = []
    for base, what, source, ablate in cuts:
        try:
            cut = ablate((csrc / source).read_text(), what)
        except ValueError as err:  # a cut of another design
            print(json.dumps({"tree": str(tree), "cut": what, "skipped": str(err)}), flush=True)
            continue
        d = tree / base / what
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / source).write_text(cut)
        procs.append(subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


TARGET_O3 = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
PTXAS = (*TARGET_O3, "-Xptxas", "-v", "-c", "-o", os.devnull)
# kernel entries whose resource lines are kept, and the instances whose SASS
# is counted: names (mangled) holding one of these, the specialised
# instances of K1 (96x64, each pass count) and K2 (96x64), K1's cluster
# instance (64x64 a CTA) and its off-chip one (each pass count and slab
# residency), K3 and K6 (16x32x32), K5 (nz = 32, 16 and the runtime-nz
# instance, with the z split) and K7 (nz = 16)
ENTRIES = ("env_step_2d", "tendencies_2d", "stage_march", "stage_rk_3d", "field_tendency",
           "div_3d")
SASS_INSTANCES = ("env_step_2d_kernelILi96ELi64E", "env_step_2d_cluster_kernelILi64ELi64E",
                  "env_step_2d_global_kernel", "tendencies_2d_march_kernelILi96ELi64E",
                  "stage_march_kernelILi16ELi32E", "stage_march_kernelILi32ELin1E",
                  "stage_march_kernelILi16ELin1E", "stage_march_kernelILi0ELin1E",
                  "stage_march_kernelILin48ELin1E", "stage_march_kernelILin96ELin1E",
                  "stage_march_kernelILi16ELi0E", "stage_march_kernelILi32ELi0E",
                  "stage_march_kernelILin48ELi0E", "stage_march_kernelILin96ELi0E",
                  "stage_march_kernelILin128ELi0E", "div_3d_kernelILi16E")

def ptxas(tree: Path, nvcc: str) -> list:
    return [subprocess.Popen([nvcc, *PTXAS, str(src)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for src in sorted((tree / "rbc_gym_tpu_torch" / "csrc").glob("*.cu"))]


def ptx_sources(tree: Path, nvcc: str) -> list:
    """One ``-ptx`` compile of each of the tree's ``csrc/*.cu`` into its build directory."""
    out = tree / "rbc_gym_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen([nvcc, *TARGET_O3, "-ptx", "-o", str(out / f"{src.stem}.ptx"),
                              str(src)], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for src in sorted((tree / "rbc_gym_tpu_torch" / "csrc").glob("*.cu"))]


def ptx_kernels(tree: Path) -> dict:
    """Each kernel's and device function's PTX body in the tree's ``-ptx``
    builds, keyed by file and name: each body runs from its ``.entry`` or
    ``.func`` to the next top-level one (so that a function emitted between
    two kernels is not counted as part of the first); the anonymous
    namespace's and internal symbols' hashes (which differ between copies
    of a source), the label, local-depot, call-sequence and
    internal-function numbers (which move when a kernel is added before
    another) normalised, blank lines dropped, and a
    trailing default template argument (``ELb0E``) dropped from the key, so
    that an instance keeps its key when a template grows a defaulted
    parameter."""
    import re

    head = re.compile(r"^[ \t]*(?:\.(?:visible|weak|extern)[ \t]+)*\.(entry|func)[ \t]+"
                      r"(?:\([^)]*\)[ \t]*)?([A-Za-z_$][\w$]*)[ \t]*\(", re.M)
    kernels = {}
    for ptx in sorted((tree / "rbc_gym_tpu_torch" / "_build").glob("*.ptx")):
        text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", ptx.read_text())
        text = re.sub(r"_INTERNAL_[0-9a-f]+_", "_INTERNAL_", text)
        text = re.sub(r"\$L__BB\d+_", "$L__BB_", text)
        text = re.sub(r"__internal_\d+", "__internal_", text)
        text = re.sub(r"__local_depot\d+", "__local_depot", text)
        text = re.sub(r"callseq \d+", "callseq", text)
        text = re.sub(r"\n\s*\n", "\n", text)
        heads = list(head.finditer(text))
        for m, nxt in zip(heads, heads[1:] + [None]):
            name = m.group(2)
            body = text[m.end():nxt.start() if nxt else len(text)]
            if m.group(1) == "func" and "{" not in body.split(";", 1)[0]:
                continue  # a declaration, not a definition
            key = name
            while "ELb0EEEv" in key:
                key = key.replace("ELb0EEEv", "EEEv")
            kernels[f"{ptx.stem}:{key}"] = body.replace(name, "")
    return kernels


def sass_histograms(tree: Path, cuobjdump: str) -> dict:
    """Opcode counts of each of ``SASS_INSTANCES`` in the tree's built library."""
    lib = next((tree / "rbc_gym_tpu_torch" / "_build").glob("librbc_gym_kernels_*.so"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip().replace("_ZN12_GLOBAL__N_1", "")
            current = name if any(n in name for n in SASS_INSTANCES) else None
        elif current and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split(";")[0].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0].split(".")[0]
                c = counts.setdefault(current, {})
                c[op] = c.get(op, 0) + 1
    return {n: {"total": sum(c.values()), **dict(sorted(c.items(), key=lambda kv: -kv[1]))}
            for n, c in counts.items()}


def compare_k3qp_rhat(trees: list) -> None:
    """One line: each tree's k3qp rhat against the first tree's; the files go."""
    import torch

    files = [t / "rbc_gym_tpu_torch" / "_build" / "k3qp_rhat.pt" for t in trees]
    have = [(t, f) for t, f in zip(trees, files) if f.exists()]
    if len(have) > 1:
        ref = torch.load(have[0][1])
        for t, f in have[1:]:
            got = torch.load(f)
            pairs = list(zip(got, ref))
            print(json.dumps({"k3qp_rhat": str(t), "against": str(have[0][0]),
                              "max_abs_diff": [float((a - b).abs().max()) for a, b in pairs],
                              "bit_for_bit": [bool(torch.equal(a, b)) for a, b in pairs]}),
                  flush=True)
    for f in files:
        f.unlink(missing_ok=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    kernels = "k1,k3,k5_training"
    if args[:1] == ["--kernels"]:
        kernels, args = args[1], args[2:]
    trees = [Path(t).resolve() for t in args]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    build = "from rbc_gym_tpu_torch.ops import _build; print(_build.build()[1])"
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=t, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True) for t in trees]
    sys.path.insert(0, str(trees[0]))
    from rbc_gym_tpu_torch.ops import _build

    compiles = [ptxas(t, _build.nvcc_path()) for t in trees]
    ptxs = [ptx_sources(t, _build.nvcc_path()) for t in trees]
    cuts = [build_ablations(t, _build.nvcc_path(), kernels) for t in trees]
    failed = False
    for t, b, procs, cut in zip(trees, builds, compiles, cuts):
        log, _ = b.communicate()
        for p in cut:
            out = p.communicate()[0]
            if p.returncode != 0:
                print(json.dumps({"tree": str(t), "cut_build_rc": p.returncode,
                                  "nvcc": out.strip()[-2000:]}), flush=True)
                failed = True
        lines, entry = [], ""
        for p in procs:
            for line in p.communicate()[0].splitlines():
                if "entry function" in line:
                    entry = line.split("'")[1] if "'" in line else line
                elif any(n in entry for n in ENTRIES) and ("Used" in line or "spill" in line):
                    lines.append(f"{entry}: {line.strip()}")
        rec = {"tree": str(t), "build_rc": b.returncode, "nvcc": log.strip()[-2000:],
               "ptxas": lines}
        if b.returncode == 0:
            rec["sass"] = sass_histograms(t, str(Path(_build.nvcc_path()).with_name("cuobjdump")))
        print(json.dumps(rec), flush=True)
        failed |= b.returncode != 0
    for procs in ptxs:
        for p in procs:
            p.wait()
    first = ptx_kernels(trees[0])
    for t in trees[1:]:
        other = ptx_kernels(t)
        differ = sorted(k for k in first.keys() & other.keys() if first[k] != other[k])
        print(json.dumps({"ptx": str(t), "against": str(trees[0]), "kernels": len(other),
                          "differ": differ,
                          "only_here": sorted(other.keys() - first.keys()),
                          "only_there": sorted(first.keys() - other.keys())}), flush=True)
        for k in differ[:3]:  # where the first differ: a few lines of each diff
            diff = list(difflib.unified_diff(first[k].splitlines(), other[k].splitlines(),
                                             lineterm="", n=1))
            print(json.dumps({"ptx_diff": k, "lines": len(diff), "head": diff[:40]}),
                  flush=True)
    for t, b in zip(trees, builds):
        if b.returncode == 0:
            try:
                rc = subprocess.run([sys.executable, "-c", MEASURE, str(t), kernels], cwd=t,
                                    timeout=900).returncode
            except subprocess.TimeoutExpired:
                print(json.dumps({"tree": str(t), "error": "timed out after 900 s"}), flush=True)
                rc = 1
            failed |= rc != 0
    compare_k3qp_rhat([t for t, b in zip(trees, builds) if b.returncode == 0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
