#!/usr/bin/env python3
"""Time the stage kernels of several source trees on one CUDA card.

    python3 scripts/kernel_variants.py
        [--kernels k1,k1c,k1o,k1t,k1t_times,k2,k3,k3qp,k5_training,k5,k6,k7,field_step]
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
- ``k1c``: K1 off the chip at 1024 envs on 128x64 and 192x64 (its
  cluster instance where the tree has one, else its off-chip instance),
  one env step of 50 substeps, its "high" and "default" instances on
  128x64 too, with float32 K1 on 96x64 timed first and last; the gates at
  6 substeps and 128 envs on both grids (and at "high" and "default" on
  128x64), and where the tree has it ``env_step_2d_occupancy``;
- ``k1o``: K1's off-chip instance (its slabs in shared memory) at 1024
  envs on 127x64, one env step of 50 substeps, float32 and "high", with
  float32 K1 on 96x64 timed first and last; its gates at 6 substeps and
  128 envs;
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

import json
import os
import subprocess
import sys
from pathlib import Path

MEASURE = r"""
import json, sys
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


def k1c():
    # K1 off the chip: 128x64 and 192x64 (the cluster instance where the
    # tree has one, else the off-chip instance), float32 K1 on 96x64 timed
    # first and last in the same process
    from rbc_gym_tpu_torch.ops import kernels2d as k2d, limits

    def k1_ms(shape, reps=3, prec=None):
        solver, case = cs.make_case(device, 1024, shape, 1.5, seed=2)
        ms = cs._cuda_ms(lambda: cs.k1_run(solver, case, True, prec), reps)
        del case
        torch.cuda.empty_cache()
        return solver, ms

    rec, errs = {"k1_96x64_first_ms": k1_ms((64, 96))[1]}, {}
    for shape in ((64, 128), (64, 192)):
        nz, nx = shape
        solver, ms = k1_ms(shape)
        bound_ms, by = cs.bound(cs.env_step_work(1024, nx, nz, solver.params.substeps_per_env_step))
        c = getattr(limits, "env_step_2d_cluster_size", lambda *_: 0)(nx, nz)
        r = {"instance": f"cluster {c}" if c else "off_chip", "ms": ms, "bound_ms": bound_ms,
             "bound_by": by, "share_of_bound": bound_ms / ms}
        if hasattr(k2d, "env_step_2d_occupancy"):
            r["occupancy"] = k2d.env_step_2d_occupancy(nx, nz)
        s6, c6 = cs.make_case(device, 128, shape, 0.18, seed=4)
        errs[f"{nx}x{nz}_6"] = (max(cs.abs_diffs(cs.K1_OUT, cs.k1_run(s6, c6, True),
                                                 cs.k1_run(s6, c6, False)).values()), cs.K1_ATOL)
        if shape == (64, 128):  # the TF32 instances there
            errs[f"{nx}x{nz}_6_bf16x3"] = (max(cs.abs_diffs(
                cs.K1_OUT, cs.k1_run(s6, c6, True, "high"),
                cs.k1_run(s6, c6, False, "high")).values()), cs.K1_ATOL)
            one = cs.k1_tf32_errors(s6, c6, cs.k1_run(s6, c6, True, "default"))
            errs[f"{nx}x{nz}_6_default"] = (one["kernel"], one["bound"])
            for prec in ("high", "default"):
                r[f"ms_{prec}"] = k1_ms(shape, 3, prec)[1]
        rec[f"{nx}x{nz}"] = r
        del c6
    rec["k1_96x64_last_ms"] = k1_ms((64, 96))[1]
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
    "k1o": k1o,
    "k1t": k1t,
    "k1t_times": lambda: k1t(cuts=False),
    "k2": k2,
    "k3": lambda: stage(k3d.stage_rk_3d, (16, 32, 32), 0.01, 32, 20),
    "k3qp": k3qp,
    "k5_training": lambda: stage(k3d.stage_rk_3d_xy, (16, 32, 32), 0.01, 32, 20),
    "k5": lambda: stage(k3d.stage_rk_3d_xy, cs.BIG_SHAPE, cs.BIG_DT_SOLVER, 8, 5),
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


def build_ablations(tree: Path, nvcc: str) -> list:
    """Start one nvcc a cut of ``ABLATIONS``: ``K1T_DIR/<what>/lib.so``
    under the tree, from its own ``csrc/rbc2d.cu`` and headers."""
    csrc = tree / "rbc_gym_tpu_torch" / "csrc"
    procs = []
    for what in ABLATIONS:
        d = tree / K1T_DIR / what
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "rbc2d.cu").write_text(ablate_k1((csrc / "rbc2d.cu").read_text(), what))
        procs.append(subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-o", str(d / "lib.so"), str(d / "rbc2d.cu")],
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
                  "div_3d_kernelILi16E")

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
    """Each kernel's PTX body in the tree's ``-ptx`` builds, keyed by file and
    entry: the anonymous namespace's hash and the label numbers (which move
    when a kernel is added before another) normalised, and a trailing
    default template argument (``ELb0E``) dropped from the key, so that an
    instance keeps its key when a template grows a defaulted parameter."""
    import re

    kernels = {}
    for ptx in sorted((tree / "rbc_gym_tpu_torch" / "_build").glob("*.ptx")):
        text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", ptx.read_text())
        text = re.sub(r"\$L__BB\d+_", "$L__BB_", text)
        for m in re.finditer(r"\.entry (\S+)\(", text):
            name = m.group(1)
            end = text.find(".entry ", m.end())
            key = name
            while "ELb0EEEv" in key:
                key = key.replace("ELb0EEEv", "EEEv")
            kernels[f"{ptx.stem}:{key}"] = text[m.end():end if end > 0 else len(text)].replace(
                name, "")
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
    cuts = [build_ablations(t, _build.nvcc_path()) if "k1t" in kernels.split(",") else []
            for t in trees]
    failed = False
    for t, b, procs, cut in zip(trees, builds, compiles, cuts):
        log, _ = b.communicate()
        for p in cut:
            out = p.communicate()[0]
            if p.returncode != 0:
                print(json.dumps({"tree": str(t), "k1t_cut_build_rc": p.returncode,
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
        print(json.dumps({"ptx": str(t), "against": str(trees[0]), "kernels": len(other),
                          "differ": sorted(k for k in first.keys() & other.keys()
                                           if first[k] != other[k]),
                          "only_here": sorted(other.keys() - first.keys()),
                          "only_there": sorted(first.keys() - other.keys())}), flush=True)
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
