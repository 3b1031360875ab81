#!/usr/bin/env python3
"""Time K5 (``stage_rk_3d_xy``) of several source trees on one CUDA card.

    python3 scripts/k5_variants.py TREE [TREE ...]

Each TREE is a checkout of this repo (for example a ``git archive`` of a
commit unpacked under the git-ignored ``rbc_gym_tpu_torch/_build/``).
The script builds every tree's kernels at once (one nvcc each, in
parallel, plus one ``-Xptxas -v`` compile of ``csrc/rbc3d.cu`` for K5's
registers and spills, and a count of the SASS opcodes of K5's nz = 32
instance from ``cuobjdump``), then runs each tree in a process of its own, one
after the other, importing that tree's own ``chip_smoke``: K5 at 1024 envs
on the 32x64x64 big grid, stages 0, 1 and 2, CUDA events over 5 launches
after a warm-up, each stage's share of its bytes bound, and K5's errors
against the plain version at the gates of ``chip_smoke.kernel_parity_big``
(1024 envs, 8 envs, forced at 256 envs on 16x32x32) with stage 0's error
against a float64 run. One JSON line per tree, then the card's name and
power limit. A tree that does not build is reported and skipped. Exits
non-zero without a card or if any tree fails.
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

device = torch.device("cuda")
out = {"tree": sys.argv[1]}
solver, case = cs.make_case_3d(device, 1024, cs.BIG_SHAPE, seed=9, dt_solver=cs.BIG_DT_SOLVER)
nz, ny, nx = cs.BIG_SHAPE
g_prev = cs.k3_run(solver, case, 0, None, True, k3d.stage_rk_3d_xy)[5]
for stage in range(3):
    gp = g_prev if stage else None
    ms = cs._cuda_ms(lambda: cs.k3_run(solver, case, stage, gp, True, k3d.stage_rk_3d_xy), 5)
    bound_ms, by = cs.bound(cs.stage_rk_3d_work(1024, nx, ny, nz, stage))
    out[f"stage{stage}"] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                            "share_of_bound": bound_ms / ms}
out["mean_ms"] = sum(out[f"stage{m}"]["ms"] for m in range(3)) / 3
del g_prev
errs = {}
_, e = cs.stage_parity(solver, case, k3d.stage_rk_3d_xy)
errs.update(e)
del case
solver, case = cs.make_case_3d(device, 8, cs.BIG_SHAPE, seed=10, dt_solver=cs.BIG_DT_SOLVER)
_, e = cs.stage_parity(solver, case, k3d.stage_rk_3d_xy, "few_envs_")
errs.update(e)
case64 = {k: v.double() for k, v in case.items()}
def outs(o):
    return (*o[:5], *o[5])
ref = outs(cs.k3_run(solver, case64, 0, None, False))
names = cs.K3_OUT + cs.G_OUT
out["stage0_float64_vs"] = {
    "kernel": cs.abs_diffs(names, ref, outs(cs.k3_run(solver, case, 0, None, True,
                                                      k3d.stage_rk_3d_xy))),
    "plain_float32": cs.abs_diffs(names, ref, outs(cs.k3_run(solver, case, 0, None, False)))}
solver, case = cs.make_case_3d(device, 256, (16, 32, 32), seed=7)
_, e = cs.stage_parity(solver, case, k3d.stage_rk_3d_xy, "small_")
errs.update(e)
out["gated"] = {k: {"error": v[0], "atol": v[1]} for k, v in errs.items()}
out["gates_pass"] = all(v[0] <= v[1] for v in errs.values())
print(json.dumps(out), flush=True)
"""

PTXAS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
         "-c", "-o", os.devnull)


def ptxas_lines(tree: Path, nvcc: str) -> subprocess.Popen:
    src = tree / "rbc_gym_tpu_torch" / "csrc" / "rbc3d.cu"
    return subprocess.Popen([nvcc, *PTXAS, str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def sass_histogram(tree: Path, cuobjdump: str) -> dict:
    """Opcode counts of the K5 nz = 32 instance in the tree's built library."""
    lib = next((tree / "rbc_gym_tpu_torch" / "_build").glob("librbc_gym_kernels_*.so"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "stage_rk_3d_xy_kernelILi32E" in line
        elif inside and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split(";")[0].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k5_variants.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    build = "from rbc_gym_tpu_torch.ops import _build; print(_build.build()[1])"
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=t, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True) for t in trees]
    sys.path.insert(0, str(trees[0]))
    from rbc_gym_tpu_torch.ops import _build

    ptxas = [ptxas_lines(t, _build.nvcc_path()) for t in trees]
    failed = False
    for t, b, p in zip(trees, builds, ptxas):
        log, _ = b.communicate()
        info, _ = p.communicate()
        k5, entry = [], ""
        for line in info.splitlines():
            if "entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "stage_rk_3d_xy" in entry and ("Used" in line or "spill" in line):
                k5.append(f"{entry}: {line.strip()}")
        rec = {"tree": str(t), "build_rc": b.returncode, "nvcc": log.strip()[-2000:],
               "ptxas": k5}
        if b.returncode == 0:
            rec["sass_k5_nz32"] = sass_histogram(t, str(Path(_build.nvcc_path()).with_name(
                "cuobjdump")))
        print(json.dumps(rec), flush=True)
        failed |= b.returncode != 0
    for t, b in zip(trees, builds):
        if b.returncode == 0:
            try:
                rc = subprocess.run([sys.executable, "-c", MEASURE, str(t)], cwd=t,
                                    timeout=600).returncode
            except subprocess.TimeoutExpired:
                print(json.dumps({"tree": str(t), "error": "timed out after 600 s"}), flush=True)
                rc = 1
            failed |= rc != 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
