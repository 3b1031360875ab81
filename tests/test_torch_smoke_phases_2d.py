"""The 2D phases of ``chip_smoke.py`` rehearsed on the CPU, each on its
plain halves at a tiny size: the main 2D phases, the lazy loop's options
(phase 38) and the 2D precisions (phase 39).

Split from ``tests/test_torch_smoke.py`` by group (their shared helpers
are in ``tests/torch_smoke_common.py``); each test as it was there.
"""

import json
import re

import torch

import chip_smoke

from torch_smoke_common import REPO, TINY


def test_smoke_phases_run_on_cpu_plain_halves():
    solver, case = chip_smoke.make_case("cpu", 2, heater_duration=0.06, **TINY)
    k1 = chip_smoke.k1_run(solver, case, kernel=False)
    k2 = chip_smoke.k2_run(solver, case, kernel=False)
    assert [tuple(t.shape) for t in k1] == [(2, 32, 16), (2, 32, 17), (2, 32, 16), (2, 32, 16)]
    assert [tuple(t.shape) for t in k2] == [(2, 32, 16), (2, 32, 17), (2, 32, 16)]
    assert all(bool(torch.isfinite(t).all()) for t in (*k1, *k2))

    parity = chip_smoke.kernel_parity("cpu", k1_envs=2, main_envs=2, off_chip_shape=(65, 4),
                                      k2_runtime_shape=(12, 20), k2_general_shape=(80, 8),
                                      cluster_shape=(2, 130), cluster_wide_shape=(2, 260),
                                      **TINY)
    assert max(parity["max_abs_err"].values()) == 0.0  # on the CPU both halves are plain
    assert {"tendencies_2d_runtime", "tendencies_2d_general", "env_step_2d_cluster",
            "env_step_2d_cluster_main", "env_step_2d_cluster_wide"} <= set(parity["max_abs_err"])
    assert parity["cluster_ctas"] == 2
    assert parity["tendencies_2d_instances"] == {
        "grid": "runtime", "runtime_grid": "runtime", "general_grid": "general"}
    assert set(parity["float64_plain_vs_50_substeps"]) == {"kernel", "plain_float32"}
    assert set(parity["tendencies_2d_float64_plain_vs"]) == {"kernel", "plain_float32"}
    json.dumps(parity)

    path = chip_smoke.main_path("cpu", num_envs=2, observation_shape=(8, 16),
                                heater_duration=0.3, steps=2, **TINY)
    assert path["launches"] == {"env_step_2d": 0, "tendencies_2d": 0}
    # the plain path's three stages each compute pHY', then the output's
    # (on the card K2 computes its own: one call)
    assert path["substep_p_hy_calls"] == 4
    assert path["max_abs_div"] < path["div_atol"]
    json.dumps(path)
    cluster = chip_smoke.main_path_cluster("cpu", num_envs=2, state_shape=(16, 130),
                                           observation_shape=(8, 26), heater_duration=0.3,
                                           steps=2)
    assert cluster["cluster_ctas"] == 2 and not any(cluster["launches"].values())
    assert cluster["max_abs_div"] < cluster["div_atol"]
    json.dumps(cluster)

    fake = {"ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes"}
    names = ("env_step_2d", "tendencies_2d", "stage_rk_3d", "correct_3d", "stage_rk_3d_xy",
             "field_tendency_3d", "div_3d", "stage_rk_3d_rhat", "env_step_2d_tf32x3",
             "env_step_2d_tf32", "env_step_2d_cluster", "stage_rk_3d_xy_split",
             "env_step_2d_global")
    records = chip_smoke.kernel_records(
        {"env_step_2d": 1e-7, "env_step_2d_main": 2e-7, "tendencies_2d": 1e-8,
         "stage_rk_3d": 3e-7, "correct_3d": 1e-8, "stage_rk_3d_xy": 4e-7,
         "field_tendency_3d": 5e-7, "div_3d": 6e-8, "stage_rk_3d_rhat": 1e-5,
         "env_step_2d_tf32x3": 3e-7, "env_step_2d_tf32": 2e-5,
         "env_step_2d_cluster_main": 3e-6, "stage_rk_3d_xy_split": 4e-6,
         "env_step_2d_global": 5e-6},
        {"env_step_2d": 3, "tendencies_2d": 3, "stage_rk_3d": 117, "correct_3d": 3,
         "stage_rk_3d_xy": 225, "field_tendency_3d": 468, "div_3d": 117,
         "stage_rk_3d_rhat": 39, "env_step_2d_tf32x3": 1, "env_step_2d_tf32": 1,
         "env_step_2d_cluster": 3, "stage_rk_3d_xy_split": 225, "env_step_2d_global": 3},
        {name: fake for name in names},
    )
    assert [rec["name"] for rec in records] == list(names)
    assert records[0]["max_abs_err"] == 2e-7  # the main path's shapes
    assert records[10]["max_abs_err"] == 3e-6  # the cluster's path at its main shapes
    assert records[-1]["max_abs_err"] == 5e-6 and records[-1]["launches"] == 3
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for rec in records:
        assert set(rec) == keys and rec["route"] == "cuda"
        assert (REPO / rec["source"]).exists()
        path_, line = rec["replaces"].split(":")
        body = (REPO / path_).read_text().splitlines()[int(line) - 1]
        assert re.match(r"def _\w*_kernel\w*\(", body)
    json.dumps({"kernels": records})


def test_smoke_lazy_options_phase_runs_on_cpu_plain_halves():
    """Phase 38 at a reduced grid: the analysis instance's plain version
    against itself (its rhat against the float64 run within twice its own
    error), also at stage 1 on a grid of twice the x-planes, the stage_qp,
    stage_ew and precision env steps from one reset, q of the three
    precisions against float64, both TF32 flags off."""
    out = chip_smoke.lazy_options("cpu", num_envs=2, state_shape=(8, 8, 8),
                                  heater_duration=0.0125, wide_shape=(8, 8, 16), wide_envs=2)
    assert all(v["error"] <= v["bound"] for v in out["gated"].values())
    assert {"stage0_fields", "stage1_g", "stage2_rhat", "nx16_stage1_fields",
            "nx16_stage1_rhat", "stage_qp_env_step", "high_env_step"} <= set(out["gated"])
    assert set(out["stage_rk_3d_rhat_wide"]) == {"shape", "num_envs", "stage1"}
    assert out["max_abs_err"] == {"stage_rk_3d_rhat": 0.0}  # both halves plain here
    assert out["stage_ew_equal"] and out["env_step_diffs"]["stage_qp_vs_stage"]["u"] == 0.0
    assert not any(n for launches in out["launches"].values() for n in launches.values())
    assert set(out["q_vs_float64"]) == {"highest", "high", "default", "max_abs_q"}
    assert out["tf32_flags"] == {"matmul": False, "cudnn": False}
    assert out["times"] == {}  # timed on the card only
    json.dumps(out)


def test_smoke_poisson_precision_2d_phase_runs_on_cpu_plain_halves():
    """Phase 39 with few envs on small grids (the bank's fixed point on
    its own 96x64): on the CPU both halves are the plain version at the
    same precision (the
    one-pass check against the float64 run then holds at one times the
    plain version's error), the env steps at "bf16x3" and "default" pass
    the 2D checks, the substep at "bf16x3" is within K1's gate of
    "highest", the parity helper refuses the CPU, the bank's fixed point
    holds after one step, both TF32 flags are off."""
    out = chip_smoke.poisson_precision_2d(
        "cpu", num_envs=2, state_shape=(16, 32), observation_shape=(8, 16), few_envs=1,
        n_fixed=1, fixed_steps=1,
        other_shapes=(("runtime", (32, 20)), ("runtime_plain", (12, 20)), ("cluster", (2, 130)),
                      ("off_chip", (8, 3))))
    assert all(v["error"] <= v["bound"] for v in out["gated"].values())
    assert {"bf16x3", "default", "bf16x3_runtime", "bf16x3_runtime_plain", "bf16x3_cluster",
            "default_cluster", "bf16x3_off_chip", "substep_bf16x3",
            "fixed_point_bf16x3"} == set(out["gated"])
    assert out["max_abs_err"] == {"env_step_2d_tf32x3": 0.0, "env_step_2d_tf32": 0.0}
    assert [o["swizzled"] for o in out["other_instances"].values()] == [True, False, False,
                                                                         False]
    assert not any(n for launches in out["launches"].values() for n in launches.values())
    assert all(c["max_abs_div"] < c["div_atol"] for c in out["checks"].values())
    assert out["tf32_flags"] == {"matmul": False, "cudnn": False}
    assert out["times"] == {}  # timed on the card only
    json.dumps(out)
