"""The 3D phases of ``chip_smoke.py`` rehearsed on the CPU, each on its
plain halves at a tiny size: K3 and K4's phases, the big grid's and the
field path's.

Split from ``tests/test_torch_smoke.py`` by group (their shared helpers
are in ``tests/torch_smoke_common.py``); each test as it was there.
"""

import json

import chip_smoke
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


def test_smoke_3d_phases_run_on_cpu_plain_halves():
    """The 3D phases at a reduced grid: both halves of every comparison are
    the plain versions here, so they agree exactly; the main path's checks
    (shapes, finiteness, reward, Nu, divergence) run as on the card."""
    tiny = dict(state_shape=(8, 8, 8))
    solver, case = chip_smoke.make_case_3d("cpu", 2, **tiny)
    assert tuple(case["q"].shape) == (2, 8, 8, 8) and tuple(case["bottom"].shape) == (2, 8, 8)
    out = chip_smoke.k3_run(solver, case, 0, None, kernel=False)
    assert [tuple(t.shape) for t in out[:5]] == [(2, 8, 8, 8)] * 2 + [(2, 8, 8, 9)] + [
        (2, 8, 8, 8)] * 2
    parity = chip_smoke.kernel_parity_3d("cpu", main_envs=2, step_envs=1, **tiny)
    assert set(parity["max_abs_err"]) == {"stage_rk_3d", "correct_3d"}
    assert all(v["error"] == 0.0 for v in parity["gated"].values())
    assert {"stage0_fields", "stage1_g", "stage2_fields", "correct_3d", "env_step_1",
            "env_step_2"} <= set(parity["gated"])
    json.dumps(parity)
    path = chip_smoke.main_path_3d("cpu", num_envs=2, heater_duration=0.0125, steps=2, **tiny)
    assert path["launches"] == {"stage_rk_3d": 0, "correct_3d": 0}
    assert path["max_abs_div"] < path["div_atol"]
    lo, hi = chip_smoke.NU_RANGE_3D
    assert lo <= path["nusselt"][0] <= path["nusselt"][1] <= hi
    json.dumps(path)


def test_smoke_big_grid_phases_run_on_cpu_plain_halves():
    """The selection rule and the big-grid phases at a reduced grid: on the
    CPU auto is the plain path, a forced K3 on the big grid is refused, and
    both halves of every comparison are the plain versions."""
    sel = chip_smoke.selection("cpu")
    assert set(sel["paths"].values()) == {"plain"}
    assert "ny * nz <= 1024" in sel["forced_stage_big_grid"] and not any(sel["launches"].values())
    json.dumps(sel)
    parity = chip_smoke.kernel_parity_big("cpu", main_envs=2, big_envs=1, small_envs=1,
                                          step_envs=1, state_shape=(8, 16, 16),
                                          small_shape=(8, 8, 8))
    assert all(v["error"] == 0.0 for v in parity["gated"].values())
    assert {"stage0_g", "stage2_fields", "correct_3d", "few_envs_stage1_g", "small_stage1_g",
            "env_step"} <= set(parity["gated"])
    assert parity["max_abs_err"] == {"stage_rk_3d_xy": 0.0, "correct_3d": 0.0}
    json.dumps(parity)
    path = chip_smoke.main_path_big("cpu", num_envs=2, state_shape=(8, 16, 16),
                                    heater_duration=0.0125, steps=2)
    assert path["launches"] == {"stage_rk_3d": 0, "stage_rk_3d_xy": 0, "correct_3d": 0}
    assert path["substeps_per_step"] == 3 and path["max_abs_div"] < path["div_atol"]
    lo, hi = chip_smoke.NU_RANGE_3D
    assert lo <= path["nusselt"][0] <= path["nusselt"][1] <= hi
    json.dumps(path)


def test_smoke_field_phases_run_on_cpu_plain_halves():
    """The field path's phases at a reduced grid with odd nx: on the CPU
    both halves of every comparison are the plain versions, and the lazy
    plain loop does the field loop's operations in the same order, so all
    agree exactly; the main path is the user's ``fused="field"`` env."""
    tiny = dict(state_shape=(8, 8, 6))
    parity = chip_smoke.kernel_parity_field("cpu", main_envs=2, step_envs=1, big_envs=1,
                                            big_shape=(8, 16, 16), odd_shape=(8, 8, 5), **tiny)
    assert all(v["error"] == 0.0 for v in parity["gated"].values())
    assert {"gu", "gv", "gw", "gb", "div", "odd_gu", "odd_div", "big_gb", "big_div",
            "env_step_1", "env_step_2", "field_vs_stage_path_2"} <= set(parity["gated"])
    # at these sizes every grid is the march's (on the card the big grid's
    # 2048-point x-planes take K6's general instance)
    assert parity["k6_instances"] == {"grid": "march", "odd_grid": "march", "big_grid": "march"}
    assert set(parity["field_tendency_3d_float64_plain_vs"]) == {"gu", "gv", "gw", "gb"}
    assert parity["max_abs_err"] == {"field_tendency_3d": 0.0, "div_3d": 0.0}
    json.dumps(parity)
    path = chip_smoke.main_path_field("cpu", num_envs=2, heater_duration=0.0125, steps=2, **tiny)
    assert path["path"] == "field" and not any(path["launches"].values())
    assert set(path["launches"]) == {"stage_rk_3d", "stage_rk_3d_xy", "correct_3d",
                                     "field_tendency_3d", "div_3d"}
    assert path["max_abs_div"] < path["div_atol"]
    lo, hi = chip_smoke.NU_RANGE_3D
    assert lo <= path["nusselt"][0] <= path["nusselt"][1] <= hi
    json.dumps(path)
    sel = chip_smoke.selection("cpu")
    assert sel["fused_true"] == "field" and sel["paths"]["odd_nx"] == "plain"
    assert "float32" in sel["forced_field_float64"]
    assert not any(sel["odd_nx_step_launches"].values())


def test_smoke_fine_grids_phase_runs_on_cpu_plain_halves():
    """Phase 41 at a tiny size: both halves of every comparison are the
    plain versions here (the split's stages agree exactly with the float64
    plain run, since the CPU runs them in float64), the envs' and the
    flow-statistics run's checks run as on the card; the card's defaults
    are grids that K5's z split and K1's global slabs take."""
    assert chip_smoke.stage_xy_split_size(chip_smoke.FINE_SHAPE_3D[0]) == 4
    assert chip_smoke.stage_xy_split_size(chip_smoke.FINE_ODD_SHAPE_3D[0]) == 4
    assert not any(chip_smoke.env_step_2d_slabs_on_chip(nx, nz)
                   for nz, nx in chip_smoke.FINE_GRIDS_2D)
    out = chip_smoke.fine_grids(
        "cpu", envs_3d=1, shape_3d=(8, 8, 8), odd_envs=1, odd_shape=(6, 8, 4),
        heater_3d=0.0125, steps=2, k1_envs=1, k1_shape=(16, 32), k1_substeps=(2, 3),
        grids_2d={(16, 32): (0.03, 0.06)}, envs_2d=((2, (16, 32)),), observation_shape=(8, 16))
    # K1 at "default" is held against float64 (the float32 plain version
    # on the CPU is that far off); every other half is the plain version
    assert all(v["error"] == 0.0 for k, v in out["gated"].items() if not k.endswith("default"))
    assert all(v["error"] <= v["bound"] for v in out["gated"].values())
    assert {"stage0_gu", "stage2_div", "odd_stage1_gw", "env_step_2d_global_2",
            "env_step_2d_global_3", "env_step_2d_global_bf16x3",
            "env_step_2d_global_default"} <= set(out["gated"])
    assert out["max_abs_err"] == {"stage_rk_3d_xy_split": 0.0, "env_step_2d_global": 0.0}
    assert out["main_path_3d"]["launches"] == dict.fromkeys(chip_smoke.FINE_WRAPPERS_3D, 0)
    assert out["main_path_3d"]["max_abs_div"] < out["main_path_3d"]["div_atol"]
    assert len(out["flowstats_3d"]["nusselt"]) == 2
    assert out["main_path_2d"]["32x16"]["substeps_per_step"] == 2
    assert out["times"] == {}
    json.dumps(out)


def test_smoke_runtime_3d_phase_runs_on_cpu_plain_halves():
    """Phase 43 with few envs on small grids of K3's and K5's buckets (on
    the CPU both halves are the plain version, so every gate holds at 0,
    past ``RUNTIME_ABS_GATE_MAX_NZ`` levels against float64 too): each
    grid's bucket as ``limits`` gives it, the gates of every stage, the env
    steps with the 3D checks and no launch, and no times off the card."""
    k3_grids = {(16, 8, 8): 16, (40, 4, 8): 48, (7, 36, 4): None}
    k5_grids = {(20, 8, 8): None, (96, 8, 4): 96, (100, 8, 4): None}
    out = chip_smoke.runtime_3d("cpu", k3_grids=k3_grids, k5_grids=k5_grids, few_envs=1,
                                paths=((2, (8, 8, 8), 0.01), (2, (8, 16, 16), 0.005)),
                                heater_duration=0.0125)
    keys = [f"stage_rk_3d_{nz}x{ny}x{nx}" for nz, ny, nx in k3_grids] + [
        f"stage_rk_3d_xy_{nz}x{ny}x{nx}" for nz, ny, nx in k5_grids]
    assert set(out["by_grid"]) == set(keys)
    assert all(v["error"] == 0.0 for v in out["gated"].values())
    # the absolute gates to 64 levels, float64's rule past them
    assert {"stage_rk_3d_16x8x8_stage1_g", "stage_rk_3d_xy_20x8x8_stage2_fields",
            "stage_rk_3d_xy_96x8x4_stage1_gw", "stage_rk_3d_xy_100x8x4_stage2_div"} <= set(
                out["gated"])
    assert [v["bucket"] for v in out["by_grid"].values()] == [16, 48, None, None, 96, None]
    assert set(out["main_paths"]) == {"8x8x8", "8x16x16"}
    for p in out["main_paths"].values():
        assert p["path"] == "plain" and not any(p["launches"].values())
        assert p["max_abs_div"] < p["div_atol"]
    assert out["times"] == {}  # timed on the card only
    json.dumps(out)
