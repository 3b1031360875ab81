"""The phases of ``chip_smoke.py`` that drive the port's tools, rehearsed
on the CPU: flow statistics and probes, the single envs and the ablation,
profiling, the examples, the launchers and the measurement layer.

Split from ``tests/test_torch_smoke.py`` by group (their shared helpers
are in ``tests/torch_smoke_common.py``); each test as it was there.
"""

import json
import re

import pytest
import torch

import chip_smoke

from torch_smoke_common import TINY
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


def test_smoke_flowstats_and_probe_phases_run_on_cpu():
    """Phases 24-27 at a tiny size: the 2D sweep at Ra 1e4 from its bank
    (its fixed-point gate holds after 2 steps), the 3D sweep on 8x16x16,
    and both probes on 2 envs for 2 steps; the gates on the JAX records
    need the full protocol."""
    fs2 = chip_smoke.flowstats_2d("cpu", ras=(10_000,), steps=2, tail=1, num_envs=4)
    pt = fs2["points"]["10000"]
    assert pt["from_bank"] and pt["tol"] == 0.02
    # seed 0 draws episodes 1, 17, 18 and 9; episode 17 is the bank's
    # other roll, at Nu 3.1806
    assert abs(pt["nu_mean"] - (3 * 4.0 + 3.1806) / 4) < 1e-3
    assert abs(pt["nu_mean"] - pt["fixed_point_first_step"]) <= pt["tol"]
    assert fs2["launches"] == {"env_step_2d": 0} and fs2["protocol"]["steps"] == 2
    fs3 = chip_smoke.flowstats_3d("cpu", ras=(500,), steps=2, tail=1, state_shape=(8, 16, 16),
                                  dt_solver=0.01, heater_duration=0.0125, check_jax=False)
    pt = fs3["points"]["500"]
    assert pt["path"] == "plain" and max(pt["first_step_vs_plain"].values()) == 0.0
    assert pt["max_abs_div"] < 1e-8 and pt["substeps_per_step"] == 2
    assert pt["jax"] == chip_smoke.JAX_FLOWSTATS_3D["500"]
    p2 = chip_smoke.probe_2d("cpu", episodes=2, n_steps=2, rows=(1,), gains=(30.0,),
                             check_jax=False)
    assert len(p2["lines"]) == 2 and set(p2["rises"]) == {"row1_gain30"}
    p3 = chip_smoke.probe_3d("cpu", episodes=2, n_steps=2, heater_duration=0.0125,
                             check_jax=False)
    assert len(p3["lines"]) == 3 and set(p3["rises"]) == {"T_row1_gain+3", "T_row1_gain-3"}
    assert p3["launches"] == {"stage_rk_3d": 0, "correct_3d": 0}
    json.dumps({"a": fs2, "b": fs3, "c": p2, "d": p3})


def test_smoke_single_env_and_ablation_phases_run_on_cpu():
    """Phases 29-31 at a small size on the plain path: the 2D core from the
    Ra=1e4 train bank for a 2-step episode (seed 0 draws episode 17, the
    bank's roll at Nu 3.1806), the 3D core from the Ra=500 test bank for 2
    steps of 2 substeps with a 2-step truncation, the ablation on 2
    episodes for 2 steps; the JAX record's gates need the full protocol."""
    s2 = chip_smoke.single_env_2d("cpu", heater_duration=0.06, episode_length=0.12,
                                  parity_steps=2)
    assert s2["path"] == "plain" and s2["bank_index"] == 17 and s2["steps"] == 2
    assert s2["truncated_at"] == [2] and s2["launches"] == {"env_step_2d": 0}
    assert len(s2["first_steps_vs_plain"]) == 2
    assert all(v == 0.0 for e in s2["first_steps_vs_plain"] for v in e.values())
    assert abs(s2["nusselt_state_first_last"][0] - 3.1806) < 1e-3
    assert "NaN" in s2["nan_raises"]
    s3 = chip_smoke.single_env_3d("cpu", heater_duration=0.0125, steps=2,
                                  truncation_length=0.1)
    assert s3["path"] == "plain" and s3["substeps_per_step"] == 2
    assert max(s3["first_step_vs_plain"].values()) == 0.0 and s3["max_abs_div"] < 1e-8
    assert s3["truncation"]["episode_steps"] == 2 and s3["truncation"]["truncated_at"][0] == 2
    assert 1.0 <= s3["nusselt"][0] <= s3["nusselt"][1] <= 3.0
    ab = chip_smoke.ablate_actuation_3d("cpu", episodes=2, n_steps=2, heater_duration=0.0125,
                                        check_jax=False)
    assert list(ab["rows"]) == ["0", "0.4", "1"] and len(ab["lines"]) == 3
    assert ab["rows"]["0"]["random"] == ab["rows"]["0"]["checker"]
    assert ab["launches"] == {"stage_rk_3d": 0, "correct_3d": 0}
    json.dumps({"a": s2, "b": s3, "c": ab})


def test_smoke_profiling_phase_runs_on_cpu():
    """Phase 28 at a tiny size: each traced loop holds its annotations; the
    CPU records no kernel, so the idle share is not measured; the memory
    stats are one empty entry; profile3d and profile_rl give their rows."""
    out = chip_smoke.profiling_hooks("cpu", big_steps=2, probe_steps=1, profile3d_envs=1,
                                     profile3d_reps=1, rl_envs=1, rl_k=1,
                                     big_shape=(8, 8, 8), big_heater_duration=0.0125,
                                     probe_episodes=1,
                                     probe_heater_duration=0.0125, rl_n_steps=1)
    for name, steps in (("flowstats_3d_one_env", 2), ("probe_3d_32_envs", 1)):
        rec = out[name]
        assert rec["annotations_in_trace"] == steps and rec["step_timer"]["n"] == steps
        assert "not_measured" in rec["device"] and rec["host_ms_per_step"] > 0
    assert out["device_memory_stats"] == {"cpu": {}}
    assert out["profile3d"]["num_envs"] == 1 and len(out["profile3d"]["ms"]) == 7
    assert out["profile_rl_2d"]["envs"] == 1
    json.dumps(out)
    times_3d = {"kernels": {f"stage_rk_3d.stage{m}": {"ms": 0.7 + m} for m in range(3)},
                "poisson": {"dense": {"ms": 0.9}}, "env_step_split": {"env_step_ms": 72.0}}
    beside = chip_smoke.profiling_beside(
        times_3d, {"s_per_iteration": 2.1, "split_s_per_iteration": {"update": 1.1}})
    assert beside["timing_3d"]["stage_rk_3d.stage2_ms"] == 2.7
    assert beside["rl_train_2d"]["s_per_iteration"] == 2.1


def test_smoke_example_phases_run_on_cpu():
    """Phases 32-34 at a tiny size on the plain path: the vectorized and
    timing twins on a 16x32 grid (the 8x16 observation's Nu sits below the
    full grid's range, so the rehearsal's range starts at 0), the PPO twin
    on 2 envs for 2 iterations of 2 steps of 2 substeps."""
    vec = chip_smoke.example_vectorized("cpu", 2, 2, nu_range=(0.0, chip_smoke.NU_RANGE[1]),
                                        **TINY, observation_shape=(8, 16), heater_duration=0.3)
    assert vec["launches"] == {"env_step_2d": 0} and vec["env_steps_per_s"] > 0
    assert re.fullmatch(r"native lockstep: 2 envs x 2 steps in [0-9.]+s \([0-9]+ env-steps/s\)",
                        vec["lines"][0])
    assert vec["lines"][1].startswith("rewards: [")
    tim = chip_smoke.example_timing("cpu", 2, 2, **TINY, observation_shape=(8, 16),
                                    heater_duration=0.06)
    assert tim["substeps_per_step"] == 2 and tim["heater_duration"] == 0.06
    assert tim["launches"] == {"env_step_2d": 0} and tim["us_per_env_step"] > 0
    ppo = chip_smoke.example_ppo_native("cpu", iterations=2, num_envs=2, n_steps=2, n_epochs=1,
                                        n_minibatches=2, heater_duration=0.0125)
    assert ppo["path"] == "plain" and ppo["substeps_per_step"] == 2
    assert ppo["launches"] == {"stage_rk_3d": 0, "correct_3d": 0}
    assert ppo["n_updates"] == [2.0, 2.0] and 0 < ppo["update_share"] < 1
    assert ppo["tf32"] == {"matmul": False, "cudnn": False}
    assert ppo["last_line"] == f"best rollout nusselt: {ppo['best_nusselt']}"
    json.dumps({"a": vec, "b": tim, "c": ppo})


def test_smoke_launchers_phase_runs_on_cpu(tmp_path, monkeypatch):
    """Phase 35 on the CPU: the bank launchers at 32x16 and 8x8x8 for one
    snapshot window, fill_missing_banks skipping all six banks, and
    train_sa.sbatch for one iteration of 2 envs through a small config."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    config = tmp_path / "tiny.yaml"
    config.write_text("rl_n_epochs: 1\nrl_batch_size: 2\nrbc_heater_duration: 0.0125\n"
                      "rbc_episode_length: 0.1\n")
    out = chip_smoke.launchers("cpu", duration_2d=0.3, duration_3d=0.125,
                               args_2d=("--N", "32", "16"), args_3d=("--N", "8", "8", "8"),
                               sbatch={"NUM_ENVS": "2", "N_STEPS": "2", "CONFIG": str(config)})
    for dim in ("2d", "3d"):
        assert [out[dim][s]["episodes"] for s in chip_smoke.SPLITS] == [2, 2, 2]
        assert len(out[dim]["lines"]) == 3
    assert out["2d"]["train"]["max_abs_div"] < out["2d"]["train"]["div_atol"]
    assert len(out["fill_missing_banks"]) == 7
    assert out["train_sa"]["first_line"].startswith("launching: ")
    assert {"config.yaml", "metrics.jsonl", "models/final_model.npz"} <= set(
        out["train_sa"]["outputs"])
    json.dumps(out)


def test_smoke_measurement_phase_runs_on_cpu():
    """Phase 37 at a tiny size: the parity checks refuse the CPU by name,
    the flop counts hold their closed forms, the shares of given rates lie
    in (0, 100] %, and the scripts run on their plain halves."""
    rates = {"main_path": 20_000.0, "main_path_3d": 12_000.0, "main_path_big": 1_000.0}
    out = chip_smoke.measurement(
        torch.device("cpu"), rates,
        flop_sizes=dict(state_shape_2d=(16, 32), num_envs=2, heater_duration_2d=0.06,
                        poisson_shapes=((8, 8, 16), (32, 16, 32)), refused_envs=1),
        script_sizes=dict(num_envs=1, bench_steps=1, n_units=1, n_iter=1))
    assert set(out["cpu_refused"]) == {"fused_parity_2d", "fused_parity_3d"}
    assert "parity" not in out  # the card's part
    assert out["flops"]["plain_2d"]["gemm_per_point_stage"] == 2.0 * (2 * 32 + 16)
    assert 250 < out["flops"]["plain_2d"]["elementwise_per_point_stage"] < 260
    assert out["roofline"]["main_path"]["fp32_utilization_pct"] == pytest.approx(
        100 * 211.4 * 96 * 64 * 150 * 20_000 / 67e12)
    assert out["scripts"]["ablate3d"]["path"] == "plain"
    json.dumps(out)
