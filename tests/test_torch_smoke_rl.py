"""The RL phases of ``chip_smoke.py`` rehearsed on the CPU: the bank's
oracles, the policies, the 2D and 3D training and evaluation, the
generalist and burn-in, and two ranks.

Split from ``tests/test_torch_smoke.py`` by group (their shared helpers
are in ``tests/torch_smoke_common.py``); each test as it was there.
"""

import json

import numpy as np
import pytest

import chip_smoke

from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)


def test_smoke_bank_oracles_run_on_cpu():
    """The committed Ra=1e4 bank: 20 episodes, its divergence within its
    float32 rounding, one env step of each fixed point; a bank of another
    size is refused before any step."""
    out = chip_smoke.bank_oracles("cpu", n_fixed=1, steps=1)
    assert out["episodes"] == 20 and out["max_abs_div"] < out["div_atol"] < 1e-5
    for name in ("fixed_point_float64", "fixed_point_float32"):
        rec = out[name]
        assert rec["path"] == "plain" and rec["env_step_2d_launches"] == 0
        assert rec["max_abs_err"] <= rec["atol"]
    assert out["fixed_point_float64"]["atol"] == 0.005
    json.dumps(out)
    with pytest.raises(AssertionError, match="20 episodes, not 19"):
        chip_smoke.bank_oracles("cpu", episodes=19)


def test_smoke_policy_phases_run_on_cpu():
    parity = chip_smoke.policy_parity("cpu", n_obs=4)
    assert parity["tf32"] == [False, False]
    assert max(parity["max_abs_err"].values()) < parity["atol"]
    evaluation = chip_smoke.rl_eval_2d("cpu", episodes=2, steps=2, min_suppression=None)
    assert evaluation["launches"] == {"env_step_2d": 0} and evaluation["path"] == "plain"
    assert np.isfinite(evaluation["suppression_vs_zero_pct"])
    assert evaluation["trained"]["nusselt_mean"] < evaluation["zero"]["nusselt_mean"]
    json.dumps({"p": parity, "e": evaluation})


def test_smoke_3d_rl_phases_run_on_cpu():
    """Phases 19-21 at a tiny size: the trained 3D policy on 2
    observations, its evaluation and 2 PPO iterations on 2 envs with 2
    substeps a step and 2-step episodes (each env truncates twice)."""
    parity = chip_smoke.policy_parity_3d("cpu", n_obs=2)
    assert parity["phase"] == "policy_parity_3d" and parity["tf32"] == [False, False]
    assert max(parity["max_abs_err"].values()) < parity["atol"]
    tiny = dict(rbc_heater_duration=0.0125)
    evaluation = chip_smoke.rl_eval_3d("cpu", episodes=2, steps=2, min_suppression=None,
                                       config_overrides=tiny)
    assert evaluation["path"] == "plain" and evaluation["substeps_per_step"] == 2
    assert evaluation["launches"] == {"stage_rk_3d": 0, "correct_3d": 0}
    assert np.isfinite(evaluation["suppression_vs_zero_pct"])
    assert evaluation["jax_record"]["suppression_vs_zero_pct"] == 1.236
    out = chip_smoke.rl_train_3d("cpu", iterations=2, config_overrides=dict(
        rl_n_envs=2, rl_n_steps=2, rl_batch_size=2, rl_n_epochs=1,
        rbc_episode_length=0.1, **tiny))
    assert out["truncations"] == 4 and 0.0 not in out["boundary_value_range"]
    assert out["launches"] == {"stage_rk_3d": 0, "correct_3d": 0}
    assert out["n_updates"] == [2.0, 2.0] and out["adam_count"] == 4
    assert out["restored_tensors"] == 23 * 3 + 9 + 1 + 2  # params and moments; env; obs; gens
    json.dumps({"p": parity, "e": evaluation, "t": out})


def test_smoke_generalist_and_burnin_run_on_cpu():
    """Phases 22-23 at a tiny size: the generalist on 2 envs a rung, and
    both generators for 2 episodes of 2 windows, read back by their envs."""
    out = chip_smoke.rl_generalist_2d("cpu", num_envs=2, config_overrides=dict(
        rl_n_steps=2, rl_batch_size=2, rl_n_epochs=1, rbc_heater_duration=0.06))
    assert out["ras"] == [10000, 30000] and out["shared_model_and_optimizer"]
    assert out["adam_count"] == sum(out["n_updates"]) and out["launches"] == {"env_step_2d": 0}
    assert out["rung_dirs"] == ["ra10000", "ra30000"]
    bank = chip_smoke.burnin("cpu", n_episodes=2, duration_2d=0.6, duration_3d=0.25, nu_steps=1,
                             nu_heater_duration_3d=0.0125)
    assert bank["2d"]["windows"] == 2 and bank["3d"]["windows"] == 2
    assert bank["2d"]["launches"] == {"env_step_2d": 0}
    assert bank["3d"]["launches"] == {"stage_rk_3d": 0, "correct_3d": 0}
    for dim in ("2d", "3d"):
        rec = bank[dim]
        assert rec["episodes"] == 2 and rec["min_episode_gap_b"] > 0.0
        assert rec["max_abs_div"] < rec["div_atol"]
        assert all(np.isfinite(v) for v in rec["zero_action_nu_after_1_steps"].values())
    json.dumps({"g": out, "b": bank})


def test_smoke_rl_train_runs_on_cpu_and_restores_exactly():
    """Episodes of 2 env steps, so each of the 2 envs truncates twice in
    the 4 steps (the card run truncates each of its 256 envs once)."""
    out = chip_smoke.rl_train_2d("cpu", iterations=2, config_overrides=dict(
        rl_n_envs=2, rl_n_steps=2, rl_batch_size=2, rl_n_epochs=1, rbc_episode_length=3.0))
    assert out["truncations"] == 4 and 0.0 not in out["boundary_value_range"]
    assert out["num_envs"] == 2 and out["iterations"] == 2 and out["launches"] == {
        "env_step_2d": 0}
    assert out["n_updates"] == [2.0, 2.0] and out["adam_count"] == 4
    assert out["restored_tensors"] == 17 * 3 + 8 + 1 + 2  # params and moments; env; obs; gens
    assert sum(out["split_s_per_iteration"].values()) == pytest.approx(out["s_per_iteration"])
    assert out["update_device"].startswith("not measured")  # the profile needs the card
    json.dumps(out)


def test_smoke_multi_rank_phase_runs_on_cpu():
    """Phase 36's ranks on the CPU at a tiny size: two gloo ranks through
    ``chip_smoke.py --rank-worker``: the 2D env, the training grid's two
    paths and one 2D PPO iteration equal one process's within the card's
    gates (the 2D env and the float64 3D path bit for bit), the ranks' params
    equal to each other; no kernel launches here. The bench and launcher
    parts run in tests/test_torch_parallel_launch.py."""
    spec = {"env_2d": {"num_envs": 8, "steps": 3, "state_shape": [16, 32],
                       "observation_shape": [8, 16], "heater_duration": 0.3},
            "env_3d": {"num_envs": 4, "steps": 1, "state_shape": [8, 8, 8],
                       "heater_duration": 0.0125},
            "ppo_2d": {"rl_n_envs": 4, "rl_n_steps": 2, "rl_batch_size": 4,
                       "rbc_heater_duration": 0.3}}
    out = chip_smoke.multi_rank_ranks("cpu", spec, timeout=300)
    assert out["phase"] == "multi_rank" and out["backend"] == "gloo"
    assert out["devices"] == ["cpu", "cpu"]
    for name in ("env_2d", "env_3d"):
        assert out["max_rel_diff"][f"{name}/rewards"] == 0.0
        assert out["max_rel_diff"][f"{name}/obs"] == 0.0
    assert out["max_rel_diff"]["env_3d_field/rewards"] <= chip_smoke.MULTI_RANK_RTOL
    assert out["env_3d_field"]["path"] == "field" and out["env_2d"]["num_envs_per_rank"] == 4
    for run, n_updates in (("one_epoch", 2.0), ("full", 2.0)):
        assert out[run]["params_ranks_max_abs_diff"] == 0.0
        assert out[run]["params_max_abs_diff"] <= chip_smoke.MULTI_RANK_PARAMS_ATOL
        assert out[run]["n_updates"] == {"ranks": [n_updates] * 2, "one_process": n_updates}
        assert out[run]["num_envs_per_rank"] == 2
    assert out["one_epoch"]["cudnn_deterministic"] and not out["full"]["cudnn_deterministic"]
    assert out["full"]["one_process_repeat_params_max_abs_diff"] == 0.0  # no cuDNN here
    assert out["launches_per_rank"]["env_2d"] == [{"env_step_2d": 0}] * 2
    json.dumps(out)
