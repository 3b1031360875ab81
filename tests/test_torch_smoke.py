"""Rehearse the card run of ``chip_smoke.py`` on the CPU.

Everything but the kernel launches runs here: the port imports with jax,
gymnasium, h5py and rbc_gym_tpu refused; the smoke's phases run at a tiny
size on their plain halves; the script refuses to run without a card; the
build command targets sm_90a into a git-ignored directory; and every
exported C function has its ctypes signature declared.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from rbc_gym_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "rbc_gym_tpu_torch"
TINY = dict(state_shape=(16, 32))


def _run(args, cwd=REPO, env=None, timeout=300):
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_port_imports_with_reference_stack_refused():
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {"jax", "jaxlib", "gymnasium", "h5py", "rbc_gym_tpu"}
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"refused import of {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        import rbc_gym_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            rbc_gym_tpu_torch.__path__, "rbc_gym_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        print(len(names))
    """)
    proc = _run([sys.executable, "-c", code])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 12


def test_no_reference_stack_imports_in_port_sources():
    """No jax stack anywhere; h5py (and msgpack, yaml, wandb, matplotlib,
    pyvista, imageio) only inside the host functions that use them, never
    at a module's top level."""
    pattern = re.compile(r"^\s*(import|from) (jax|flax|optax|gymnasium|rbc_gym_tpu)\b", re.M)
    top_level = re.compile(
        r"^(import|from) (h5py|msgpack|yaml|wandb|matplotlib|pyvista|imageio)\b", re.M)
    files = [f for f in sorted(PACKAGE.rglob("*.py"))
             if "_build" not in f.relative_to(PACKAGE).parts] + [REPO / "chip_smoke.py"]
    assert not [f for f in files if pattern.search(f.read_text())]
    assert not [f for f in files if top_level.search(f.read_text())]


def test_smoke_phases_run_on_cpu_plain_halves():
    solver, case = chip_smoke.make_case("cpu", 2, heater_duration=0.06, **TINY)
    k1 = chip_smoke.k1_run(solver, case, kernel=False)
    k2 = chip_smoke.k2_run(solver, case, kernel=False)
    assert [tuple(t.shape) for t in k1] == [(2, 32, 16), (2, 32, 17), (2, 32, 16), (2, 32, 16)]
    assert [tuple(t.shape) for t in k2] == [(2, 32, 16), (2, 32, 17), (2, 32, 16)]
    assert all(bool(torch.isfinite(t).all()) for t in (*k1, *k2))

    parity = chip_smoke.kernel_parity("cpu", k1_envs=2, main_envs=2, off_chip_shape=(65, 4),
                                      k2_runtime_shape=(12, 20), k2_general_shape=(80, 8),
                                      **TINY)
    assert max(parity["max_abs_err"].values()) == 0.0  # on the CPU both halves are plain
    assert {"tendencies_2d_runtime", "tendencies_2d_general"} <= set(parity["max_abs_err"])
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

    fake = {"ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes"}
    names = ("env_step_2d", "tendencies_2d", "stage_rk_3d", "correct_3d", "stage_rk_3d_xy",
             "field_tendency_3d", "div_3d")
    records = chip_smoke.kernel_records(
        {"env_step_2d": 1e-7, "env_step_2d_main": 2e-7, "tendencies_2d": 1e-8,
         "stage_rk_3d": 3e-7, "correct_3d": 1e-8, "stage_rk_3d_xy": 4e-7,
         "field_tendency_3d": 5e-7, "div_3d": 6e-8},
        {"env_step_2d": 3, "tendencies_2d": 3, "stage_rk_3d": 117, "correct_3d": 3,
         "stage_rk_3d_xy": 225, "field_tendency_3d": 468, "div_3d": 117},
        {name: fake for name in names},
    )
    assert [rec["name"] for rec in records] == list(names)
    assert records[0]["max_abs_err"] == 2e-7  # the main path's shapes
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for rec in records:
        assert set(rec) == keys and rec["route"] == "cuda"
        assert (REPO / rec["source"]).exists()
        path_, line = rec["replaces"].split(":")
        body = (REPO / path_).read_text().splitlines()[int(line) - 1]
        assert re.match(r"def _\w*_kernel\w*\(", body)
    json.dumps({"kernels": records})


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


def test_smoke_rl_config_is_the_trained_policys():
    """The smoke trains and evaluates at results/sarl2d_ra10000's config."""
    import yaml

    from rbc_gym_tpu_torch.experiments.run_sarl_2d import DEFAULT_CONFIG

    with open(REPO / "results" / "sarl2d_ra10000" / "config.yaml") as f:
        trained = yaml.safe_load(f)
    smoke = {**DEFAULT_CONFIG, **chip_smoke.SARL2D_RA10000}
    assert {k: smoke[k] for k in trained} == trained
    assert set(smoke) - set(trained) == {"rl_shared_trunk"} and not smoke["rl_shared_trunk"]


@pytest.fixture
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several processes
    on a few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_smoke_3d_rl_config_is_the_trained_policys():
    """The 3D smoke trains and evaluates at results/sarl_ra2500's config,
    which is experiments/configs/sarl3d_ra2500.yaml."""
    import yaml

    from rbc_gym_tpu_torch.experiments.run_sarl import DEFAULT_CONFIG

    with open(REPO / "results" / "sarl_ra2500" / "config.yaml") as f:
        trained = yaml.safe_load(f)
    with open(REPO / "experiments" / "configs" / "sarl3d_ra2500.yaml") as f:
        assert yaml.safe_load(f) == {k: v for k, v in trained.items()
                                     if k not in ("rbc_checkpoint_idx", "rl_stat_window_size")}
    smoke = {**DEFAULT_CONFIG, **chip_smoke.SARL3D_RA2500}
    assert {k: smoke[k] for k in trained} == trained
    assert set(smoke) - set(trained) == {"rl_share_features_extractor"}
    assert not smoke["rl_share_features_extractor"]


def test_smoke_3d_rl_phases_run_on_cpu(one_torch_thread):
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


def test_smoke_generalist_and_burnin_run_on_cpu(one_torch_thread):
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


def test_field_bounds():
    """K6 and K7 at 1024 envs on 16x32x32 move more bytes than their FLOP
    hide: 339,738,624 bytes for gu and gv, 276,824,064 for gw, 343,932,928
    for gb and 272,629,760 for div."""
    works = {f: chip_smoke.field_tendency_3d_work(1024, 32, 32, 16, f) for f in "uvwb"}
    assert [works[f]["bytes"] for f in "uvwb"] == [339_738_624, 339_738_624, 276_824_064,
                                                   343_932_928]
    div = chip_smoke.div_3d_work(1024, 32, 32, 16)
    assert div["bytes"] == 272_629_760
    bounds = [chip_smoke.bound(w) for w in (*works.values(), div)]
    assert all(by == "bytes" for _, by in bounds)
    assert [round(ms, 4) for ms, _ in bounds] == [0.1014, 0.1014, 0.0826, 0.1027, 0.0814]


def test_bounds_at_main_path_shapes():
    k1_ms, k1_by = chip_smoke.bound(chip_smoke.env_step_work(1024, 96, 64, 50))
    k2_ms, k2_by = chip_smoke.bound(chip_smoke.tendencies_work(1024, 96, 64))
    assert (k1_by, k2_by) == ("operations", "bytes")
    # ~0.66 GFLOP per env per env step at 67 TFLOP/s; ~7 field slabs at 3.35 TB/s
    assert 9.5 < k1_ms < 11.0 and 0.04 < k2_ms < 0.08


def test_k2_bytes_with_and_without_p_hy():
    """K2's bound is its own function's, which takes b and no p_hy:
    152,174,592 bytes at 1024 envs on 96x64, 0.0454 ms, one (nx, nz) slab
    less than the Pallas kernel's 177,340,416 bytes (0.0529 ms), its
    yardstick beside it."""
    assert chip_smoke.tendencies_work(1024, 96, 64)["bytes"] == 177_340_416
    assert round(chip_smoke.bound(chip_smoke.tendencies_work(1024, 96, 64))[0], 4) == 0.0529
    own = chip_smoke.tendencies_own_work(1024, 96, 64)
    assert own["bytes"] == 152_174_592 == 177_340_416 - 4 * 1024 * 96 * 64
    assert chip_smoke.bound(own)[1] == "bytes"
    assert round(chip_smoke.bound(own)[0], 4) == 0.0454


def test_kernel_time_split_of_a_trace():
    """The substep's device split from a Chrome trace: kernels by name,
    largest first, their busy sum and the idle share of their span; CPU
    events are not device time."""
    events = [{"cat": "kernel", "name": "k2", "ts": 0.0, "dur": 100.0},
              {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 900.0},
              {"cat": "kernel", "name": "gemm", "ts": 150.0, "dur": 300.0},
              {"cat": "kernel", "name": "k2", "ts": 500.0, "dur": 100.0}]
    split = chip_smoke.kernel_time_split(events)
    assert split["device_busy_ms"] == 0.5 and split["span_ms"] == 0.6
    assert abs(split["idle_share"] - 1 / 6) < 1e-12
    assert split["kernels"] == [{"name": "gemm", "ms": 0.3, "count": 1},
                                {"name": "k2", "ms": 0.2, "count": 2}]
    assert "not_measured" in chip_smoke.kernel_time_split(events[1:2])


def test_3d_bounds_at_main_path_shapes():
    """K3 and K4 move more bytes than the card can hide behind their FLOP:
    ~1.2 MB per env per stage-1 launch at 3.35 TB/s (0.37 ms at 1024 envs)."""
    works = [chip_smoke.stage_rk_3d_work(1024, 32, 32, 16, m) for m in range(3)]
    bounds = [chip_smoke.bound(w) for w in works]
    assert all(by == "bytes" for _, by in bounds)
    assert works[0]["bytes"] == works[2]["bytes"] < works[1]["bytes"]
    assert 0.35 < bounds[1][0] < 0.38 and 0.27 < bounds[0][0] < 0.30
    k4_ms, k4_by = chip_smoke.bound(chip_smoke.correct_3d_work(1024, 32, 32, 16))
    assert k4_by == "bytes" and 0.1 < k4_ms < 0.15
    # the dense solve is ~36 MFLOP per env at 16x32x32; the factored one fewer
    dense = chip_smoke.poisson_3d_flops(1, 32, 32, 16, factored=False)
    assert 3.4e7 < dense < 3.8e7
    assert chip_smoke.poisson_3d_flops(1, 32, 32, 16, factored=True) < dense / 4


def test_big_grid_bounds():
    """K5 on 32x64x64 at 1024 envs: 7.4 MB per env at stages 0 and 2, 9.5 MB
    at stage 1, 2.264 and 2.910 ms at 3.35 TB/s; its FLOP need 0.76-0.78 ms."""
    works = [chip_smoke.stage_rk_3d_work(1024, 64, 64, 32, m) for m in range(3)]
    assert [w["bytes"] for w in works] == [7_583_301_632, 9_747_562_496, 7_583_301_632]
    bounds = [chip_smoke.bound(w) for w in works]
    assert all(by == "bytes" for _, by in bounds)
    assert [round(ms, 3) for ms, _ in bounds] == [2.264, 2.910, 2.264]
    assert all(0.76e-3 < w["flops"] / chip_smoke.FP32_FLOPS < 0.78e-3 for w in works)


@pytest.mark.parametrize("alone", [False, True])
def test_smoke_script_fails_without_a_card(tmp_path, alone):
    """No CUDA device: non-zero exit and no result; alone in a directory
    (without the package), the same."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
    proc = _run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_nvcc_targets_sm90a_into_an_ignored_directory(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    lib = _build.library_path()
    objects = [lib.with_suffix(f".{src.stem}.o") for src in _build.sources()]
    for src, obj in zip(_build.sources(), objects):  # one nvcc a source
        cmd = _build.compile_command(src, obj)
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert "-c" in cmd and cmd[-1] == str(src)
    cmd = _build.link_command(lib, objects)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and cmd[-len(objects):] == list(map(str, objects))
    assert lib.parent == _build.BUILD_DIR
    rel = lib.relative_to(REPO)
    assert "rbc_gym_tpu_torch/_build/" in (REPO / ".gitignore").read_text().splitlines()
    if _run(["git", "rev-parse", "--is-inside-work-tree"]).returncode == 0:
        assert _run(["git", "check-ignore", "-q", str(rel)]).returncode == 0
    for src in _build.sources():
        assert "torch/extension.h" not in src.read_text()


def _exports(text: str):
    """(name, [parameter declarations]) of every extern "C" function."""
    out = []
    for start in (m.end() for m in re.finditer(r'extern "C"\s*\{', text)):
        depth, end = 1, start
        while depth:
            depth += {"{": 1, "}": -1}.get(text[end], 0)
            end += 1
        block = text[start:end]
        for name, params in re.findall(r"^[A-Za-z_][\w\s\*]*?\b(\w+)\(([^)]*)\)", block, re.M):
            out.append((name, [p.strip() for p in params.split(",") if p.strip()]))
    return out


def test_every_export_has_matching_argtypes():
    exports = [e for src in _build.sources() for e in _exports(src.read_text())]
    assert {name for name, _ in exports} == set(_build.ARGTYPES)
    for name, params in exports:
        argtypes = _build.ARGTYPES[name]
        assert len(argtypes) == len(params), name
        for decl, argtype in zip(params, argtypes):
            if "*" in decl:
                want = ctypes.c_void_p
            elif decl.startswith("int "):
                want = ctypes.c_int
            else:
                want = ctypes.c_float
            assert argtype is want, f"{name}: {decl}"
