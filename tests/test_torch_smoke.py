"""Rehearse the card run of ``chip_smoke.py`` on the CPU.

Everything but the kernel launches runs here: the port imports with jax,
gymnasium, h5py and rbc_gym_tpu refused; the smoke's phases run at a tiny
size on their plain halves; the script refuses to run without a card; the
build command targets sm_90a into a git-ignored directory; and every
exported C function has its ctypes signature declared.
"""

import ast
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
# the host-only modules: gymnasium types, or gym demos, so they need
# gymnasium at import
GYM_MODULES = (
    "rbc_gym_tpu_torch.envs.gym_vector",
    "rbc_gym_tpu_torch.envs.rbc2d",
    "rbc_gym_tpu_torch.envs.rbc3d",
    "rbc_gym_tpu_torch.examples.run_2D",
    "rbc_gym_tpu_torch.examples.run_3D",
    "rbc_gym_tpu_torch.examples.run_checkpoint",
    "rbc_gym_tpu_torch.examples.run_wandb",
    "rbc_gym_tpu_torch.examples.run_wrapped",
    "rbc_gym_tpu_torch.wrappers.rbc_normalize_observation",
    "rbc_gym_tpu_torch.wrappers.rbc_normalize_reward",
    "rbc_gym_tpu_torch.wrappers.rbc_reward_shaping",
)
# the card-side example twins import gymnasium only inside these functions
GYM_FUNCTIONS = {
    "rbc_gym_tpu_torch/examples/run_vectorized.py": {"gymnasium_sync"},
    "rbc_gym_tpu_torch/examples/timing.py": {"time_gym_env"},
}


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
        refused = []
        for name in names:
            try:
                importlib.import_module(name)
            except ImportError as e:
                assert "refused import of gymnasium" in str(e), (name, e)
                refused.append(name)
        import chip_smoke
        print(len(names), " ".join(sorted(refused)))
    """)
    proc = _run([sys.executable, "-c", code])
    assert proc.returncode == 0, proc.stderr
    count, *refused = proc.stdout.split()
    assert int(count) >= 12
    # the host-only gymnasium modules, and nothing else, need gymnasium
    assert refused == sorted(GYM_MODULES)


def _functions_importing(path: Path, module: str) -> set:
    """The names of the functions of ``path`` whose bodies import ``module``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for inner in ast.walk(node):
                imported = ([a.name for a in inner.names] if isinstance(inner, ast.Import)
                            else [inner.module] if isinstance(inner, ast.ImportFrom) else [])
                if any(m and m.split(".")[0] == module for m in imported):
                    names.add(node.name)
    return names


def test_no_reference_stack_imports_in_port_sources():
    """No jax stack anywhere; gymnasium only in the host-only gym modules
    (at their top), in the package's registration (inside a function,
    where it may be missing) and in the card-side example twins' gym
    functions (``GYM_FUNCTIONS``); h5py (and msgpack, yaml, wandb,
    matplotlib, pyvista, imageio, pygame) only inside the host functions
    that use them, never at a module's top level."""
    jax_stack = re.compile(r"^\s*(import|from) (jax|flax|optax|rbc_gym_tpu)\b", re.M)
    gym_any = re.compile(r"^\s*(import|from) gymnasium\b", re.M)
    gym_top = re.compile(r"^(import|from) gymnasium\b", re.M)
    top_level = re.compile(
        r"^(import|from) (h5py|msgpack|yaml|wandb|matplotlib|pyvista|imageio|pygame)\b", re.M)
    files = [f for f in sorted(PACKAGE.rglob("*.py"))
             if "_build" not in f.relative_to(PACKAGE).parts] + [REPO / "chip_smoke.py"]
    gym_files = sorted(PACKAGE.parent / (m.replace(".", "/") + ".py") for m in GYM_MODULES)
    texts = {f: f.read_text() for f in files}
    assert not [f for f in files if jax_stack.search(texts[f])]
    assert [f for f in files if gym_top.search(texts[f])] == gym_files
    gym_inside = [REPO / f for f in GYM_FUNCTIONS]
    assert [f for f in files if gym_any.search(texts[f])] == sorted(
        gym_files + gym_inside + [PACKAGE / "__init__.py"])
    for f, functions in GYM_FUNCTIONS.items():
        assert _functions_importing(REPO / f, "gymnasium") == functions
    assert not [f for f in files if top_level.search(texts[f])]


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


def test_smoke_multi_rank_phase_runs_on_cpu(one_torch_thread):
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


def test_smoke_flowstats_and_probe_phases_run_on_cpu(one_torch_thread):
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


def test_smoke_single_env_and_ablation_phases_run_on_cpu(one_torch_thread):
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


def test_smoke_ablation_gates():
    """The JAX record passes its own gates; a zero row off by 3 %, unequal
    zero rows or a checkerboard falling with the amplitude fail."""
    jax_rows = {k: chip_smoke.JAX_ABLATION[k] for k in ("0", "0.4", "1")}
    assert chip_smoke.ablation_gates(jax_rows) == {}
    off = {**jax_rows, "0": {"random": 1.957 * 1.03, "checker": 1.957}}
    assert set(chip_smoke.ablation_gates(off)) == {"0", "0 random == checker"}
    falling = {**jax_rows, "1": {"random": 2.048, "checker": 2.0}}
    assert set(chip_smoke.ablation_gates(falling)) == {"1", "checker non-decreasing"}


def test_smoke_probe_gates_fail_off_the_jax_record():
    failed = {}
    rises = chip_smoke._probe_checks("2d", 10.0, {"row1": 10.5}, 13.2262, "2d", True, failed)
    assert rises == {"row1": pytest.approx(0.05)} and set(failed) == {"2d zero", "2d rise"}
    assert chip_smoke._near_jax(1.39, (1.3589, 0.00077), 0.03) == (True, pytest.approx(0.040767))
    assert not chip_smoke._near_jax(2.2, (1.7716, 0.0249), 0.03)[0]


def test_smoke_profiling_phase_runs_on_cpu(one_torch_thread):
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


def test_smoke_jax_records_are_the_committed_ones():
    """The JAX numbers the new phases gate on are the committed records':
    the flow-statistics JSONs and the probe logs."""
    with open(REPO / "experiments" / "flowstats" / "flowstats_ra_2d.json") as f:
        points = json.load(f)["points"]
    assert chip_smoke.JAX_FLOWSTATS_2D == {
        ra: (p["nu_mean"], p["nu_std"]) for ra, p in points.items()}
    with open(REPO / "experiments" / "flowstats" / "flowstats_ra.json") as f:
        points = json.load(f)
    assert chip_smoke.JAX_FLOWSTATS_3D == {
        ra: (points[ra]["nu_mean"], points[ra]["nu_std"]) for ra in ("500", "2000")}
    log2 = (REPO / "results" / "probe2d_ra1000000.log").read_text()
    assert f"steps): {chip_smoke.JAX_PROBE_2D['zero']:.4f}" in log2
    assert f"row=1 gain= 30.0: Nu={chip_smoke.JAX_PROBE_2D['row1_gain30']:.4f}" in log2
    log3 = (REPO / "results" / "probe3d_ra500.log").read_text()
    assert f"zero-action Nu: {chip_smoke.JAX_PROBE_3D['zero']:.4f}" in log3
    for sign in "+-":
        nu = chip_smoke.JAX_PROBE_3D[f"T_row1_gain{sign}3"]
        assert f"T row= 1 gain= {sign}3.00: Nu={nu:.4f}" in log3


def test_smoke_example_phases_run_on_cpu(one_torch_thread):
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


def test_smoke_measurement_phase_runs_on_cpu(one_torch_thread):
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
