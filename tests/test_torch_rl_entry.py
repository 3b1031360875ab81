"""The port's RL entry points end to end on the CPU at a tiny size.

``run_sarl_2d`` trains, evaluates, snapshots and resumes as its JAX twin
does (tests/test_experiments.py); ``eval_baselines`` writes the JAX twin's
record, as ``baseline_eval_torch.json``, for a 2D and a 3D result dir and
leaves the JAX record beside it as it was, and its bootstrap is the JAX
script's; each runs as
``python -m``; and the port's modules import none of the JAX stack, with
h5py, msgpack and yaml imported only inside the host functions that need
them.
"""

import importlib.util
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from rbc_gym_tpu_torch.experiments import eval_baselines, run_sarl_2d
from rbc_gym_tpu_torch.models.nets import RBCActorCritic, RBCActorCritic2D
from rbc_gym_tpu_torch.models.params import save_params
from rbc_gym_tpu_torch.utils import checkpoints as ckpt

REPO = Path(__file__).resolve().parent.parent
TINY_2D = {
    "rl_n_steps": 2,
    "rl_n_envs": 2,
    "rl_batch_size": 2,
    "rl_n_epochs": 1,
    "rl_nr_iterations": 2,
    "rbc_heater_duration": 0.3,
    "rbc_rayleigh_number": 10_000,
    "rbc_episode_length": 0.9,
    "rbc_observation_shape": [8, 16],
    "rbc_state_shape": [16, 32],
    "rbc_checkpoint": None,
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several processes
    on a few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bank(path, shape, n=3, seed=0):
    """A tiny bank of conductive states with a small kick, (n, *shape)."""
    rng = np.random.default_rng(seed)
    nz = shape[-1]
    z = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z) / 2.0 + 0.01 * rng.standard_normal((n,) + shape), 1.0, 2.0)
    w = 0.01 * rng.standard_normal((n,) + shape[:-1] + (nz + 1,))
    w[..., 0] = w[..., -1] = 0.0
    vel = {"u": 0.01 * rng.standard_normal((n,) + shape), "w": w}
    if len(shape) == 3:
        ckpt.save_bank_3d(path, ckpt.CheckpointBank3D(
            b=b, v=0.01 * rng.standard_normal((n,) + shape), **vel))
    else:
        ckpt.save_bank_2d(path, ckpt.CheckpointBank2D(b=b, **vel))
    return str(path)


def test_run_sarl_2d_trains_snapshots_and_resumes(tmp_path):
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(TINY_2D))
    out = tmp_path / "run2d"
    args = ["--config", str(cfg_path), "--output_dir", str(out), "--device", "cpu"]
    run_sarl_2d.main(args)
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in recs] == [0, 1]
    assert np.isfinite(recs[-1]["rollout/nusselt_mean"]) and np.isfinite(recs[0]["eval/nusselt"])
    models = out / "models"
    for name in ("final_model.npz", "best_model.npz", "checkpoints/latest_full.npz",
                 "checkpoints/rl_model_4_steps.npz"):
        assert (models / name).exists(), name
    frozen = yaml.safe_load((out / "config.yaml").read_text())
    assert frozen == {**run_sarl_2d.DEFAULT_CONFIG, **TINY_2D}

    # resume: the frozen config rebuilds the trainer; two more iterations
    run_sarl_2d.main(["--output_dir", str(out), "--resume_training", "--iterations", "4",
                      "--device", "cpu"])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in recs] == [0, 1, 2, 3]


def test_run_sarl_2d_takes_a_bank_and_its_default_device_is_the_card(tmp_path):
    config = {**run_sarl_2d.DEFAULT_CONFIG, **TINY_2D,
              "rbc_checkpoint": _bank(tmp_path / "bank.npz", (32, 16))}
    trainer, eval_env, _ = run_sarl_2d.make_trainer(config, "cpu")
    assert trainer.env._bank.size == 3 and eval_env._bank.size == 3
    assert trainer.config.n_minibatches == 2 and trainer.config.target_kl == 0.02
    args = run_sarl_2d.parse_args(["--output_dir", str(tmp_path)])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_sarl_2d.make_trainer(config, args.device)


@pytest.mark.parametrize("three_d", [False, True])
def test_eval_baselines_writes_the_jax_record(tmp_path, three_d):
    if three_d:
        config = {"rbc_state_shape": [16, 32, 32], "rbc_rayleigh_number": 2500,
                  "rbc_heater_duration": 0.02, "rbc_heater_limit": 0.9,
                  "rbc_episode_length": 0.1, "rbc_heater_segments": 8}
        bank = _bank(tmp_path / "bank3d.npz", (32, 32, 16), n=2)
        model = RBCActorCritic()
    else:
        # 4 heaters: the proportional law averages whole sensor columns a segment
        config = {**run_sarl_2d.DEFAULT_CONFIG, **TINY_2D, "rbc_heater_segments": 4}
        bank = _bank(tmp_path / "bank.npz", (32, 16), n=2)
        model = RBCActorCritic2D(n_heaters=4, log_std_init=-0.5, obs_shape=(8, 16))
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    save_params(model, tmp_path / "models" / "best_model.npz")
    eval_baselines.main([str(tmp_path), "--bank", bank, "--episodes", "3", "--n_steps", "2",
                         "--device", "cpu"])
    res = json.loads((tmp_path / "baseline_eval_torch.json").read_text())
    for name in ("trained", "zero", "random", "proportional"):
        r = res[name]
        assert r["episodes"] == 3 and r["n_steps"] == 2 and len(r["nusselt_trace"]) == 2
        lo, hi = r["nusselt_second_half_ci95"]
        assert lo <= r["nusselt_mean_second_half"] <= hi
    assert res["bank_size"] == 2 and res["ic_duplication"] == 2
    assert np.isfinite(res["suppression_vs_zero_pct"])
    assert set(res["suppression_random_vs_zero"]) == {"pct", "ci95"}


def test_eval_baselines_leaves_the_jax_record_untouched(tmp_path):
    """On a copy of a JAX result dir (its config, flax params and
    ``baseline_eval.json``), the port writes its own file and the JAX
    record stays byte for byte."""
    src = REPO / "results" / "sarl2d_ra10000"
    (tmp_path / "models").mkdir()
    for name in ("config.yaml", "baseline_eval.json", "models/best_model.msgpack"):
        shutil.copy(src / name, tmp_path / name)
    eval_baselines.main([str(tmp_path), "--model", "models/best_model.msgpack",
                         "--bank", str(REPO / "data/checkpoints/test/ckpt_ra10000.h5"),
                         "--episodes", "2", "--n_steps", "1", "--device", "cpu"])
    assert (tmp_path / "baseline_eval.json").read_bytes() == (
        src / "baseline_eval.json").read_bytes()
    res = json.loads((tmp_path / "baseline_eval_torch.json").read_text())
    assert res["trained"]["episodes"] == 2 and res["bank_size"] == 10


def _jax_eval_baselines():
    """``experiments/eval_baselines.py`` (its bootstrap is plain numpy)."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_baselines", REPO / "experiments" / "eval_baselines.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("clustered", [False, True])
def test_bootstrap_and_suppression_are_the_jax_scripts(clustered):
    """The port's ``bootstrap_ci`` and ``suppression`` give the JAX script's
    CIs exactly on the same per-episode arrays (64 episodes on a bank of 10,
    as in results/sarl2d_ra10000), clustered by bank state or not. The JAX
    ``suppression`` is a closure inside its ``main``; its statistic is
    restated here from there."""
    jax_eb = _jax_eval_baselines()
    rng = np.random.default_rng(3)
    state = 3.7 + 0.4 * rng.standard_normal(10)
    zero = state[np.arange(64) % 10] + 1e-3 * rng.standard_normal(64)
    trained = 0.7 * zero + 0.01 * rng.standard_normal(64)
    clusters = np.arange(64) % 10 if clustered else None

    def mean(e):
        return e.mean()

    assert eval_baselines.bootstrap_ci(mean, (zero,), clusters=clusters) == \
        jax_eb.bootstrap_ci(mean, (zero,), clusters=clusters)

    def stat(te, ze):  # experiments/eval_baselines.py, main(), suppression()
        zm = ze.mean()
        if not np.isfinite(zm) or abs(zm) < 1e-9:
            return np.nan
        return 100.0 * (zm - te.mean()) / zm

    want = jax_eb.bootstrap_ci(stat, (trained, zero), clusters=clusters)
    got = eval_baselines.suppression({"trained": trained, "zero": zero}, "trained", clusters)
    assert got["ci95"] == list(want)
    assert got["pct"] == 100.0 * (zero.mean() - trained.mean()) / zero.mean()


def test_bootstrap_resamples_clusters_together():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(12)
    clusters = np.arange(12) % 3
    lo, hi = eval_baselines.bootstrap_ci(lambda e: e.mean(), (x,), n_boot=500,
                                         clusters=clusters)
    lo_i, hi_i = eval_baselines.bootstrap_ci(lambda e: e.mean(), (x,), n_boot=500)
    assert lo <= x.mean() <= hi and lo_i <= x.mean() <= hi_i


@pytest.mark.parametrize("module", ["rbc_gym_tpu_torch.experiments.run_sarl_2d",
                                    "rbc_gym_tpu_torch.experiments.eval_baselines",
                                    "rbc_gym_tpu_torch.utils.convert"])
def test_entry_points_run_as_modules(module):
    proc = subprocess.run([sys.executable, "-m", module, "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage" in proc.stdout


def test_port_imports_with_jax_stack_and_host_libraries_refused():
    """Every module of the port (and chip_smoke) imports with jax, flax,
    optax, rbc_gym_tpu, gymnasium, h5py, msgpack, yaml, wandb, matplotlib,
    imageio and pyvista refused: the host libraries are imported inside
    host-only functions, never at import. The host-only gym modules, whose
    classes derive from gymnasium's, and the gym example twins are the
    exception: they, and nothing else, are refused, and for gymnasium."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {"jax", "jaxlib", "flax", "optax", "gymnasium", "h5py", "msgpack", "yaml",
                   "rbc_gym_tpu", "wandb", "matplotlib", "imageio", "pyvista"}
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
        from rbc_gym_tpu_torch.utils.checkpoints import load_bank_2d
        load_bank_2d("rbc_gym_tpu_torch/assets/ckpt_ra10000_train.npz")
        print(len(names), " ".join(sorted(refused)))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, *refused = proc.stdout.split()
    assert int(count) >= 24
    assert refused == [
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
    ]
