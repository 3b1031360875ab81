"""The port's 3D RL path and its host-side helpers against the JAX package.

- ``run_sarl``'s defaults and config resolution (YAML, frozen config on
  resume, flags, batch-size repair) equal the JAX script's on the same
  arguments (exactly);
- the 3D PPO loss and its metrics equal the JAX trainer's with the flax
  weights carried across, in float64 (atol 1e-10);
- a 3D full-state resume is bit-exact on the CPU;
- the ``run_sarl`` twin trains, snapshots, evaluates at iteration 0 and
  resumes, and ``eval_sarl`` renders its final model;
- the generalist shares one model and one optimizer, initialised as
  trainer 0's, and its per-rung dirs are read by ``eval_baselines``;
- ``WandbCallback`` makes the JAX package's calls under one fake wandb;
- ``colormap`` and ``render_volume_slices`` equal the JAX package's
  (exactly);
- every new entry point's ``--help`` runs with the JAX stack and the host
  libraries refused.
"""

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rbc_gym_tpu.models import flax_nets as fx
from rbc_gym_tpu.rl.ppo import PPO as JPPO
from rbc_gym_tpu.rl.ppo import PPOConfig as JPPOConfig
from rbc_gym_tpu.rl.ppo import Transition as JTransition
from rbc_gym_tpu_torch.envs import rendering
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.experiments import eval_baselines, eval_sarl, run_sarl
from rbc_gym_tpu_torch.experiments import run_sarl_2d_generalist as gen
from rbc_gym_tpu_torch.models import nets
from rbc_gym_tpu_torch.models.params import state_dict_from_flax
from rbc_gym_tpu_torch.rl import (
    PPO,
    CheckpointCallback,
    NusseltCallback,
    PPOConfig,
    restore_training_state,
)
from rbc_gym_tpu_torch.rl.checkpoint import trainer_tensors

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rbc_gym_tpu_torch" / "assets"
SARL3D = "experiments/configs/sarl3d_ra2500.yaml"
OBS_3D = (4, 16, 32, 32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several processes
    on a few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run_sarl():
    """``experiments/run_sarl.py``, imported as tests/test_experiments.py does."""
    sys.path.insert(0, str(REPO / "experiments"))
    import run_sarl as jax_run_sarl

    return jax_run_sarl


class _Stop(Exception):
    pass


def _jax_resolved_config(argv, monkeypatch):
    """The config the JAX script writes to ``--output_dir`` for ``argv``;
    it stops at its first multi-host step, which follows the write."""
    import rbc_gym_tpu.parallel

    def stop():
        raise _Stop

    monkeypatch.setattr(rbc_gym_tpu.parallel, "initialize_distributed", stop)
    monkeypatch.setattr(sys, "argv", ["run_sarl.py", *argv])
    with pytest.raises(_Stop):
        _jax_run_sarl().main()


@pytest.mark.parametrize("flags", [
    [],
    ["--config", SARL3D],
    ["--config", SARL3D, "--num_envs", "100", "--n_steps", "3"],  # batch-size repair
    ["--ra", "8000", "--checkpoint", "bank.npz", "--iterations", "7", "--num_envs", "32"],
    "resume",
])
def test_default_config_and_resolution_match_jax(tmp_path, monkeypatch, flags):
    assert run_sarl.DEFAULT_CONFIG == _jax_run_sarl().DEFAULT_CONFIG
    monkeypatch.chdir(REPO)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    if flags == "resume":  # a frozen config in the output dir wins over the defaults
        frozen = {**run_sarl.DEFAULT_CONFIG, "rl_n_envs": 8, "rl_batch_size": 4, "seed": 3}
        for d in (jax_out, port_out):
            d.mkdir()
            (d / "config.yaml").write_text(yaml.safe_dump(frozen))
        flags = ["--resume_training", "--iterations", "9"]
    _jax_resolved_config(["--output_dir", str(jax_out), *flags], monkeypatch)
    want = yaml.safe_load((jax_out / "config.yaml").read_text())
    got = run_sarl.load_config(run_sarl.parse_args(["--output_dir", str(port_out), *flags]))
    assert got == want


def test_indivisible_batch_is_refused_as_in_jax(tmp_path, monkeypatch):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"rl_n_envs": 6, "rl_n_steps": 1, "rl_batch_size": 4}))
    monkeypatch.setattr(sys, "argv", ["run_sarl.py", "--config", str(cfg), "--output_dir",
                                      str(tmp_path / "jax")])
    with pytest.raises(AssertionError, match="divisible"):
        _jax_run_sarl().main()
    with pytest.raises(ValueError, match="divisible"):
        run_sarl.load_config(run_sarl.parse_args(["--config", str(cfg)]))


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in kp): np.asarray(v, np.float64) for kp, v in leaves}


@pytest.mark.parametrize("normalize", [True, False])
def test_3d_loss_and_metrics_match_jax(normalize):
    """The trained sarl_ra2500 weights in both nets (float64); the JAX
    trainer's ``_loss`` and the port's on the same batch, made by numpy
    from a seed: loss and every metric within 1e-10."""
    from flax import serialization

    fm = fx.RBCActorCritic(action_grid=(8, 8), log_std_init=-0.5)
    with open(REPO / "results" / "sarl_ra2500" / "models" / "best_model.msgpack", "rb") as f:
        params = serialization.msgpack_restore(f.read())
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    tm = nets.RBCActorCritic(log_std_init=-0.5).double()
    tm.load_state_dict(state_dict_from_flax(_flat(params), tm))

    rng = np.random.default_rng(11)
    n = 8  # the clip fraction is a multiple of 1/8, exact in JAX's float32 count
    obs = rng.uniform(-1.0, 1.0, (n,) + OBS_3D)
    with torch.no_grad():
        mean, log_std = (t.numpy() for t in tm(torch.as_tensor(obs))[:2])
    # actions near the policy's, so both clip branches are taken
    action = mean + np.exp(log_std) * rng.standard_normal((n, 8, 8))
    old_lp = (-0.5 * (((action - mean) / np.exp(log_std)) ** 2
                      + 2 * log_std + np.log(2 * np.pi))).reshape(n, -1).sum(-1)
    old_lp = old_lp + rng.uniform(-0.3, 0.3, n)
    adv, ret = rng.standard_normal(n) * 2.0 + 0.5, rng.standard_normal(n)
    cfg = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, normalize_advantage=normalize)
    fake = types.SimpleNamespace(config=JPPOConfig(**cfg),
                                 train_state=types.SimpleNamespace(apply_fn=fm.apply))
    batch = JTransition(obs=jnp.asarray(obs), action=jnp.asarray(action),
                        log_prob=jnp.asarray(old_lp), value=None, reward=None, truncated=None,
                        boundary_value=None, nusselt=None)
    jloss, jmetrics = jax.jit(lambda p: JPPO._loss(fake, p, batch, jnp.asarray(adv),
                                                   jnp.asarray(ret)))(params)
    me = types.SimpleNamespace(config=PPOConfig(**cfg), model=tm)
    loss, metrics = PPO._loss(me, *(torch.as_tensor(x) for x in (obs, action, old_lp, adv, ret)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-10)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=0, atol=1e-10,
                                   err_msg=k)
    assert 0.0 < float(metrics["clip_fraction"]) < 1.0


# 16x32x32 (the 3D net's grid), 2 substeps a step, 2-step episodes
TINY_ENV = dict(heater_duration=0.0125, episode_length=0.1)


def _trainer_3d():
    env = RBC3DVectorEnv(2, checkpoint=str(ASSETS / "3D_ckpt_ra2500_train.npz"),
                         device="cpu", **TINY_ENV)
    cfg = PPOConfig(n_steps=3, n_epochs=2, n_minibatches=2, anneal_lr=True, total_iterations=3,
                    target_kl=0.05)
    return PPO(env, nets.RBCActorCritic(log_std_init=-0.5), cfg, seed=0, device="cpu")


def test_3d_full_state_resume_is_bit_exact(tmp_path):
    """Run A goes 3 iterations; run B stops after 2 with a checkpoint; a
    fresh trainer restores it and goes on: its metrics and every tensor of
    its state (params, Adam moments, EnvState3D with its keys, the carried
    obs, the generators) equal A's, bit for bit (float32 on the CPU)."""
    rec_a, rec_c = [], []
    a = _trainer_3d()
    a.learn(3, callbacks=(NusseltCallback(), lambda m, t: rec_a.append(dict(m))))
    b = _trainer_3d()
    ckpt = CheckpointCallback(str(tmp_path), save_freq=1)
    cbs = (NusseltCallback(), ckpt)
    ckpt.sibling_callbacks = cbs
    b.learn(2, callbacks=cbs)
    c, nus = _trainer_3d(), NusseltCallback()
    start = restore_training_state(ckpt.full_path, c, callbacks=(nus,))
    assert start == 2 and c.optimizer.count == b.optimizer.count
    c.learn(3, callbacks=(nus, lambda m, t: rec_c.append(dict(m))), start_iteration=start)
    assert [r["iteration"] for r in rec_c] == [2]
    for ra, rc in zip(rec_a[2:], rec_c):
        assert ra == rc
    ta, tc = trainer_tensors(a), trainer_tensors(c)
    assert set(ta) == set(tc) and {"env/fields/v", "env/key", "gen/action"} <= set(ta)
    for k in ta:
        assert torch.equal(ta[k], tc[k]), k
    assert int(a.env_state.key.ne(_trainer_3d().env_state.key).sum()) > 0  # episodes restarted


TINY_3D = {
    "rl_n_steps": 2,
    "rl_n_envs": 2,
    "rl_batch_size": 2,
    "rl_n_epochs": 1,
    "rl_nr_iterations": 2,
    "rbc_heater_duration": 0.0125,
    "rbc_episode_length": 0.1,
    "rbc_checkpoint": str(ASSETS / "3D_ckpt_ra2500_train.npz"),
}


def test_run_sarl_trains_snapshots_resumes_and_eval_sarl_renders(tmp_path, capsys):
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(TINY_3D))
    out = tmp_path / "run"
    run_sarl.main(["--config", str(cfg_path), "--output_dir", str(out), "--device", "cpu"])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in recs] == [0, 1]
    # EvaluationCallback runs before MetricsLogger: eval/* at iteration 0
    assert np.isfinite(recs[0]["eval/nusselt"]) and np.isfinite(recs[0]["eval/reward"])
    assert np.isfinite(recs[-1]["rollout/nusselt_mean"])
    models = out / "models"
    for name in ("final_model.npz", "best_model.npz", "checkpoints/latest_full.npz",
                 "checkpoints/rl_model_4_steps.npz"):
        assert (models / name).exists(), name
    assert yaml.safe_load((out / "config.yaml").read_text()) == {**run_sarl.DEFAULT_CONFIG,
                                                                 **TINY_3D}
    # resume from the iteration-0 snapshot (save_freq 4): iterations 1-3
    run_sarl.main(["--output_dir", str(out), "--resume_training", "--iterations", "4",
                   "--device", "cpu"])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in recs] == [0, 1, 2, 3]

    capsys.readouterr()
    frames = tmp_path / "frames"
    eval_sarl.main([str(out), "--model", "models/final_model.npz", "--episodes", "2",
                    "--render", str(frames), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [x.split(":")[0] for x in lines] == ["episode 0", "episode 1"]
    assert all(np.isfinite(float(x.split()[4])) for x in lines)  # "mean Nu <x>"
    assert sorted(p.name for p in frames.iterdir()) == [
        "ep0_s0000.png", "ep0_s0001.png", "ep1_s0000.png", "ep1_s0001.png"]


def test_generalist_shares_trainer_0s_model_and_optimizer(tmp_path, monkeypatch):
    monkeypatch.setitem(gen.BASE, "rl_n_epochs", 1)
    monkeypatch.setitem(gen.BASE, "rbc_heater_duration", 0.06)  # 2 substeps a step
    monkeypatch.setitem(gen.BASE, "rbc_episode_length", 0.18)
    out = tmp_path / "gen"
    argv = ["--ras", "10000", "30000", "--iterations", "4", "--num_envs", "2", "--n_steps", "2",
            "--batch_size", "2", "--output_dir", str(out), "--device", "cpu",
            "--bank_pattern", str(ASSETS / "ckpt_ra{ra}_train.npz")]
    args = gen.parse_args(argv)
    cfg = gen.make_config(args)
    trainers = gen.make_trainers(cfg, "cpu", args.bank_pattern)
    assert all(t.model is trainers[0].model and t.optimizer is trainers[0].optimizer
               for t in trainers)
    assert trainers[1].optimizer.params == list(trainers[0].model.parameters())
    # initialised as trainer 0's (seed 0), not the last trainer's (seed 1)
    want = nets.RBCActorCritic2D(log_std_init=-0.5)
    nets.lecun_normal_(want, torch.Generator().manual_seed(cfg["seed"]))
    assert all(torch.equal(a, b.float()) for a, b in zip(want.parameters(),
                                                          trainers[0].model.parameters()))
    assert trainers[0].reward_transform is not trainers[1].reward_transform
    assert trainers[0].env.params.ra == 1e4 and trainers[1].env.params.ra == 3e4

    gen.main(argv)
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["ra"] for r in recs] == [10000, 30000, 10000, 30000]
    assert all(np.isfinite(r["rollout/nusselt_mean"]) for r in recs)
    assert (out / "models" / "final_model.npz").exists()
    for ra in (10000, 30000):
        d = out / f"ra{ra}"
        rung = yaml.safe_load((d / "config.yaml").read_text())
        assert rung["rbc_rayleigh_number"] == ra and "rbc_ras" not in rung
        eval_baselines.main([str(d), "--bank", str(REPO / f"data/checkpoints/test/ckpt_ra{ra}.h5"),
                             "--episodes", "2", "--n_steps", "1", "--device", "cpu"])
        res = json.loads((d / "baseline_eval_torch.json").read_text())
        assert np.isfinite(res["trained"]["nusselt_mean"]) and res["bank_size"] == 10


def test_shared_optimizer_counts_every_rungs_updates(tmp_path, monkeypatch):
    """After two rungs' iterations the one Adam count is the sum of both
    iterations' applied updates."""
    monkeypatch.setitem(gen.BASE, "rl_n_epochs", 2)
    monkeypatch.setitem(gen.BASE, "rbc_heater_duration", 0.06)
    args = gen.parse_args(["--ras", "10000", "30000", "--iterations", "2", "--num_envs", "2",
                           "--n_steps", "2", "--batch_size", "2"])
    cfg = gen.make_config(args)
    trainers = gen.make_trainers(cfg, "cpu", str(ASSETS / "ckpt_ra{ra}_train.npz"))
    recs = gen.train(trainers, cfg, str(tmp_path / "metrics.jsonl"))
    applied = [r["n_updates"] for r in recs]
    assert min(applied) >= 1 and trainers[0].optimizer.count == sum(applied)


class FakeWandb(types.ModuleType):
    """Records every call the callbacks make, paths relative to the model dir."""

    def __init__(self):
        super().__init__("wandb")
        self.run, self.calls = None, []

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))
        self.run = object()

    def define_metric(self, *args, **kwargs):
        self.calls.append(("define_metric", args, kwargs))

    def log(self, metrics, step=None):
        self.calls.append(("log", dict(metrics), step))

    def save(self, path, base_path=None, policy=None):
        self.calls.append(("save", os.path.relpath(path, base_path), policy))


def test_wandb_callback_makes_the_jax_packages_calls(tmp_path, monkeypatch):
    from rbc_gym_tpu.rl.callbacks import WandbCallback as JWandbCallback
    from rbc_gym_tpu_torch.rl import WandbCallback

    calls = {}
    for name, cls in (("jax", JWandbCallback), ("port", WandbCallback)):
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        models = tmp_path / name / "models"
        cb = cls(project="rbc-3D-rl", config={"a": 1}, dir=str(tmp_path / name),
                 model_save_path=str(models))
        (models / "best_model.npz").write_bytes(b"1")
        (models / "notes.txt").write_bytes(b"-")
        cb({"global_step": 8, "loss": 0.5}, None)
        cb({"global_step": 16, "loss": 0.25}, None)  # unchanged files: no new save
        os.utime(models / "best_model.npz", (1, 1))
        (models / "final_model.msgpack").write_bytes(b"2")
        cb({"global_step": 24, "loss": 0.125}, None)
        calls[name] = [c if c[0] != "init" else ("init", {**c[1], "dir": None})
                       for c in fake.calls]
    assert calls["port"] == calls["jax"]
    saves = [c for c in calls["port"] if c[0] == "save"]
    assert sorted(saves) == [("save", "best_model.npz", "live")] * 2 + [
        ("save", "final_model.msgpack", "live")]


def test_rendering_equals_the_jax_packages():
    from rbc_gym_tpu.envs import rendering as jrendering

    field = np.random.default_rng(4).uniform(0.9, 2.1, (16, 32, 32))
    for args in ((1.0, 2.0), (0.5, 3.0)):
        got = rendering.colormap(field[3], *args)
        assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, jrendering.colormap(field[3], *args))
    img = rendering.render_volume_slices(field, 1.0, 2.0)
    assert img.shape == (32, 4 * 32, 3)
    np.testing.assert_array_equal(img, jrendering.render_volume_slices(field, 1.0, 2.0))
    np.testing.assert_array_equal(rendering.render_volume_slices(field, 1.0, 2.0, n_slices=3),
                                  jrendering.render_volume_slices(field, 1.0, 2.0, n_slices=3))


def test_entry_points_help_with_host_libraries_refused():
    """``--help`` of run_sarl, eval_sarl, run_sarl_2d_generalist and
    create_checkpoints in one process that refuses the JAX stack, wandb,
    h5py, msgpack, matplotlib, imageio and pyvista."""
    code = textwrap.dedent("""
        import contextlib, importlib.abc, io, runpy, sys
        BLOCKED = {"jax", "jaxlib", "flax", "optax", "rbc_gym_tpu", "gymnasium", "wandb",
                   "h5py", "msgpack", "matplotlib", "imageio", "pyvista"}
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
        for module in ("run_sarl", "eval_sarl", "run_sarl_2d_generalist", "create_checkpoints"):
            sys.argv = [module, "--help"]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                try:
                    runpy.run_module("rbc_gym_tpu_torch.experiments." + module,
                                     run_name="__main__")
                except SystemExit as e:
                    assert e.code == 0, (module, e.code)
            assert "usage" in out.getvalue() and "--device" in out.getvalue(), module
            print(module)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["run_sarl", "eval_sarl", "run_sarl_2d_generalist",
                                   "create_checkpoints"]
