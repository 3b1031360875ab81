"""The port's profiling hooks, training plots and profiling scripts, on the CPU.

The first three tests are tests/test_profiling.py's, on
``rbc_gym_tpu_torch.utils.profiling``; the CPU has no device, so the
trace holds no kernel and the memory stats are one empty entry, as the
JAX package gives where a device has none.
"""

import glob
import json
import os

import pytest
import torch

from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.experiments import plot_training
from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D
from rbc_gym_tpu_torch.rl import PPO, MetricsLogger, PPOConfig
from rbc_gym_tpu_torch.scripts import profile3d, profile_rl
from rbc_gym_tpu_torch.utils import profiling
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)




def test_step_timer_summary():
    timer = profiling.StepTimer(skip_first=1)
    x = torch.ones((64, 64))
    for _ in range(5):
        with timer:
            y = x @ x
            timer.sink(y)
    s = timer.summary()
    assert s["n"] == 4  # first iteration skipped
    assert s["mean_ms"] > 0
    assert s["p95_ms"] >= s["p50_ms"]
    assert s["steps_per_sec"] > 0


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("hot_region"):
            (torch.arange(128.0) * 2).sum()
    files = glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
    assert any(os.path.isfile(p) for p in files)


def test_device_memory_stats_shape():
    stats = profiling.device_memory_stats()
    assert len(stats) == max(1, torch.cuda.device_count())
    assert all(isinstance(v, dict) for v in stats.values())
    if not torch.cuda.is_available():
        assert stats == {"cpu": {}}


def test_annotated_names_appear_in_the_written_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as traced:
        for i in range(3):
            with profiling.annotate("env_step"):
                torch.ones(8).cumsum(0)
        with profiling.annotate("update"):
            torch.ones(8).sum()
    assert traced.path.startswith(str(tmp_path)) and os.path.isfile(traced.path)
    events = profiling.trace_events(traced.path)
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("env_step") == 3 and names.count("update") == 1
    # no device on the CPU: the split says so rather than report 0 % idle
    assert "not_measured" in profiling.kernel_time_split(events)


def test_annotate_is_a_decorator_too(tmp_path):
    @profiling.annotate("decorated")
    def work():
        return torch.ones(4).sum()

    with profiling.trace(str(tmp_path)) as traced:
        work()
        work()
    events = profiling.trace_events(traced.path)
    assert sum(e.get("name") == "decorated" for e in events) == 2


def test_step_timer_finds_the_devices_of_nested_outputs():
    t = torch.ones(2)
    assert profiling._cuda_devices((t, {"a": [t, None]}, 3.0)) == set()
    assert profiling.device_ms(lambda: t + t, reps=2, device="cpu") > 0.0


def test_plot_twin_writes_pngs_from_a_tiny_ppo_run(tmp_path):
    env = RBC2DVectorEnv(2, state_shape=(16, 32), observation_shape=(8, 16),
                         heater_duration=0.06, device="cpu")
    model = RBCActorCritic2D(n_heaters=12, obs_shape=env.observation_shape)
    trainer = PPO(env, model, PPOConfig(n_steps=2, n_epochs=1, n_minibatches=1), device="cpu")
    trainer.learn(3, callbacks=(MetricsLogger(str(tmp_path / "metrics.jsonl"), echo_every=0),))
    assert len(plot_training.read_metrics(str(tmp_path))) == 3
    written = plot_training.main([str(tmp_path)])
    assert written == [str(tmp_path / "curves_torch.png")]
    assert os.path.getsize(written[0]) > 0

    trace = [4.0, 3.9, 3.8, 3.7]
    record = {name: {"nusselt_mean_second_half": 3.7, "nusselt_trace": trace}
              for name in ("trained", "zero", "random")}
    record.update(suppression_vs_zero_pct=1.0, suppression_vs_zero_ci95=[0.5, 1.5])
    with open(tmp_path / plot_training.BASELINES, "w") as f:
        json.dump(record, f)
    written = plot_training.main([str(tmp_path), "-o", str(tmp_path / "c.png")])
    assert written == [str(tmp_path / "c.png"), str(tmp_path / "eval_traces_torch.png")]
    assert all(os.path.getsize(p) > 0 for p in written)
    assert not (tmp_path / "curves.png").exists()  # the JAX script's name stays free


def test_profile_rl_runs_on_cpu(capsys):
    rows = profile_rl.main(["--dim", "2", "--envs", "2", "--n_steps", "1", "--k", "1",
                            "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "dim=2 n_steps=1 epochs=1 (k=1 reps)" and out[1].split()[0] == "envs"
    assert len(rows) == 1 and rows[0]["envs"] == 2
    assert rows[0]["iter_ms"] > 0 and rows[0]["env_ms"] > 0
    trainer, actions = profile_rl.build(3, 1, 1, 1, "cpu")
    assert tuple(actions.shape) == (1, 8, 8) and trainer.env.params.heater_duration == 0.375


def test_profile3d_runs_on_cpu(capsys):
    out = profile3d.main(["1", "--reps", "1", "--device", "cpu"])
    assert out["clock"].startswith("host clock") and out["path"] == "plain"
    assert set(out["ms"]) == {"stage-RK kernel (m=0)", "stage-RK kernel (m=1)",
                              "stage-RK kernel (m=2)", "per-field kernels (4x)",
                              "poisson solve", "full env step (plain)",
                              "full env step (fused=False)"}
    assert all(v > 0 for v in out["ms"].values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "16x32x32 at 1 envs, 1 reps, host clock (plain versions on the CPU)"
    assert any("ms per stage-unit (13 substeps x 3 stages)" in ln for ln in lines)
