"""Interrupted-run resume on the port: the full-state checkpoint must
reproduce an uninterrupted run exactly (tests/test_resume.py's protocol,
at a tiny size on the CPU in float64).

Run A goes uninterrupted; run B, the same config, stops mid-way with a
checkpoint; run C, a fresh trainer, restores B's checkpoint and goes on.
C's metrics and final params equal A's, bit for bit: params, Adam moments,
the schedule count, the env state with its keys and the generators' states
all survive the checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch

from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D
from rbc_gym_tpu_torch.rl import (
    PPO,
    CheckpointCallback,
    MetricsLogger,
    NusseltCallback,
    PPOConfig,
    restore_training_state,
    restore_training_state_with_fallback,
    save_training_state,
    truncate_metrics_jsonl,
)
from rbc_gym_tpu_torch.rl.checkpoint import trainer_tensors
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

TOTAL_ITERS = 4
STOP_AFTER = 2  # B runs iterations 0..1, C resumes at 2


def _make_trainer(hidden=32, n_envs=2):
    env = RBC2DVectorEnv(n_envs, state_shape=(16, 32), observation_shape=(8, 16),
                         heater_duration=0.3, episode_length=0.9,  # truncates inside the run
                         dtype=torch.float64, device="cpu")
    cfg = PPOConfig(n_steps=4, n_epochs=2, n_minibatches=2, anneal_lr=True,
                    total_iterations=TOTAL_ITERS, target_kl=0.05)
    model = RBCActorCritic2D(hidden_channels=hidden, log_std_init=-0.5, obs_shape=(8, 16))
    return PPO(env, model, cfg, seed=0, device="cpu")


class Recorder:
    def __init__(self):
        self.records = []

    def __call__(self, metrics, trainer):
        self.records.append(dict(metrics))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    rec_a, trainer_a = Recorder(), _make_trainer()
    trainer_a.learn(TOTAL_ITERS, callbacks=(NusseltCallback(), rec_a))

    rec_b, trainer_b = Recorder(), _make_trainer()
    ckpt_cb = CheckpointCallback(str(tmp / "ckpts"), save_freq=1)
    cbs_b = (NusseltCallback(), rec_b, ckpt_cb, MetricsLogger(str(tmp / "metrics.jsonl")))
    ckpt_cb.sibling_callbacks = cbs_b
    trainer_b.learn(STOP_AFTER, callbacks=cbs_b)

    rec_c, trainer_c, nus_c = Recorder(), _make_trainer(), NusseltCallback()
    cbs_c = (nus_c, rec_c, MetricsLogger(str(tmp / "metrics.jsonl")))
    start = restore_training_state(ckpt_cb.full_path, trainer_c, callbacks=cbs_c)
    truncate_metrics_jsonl(str(tmp / "metrics.jsonl"), start - 1)
    trainer_c.learn(TOTAL_ITERS, callbacks=cbs_c, start_iteration=start)
    return tmp, rec_a, rec_b, rec_c, trainer_a, trainer_b, trainer_c, nus_c, start


def test_resume_starts_where_b_stopped(runs):
    _, _, rec_b, rec_c, _, _, _, _, start = runs
    assert start == STOP_AFTER
    assert [r["iteration"] for r in rec_b.records] == list(range(STOP_AFTER))
    assert [r["iteration"] for r in rec_c.records] == list(range(STOP_AFTER, TOTAL_ITERS))


def test_resumed_metrics_match_uninterrupted(runs):
    _, rec_a, _, rec_c, *_ = runs
    for a, c in zip(rec_a.records[STOP_AFTER:], rec_c.records):
        assert a["iteration"] == c["iteration"] and a["global_step"] == c["global_step"]
        for k in ("loss", "approx_kl", "n_updates", "rollout/nusselt_mean", "rollout/nusselt_min"):
            assert c[k] == a[k], k


def test_resumed_final_state_matches(runs):
    _, _, _, _, trainer_a, _, trainer_c, _, _ = runs
    a, c = trainer_tensors(trainer_a), trainer_tensors(trainer_c)
    assert set(a) == set(c)
    for k in a:
        assert torch.equal(a[k], c[k]), k


def test_schedule_step_survives(runs):
    _, _, _, _, trainer_a, trainer_b, trainer_c, _, _ = runs
    assert 0 < trainer_b.optimizer.count < trainer_c.optimizer.count
    assert trainer_c.optimizer.count == trainer_a.optimizer.count
    assert trainer_c.optimizer.learning_rate() == trainer_a.optimizer.learning_rate()


def test_callback_state_survives(runs):
    _, rec_a, _, _, _, _, _, nus_c, _ = runs
    assert len(nus_c.history) == TOTAL_ITERS
    assert nus_c.best_nusselt == min(r["rollout/nusselt_mean"] for r in rec_a.records)


def test_metrics_jsonl_continuous(runs):
    tmp = runs[0]
    lines = (tmp / "metrics.jsonl").read_text().strip().splitlines()
    recs = [json.loads(x) for x in lines]
    assert [r["iteration"] for r in recs] == list(range(TOTAL_ITERS))
    times = [r["wall_time"] for r in recs]
    assert times == sorted(times)


def test_restore_rejects_mismatched_architecture_and_env(runs, tmp_path):
    tmp = runs[0]
    path = str(tmp / "ckpts" / "latest_full.npz")
    with pytest.raises(ValueError, match="Conv_0"):
        restore_training_state(path, _make_trainer(hidden=16))
    with pytest.raises(ValueError, match="env/"):
        restore_training_state(path, _make_trainer(n_envs=3))


def _copy_ckpts(runs, tmp_path):
    src = runs[0] / "ckpts"
    for name in os.listdir(src):
        (tmp_path / name).write_bytes((src / name).read_bytes())
    return str(tmp_path / "latest_full.npz")


def test_fallback_crash_before_promote(runs, tmp_path):
    path = _copy_ckpts(runs, tmp_path)
    os.replace(path, path + ".new")  # the save finished, the promote did not
    assert restore_training_state_with_fallback(path, _make_trainer()) == STOP_AFTER


def test_fallback_corrupt_latest_uses_previous(runs, tmp_path):
    path = _copy_ckpts(runs, tmp_path)
    with open(path, "wb") as f:
        f.write(b"not a zip")
    assert restore_training_state_with_fallback(path, _make_trainer()) == STOP_AFTER - 1


def test_fallback_nothing_usable(tmp_path):
    with pytest.raises(FileNotFoundError, match="no usable"):
        restore_training_state_with_fallback(str(tmp_path / "latest_full.npz"), _make_trainer())


def test_rotation_leaves_no_temp_files(runs):
    names = sorted(os.listdir(runs[0] / "ckpts"))
    assert "latest_full.npz" in names and "previous_full.npz" in names
    assert not [n for n in names if n.endswith((".tmp", ".new"))]
    assert {"rl_model_8_steps.npz", "rl_model_16_steps.npz"} <= set(names)


def test_save_is_atomic_and_truncate_keeps_earlier_records(runs, tmp_path):
    trainer = runs[4]
    save_training_state(str(tmp_path / "x.npz"), trainer, 7)
    assert os.listdir(tmp_path) == ["x.npz"]
    path = tmp_path / "m.jsonl"
    path.write_text("".join(json.dumps({"iteration": i}) + "\n" for i in range(5)) + "junk\n")
    assert truncate_metrics_jsonl(str(path), 2) == 3
    assert [json.loads(x)["iteration"] for x in path.read_text().splitlines()] == [0, 1, 2]
    assert np.all([n.endswith(".jsonl") for n in os.listdir(tmp_path) if n.startswith("m")])
