"""The port's multi-rank launchers on the CPU, through the smoke's
``multi_rank`` parts, each through torchrun with a standalone rendezvous
on a free local port and two gloo ranks:

* ``rbc_gym_tpu_torch/scripts/bench_multihost.sh``, the weak-scaling
  harness, end to end at 16 envs a process and 3 steps, with the JAX
  harness's records and efficiency arithmetic
  (``tests/test_bench_multihost.py``);
* two ranks of ``tests/torch_parallel_worker.py`` (part ``groups``)
  launched several times in a row, each rank joining its group, one
  all-reduce, and ending it before it exits;
* ``rbc_gym_tpu_torch/scripts/launch_multihost.sh`` running ``run_sarl``
  at a tiny 3D config: rank 0 alone writes the outputs (one metrics record
  an iteration, the models, the full state in the one-process layout), and
  the final params are one process's to float32 rounding (on the card
  the record sets them beside one process's own repeat).
"""

import json
import sys

import pytest

import chip_smoke
import torch_parallel_worker as worker
from rbc_gym_tpu_torch.parallel.launch import run_ranks
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ASSETS = chip_smoke.ASSETS
TINY_3D = {
    "rl_n_steps": 2,
    "rl_batch_size": 4,
    "rl_n_epochs": 1,
    "rbc_heater_duration": 0.0125,
    "rbc_episode_length": 0.1,
    "rbc_checkpoint": str(ASSETS / "3D_ckpt_ra2500_train.npz"),
}


@pytest.fixture
def one_rank_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_weak_scaling_harness_end_to_end(one_rank_thread):
    out = chip_smoke.multi_rank_bench("cpu", 16, 3, args=("--state_shape", "16", "32"))
    one, two, eff = out["one_rank"], out["two_ranks"], out["efficiency"]
    assert one["processes"] == 1 and one["backend"] is None and one["device"] == "cpu"
    assert two["processes"] == 2 and two["backend"] == "gloo"
    assert two["num_envs"] == 32 and two["envs_per_process"] == 16
    assert len(two["per_process_sec"]) == 2 and two["value"] > 0
    assert two["value"] == pytest.approx(32 * 3 / max(two["per_process_sec"]))
    assert eff["metric"] == "multihost_weak_scaling_efficiency_2d"
    assert eff["value"] == pytest.approx(
        eff["scaled_env_steps_per_sec"] / (2 * eff["baseline_env_steps_per_sec"]))
    assert eff["scaled_env_steps_per_sec"] == two["value"]
    assert 0.1 < eff["value"] <= 1.5


def test_launcher_trains_over_two_ranks_and_rank_0_writes(one_rank_thread):
    out = chip_smoke.multi_rank_launcher("cpu", num_envs=4, iterations=2, config=TINY_3D)
    assert out["global_steps"] == [8, 16]  # the whole fleet's steps, one record each
    assert {"config.yaml", "metrics.jsonl", "models/final_model.npz", "models/best_model.npz",
            "models/checkpoints/latest_full.npz"} <= set(out["outputs"])
    # deterministic here: one process repeats itself exactly
    assert out["one_process_repeat_params_max_abs_diff"] == 0.0
    assert out["params_max_abs_diff"] <= chip_smoke.MULTI_RANK_PARAMS_ATOL
    assert out["n_updates"] == [2.0, 2.0]  # 2 minibatches of 4, one epoch


def test_ranks_end_their_group_before_they_exit(one_rank_thread, tmp_path):
    """A rank that exits with its process group alive can abort as the
    interpreter ends ("terminate called without an active exception",
    exit -6, in a few launches of a hundred under load). Each rank of the
    worker ends its group (``parallel.shutdown_distributed``: a barrier,
    then ``destroy_process_group``), so every launch of several in a row
    exits 0 on both ranks, with no such abort in their output."""
    for launch in range(4):
        out = tmp_path / str(launch)
        out.mkdir()
        logs = run_ranks([sys.executable, worker.__file__, str(out), "groups"], 2, timeout=120)
        assert not any("terminate called" in log for log in logs), logs
        for rank in range(2):
            rec = json.loads((out / f"groups_rank{rank}.json").read_text())
            assert rec == {"rank": rank, "size": 2, "sum": [2.0, 2.0]}
