"""Two gloo ranks on the CPU train the port's PPO over a sharded 2D env
(``tests/torch_parallel_worker.py``, part ``ppo``) and reproduce one
process in float64 (16 envs at 16x32, 2 steps a rollout, one iteration):

* the params after one iteration within rtol 1e-9 of one process's, the
  same on both ranks to the bit, and so are the metrics;
* under a ``target_kl`` that stops the first epoch after its first
  minibatch, both ranks and one process apply the same one update;
* with minibatches of one sample, where most minibatches hold none of a
  rank's envs, every rank still joins every collective;
* a full checkpoint written by the two ranks (the one-process layout,
  written once, by rank 0) resumes in one process, and a one-process
  checkpoint resumes in two ranks, each continuing as the uninterrupted
  one-process run.
"""

import json
import sys

import numpy as np
import pytest
import torch

from rbc_gym_tpu_torch.parallel.launch import run_ranks
from rbc_gym_tpu_torch.rl import CheckpointCallback, restore_training_state

import torch_parallel_worker as worker
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

RTOL = 1e-9




@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The worker's outputs, after writing the one-process checkpoint that
    its last run resumes from."""
    out = tmp_path_factory.mktemp("ppo")
    trainer = worker.ppo_trainer()
    ckpt = CheckpointCallback(str(out / "ckpt_1p"), save_freq=1)
    trainer.learn(1, callbacks=(ckpt,))
    run_ranks([sys.executable, worker.__file__, str(out), "ppo"], 2, timeout=300,
              env={"OMP_NUM_THREADS": "1"})
    records = [json.loads((out / f"records_rank{r}.json").read_text()) for r in (0, 1)]
    return out, records


def _params(out, name, rank):
    return dict(np.load(out / f"params_{name}_rank{rank}.npz"))


def _assert_params_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("run", list(worker.PPO_RUNS))
def test_two_ranks_reproduce_one_process(ranks, run):
    out, records = ranks
    trainer = worker.ppo_trainer(**worker.PPO_RUNS[run])
    metrics = trainer.learn(1)
    p0, p1 = _params(out, run, 0), _params(out, run, 1)
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k  # the ranks apply the same update
    _assert_params_close(p0, worker.params_of(trainer))
    assert records[0][run] == records[1][run]
    assert records[0][run].keys() == metrics.keys()
    for k, v in metrics.items():
        assert records[0][run][k] == pytest.approx(v, rel=RTOL, abs=1e-15), k
    assert metrics["global_step"] == 2 * worker.N_ENVS_2D
    n_updates = {"plain": 4, "target_kl": 1, "one_sample": 32}[run]
    assert records[0][run]["n_updates"] == records[1][run]["n_updates"] == n_updates
    assert metrics["n_updates"] == n_updates


def test_two_rank_checkpoint_resumes_in_one_process(ranks):
    out, _ = ranks
    full = worker.ppo_trainer()
    full.learn(2)
    resumed = worker.ppo_trainer()
    start = restore_training_state(str(out / "ckpt_2r" / "latest_full.npz"), resumed)
    assert start == 1 and resumed.global_step == 2 * worker.N_ENVS_2D
    resumed.learn(2, start_iteration=start)
    _assert_params_close(worker.params_of(resumed), worker.params_of(full))
    # the files were written once: rank 0's metrics record and checkpoint
    assert len((out / "metrics_2r.jsonl").read_text().splitlines()) == 1
    with np.load(out / "ckpt_2r" / "latest_full.npz") as z:
        assert z["env/key"].shape == (worker.N_ENVS_2D,)
        assert z["last_obs"].shape[0] == worker.N_ENVS_2D


def test_one_process_checkpoint_resumes_in_two_ranks(ranks):
    out, records = ranks
    full = worker.ppo_trainer()
    metrics = full.learn(2)
    _assert_params_close(_params(out, "resumed", 0), worker.params_of(full))
    assert records[0]["resumed"]["iteration"] == 1
    assert records[0]["resumed"]["rollout/nusselt_mean"] == pytest.approx(
        metrics["rollout/nusselt_mean"], rel=RTOL)
