"""One rank of the port's CPU multi-rank tests (tests/test_torch_parallel_*.py).

    python tests/torch_parallel_worker.py OUT_DIR PART

run as two ranks by ``rbc_gym_tpu_torch.parallel.launch.run_ranks``: each
joins a gloo process group on the CPU, runs PART in float64 and leaves its
results in OUT_DIR (what every rank holds gathered to rank 0, and each
rank's own records) for the parent test to compare with one process:

* ``env``: the sharded 2D env (16 envs at 16x32) from reset(seed=0) for 3
  steps (an autoreset at step 2), one step of it from the fields in
  ``OUT_DIR/shared.npz``, and the sharded 3D env (4 envs at 8x8x8) for 2
  steps;
* ``ppo``: one PPO iteration of the tiny 2D trainer (``ppo_trainer``) in
  four runs: plain (writing a full checkpoint), with a ``target_kl`` that
  stops mid-epoch, with minibatches of one sample (a rank holds none of
  most), and resumed from the one-process checkpoint ``OUT_DIR/ckpt_1p``;
* ``groups``: one all-reduce, each rank's record of it in
  ``OUT_DIR/groups_rank<r>.json``.

Every part ends its rank's group (``parallel.shutdown_distributed``) before
the process exits.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rbc_gym_tpu_torch.envs.vector2d import EnvState2D, RBC2DVectorEnv  # noqa: E402
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv  # noqa: E402
from rbc_gym_tpu_torch.envs.autoreset import seed_keys  # noqa: E402
from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D  # noqa: E402
from rbc_gym_tpu_torch.parallel import (  # noqa: E402
    initialize_distributed,
    make_env_mesh,
    shard_batch,
    shard_ppo_trainer,
    shard_vector_env,
    shutdown_distributed,
)
from rbc_gym_tpu_torch.rl import (  # noqa: E402
    CheckpointCallback,
    MetricsLogger,
    PPO,
    PPOConfig,
    restore_training_state,
)
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy  # noqa: E402
from rbc_gym_tpu_torch.wrappers import functional as fn  # noqa: E402

# the JAX sharding tests' env (tests/test_parallel.py), with 2-step episodes
ENV_2D = dict(state_shape=(16, 32), observation_shape=(8, 16), heater_duration=0.3,
              episode_length=0.6)
N_ENVS_2D = 16
ENV_3D = dict(state_shape=(8, 8, 8), heater_duration=0.0125, episode_length=10.0)
N_ENVS_3D = 4
PPO_RUNS = {
    "plain": {},
    "target_kl": {"target_kl": 1e-12},  # the second minibatch's KL stops the epoch
    "one_sample": {"n_minibatches": 32, "n_epochs": 1},  # batch 2 x 16
}


def actions_2d(step: int) -> torch.Tensor:
    return torch.full((N_ENVS_2D, 12), 0.1 * step, dtype=torch.float64)


def ppo_trainer(mesh=None, **cfg) -> PPO:
    """The tiny 2D trainer of the tests, over ``mesh``'s ranks or in one process."""
    kw = dict(**ENV_2D, dtype=torch.float64, device="cpu")
    env = (RBC2DVectorEnv(N_ENVS_2D, **kw) if mesh is None
           else shard_vector_env(RBC2DVectorEnv, N_ENVS_2D, mesh, **kw))
    norm = fn.make_obs_norm_2d(heater_limit=0.75)
    config = PPOConfig(**{**dict(n_steps=2, n_epochs=2, n_minibatches=2), **cfg})
    trainer = PPO(env, RBCActorCritic2D(obs_shape=(8, 16), log_std_init=-0.5), config,
                  obs_transform=lambda o: fn.normalize_observation(o, norm),
                  seed=0, device="cpu")
    return trainer if mesh is None else shard_ppo_trainer(trainer, mesh)


def params_of(trainer: PPO) -> dict:
    return {k: p.detach().numpy().copy() for k, p in trainer.model.named_parameters()}


def _gathered(mesh, named: dict) -> dict:
    return {k: mesh.gather_rows(v) for k, v in named.items()}


def _save(mesh, path: str, named: dict) -> None:
    arrays = _gathered(mesh, named)
    if mesh.rank == 0:
        np.savez(path, **{k: v.numpy() for k, v in arrays.items()})


def _outputs(prefix: str, state, ts) -> dict:
    out = {f"{prefix}fields/{k}": v for k, v in state.fields._asdict().items()}
    out.update({f"{prefix}{k}": getattr(ts, k) for k in ("obs", "final_obs", "reward")})
    out[f"{prefix}truncated"] = ts.truncated
    out[f"{prefix}key"] = state.key
    return out


def part_env(mesh, out: str) -> None:
    kw = dict(**ENV_2D, dtype=torch.float64, device="cpu")
    env = shard_vector_env(RBC2DVectorEnv, N_ENVS_2D, mesh, **kw)
    state, obs = env.reset(seed=0)
    named = {"reset_obs": obs}
    for i in range(3):
        state, ts = env.step(state, shard_batch(actions_2d(i), mesh))
        named.update(_outputs(f"step{i}/", state, ts))
    _save(mesh, os.path.join(out, "env2d_seed.npz"), named)

    with np.load(os.path.join(out, "shared.npz")) as z:
        shared = {k: torch.from_numpy(z[k]) for k in z.files}
    fields = shard_batch(fields_from_numpy(types.SimpleNamespace(**{
        k: shared[k].numpy() for k in ("u", "w", "b", "p_hy", "p_nhs")})), mesh)
    lo, hi = mesh.rows(N_ENVS_2D)
    state = EnvState2D(fields=fields, t=shared["t"][lo:hi], step=shared["step"][lo:hi],
                       key=seed_keys(1, N_ENVS_2D)[lo:hi])
    state, ts = env.step(state, shared["actions"][lo:hi])
    _save(mesh, os.path.join(out, "env2d_shared.npz"), _outputs("", state, ts))

    env3 = shard_vector_env(RBC3DVectorEnv, N_ENVS_3D, mesh, **ENV_3D, dtype=torch.float64,
                            device="cpu")
    state, _ = env3.reset(seed=0)
    named = {}
    rng = np.random.default_rng(0)
    for i in range(2):
        actions = torch.as_tensor(rng.uniform(-1, 1, (N_ENVS_3D, 8, 8)))
        state, ts = env3.step(state, shard_batch(actions, mesh))
        named.update({f"step{i}/reward": ts.reward, f"step{i}/obs": ts.obs})
    named.update({f"fields/{k}": v for k, v in state.fields._asdict().items()})
    _save(mesh, os.path.join(out, "env3d.npz"), named)


def part_ppo(mesh, out: str) -> None:
    records = {}
    for name, cfg in PPO_RUNS.items():
        trainer = ppo_trainer(mesh, **cfg)
        callbacks = ()
        if name == "plain":
            ckpt = CheckpointCallback(os.path.join(out, "ckpt_2r"), save_freq=1)
            callbacks = (MetricsLogger(os.path.join(out, "metrics_2r.jsonl"), echo_every=0), ckpt)
            ckpt.sibling_callbacks = callbacks
        records[name] = trainer.learn(1, callbacks=callbacks)
        np.savez(os.path.join(out, f"params_{name}_rank{mesh.rank}.npz"), **params_of(trainer))
    trainer = ppo_trainer(mesh)
    start = restore_training_state(os.path.join(out, "ckpt_1p", "latest_full.npz"), trainer)
    records["resumed"] = trainer.learn(2, start_iteration=start)
    np.savez(os.path.join(out, f"params_resumed_rank{mesh.rank}.npz"), **params_of(trainer))
    with open(os.path.join(out, f"records_rank{mesh.rank}.json"), "w") as f:
        json.dump(records, f)


def part_groups(mesh, out: str) -> None:
    """One all-reduce over the group, and this rank's record of it."""
    total = mesh.all_reduce_(torch.ones(2, dtype=torch.float64))
    with open(os.path.join(out, f"groups_rank{mesh.rank}.json"), "w") as f:
        json.dump({"rank": mesh.rank, "size": mesh.size, "sum": total.tolist()}, f)


def main(out: str, part: str) -> None:
    torch.set_num_threads(1)
    if not initialize_distributed(device="cpu", timeout=120):
        raise RuntimeError("initialize_distributed returned False in a multi-rank launch")
    done = False
    try:
        mesh = make_env_mesh(device="cpu")
        {"env": part_env, "ppo": part_ppo, "groups": part_groups}[part](mesh, out)
        done = True
    finally:
        shutdown_distributed(barrier=done)


if __name__ == "__main__":
    main(*sys.argv[1:])
