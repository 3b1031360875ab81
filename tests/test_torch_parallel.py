"""The port's env-axis split (``rbc_gym_tpu_torch.parallel``) in one process.

The layout's (dp, env) factoring against the JAX package's
``make_env_mesh`` on the conftest's 8 virtual devices, the rows of each
rank, the refusals by name (a fleet that does not divide over the ranks,
two NCCL ranks on one device), and the shard envs: a shard's reset is the
rows of the whole fleet's reset, bit for bit, except for ``ic_noise``,
whose kick a shard draws for itself (an intended difference from the JAX
package, ROADMAP C). The multi-rank runs are in
``test_torch_parallel_{env,ppo,launch}.py``.
"""

import os
import sys

import jax
import pytest
import torch

from rbc_gym_tpu.parallel import make_env_mesh as jax_make_env_mesh
from rbc_gym_tpu_torch.envs.autoreset import seed_keys
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D
from rbc_gym_tpu_torch.parallel import (
    host_local_slice,
    initialize_distributed,
    make_env_mesh,
    make_host_env_mesh,
    replicate,
    shard_batch,
    shard_ppo_trainer,
    shard_vector_env,
)
from rbc_gym_tpu_torch.parallel.distributed import rank_device_index
from rbc_gym_tpu_torch.parallel.launch import run_ranks
from rbc_gym_tpu_torch.parallel.mesh import EnvMesh, env_rows, mesh_shape
from rbc_gym_tpu_torch.rl import PPO, PPOConfig, restore_training_state, save_training_state
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ENV_2D = dict(state_shape=(16, 32), observation_shape=(8, 16), heater_duration=0.3,
              dtype=torch.float64, device="cpu")
BANK_2D = "rbc_gym_tpu_torch/assets/ckpt_ra10000_train.npz"
DIST_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
             "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID")


def _fake_mesh(size: int, rank: int) -> EnvMesh:
    """A layout of ``size`` ranks seen from ``rank``, with no process
    group: enough for what needs no collective."""
    return EnvMesh({"dp": 1, "env": size}, rank, torch.device("cpu"))


@pytest.mark.parametrize("n,dp", [(1, None), (2, None), (4, None), (8, None), (8, 4), (8, 1),
                                  (6, 3)])
def test_mesh_factoring_matches_jax(n, dp):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    want = jax_make_env_mesh(n, dp=dp).shape
    assert dict(zip(("dp", "env"), mesh_shape(n, dp))) == dict(want)


def test_single_process_layouts(monkeypatch):
    for name in DIST_VARS:
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(device="cpu") is False  # safe to call twice
    mesh = make_env_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "env": 1} and mesh.size == 1 and mesh.rank == 0
    assert mesh.shape == dict(jax_make_env_mesh(1).shape)
    host = make_host_env_mesh(device="cpu")
    assert host.axis_names == ("host", "env") and host.shape == {"host": 1, "env": 1}
    assert host_local_slice(16) == slice(0, 16)
    with pytest.raises(ValueError, match="spans exactly the ranks"):
        make_env_mesh(2, device="cpu")
    # every collective is the identity in one process
    t = torch.arange(3.0)
    assert mesh.all_reduce_(t) is t and torch.equal(t, torch.arange(3.0))
    assert torch.equal(mesh.gather_rows(t), t)
    assert replicate({"a": t}, mesh)["a"] is t


def test_rows_of_each_rank():
    assert [env_rows(16, 4, r) for r in range(4)] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert env_rows(1024, 2, 1) == (512, 1024)
    batch = {"x": torch.arange(8), "pair": (torch.arange(8) * 2,)}
    got = shard_batch(batch, _fake_mesh(4, 2))
    assert torch.equal(got["x"], torch.tensor([4, 5])) and torch.equal(
        got["pair"][0], torch.tensor([8, 10]))


def test_indivisible_fleet_refused_by_name():
    with pytest.raises(ValueError, match="num_envs=10 does not divide over 4 ranks"):
        env_rows(10, 4, 0)
    with pytest.raises(ValueError, match="num_envs=10 does not divide over 4 ranks"):
        shard_vector_env(RBC2DVectorEnv, 10, _fake_mesh(4, 1), **ENV_2D)
    with pytest.raises(ValueError, match="do not lie in a fleet"):
        RBC2DVectorEnv(4, env_slice=(14, 16), **ENV_2D)


def test_two_nccl_ranks_on_one_device_refused():
    """The rule, not the backend: NCCL takes one rank a device, gloo lets
    ranks share one."""
    with pytest.raises(ValueError, match="one rank per card.*backend='gloo'"):
        rank_device_index("nccl", 1, 2, 1)
    assert rank_device_index("gloo", 1, 2, 1) == 0
    assert [rank_device_index("nccl", r, 2, 2) for r in range(2)] == [0, 1]
    assert [rank_device_index("gloo", r, 4, 2) for r in range(4)] == [0, 1, 0, 1]


@pytest.mark.parametrize("ic", ["random", "bank_random", "bank_sequential"])
def test_shard_reset_is_the_fleet_rows(ic):
    """A shard's keys are the slice of ``seed_keys(seed, fleet)``, and its
    reset (random IC, random bank index, sequential bank index) the rows
    of the whole fleet's, bit for bit; so is a step through an autoreset."""
    kw = dict(ENV_2D, episode_length=0.9)  # 3 steps
    if ic != "random":
        kw.update(state_shape=(64, 96), observation_shape=(8, 48), checkpoint=BANK_2D,
                  bank_sampling=ic.split("_")[1], auto_reset=False)
    full = RBC2DVectorEnv(8, **kw)
    shard = shard_vector_env(RBC2DVectorEnv, 8, _fake_mesh(2, 1), **kw)
    assert (shard.num_envs, shard.env_offset, shard.fleet_size) == (4, 4, 8)
    s_full, o_full = full.reset(seed=5)
    s_part, o_part = shard.reset(seed=5)
    assert torch.equal(s_part.key, seed_keys(5, 8)[4:]) and torch.equal(s_part.key,
                                                                        s_full.key[4:])
    assert torch.equal(o_part, o_full[4:])
    for a, b in zip(s_full.fields, s_part.fields):
        assert torch.equal(a[4:], b)
    if ic == "random":  # one step through an autoreset of every env
        step3 = torch.full((8,), 3, dtype=torch.int32)
        s_full, s_part = s_full._replace(step=step3), s_part._replace(step=step3[4:])
        s_full, ts_full = full.step(s_full, torch.zeros(8, 12))
        s_part, ts_part = shard.step(s_part, torch.zeros(4, 12))
        assert bool(ts_full.truncated.all())
        assert torch.equal(ts_part.obs, ts_full.obs[4:])
        assert torch.equal(s_part.key, s_full.key[4:])


def test_ic_noise_is_drawn_per_shard():
    """Intended difference (ROADMAP C): with ``ic_noise`` > 0 a shard draws
    its kick from a generator seeded by its own envs' keys
    (``autoreset.batch_generator``), so its reset differs from the rows of
    the one-process fleet's; the bank states under the kick are the same,
    and so is the kick's size."""
    kw = dict(ENV_2D, state_shape=(64, 96), observation_shape=(8, 48), checkpoint=BANK_2D,
              bank_sampling="sequential", auto_reset=False, ic_noise=1e-3)
    s_full, _ = RBC2DVectorEnv(8, **kw).reset(seed=0)
    s_part, _ = shard_vector_env(RBC2DVectorEnv, 8, _fake_mesh(2, 1), **kw).reset(seed=0)
    clean, _ = RBC2DVectorEnv(8, **{**kw, "ic_noise": 0.0}).reset(seed=0)
    kick_full = s_full.fields.u[4:] - clean.fields.u[4:]
    kick_part = s_part.fields.u - clean.fields.u[4:]
    assert not torch.equal(kick_part, kick_full)
    assert float(kick_part.std()) == pytest.approx(1e-3, rel=0.05)
    assert float(kick_full.std()) == pytest.approx(1e-3, rel=0.05)


def test_shard_envs_carry_their_slice_in_3d():
    kw = dict(state_shape=(8, 8, 8), dtype=torch.float64, device="cpu")
    full = RBC3DVectorEnv(4, **kw)
    shard = shard_vector_env(RBC3DVectorEnv, 4, _fake_mesh(2, 1), **kw)
    s_full, o_full = full.reset(seed=2)
    s_part, o_part = shard.reset(seed=2)
    assert torch.equal(o_part, o_full[2:]) and torch.equal(s_part.key, s_full.key[2:])


def test_shard_ppo_trainer_refuses_an_unsharded_env():
    env = RBC2DVectorEnv(4, **ENV_2D)
    trainer = PPO(env, RBCActorCritic2D(obs_shape=(8, 16)), PPOConfig(n_steps=2), device="cpu")
    with pytest.raises(ValueError, match="shard_vector_env"):
        shard_ppo_trainer(trainer, _fake_mesh(2, 0))
    assert trainer.mesh is None


def test_one_process_checkpoint_restores_into_a_shard(tmp_path):
    """A restore takes this rank's rows of the saved fleet: rank 1 of 2
    gets rows 2:4 of a 4-env one-process checkpoint; a fleet of another
    size is refused by name."""

    def trainer(env):
        return PPO(env, RBCActorCritic2D(obs_shape=(8, 16)), PPOConfig(n_steps=2), seed=0,
                   device="cpu")

    one = trainer(RBC2DVectorEnv(4, **ENV_2D))
    one.env_state = one.env_state._replace(t=torch.arange(4.0, dtype=torch.float64))
    path = str(tmp_path / "full.npz")
    save_training_state(path, one, iteration=3)
    shard = trainer(shard_vector_env(RBC2DVectorEnv, 4, _fake_mesh(2, 1), **ENV_2D))
    assert restore_training_state(path, shard) == 4
    assert torch.equal(shard.env_state.t, torch.tensor([2.0, 3.0], dtype=torch.float64))
    assert torch.equal(shard.last_obs, one.last_obs[2:])
    for a, b in zip(one.env_state.fields, shard.env_state.fields):
        assert torch.equal(a[2:], b)
    other = trainer(shard_vector_env(RBC2DVectorEnv, 8, _fake_mesh(2, 1), **ENV_2D))
    with pytest.raises(ValueError, match="holds 4 envs, the live trainer's fleet 8"):
        restore_training_state(path, other)


def test_callbacks_write_nothing_off_rank_0(tmp_path):
    from rbc_gym_tpu_torch.rl import MetricsLogger

    rank1 = type("T", (), {"mesh": _fake_mesh(2, 1)})()
    path = tmp_path / "metrics.jsonl"
    MetricsLogger(str(path), echo_every=0)({"iteration": 0, "global_step": 4}, rank1)
    assert not os.path.exists(path)
    MetricsLogger(str(path), echo_every=0)({"iteration": 0, "global_step": 4}, None)
    assert path.read_text().count("\n") == 1


RESERVED_PORT_CHECK = """
import datetime, errno, os, socket
from torch.distributed import TCPStore
port = int(os.environ["MASTER_PORT"])
with socket.socket() as s:  # a plain bind, as another process on the host would make
    try:
        s.bind(("localhost", port))
        raise SystemExit("the ranks' port was free to take")
    except OSError as e:
        assert e.errno == errno.EADDRINUSE, e
for _ in range(200):  # the ports the host hands out are never it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        assert s.getsockname()[1] != port
assert os.environ["TORCHELASTIC_USE_AGENT_STORE"] == "True"
# every rank is a client of the launcher's store on that port
store = TCPStore("localhost", port, is_master=False, timeout=datetime.timedelta(seconds=60))
store.set(f"rank{os.environ['RANK']}", "here")
store.wait(["rank0", "rank1"])
"""


def test_run_ranks_holds_the_ranks_port_while_they_run():
    """The port ``run_ranks`` gives its ranks is its own store's
    (``parallel.launch.rendezvous_store``), listening before they start:
    another process can neither bind it nor be handed it while they run,
    and each rank joins the store as a client, as under torchrun's agent."""
    # (c10d warns where the host's name cannot be looked up: not this test's concern)
    outputs = run_ranks([sys.executable, "-c", RESERVED_PORT_CHECK], 2, timeout=120,
                        env={"TORCH_CPP_LOG_LEVEL": "ERROR"})
    assert outputs == ["", ""]


REUSING_LISTENER_CHECK = """
import errno, os, socket
port = int(os.environ["MASTER_PORT"])
with socket.socket() as s:  # another job's TCPStore: SO_REUSEADDR, then listen
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("localhost", port))
        s.listen()
        raise SystemExit("another process's store could listen on the ranks' port")
    except OSError as e:
        assert e.errno == errno.EADDRINUSE, e
"""


def test_run_ranks_port_cannot_be_taken_by_another_store():
    """No other process can listen on the ranks' port while they run, not
    even one binding with SO_REUSEADDR as a ``TCPStore`` or torchrun's
    agent does. A port held by a socket that is bound but not listening
    (the launcher before this test) lets such a process bind and listen on
    it: then rank 0's store fails to listen (EADDRINUSE), or a rank joins
    the other job's store; the fixture of ``test_torch_parallel_env.py``
    failed under six test workers, one of them running torchrun."""
    outputs = run_ranks([sys.executable, "-c", REUSING_LISTENER_CHECK], 2, timeout=120)
    assert outputs == ["", ""]
