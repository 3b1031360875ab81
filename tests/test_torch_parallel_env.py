"""Two gloo ranks on the CPU step the port's sharded vector envs
(``tests/torch_parallel_worker.py``, part ``env``), in float64 at the JAX
sharding test's size (16 envs at 16x32, heater_duration 0.3, 3 steps):

* the 2D shard fleet from ``reset(seed=0)``, through an autoreset at step
  2, equals one process's fleet bit for bit: fields, obs, rewards, keys;
* one step of it from shared fields (made by numpy from a seed) equals the
  JAX package's ``shard_vector_env`` on the conftest's 8-device mesh at
  ``tests/test_torch_vector2d.py``'s tolerance;
* the 3D shard fleet (4 envs at 8x8x8, 2 steps) equals one process's bit
  for bit.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.envs.vector2d import EnvState2D as JEnvState2D
from rbc_gym_tpu.envs.vector2d import RBC2DVectorEnv as JRBC2DVectorEnv
from rbc_gym_tpu.parallel import make_env_mesh as jax_make_env_mesh
from rbc_gym_tpu.parallel import shard_vector_env as jax_shard_vector_env
from rbc_gym_tpu.sim import solver2d as jsolver
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.parallel.launch import run_ranks

import torch_parallel_worker as worker
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ATOL = 1e-10  # tests/test_torch_vector2d.py: the float64 env step
N = worker.N_ENVS_2D


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The worker's outputs, after writing the shared fields it steps from."""
    out = tmp_path_factory.mktemp("env")
    rng = np.random.default_rng(7)
    nz, nx = worker.ENV_2D["state_shape"]
    u = 0.05 * rng.standard_normal((N, nx, nz))
    w = 0.05 * rng.standard_normal((N, nx, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + 0.05 * rng.standard_normal((N, nx, nz)), 1.0, 2.0)
    p_hy = np.asarray(jsolver._hydrostatic_pressure(jnp.asarray(b), 2.0 / nz, 1.0))
    np.savez(out / "shared.npz", u=u, w=w, b=b, p_hy=p_hy, p_nhs=np.zeros_like(u),
             t=np.zeros(N), step=np.ones(N, np.int32), actions=rng.uniform(-1, 1, (N, 12)))
    run_ranks([sys.executable, worker.__file__, str(out), "env"], 2, timeout=300,
              env={"OMP_NUM_THREADS": "1"})
    return out


def test_sharded_2d_steps_equal_one_process_bit_for_bit(ranks):
    z = np.load(ranks / "env2d_seed.npz")
    env = RBC2DVectorEnv(N, **worker.ENV_2D, dtype=torch.float64, device="cpu")
    state, obs = env.reset(seed=0)
    assert np.array_equal(z["reset_obs"], obs.numpy())
    for i in range(3):
        state, ts = env.step(state, worker.actions_2d(i))
        for name, want in state.fields._asdict().items():
            assert np.array_equal(z[f"step{i}/fields/{name}"], want.numpy()), (i, name)
        for name in ("obs", "final_obs", "reward", "truncated"):
            assert np.array_equal(z[f"step{i}/{name}"], getattr(ts, name).numpy()), (i, name)
        assert np.array_equal(z[f"step{i}/key"], state.key.numpy()), i
    assert z["step1/truncated"].all() and not z["step0/truncated"].any()  # the autoreset


def test_sharded_2d_step_matches_jax_shard_vector_env(ranks):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    shared = dict(np.load(ranks / "shared.npz"))
    jenv = jax_shard_vector_env(JRBC2DVectorEnv(N, **worker.ENV_2D, dtype=jnp.float64),
                                jax_make_env_mesh(8))
    f = jsolver.Fields2D(*(jnp.asarray(shared[k]) for k in ("u", "w", "b", "p_hy", "p_nhs")))
    jstate = JEnvState2D(fields=f, t=jnp.asarray(shared["t"]), step=jnp.asarray(shared["step"]),
                         key=jax.random.split(jax.random.PRNGKey(1), N))
    jnext, jts = jenv.step(jstate, jnp.asarray(shared["actions"]))
    assert len(jnext.fields.b.sharding.device_set) == 8
    z = np.load(ranks / "env2d_shared.npz")
    for name in ("obs", "final_obs", "reward"):
        np.testing.assert_allclose(z[name], np.asarray(getattr(jts, name)), rtol=0, atol=ATOL,
                                   err_msg=name)
    assert not z["truncated"].any() and not np.asarray(jts.truncated).any()
    for name in ("u", "w", "b", "p_hy", "p_nhs"):
        np.testing.assert_allclose(z[f"fields/{name}"], np.asarray(getattr(jnext.fields, name)),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_sharded_3d_steps_equal_one_process_bit_for_bit(ranks):
    z = np.load(ranks / "env3d.npz")
    env = RBC3DVectorEnv(worker.N_ENVS_3D, **worker.ENV_3D, dtype=torch.float64, device="cpu")
    state, _ = env.reset(seed=0)
    rng = np.random.default_rng(0)
    for i in range(2):
        actions = torch.as_tensor(rng.uniform(-1, 1, (worker.N_ENVS_3D, 8, 8)))
        state, ts = env.step(state, actions)
        assert np.array_equal(z[f"step{i}/reward"], ts.reward.numpy())
        assert np.array_equal(z[f"step{i}/obs"], ts.obs.numpy())
    for name, want in state.fields._asdict().items():
        assert np.array_equal(z[f"fields/{name}"], want.numpy()), name
