"""The port's gym vector adapters and SB3-style torch nets, on the CPU.

``RBC2DGymVectorEnv`` and ``RBC3DGymVectorEnv`` have the JAX adapters'
spaces and info keys, take and give numpy, pass their keyword arguments
to the port's vector env (``device``, ``fused``, ``poisson_precision``,
unknown names refused) and return what that functional env returns from
the same seed and actions. ``models.torch_nets`` with the JAX module's
weights loaded gives the JAX module's outputs.
"""

import numpy as np
import pytest
import torch

from rbc_gym_tpu.envs.vector2d import RBC2DGymVectorEnv as JRBC2DGymVectorEnv
from rbc_gym_tpu.envs.vector3d import RBC3DGymVectorEnv as JRBC3DGymVectorEnv
from rbc_gym_tpu.models import torch_nets as jnets
from rbc_gym_tpu_torch import envs
from rbc_gym_tpu_torch import models
from rbc_gym_tpu_torch.envs.gym_vector import RBC2DGymVectorEnv, RBC3DGymVectorEnv
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.models import torch_nets as nets

SMALL_2D = dict(state_shape=(16, 32), observation_shape=(8, 16), heater_duration=0.3,
                episode_length=0.6)
SMALL_3D = dict(state_shape=(8, 16, 16), heater_duration=0.0125, episode_length=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on a few
    cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_spaces(a, b):
    for name in ("single_observation_space", "single_action_space", "observation_space",
                 "action_space"):
        assert getattr(a, name) == getattr(b, name), name


def test_2d_adapter_spaces_are_the_jax_adapters():
    _same_spaces(RBC2DGymVectorEnv(3, **SMALL_2D, device="cpu"), JRBC2DGymVectorEnv(3, **SMALL_2D))
    _same_spaces(RBC2DGymVectorEnv(2, **SMALL_2D, pressure=True, device="cpu"),
                 JRBC2DGymVectorEnv(2, **SMALL_2D, pressure=True))


def test_3d_adapter_spaces_are_the_jax_adapters():
    _same_spaces(RBC3DGymVectorEnv(2, **SMALL_3D, device="cpu"),
                 JRBC3DGymVectorEnv(2, **SMALL_3D))


def test_2d_adapter_numpy_io_equals_its_functional_env():
    env = RBC2DGymVectorEnv(2, seed=5, **SMALL_2D, dtype=torch.float64, device="cpu")
    ref = RBC2DVectorEnv(2, **SMALL_2D, dtype=torch.float64, device="cpu")
    obs, info = env.reset()
    state, ref_obs = ref.reset(seed=5)
    assert info == {} and obs.dtype == np.float32 and obs.shape == (2, 3, 8, 16)
    np.testing.assert_array_equal(obs, ref_obs.numpy().astype(np.float32))
    rng = np.random.default_rng(0)
    for step in range(2):
        a = rng.uniform(-1, 1, (2, 12)).astype(np.float32)
        obs, reward, terminated, truncated, info = env.step(a)
        state, ts = ref.step(state, a)
        assert set(info) == {"t", "step", "nusselt_state", "nusselt_obs"}
        assert all(isinstance(v, np.ndarray) for v in (obs, reward, terminated, truncated))
        assert reward.dtype == np.float32 and truncated.dtype == bool
        np.testing.assert_array_equal(obs, ts.obs.numpy().astype(np.float32))
        np.testing.assert_array_equal(reward, ts.reward.numpy().astype(np.float32))
        np.testing.assert_array_equal(info["nusselt_obs"], ts.nusselt_obs.numpy())
        np.testing.assert_array_equal(info["step"], ts.step.numpy())
        assert truncated.tolist() == [step == 1] * 2 and not terminated.any()


def test_3d_adapter_numpy_io_equals_its_functional_env():
    env = RBC3DGymVectorEnv(2, **SMALL_3D, fused=False, dtype=torch.float64, device="cpu")
    assert env._env.solver.path == "plain"
    ref = RBC3DVectorEnv(2, **SMALL_3D, dtype=torch.float64, device="cpu")
    obs, _ = env.reset(seed=3)
    state, ref_obs = ref.reset(seed=3)
    np.testing.assert_array_equal(obs, ref_obs.numpy().astype(np.float32))
    a = np.random.default_rng(1).uniform(-1, 1, (2, 8, 8)).astype(np.float32)
    obs, reward, terminated, truncated, info = env.step(a)
    state, ts = ref.step(state, a)
    assert set(info) == {"t", "step", "nusselt"} and obs.shape == (2, 4, 8, 16, 16)
    np.testing.assert_array_equal(obs, ts.obs.numpy().astype(np.float32))
    np.testing.assert_array_equal(info["nusselt"], ts.nusselt.numpy())
    np.testing.assert_array_equal(reward, (-ts.nusselt).numpy().astype(np.float32))


def test_adapter_seeding():
    env = RBC2DGymVectorEnv(2, **SMALL_2D, device="cpu")
    a, _ = env.reset(seed=4)
    b, _ = env.reset()  # keeps the last seed
    c, _ = env.reset(seed=5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("cls, kwargs", [(RBC2DGymVectorEnv, SMALL_2D),
                                         (RBC3DGymVectorEnv, SMALL_3D)])
def test_adapters_refuse_poisson_precision_by_name(cls, kwargs):
    """The adapters pass ``poisson_precision`` through: "highest" and
    "default" are taken in 2D and 3D, 2D's "bf16x3" (K1's split-product
    instance) too; a name neither package knows is refused by name."""
    taken = ("highest", "default") + (("bf16x3",) if cls is RBC2DGymVectorEnv else ())
    for value in taken:
        assert cls(2, **kwargs, poisson_precision=value, device="cpu").num_envs == 2
    with pytest.raises(ValueError, match="poisson_precision"):
        cls(2, **kwargs, poisson_precision="exact", device="cpu")


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
def test_2d_adapter_at_bf16x3_and_default_equals_its_functional_env(precision):
    """The 2D adapter at each of the JAX env's other two names steps as the
    port's vector env at that name (which ``tests/test_torch_vector2d.py``
    holds against the JAX env), numpy in and out."""
    env = RBC2DGymVectorEnv(2, seed=7, **SMALL_2D, poisson_precision=precision,
                            dtype=torch.float64, device="cpu")
    ref = RBC2DVectorEnv(2, **SMALL_2D, poisson_precision=precision, dtype=torch.float64,
                         device="cpu")
    obs, _ = env.reset()
    state, ref_obs = ref.reset(seed=7)
    np.testing.assert_array_equal(obs, ref_obs.numpy().astype(np.float32))
    a = np.random.default_rng(3).uniform(-1, 1, (2, 12)).astype(np.float32)
    obs, reward, _, _, info = env.step(a)
    state, ts = ref.step(state, a)
    np.testing.assert_array_equal(obs, ts.obs.numpy().astype(np.float32))
    np.testing.assert_array_equal(reward, ts.reward.numpy().astype(np.float32))
    np.testing.assert_array_equal(info["nusselt_obs"], ts.nusselt_obs.numpy())


def test_env_layer_exports_the_jax_names():
    from rbc_gym_tpu import envs as jenvs

    assert envs.__all__ == jenvs.__all__
    assert envs.RBC2DGymVectorEnv is RBC2DGymVectorEnv and envs.RBC3DVectorEnv is RBC3DVectorEnv
    assert envs.EnvState3D.__name__ == "EnvState3D" and envs.TimeStep._fields[0] == "obs"
    with pytest.raises(AttributeError):
        envs.NoSuchEnv


def _load_jax_weights(port_module, jax_module):
    port_module.load_state_dict(jax_module.state_dict())
    return port_module.double().eval(), jax_module.double().eval()


def test_torch_nets_match_the_jax_module():
    torch.manual_seed(0)
    x = torch.randn(3, 4, 16, 32, 32, dtype=torch.float64)
    assert nets.HAS_SB3 is False and not hasattr(nets, "CustomActorCriticPolicy")
    port, ref = _load_jax_weights(nets.FluidCNN(), jnets.FluidCNN())
    with torch.no_grad():
        feats = port(x)
        np.testing.assert_allclose(feats.numpy(), ref(x).numpy(), rtol=0, atol=1e-12)
    assert feats.shape == (3, port.features_dim)
    port, ref = _load_jax_weights(nets.ActorCriticTorso(), jnets.ActorCriticTorso())
    with torch.no_grad():
        for got, want in zip(port(feats), ref(feats)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    assert port.forward_actor(feats).shape == (3, port.latent_dim_pi)
    pad = nets.PeriodicPad3D(1, 2, 1)
    np.testing.assert_array_equal(pad(x).numpy(), jnets.PeriodicPad3D(1, 2, 1)(x).numpy())
    assert models.FluidCNN is nets.FluidCNN and models.PeriodicPad3D is nets.PeriodicPad3D
    with pytest.raises(AttributeError):
        models.CustomActorCriticPolicy
