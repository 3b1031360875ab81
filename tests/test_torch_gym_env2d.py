"""The port's 2D gym env against the JAX package's, on the CPU.

The port's ``RayleighBenardConvection2DEnv`` (``device="cpu"``) passes
gymnasium's checker and keeps the JAX env's reset/step contract; from a
bank file both packages read, the same seed picks the same bank episode
and three steps of the same actions agree in float64 to 1e-10; renders
match the JAX env's pixels. The gym-free core and the package import with
gymnasium blocked, as on the card.
"""

import subprocess
import sys
import textwrap
import types
import warnings
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest
import torch
from gymnasium.utils.env_checker import check_env

import rbc_gym_tpu  # noqa: F401  (registers the JAX gym IDs)
import rbc_gym_tpu_torch
from rbc_gym_tpu.utils import checkpoints as jckpt
from rbc_gym_tpu_torch.envs.rbc2d import RayleighBenardConvection2DEnv
from rbc_gym_tpu_torch.envs.single2d import RBC2DEnvCore, RBCField
from rbc_gym_tpu_torch.sim.grid import Grid2D
from rbc_gym_tpu_torch.sim.solver2d import SimParams2D, make_solver2d

REPO = Path(__file__).resolve().parent.parent
JAX_ID = "rbc_gym/RayleighBenardConvection2D-v0"
PORT_ID = rbc_gym_tpu_torch.ENV_ID_2D
SMALL = dict(
    state_shape=(16, 32),
    observation_shape=(8, 16),
    heater_duration=0.3,
    episode_length=3.0,
)
BANK_EPISODES = 5
ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on a few
    cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """A 5-episode bank at the small grid, written by the JAX package's
    writer and read by both packages: random ICs of the port's solver
    after two plain float64 env steps (so each holds a moving flow)."""
    nz, nx = SMALL["state_shape"]
    solver = make_solver2d(Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0),
                           SimParams2D(heater_duration=0.3), dtype=torch.float64,
                           device="cpu")
    f = solver.init_random(torch.Generator().manual_seed(5), (BANK_EPISODES,))
    for _ in range(2):
        f = solver.env_step(f, torch.zeros(BANK_EPISODES, 12, dtype=torch.float64))
    path = tmp_path_factory.mktemp("bank2d") / "ckpt_small.h5"
    jckpt.save_bank_2d(str(path), jckpt.CheckpointBank2D(
        b=f.b.numpy(), u=f.u.numpy(), w=f.w.numpy(), start_seed=5))
    return str(path)


@pytest.fixture(scope="module")
def jax_env(bank):
    e = gym.make(JAX_ID, **SMALL, checkpoint=bank, dtype="float64")
    yield e.unwrapped
    e.close()


@pytest.fixture(scope="module")
def port_env(bank):
    e = gym.make(PORT_ID, **SMALL, checkpoint=bank, dtype="float64", device="cpu")
    yield e.unwrapped
    e.close()


@pytest.fixture(scope="module")
def env():
    e = gym.make(PORT_ID, **SMALL, device="cpu")
    yield e
    e.close()


def test_registration_defaults_are_the_jax_ids_plus_device():
    spec, jax_spec = gym.spec(PORT_ID), gym.spec(JAX_ID)
    assert spec.kwargs == {**jax_spec.kwargs, "device": "cuda"}
    assert spec.kwargs["use_gpu"] is False and spec.kwargs["state_shape"] == (64, 96)
    assert spec.entry_point == "rbc_gym_tpu_torch.envs:RayleighBenardConvection2DEnv"
    assert gym.spec(rbc_gym_tpu_torch.ENV_ID_3D).kwargs == {
        **gym.spec("rbc_gym/RayleighBenardConvection3D-v0").kwargs, "device": "cuda"}


def test_check_env():
    e = gym.make(PORT_ID, **SMALL, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(e.unwrapped, skip_render_check=True)
    e.close()


@pytest.mark.parametrize("env_id", [PORT_ID, rbc_gym_tpu_torch.ENV_ID_3D])
def test_default_device_refuses_without_cuda(env_id, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gym.make(env_id)


def test_reset_step_contract(env):
    obs, info = env.reset(seed=123)
    assert obs.shape == (3, 8, 16) and obs.dtype == np.float32
    assert info["t"] == 0.0 and info["step"] == 1
    assert info["state"].shape == (3, 16, 32)
    assert set(info) == {"t", "step", "nusselt_state", "nusselt_obs", "state"}

    obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
    assert not terminated and not truncated
    assert info["t"] == pytest.approx(0.3) and info["step"] == 2
    assert reward == -info["nusselt_obs"] and np.isfinite(reward) and np.isfinite(obs).all()


def test_truncation_at_episode_length(env):
    env.reset(seed=0)
    flags = [env.step(np.zeros(12, np.float32))[3] for _ in range(10)]
    assert flags == [False] * 9 + [True]  # 3.0 / 0.3 = 10 steps


def test_seed_reproducibility(env):
    a, _ = env.reset(seed=7)
    b, _ = env.reset(seed=7)
    c, _ = env.reset(seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert env.unwrapped.np_random_seed == 8


def test_pressure_channels():
    e = RayleighBenardConvection2DEnv(**SMALL, pressure=True, device="cpu")
    obs, info = e.reset(seed=0)
    assert obs.shape == (5, 8, 16) and info["state"].shape == (5, 16, 32)
    assert e.observation_space.shape == (5, 8, 16)
    assert e.observation_space.low[0].min() == 1.0 and e.observation_space.high[3].max() == np.inf


def test_missing_checkpoint_raises(tmp_path):
    e = RayleighBenardConvection2DEnv(**SMALL, checkpoint=str(tmp_path / "nope.h5"),
                                      device="cpu")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        e.reset(seed=0)


def test_nan_raises_runtime_error_and_use_gpu_is_ignored():
    e = RayleighBenardConvection2DEnv(**SMALL, use_gpu=True, device="cpu")
    assert e.device.type == "cpu"
    e.reset(seed=0)
    b = e._fields.b.clone()
    b[3, 4] = float("nan")
    e._fields = e._fields._replace(b=b)
    with pytest.raises(RuntimeError, match="NaN"):
        e.step(np.zeros(12, np.float32))


def test_none_action_warns_and_acts_as_zero(env):
    env.reset(seed=3)
    with pytest.warns(UserWarning, match="zero action"):
        none_obs = env.step(None)[0]
    env.reset(seed=3)
    np.testing.assert_array_equal(none_obs, env.step(np.zeros(12, np.float32))[0])


@pytest.mark.parametrize("seed", [0, 1, 2, 11])
def test_same_seed_draws_the_same_bank_episode(jax_env, port_env, seed):
    _, jinfo = jax_env.reset(seed=seed)
    _, info = port_env.reset(seed=seed)
    np.testing.assert_array_equal(info["state"], jinfo["state"])
    idx = int(np.random.default_rng(seed).integers(BANK_EPISODES))
    bank = jckpt.load_bank_2d(port_env.checkpoint)
    np.testing.assert_array_equal(info["state"][RBCField.T], bank.b[idx].T.astype(np.float32))


def test_three_steps_match_jax_in_float64(jax_env, port_env):
    rng = np.random.default_rng(4)
    jax_env.reset(seed=4)
    port_env.reset(seed=4)
    for _ in range(3):
        a = rng.uniform(-1, 1, 12).astype(np.float32)
        jobs, jrew, _, jtrunc, jinfo = jax_env.step(a)
        obs, rew, _, trunc, info = port_env.step(a)
        np.testing.assert_allclose(obs, jobs, rtol=0, atol=ATOL)
        np.testing.assert_allclose(info["state"], jinfo["state"], rtol=0, atol=ATOL)
        for k in ("nusselt_state", "nusselt_obs", "t"):
            assert abs(info[k] - jinfo[k]) <= ATOL, k
        assert abs(rew - jrew) <= ATOL and trunc == jtrunc and info["step"] == jinfo["step"]
    np.testing.assert_allclose(port_env._fields.b.numpy(), np.asarray(jax_env._fields.b),
                               rtol=0, atol=ATOL)


def test_rgb_render_matches_jax(jax_env, port_env, monkeypatch):
    jax_env.reset(seed=1)
    port_env.reset(seed=1)
    monkeypatch.setattr(jax_env, "render_mode", "rgb_array")
    monkeypatch.setattr(port_env, "render_mode", "rgb_array")
    want, got = jax_env.render(), port_env.render()
    assert got.shape == want.shape == (16, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_render_without_mode_warns(env):
    env.reset(seed=0)
    with pytest.warns(UserWarning, match="render_mode"):
        assert env.unwrapped.render() is None


def _fake_pygame(calls):
    def record(name, ret=None):
        return lambda *a, **k: (calls.append(name), ret)[1]

    class Surface:
        def blit(self, *a):
            calls.append("blit")

    mod = types.ModuleType("pygame")
    mod.init = record("init")
    mod.quit = record("quit")
    mod.display = types.SimpleNamespace(
        init=record("display.init"), set_mode=record("set_mode", Surface()),
        set_caption=record("set_caption"), flip=record("flip"), quit=record("display.quit"))
    mod.time = types.SimpleNamespace(Clock=lambda: types.SimpleNamespace(tick=record("tick")))
    mod.surfarray = types.SimpleNamespace(
        make_surface=lambda arr: (calls.append(("surface", arr.shape)), arr)[1])
    mod.transform = types.SimpleNamespace(scale=lambda c, size: c)
    mod.event = types.SimpleNamespace(pump=record("pump"))
    return mod


def test_human_render_through_a_fake_pygame(monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "pygame", _fake_pygame(calls))
    e = RayleighBenardConvection2DEnv(**SMALL, render_mode="human", device="cpu")
    e.reset(seed=0)
    assert e.render() is None and e.render() is None
    assert calls.count("set_mode") == 1 and calls.count("flip") == 2
    assert ("surface", (32, 16, 3)) in calls  # (w, h, 3), as surfarray expects
    e.close()
    e.close()
    assert calls.count("quit") == 1 and calls[-2:] == ["display.quit", "quit"]


def test_gym_free_core_runs_without_gymnasium_types():
    core = RBC2DEnvCore(**SMALL, device="cpu")
    assert not isinstance(core, gym.Env)
    obs, info = core.reset(seed=0)
    obs2, reward, terminated, truncated, info2 = core.step(np.zeros(12, np.float32))
    assert obs2.shape == (3, 8, 16) and reward == -info2["nusselt_obs"] and info2["step"] == 2
    e = RayleighBenardConvection2DEnv(**SMALL, device="cpu")
    np.testing.assert_array_equal(e.reset(seed=0)[0], obs)  # the same seed, the same IC


def test_port_imports_without_gymnasium():
    """The card's condition: no gymnasium. The package, the env layer, both
    gym-free cores and the ablation script import, and nothing loads
    gymnasium; the gym classes then refuse by ImportError."""
    code = textwrap.dedent("""
        import sys
        sys.modules["gymnasium"] = None
        import rbc_gym_tpu_torch
        import rbc_gym_tpu_torch.envs as envs
        import rbc_gym_tpu_torch.envs.single2d, rbc_gym_tpu_torch.envs.single3d
        import rbc_gym_tpu_torch.scripts.ablate_actuation3d
        import rbc_gym_tpu_torch.wrappers, rbc_gym_tpu_torch.models
        assert [m for m in sys.modules if m.startswith("gymnasium.")] == []
        assert envs.RBCField.UY == 2 and envs.RBC3DField.W == 3
        try:
            envs.RayleighBenardConvection2DEnv
        except ImportError:
            print("refused")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "refused"
