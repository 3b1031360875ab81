"""The port's 3D gym env and actuation ablation against the JAX package's,
on the CPU.

The port's ``RayleighBenardConvection3DEnv`` (``device="cpu"``) passes
gymnasium's checker and keeps the JAX env's contract (free-fall time,
truncation, info, the per-env log file); from a bank both packages read,
the same seed or ``checkpoint_idx`` gives the same state and three steps
agree in float64 to 1e-10; the rgb montage matches the JAX env's pixels
and the PyVista branch runs through a fake module. The ablation twin's
checkerboard rollouts match the JAX script's (run here, its env swapped
for a float64 one on a small grid) from a one-state bank.
"""

import importlib.util
import json
import sys
import types
import warnings
from functools import partial
from pathlib import Path

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from gymnasium.utils.env_checker import check_env

import rbc_gym_tpu  # noqa: F401  (registers the JAX gym IDs)
import rbc_gym_tpu_torch
from rbc_gym_tpu.envs import vector3d as jvector3d
from rbc_gym_tpu.utils import checkpoints as jckpt
from rbc_gym_tpu_torch.envs.rbc3d import RayleighBenardConvection3DEnv
from rbc_gym_tpu_torch.envs.single3d import RBC3DEnvCore
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.scripts import ablate_actuation3d as ab
from rbc_gym_tpu_torch.sim.grid import Grid3D
from rbc_gym_tpu_torch.sim.solver3d import SimParams3D, make_solver3d

REPO = Path(__file__).resolve().parent.parent
JAX_ID = "rbc_gym/RayleighBenardConvection3D-v0"
PORT_ID = rbc_gym_tpu_torch.ENV_ID_3D
SHAPE = (8, 16, 16)
SMALL = dict(state_shape=SHAPE, heater_duration=0.125, episode_length=3)
# the float64 parity and ablation runs: 2 substeps a step
FAST = dict(state_shape=SHAPE, heater_duration=0.0125, episode_length=3)
BANK_EPISODES = 4
ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on a few
    cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_bank(path, episodes, seed):
    """``episodes`` random ICs of the port's float64 solver at the small grid
    after one plain env step, written by the JAX package's writer."""
    nz, ny, nx = SHAPE
    grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    solver = make_solver3d(grid, SimParams3D(heater_duration=0.0125), dtype=torch.float64,
                           device="cpu")
    f = solver.init_random(torch.Generator().manual_seed(seed), (episodes,))
    f = solver.env_step(f, torch.zeros(episodes, 8, 8, dtype=torch.float64))
    jckpt.save_bank_3d(str(path), jckpt.CheckpointBank3D(
        b=f.b.numpy(), u=f.u.numpy(), v=f.v.numpy(), w=f.w.numpy(), start_seed=seed))
    return str(path)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    return _write_bank(tmp_path_factory.mktemp("bank3d") / "3D_ckpt_small.h5",
                       BANK_EPISODES, 9)


@pytest.fixture(scope="module")
def jax_env(bank):
    e = gym.make(JAX_ID, **FAST, checkpoint=bank, dtype="float64")
    yield e.unwrapped
    e.close()


@pytest.fixture(scope="module")
def port_env(bank):
    e = gym.make(PORT_ID, **FAST, checkpoint=bank, dtype="float64", device="cpu")
    yield e.unwrapped
    e.close()


def test_check_env_3d():
    e = gym.make(PORT_ID, **SMALL, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(e.unwrapped, skip_render_check=True)
    e.close()


def test_reset_step_contract_3d():
    e = gym.make(PORT_ID, **SMALL, device="cpu").unwrapped
    obs, info = e.reset(seed=0)
    assert obs.shape == (4, *SHAPE) and obs.dtype == np.float32
    assert info == {"t": 0.0, "step": 1, "nusselt": info["nusselt"]}
    assert e.action_space.shape == (8, 8) and e.observation_space.shape == (4, *SHAPE)
    obs, reward, terminated, truncated, info = e.step(e.action_space.sample())
    assert info["t"] == pytest.approx(0.125 * e._params.t_ff) and info["step"] == 2
    assert reward == -info["nusselt"] and np.isfinite(obs).all()
    assert not terminated and not truncated


def test_truncation_3d():
    e = RayleighBenardConvection3DEnv(**SMALL, device="cpu")
    assert e.episode_steps == int(round(3 / (0.125 * e._params.t_ff))) == 6
    e.reset(seed=0)
    flags = [e.step(np.zeros((8, 8), np.float32))[3] for _ in range(6)]
    assert flags == [False] * 5 + [True]


def test_seed_reproducibility_and_use_gpu_ignored_3d():
    e = RayleighBenardConvection3DEnv(**FAST, use_gpu=True, device="cpu")
    assert e.device.type == "cpu"
    a, _ = e.reset(seed=5)
    b, _ = e.reset(seed=5)
    c, _ = e.reset(seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_missing_checkpoint_and_nan_3d(tmp_path, caplog):
    e = RayleighBenardConvection3DEnv(**FAST, checkpoint=str(tmp_path / "x.h5"), device="cpu")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        e.reset(seed=0)
    e = RayleighBenardConvection3DEnv(**FAST, device="cpu")
    e.reset(seed=0)
    b = e._fields.b.clone()
    b[1, 2, 3] = float("nan")
    e._fields = e._fields._replace(b=b)
    with pytest.raises(RuntimeError, match="NaN"):
        e.step(np.zeros((8, 8), np.float32))
    assert "Error during step" in caplog.text


def test_per_env_log_file(tmp_path):
    core = RBC3DEnvCore(**FAST, log_dir=str(tmp_path), env_id=3, device="cpu")
    core.reset(seed=0)
    for h in core.logger.handlers:
        h.flush()
    text = (tmp_path / "env_3.log").read_text()
    assert "Using Rayleigh number Ra=2500" in text and "env_3" in text
    for h in list(core.logger.handlers):
        core.logger.removeHandler(h)
        h.close()


@pytest.mark.parametrize("seed", [0, 3])
def test_same_seed_and_checkpoint_idx_give_the_jax_state(jax_env, port_env, seed, monkeypatch):
    np.testing.assert_array_equal(port_env.reset(seed=seed)[0], jax_env.reset(seed=seed)[0])
    monkeypatch.setattr(jax_env, "checkpoint_idx", 2)
    monkeypatch.setattr(port_env, "checkpoint_idx", 2)
    obs, _ = port_env.reset(seed=seed)
    np.testing.assert_array_equal(obs, jax_env.reset(seed=seed)[0])
    bank = jckpt.load_bank_3d(port_env.checkpoint)
    np.testing.assert_array_equal(obs[0], bank.b[2].transpose(2, 1, 0).astype(np.float32))


def test_three_steps_match_jax_in_float64_3d(jax_env, port_env, monkeypatch):
    monkeypatch.setattr(jax_env, "checkpoint_idx", 1)
    monkeypatch.setattr(port_env, "checkpoint_idx", 1)
    jax_env.reset(seed=0)
    port_env.reset(seed=0)
    rng = np.random.default_rng(8)
    for _ in range(3):
        a = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
        jobs, jrew, _, jtrunc, jinfo = jax_env.step(a)
        obs, rew, _, trunc, info = port_env.step(a)
        np.testing.assert_allclose(obs, jobs, rtol=0, atol=ATOL)
        assert abs(rew - jrew) <= ATOL and abs(info["nusselt"] - jinfo["nusselt"]) <= ATOL
        assert info["t"] == pytest.approx(jinfo["t"], abs=1e-12) and trunc == jtrunc
    for name in ("u", "v", "w", "b", "p_nhs"):
        np.testing.assert_allclose(getattr(port_env._fields, name).numpy(),
                                   np.asarray(getattr(jax_env._fields, name)),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_rgb_render_matches_jax_3d(jax_env, port_env, monkeypatch):
    port_env.reset(seed=1)
    jax_env.reset(seed=1)
    monkeypatch.setattr(jax_env, "render_mode", "rgb_array")
    monkeypatch.setattr(port_env, "render_mode", "rgb_array")
    monkeypatch.setitem(sys.modules, "pyvista", None)  # the montage, as without PyVista
    want, got = jax_env.render(), port_env.render()
    assert got.shape == want.shape == (16, 4 * 16, 3)
    np.testing.assert_array_equal(got, want)


class FakePlotter:
    def __init__(self, off_screen=False, window_size=(800, 608)):
        self.off_screen, self.window_size = off_screen, tuple(window_size)
        self.volumes, self.rendered, self.closed = [], 0, False

    def add_volume(self, grid, **kwargs):
        self.volumes.append(kwargs)

    def add_axes(self):
        pass

    def render(self):
        self.rendered += 1

    def screenshot(self, return_img=False):
        w, h = self.window_size
        return np.full((h, w, 4), 7, np.uint8)

    def close(self):
        self.closed = True


class FakeGrid:
    def __init__(self, x, y, z):
        self.coords, self.point_data = (x, y, z), {}

    def __setitem__(self, key, value):
        self.point_data[key] = np.array(value)


@pytest.mark.parametrize("mode", ["rgb_array", "human"])
def test_pyvista_branch_through_a_fake_module(mode, monkeypatch):
    plotters = []
    mod = types.ModuleType("pyvista")
    mod.RectilinearGrid = FakeGrid
    mod.Plotter = lambda **kw: plotters.append(FakePlotter(**kw)) or plotters[-1]
    monkeypatch.setitem(sys.modules, "pyvista", mod)
    e = RayleighBenardConvection3DEnv(**FAST, render_mode=mode, device="cpu")
    obs, _ = e.reset(seed=0)
    img = e.render()
    p = plotters[0]
    assert p.off_screen == (mode != "human")
    assert p.volumes[0]["clim"] == (1, 2) and p.volumes[0]["cmap"] == "turbo"
    assert p.volumes[0]["opacity"] == "sigmoid_1"
    np.testing.assert_array_equal(e._grid_pv.point_data["T"],
                                  np.flip(obs[0], axis=1).ravel(order="C"))
    np.testing.assert_allclose(e._grid_pv.coords[0], np.arange(16) * 4 * np.pi / 16)
    if mode == "human":
        assert img is None and p.rendered == 1
        e.close()
    else:
        assert img.shape == (608, 800, 3) and (img == 7).all() and p.closed
        assert e._plotter is None
    assert p.closed


def _jax_ablation_script():
    spec = importlib.util.spec_from_file_location("jax_ablate_actuation3d",
                                                  REPO / "scripts" / "ablate_actuation3d.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ablation_checkerboard_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """Both scripts from a one-state bank (every env starts from it) on
    8x16x16 in float64, 2 episodes, 3 steps of 2 substeps: the JAX
    script's checkerboard Nu (recorded from its jitted rollout) and the
    twin's, every step and env, to 1e-10; then the twin's CLI on its
    default bank (the 16x32x32 training grid, one step): the JAX table's
    lines and the JSON record."""
    bank = _write_bank(tmp_path / "one.h5", 1, 4)
    episodes, n_steps, seed = 2, 3, 7
    monkeypatch.setattr(jvector3d, "RBC3DVectorEnv",
                        partial(jvector3d.RBC3DVectorEnv, state_shape=SHAPE,
                                dtype=jnp.float64))
    real_jit, recorded = jax.jit, {}

    def recording_jit(fun, **kwargs):
        jitted = real_jit(fun, **kwargs)
        if getattr(fun, "__name__", "") != "rollout":
            return jitted

        def call(mode, amp):
            out = jitted(mode, amp)
            recorded[(mode, amp)] = np.asarray(out)
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(sys, "argv", ["ablate", "--episodes", str(episodes), "--n-steps",
                                      str(n_steps), "--heater-duration", "0.0125",
                                      "--bank", bank, "--seed", str(seed)])
    _jax_ablation_script().main()
    monkeypatch.undo()
    capsys.readouterr()

    env = RBC3DVectorEnv(episodes, state_shape=SHAPE, heater_duration=0.0125, checkpoint=bank,
                         auto_reset=False, dtype=torch.float64, device="cpu")
    state0, _ = env.reset(seed=seed)
    for amp in ab.AMPLITUDES:
        got = ab.rollout(env, state0, "checker", amp, n_steps, seed + 1)
        np.testing.assert_allclose(got, recorded[("checker", amp)], rtol=0, atol=ATOL,
                                   err_msg=str(amp))
        assert recorded[("random", amp)].shape == got.shape
    assert len(set(ab.rollout(env, state0, "checker", 1.0, n_steps, 0).ravel())) > 1

    out = tmp_path / "ablation.json"
    rec = ab.main(["--episodes", "2", "--n-steps", "1", "--heater-duration", "0.0125",
                   "--device", "cpu", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Ra=2500 duration=0.0125 (2 episodes x 1 steps, 2nd-half Nu)"
    assert lines[1].split() == ["amp", "Nu(random)", "Nu(checker)"] and len(lines) == 2 + 7
    assert rec["nu_random"][0] == rec["nu_checker"][0]  # amplitude 0: both are zero action
    assert rec["bank"] == ab.DEFAULT_BANK and rec["amplitudes"] == list(ab.AMPLITUDES)
    assert json.loads(out.read_text()) == rec


def test_ablation_checkerboard_and_random_draws():
    np.testing.assert_array_equal(
        ab.checkerboard(4), np.array([[-1, 1, -1, 1], [1, -1, 1, -1]] * 2, np.float32))
    env = ab.make_env(2, 2500, 0.0125, None, device="cpu")
    assert not env.auto_reset and env._bank is None
    state0, _ = env.reset(seed=0)
    a = ab.rollout(env, state0, "random", 0.5, 1, 8)
    b = ab.rollout(env, state0, "random", 0.5, 1, 8)
    np.testing.assert_array_equal(a, b)  # one generator a rollout, seeded alike
    assert Path(ab.DEFAULT_BANK).exists()
