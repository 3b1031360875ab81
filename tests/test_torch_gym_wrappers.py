"""The port's gym wrappers over the port's envs against the JAX package's
wrappers over the JAX envs, from the same bank state, on the CPU.

Both env pairs read one bank file written here and step in float64, so
the wrapped observations, rewards and cell distances agree to 1e-10; the
wrappers keep the reference constants (the 3D Hill limit, the Nu_max
power laws, the 0.001 peak height); the 2D ``u_limit=None`` is refused;
the debug view draws under Agg; the ``example/run_wrapped.py`` stack runs
over the port's env.
"""

import matplotlib

matplotlib.use("Agg")

import gymnasium as gym  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from gymnasium.wrappers import FlattenObservation, FrameStackObservation  # noqa: E402

import rbc_gym_tpu  # noqa: E402,F401  (registers the JAX gym IDs)
import rbc_gym_tpu_torch  # noqa: E402
from rbc_gym_tpu import wrappers as jwrappers  # noqa: E402
from rbc_gym_tpu.utils import checkpoints as jckpt  # noqa: E402
from rbc_gym_tpu.wrappers import rbc_normalize_observation as jnorm_obs  # noqa: E402
from rbc_gym_tpu.wrappers import rbc_reward_shaping as jshaping  # noqa: E402
from rbc_gym_tpu_torch import wrappers  # noqa: E402
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D  # noqa: E402
from rbc_gym_tpu_torch.sim.solver2d import SimParams2D, make_solver2d  # noqa: E402
from rbc_gym_tpu_torch.sim.solver3d import SimParams3D, make_solver3d  # noqa: E402
from rbc_gym_tpu_torch.wrappers import rbc_normalize_observation as norm_obs  # noqa: E402
from rbc_gym_tpu_torch.wrappers import rbc_reward_shaping as shaping  # noqa: E402

SMALL_2D = dict(state_shape=(16, 32), observation_shape=(8, 16), heater_duration=0.3,
                episode_length=3.0)
SMALL_3D = dict(state_shape=(8, 16, 16), heater_duration=0.0125, episode_length=3,
                checkpoint_idx=0)
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
def banks(tmp_path_factory):
    """One 2D and one 3D bank at the small grids: random ICs of the port's
    float64 solvers after plain env steps (the 2D ones past the onset of
    rolls, so the cell distance has peaks), written by the JAX writer."""
    d = tmp_path_factory.mktemp("banks")
    solver = make_solver2d(Grid2D(nx=32, nz=16, lx=2 * np.pi, lz=2.0),
                           SimParams2D(heater_duration=1.5), dtype=torch.float64, device="cpu")
    f = solver.init_random(torch.Generator().manual_seed(1), (3,))
    for _ in range(6):
        f = solver.env_step(f, torch.zeros(3, 12, dtype=torch.float64))
    jckpt.save_bank_2d(str(d / "b2.h5"), jckpt.CheckpointBank2D(
        b=f.b.numpy(), u=f.u.numpy(), w=f.w.numpy()))
    grid = Grid3D(nx=16, ny=16, nz=8, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    solver = make_solver3d(grid, SimParams3D(heater_duration=0.0125), dtype=torch.float64,
                           device="cpu")
    g = solver.init_random(torch.Generator().manual_seed(2), (1,))
    jckpt.save_bank_3d(str(d / "b3.h5"), jckpt.CheckpointBank3D(
        b=g.b.numpy(), u=g.u.numpy(), v=g.v.numpy(), w=g.w.numpy()))
    return str(d / "b2.h5"), str(d / "b3.h5")


@pytest.fixture(scope="module")
def envs_2d(banks):
    """(JAX env, port env), float64, the same bank."""
    pair = (gym.make("rbc_gym/RayleighBenardConvection2D-v0", **SMALL_2D, checkpoint=banks[0],
                     dtype="float64"),
            gym.make(rbc_gym_tpu_torch.ENV_ID_2D, **SMALL_2D, checkpoint=banks[0],
                     dtype="float64", device="cpu"))
    yield pair
    for e in pair:
        e.close()


@pytest.fixture(scope="module")
def envs_3d(banks):
    pair = (gym.make("rbc_gym/RayleighBenardConvection3D-v0", **SMALL_3D, checkpoint=banks[1],
                     dtype="float64"),
            gym.make(rbc_gym_tpu_torch.ENV_ID_3D, **SMALL_3D, checkpoint=banks[1],
                     dtype="float64", device="cpu"))
    yield pair
    for e in pair:
        e.close()


def _run_pair(jenv, env, steps, action_shape, seed=0):
    """reset(seed) and ``steps`` equal random actions on both -> the JAX and
    the port (obs, reward, info) lists, reset first (reward None)."""
    rng = np.random.default_rng(seed)
    outs = ([], [])
    for e, out in zip((jenv, env), outs):
        obs, info = e.reset(seed=seed)
        out.append((obs, None, info))
    for _ in range(steps):
        a = rng.uniform(-1, 1, action_shape).astype(np.float32)
        for e, out in zip((jenv, env), outs):
            obs, reward, _, _, info = e.step(a)
            out.append((obs, reward, info))
    return outs


def test_constants_are_the_references():
    assert (norm_obs.W_INF, norm_obs.RA_C, norm_obs.HILL_N) == (
        jnorm_obs.W_INF, jnorm_obs.RA_C, jnorm_obs.HILL_N)
    for ra in (500, 2500, 1e4):
        assert norm_obs.u_limit_3d(ra) == jnorm_obs.u_limit_3d(ra)
    assert set(wrappers.__all__) == set(jwrappers.__all__)


def test_normalize_observation_2d_matches_jax(envs_2d):
    jenv, env = envs_2d
    jw = jwrappers.RBCNormalizeObservation(jenv, heater_limit=0.75, u_limit=1.3)
    w = wrappers.RBCNormalizeObservation(env, heater_limit=0.75, u_limit=1.3)
    assert w.observation_space == jw.observation_space
    np.testing.assert_array_equal(w.min_vals, jw.min_vals)
    for (jo, _, _), (o, _, _) in zip(*_run_pair(jw, w, 2, (12,))):
        assert o.dtype == np.float32 and o.shape == (3, 8, 16)
        np.testing.assert_allclose(o, jo, rtol=0, atol=ATOL)


def test_normalize_observation_2d_needs_u_limit(envs_2d):
    with pytest.raises(ValueError, match="u_limit must be provided"):
        wrappers.RBCNormalizeObservation(envs_2d[1], heater_limit=0.75, u_limit=None)


def test_normalize_observation_3d_hill_limit_matches_jax(envs_3d):
    jenv, env = envs_3d
    jw = jwrappers.RBCNormalizeObservation(jenv, heater_limit=0.9, u_limit=None, clip=True)
    w = wrappers.RBCNormalizeObservation(env, heater_limit=0.9, u_limit=None, clip=True)
    limit = norm_obs.u_limit_3d(env.unwrapped.ra)  # the 3D ID: Ra=500
    np.testing.assert_allclose(w.max_vals, np.float32([2.9, limit, limit, limit]))
    np.testing.assert_array_equal(w.max_vals, jw.max_vals)
    for (jo, _, _), (o, _, _) in zip(*_run_pair(jw, w, 2, (8, 8))):
        assert o.shape == (4, 8, 16, 16) and np.abs(o).max() <= 1.0
        np.testing.assert_allclose(o, jo, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_normalize_reward_matches_jax(dim, envs_2d, envs_3d):
    jenv, env = envs_2d if dim == "2d" else envs_3d
    jw, w = jwrappers.RBCNormalizeReward(jenv), wrappers.RBCNormalizeReward(env)
    s, a = (0.1, 0.4) if dim == "2d" else (0.22, 0.27)
    assert w.scale == jw.scale == s * env.unwrapped.ra**a
    jout, out = _run_pair(jw, w, 2, (12,) if dim == "2d" else (8, 8))
    for (_, jr, _), (_, r, _) in zip(jout[1:], out[1:]):
        assert abs(r - jr) <= ATOL


def test_normalize_reward_refuses_other_envs(envs_2d):
    """The port's wrapper takes the port's envs only (the JAX env has an Ra
    too, and is refused)."""
    with pytest.raises(TypeError, match="RBC 2D or 3D"):
        wrappers.RBCNormalizeReward(envs_2d[0])


def test_reward_shaping_matches_jax(envs_2d):
    jenv, env = envs_2d
    jw = jwrappers.RBCRewardShaping(jenv, shaping_weight=0.3)
    w = wrappers.RBCRewardShaping(env, shaping_weight=0.3)
    jout, out = _run_pair(jw, w, 3, (12,))
    dists = []
    for (jo, jr, ji), (o, r, i) in zip(jout[1:], out[1:]):
        assert abs(i["cell_dist"] - ji["cell_dist"]) <= ATOL and abs(r - jr) <= ATOL
        dists.append(i["cell_dist"])
    assert max(dists) > 0.0  # the bank's rolls have cells apart


def test_compute_cell_distances_matches_jax():
    rng = np.random.default_rng(0)
    x = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    for k in range(6):
        state = rng.normal(size=(3, 16, 32)) * 0.1
        state[2] += np.sin((k % 3 + 1) * x + k)[None, :]
        for use_avg in (False, True):
            got = shaping.compute_cell_distances(state, (16, 32), use_avg=use_avg,
                                                 return_peaks=True)
            want = jshaping.compute_cell_distances(state, (16, 32), use_avg=use_avg,
                                                   return_peaks=True)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
    flat = np.zeros((3, 16, 32))
    flat[2, 7] = 0.0009  # under the 0.001 peak height: no peaks
    assert shaping.compute_cell_distances(flat, (16, 32)) == 0.0


def test_reward_shaping_debug_view_draws_under_agg(envs_2d):
    env = envs_2d[1]
    w = wrappers.RBCRewardShaping(env, shaping_weight=0.5, debug_cell_dist=True)
    w.reset(seed=1)
    state = env.unwrapped._diag_state
    np.testing.assert_array_equal(w.line_uy.get_ydata(), state[2][7])
    _, _, _, _, info = w.step(np.zeros(12, np.float32))
    x_peaks = w.line_cells.get_xdata()
    assert len(x_peaks) >= 1 and np.isfinite(info["cell_dist"])
    w._plt.close(w.fig_anim)


def test_the_run_wrapped_stack_runs_over_the_port_env():
    """example/run_wrapped.py's stack (normalisation, shaping, flatten,
    frame stack) over the port's env, at the small grid."""
    env = gym.make(rbc_gym_tpu_torch.ENV_ID_2D, **{**SMALL_2D, "episode_length": 0.9},
                   device="cpu")
    env = wrappers.RBCNormalizeObservation(env, heater_limit=0.75, u_limit=1.3)
    env = wrappers.RBCNormalizeReward(env)
    env = wrappers.RBCRewardShaping(env, shaping_weight=0.3)
    env = FlattenObservation(env)
    env = FrameStackObservation(env, 4)
    obs, info = env.reset(seed=42)
    assert obs.shape == (4, 3 * 8 * 16)
    truncated, steps = False, 0
    while not truncated:
        obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
        steps += 1
        assert np.isfinite(reward) and "cell_dist" in info and not terminated
    assert steps == 3 and obs.shape == (4, 384)
    env.close()
