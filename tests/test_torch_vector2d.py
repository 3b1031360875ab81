"""The port's RBC2DVectorEnv against the JAX package's, on the CPU.

Both envs step from the same fields (made by numpy from a seed) in
float64: the deterministic outputs (obs, reward, Nusselt numbers, episode
bookkeeping, fields) agree to 1e-10, the float64 tolerance of the full env
step (tests/test_torch_solver2d.py). The two packages draw random numbers
differently (numbers from a seed differ between jax.random and torch), so
whatever depends on them (fresh initial conditions after an autoreset) is
tested by its properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.envs.vector2d import EnvState2D as JEnvState2D
from rbc_gym_tpu.envs.vector2d import RBC2DVectorEnv as JRBC2DVectorEnv
from rbc_gym_tpu.sim import solver2d as jsolver
from rbc_gym_tpu_torch.envs.autoreset import seed_keys
from rbc_gym_tpu_torch.envs.vector2d import EnvState2D, RBC2DVectorEnv
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

CFG = dict(
    state_shape=(16, 32),
    observation_shape=(8, 16),
    heater_duration=0.3,
    episode_length=0.9,  # 3 steps per episode
)
ATOL = 1e-10


def _env(n, **kw):
    return RBC2DVectorEnv(n, **{**CFG, **kw}, dtype=torch.float64, device="cpu")


def _np_fields(n, seed):
    rng = np.random.default_rng(seed)
    nz, nx = CFG["state_shape"]
    u = 0.05 * rng.standard_normal((n, nx, nz))
    w = 0.05 * rng.standard_normal((n, nx, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + 0.05 * rng.standard_normal((n, nx, nz)), 1.0, 2.0)
    p_hy = np.asarray(jsolver._hydrostatic_pressure(jnp.asarray(b), 2.0 / nz, 1.0))
    return jsolver.Fields2D(u, w, b, p_hy, np.zeros_like(u))


def _states(n, step, seed=0):
    """The same state for both packages, every env at episode step ``step``."""
    f = _np_fields(n, seed)
    t = (np.asarray(step) - 1) * CFG["heater_duration"] * np.ones(n)
    steps = np.asarray(step, np.int32) * np.ones(n, np.int32)
    jstate = JEnvState2D(
        fields=jax.tree_util.tree_map(jnp.asarray, f),
        t=jnp.asarray(t),
        step=jnp.asarray(steps),
        key=jax.random.split(jax.random.PRNGKey(seed), n),
    )
    state = EnvState2D(
        fields=fields_from_numpy(f),
        t=torch.as_tensor(t),
        step=torch.as_tensor(steps),
        key=seed_keys(seed, n),
    )
    return jstate, state


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("pressure", [False, True])
def test_step_matches_jax_env(pressure):
    jenv = JRBC2DVectorEnv(3, **CFG, pressure=pressure, dtype=jnp.float64)
    env = _env(3, pressure=pressure)
    jstate, state = _states(3, step=1, seed=1)
    actions = np.random.default_rng(2).uniform(-1, 1, (3, 12))
    jnext, jts = jenv.step(jstate, jnp.asarray(actions))
    nxt, ts = env.step(state, actions)
    assert tuple(ts.obs.shape) == (3, 5 if pressure else 3, 8, 16)
    for name in ("obs", "final_obs", "reward", "nusselt_state", "nusselt_obs", "t"):
        _close(getattr(ts, name), getattr(jts, name), name)
    for name in ("truncated", "terminated", "step"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(jts, name)))
    assert torch.equal(ts.reward, -ts.nusselt_obs)
    for name, got in fields_to_numpy(nxt.fields).items():
        _close(got, getattr(jnext.fields, name), name)


def test_truncating_step_matches_jax_env_up_to_the_fresh_ic():
    jenv = JRBC2DVectorEnv(2, **CFG, dtype=jnp.float64)
    env = _env(2)
    jstate, state = _states(2, step=3, seed=3)
    actions = np.zeros((2, 12))
    _, jts = jenv.step(jstate, jnp.asarray(actions))
    nxt, ts = env.step(state, actions)
    for name in ("final_obs", "reward", "nusselt_state", "nusselt_obs", "t"):
        _close(getattr(ts, name), getattr(jts, name), name)
    for name in ("truncated", "step"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(jts, name)))
    assert bool(ts.truncated.all())
    assert torch.all(nxt.t == 0) and torch.all(nxt.step == 1)
    # obs is the fresh episode's, built from the new fields
    assert torch.equal(ts.obs, env._observe(nxt.fields))
    assert not torch.equal(ts.obs, ts.final_obs)
    assert not torch.equal(nxt.key, state.key)


def test_autoreset_only_truncated_envs():
    env = _env(3)
    _, state = _states(3, step=1, seed=4)
    state = state._replace(step=torch.tensor([3, 1, 2], dtype=torch.int32))
    no_reset = _env(3, auto_reset=False)
    actions = np.zeros((3, 12))
    nxt, ts = env.step(state, actions)
    ref, ref_ts = no_reset.step(state, actions)
    assert ts.truncated.tolist() == [True, False, False]
    assert ts.step.tolist() == [1, 2, 3]
    for got, want in zip(nxt.fields, ref.fields):
        assert torch.equal(got[1:], want[1:])
        assert not torch.equal(got[0], want[0]) or not bool(want[0].any())
    assert torch.equal(nxt.key[1:], state.key[1:]) and nxt.key[0] != state.key[0]
    assert torch.equal(ts.obs[1:], ts.final_obs[1:])
    assert torch.equal(ref_ts.obs, ref_ts.final_obs)


def test_shapes_truncation_and_autoreset():
    env = _env(4)
    state, obs = env.reset(seed=0)
    assert tuple(obs.shape) == (4, 3, 8, 16)
    actions = torch.zeros(4, 12, dtype=torch.float64)
    for _ in range(3):
        state, ts = env.step(state, actions)
    assert bool(ts.truncated.all())  # every env truncates at step 3
    assert torch.all(state.t == 0.0) and torch.all(state.step == 1)
    state, ts = env.step(state, actions)
    assert not bool(ts.truncated.any())
    np.testing.assert_allclose(ts.t.numpy(), 0.3)


def test_autoreset_draws_fresh_ic_each_episode():
    """Consecutive episodes of one env slot start from different initial
    conditions: the per-env key advances at every autoreset."""
    env = _env(2)
    state, first_obs = env.reset(seed=7)
    actions = torch.zeros(2, 12, dtype=torch.float64)
    starts = [first_obs]
    for _ in range(3):
        for _ in range(3):
            state, ts = env.step(state, actions)
        assert bool(ts.truncated.all())
        starts.append(ts.obs)
    for a, b in zip(starts, starts[1:]):
        for e in range(2):
            assert not torch.equal(a[e], b[e]), "autoreset replayed an IC"


def test_reset_is_seeded_and_envs_are_independent():
    env = _env(3)
    _, obs = env.reset(seed=2)
    _, again = env.reset(seed=2)
    _, other = env.reset(seed=3)
    assert torch.equal(obs, again) and not torch.equal(obs, other)
    assert not torch.equal(obs[0], obs[1]) and not torch.equal(obs[1], obs[2])


def test_step_leaves_its_input_state_unmodified():
    env = _env(2)
    state, _ = env.reset(seed=5)
    state = state._replace(step=torch.tensor([3, 1], dtype=torch.int32))  # one autoresets
    snapshot = [t.clone() for t in (*state.fields, state.t, state.step, state.key)]
    env.step(state, torch.ones(2, 12, dtype=torch.float64))
    for before, after in zip(snapshot, (*state.fields, state.t, state.step, state.key)):
        assert torch.equal(before, after)


def test_bank_options_are_validated():
    """A bank that does not fit the env's grid is refused by name, an
    unknown sampling mode too; sequential
    sampling and ic_noise, which act only on banks, are accepted without
    one, as the JAX env accepts them."""
    with pytest.raises(ValueError, match="do not fit"):
        _env(2, checkpoint="rbc_gym_tpu_torch/assets/ckpt_ra10000_train.npz")
    with pytest.raises(ValueError, match="bank_sampling"):
        _env(2, bank_sampling="nope")
    _env(2, bank_sampling="sequential", auto_reset=False)
    _env(2, ic_noise=0.01)
    env = RBC2DVectorEnv(2, checkpoint="rbc_gym_tpu_torch/assets/ckpt_ra10000_train.npz",
                         dtype=torch.float64, device="cpu")
    assert env._bank.size == 20


def test_poisson_precision_is_taken_as_none_and_refused_otherwise():
    """The JAX env's 2D ``poisson_precision``: None, "highest" and "high"
    (which the JAX package maps to "highest") are one full-precision solve,
    so the port steps exactly as without it; "bf16x3" and "default", which
    run K1's split-product and one-pass instances, are taken
    (``test_split_and_one_pass_precisions_match_the_jax_env``); unknown
    names are refused by name."""
    jenv = JRBC2DVectorEnv(2, **CFG, dtype=jnp.float64, poisson_precision="high")
    default = _env(2)
    _, state = _states(2, step=1, seed=9)
    actions = np.random.default_rng(10).uniform(-1, 1, (2, 12))
    _, ts_default = default.step(state, actions)
    for value in (None, "highest", "high"):
        _, ts = _env(2, poisson_precision=value).step(state, actions)
        assert torch.equal(ts.obs, ts_default.obs) and torch.equal(ts.reward, ts_default.reward)
    assert jenv.num_envs == default.num_envs
    for value in ("bf16x3", "default"):
        assert _env(2, poisson_precision=value).solver.path == "plain"
    for value in ("bf16", "HIGH", "tf32"):
        with pytest.raises(ValueError, match="unknown poisson_precision"):
            _env(2, poisson_precision=value)


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
def test_split_and_one_pass_precisions_match_the_jax_env(precision):
    """At "bf16x3" and "default" the port's env steps as the JAX env at the
    same name, in float64 (where both solves' products are full precision
    whatever the name), at the env step's float64 tolerance."""
    jenv = JRBC2DVectorEnv(2, **CFG, dtype=jnp.float64, poisson_precision=precision)
    env = _env(2, poisson_precision=precision)
    jstate, state = _states(2, step=1, seed=11)
    actions = np.random.default_rng(12).uniform(-1, 1, (2, 12))
    jnext, jts = jenv.step(jstate, jnp.asarray(actions))
    nxt, ts = env.step(state, actions)
    for name in ("obs", "reward", "nusselt_state", "nusselt_obs"):
        _close(getattr(ts, name), getattr(jts, name), name)
    for name, got in fields_to_numpy(nxt.fields).items():
        _close(got, getattr(jnext.fields, name), name)
