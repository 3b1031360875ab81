"""The port's RBC3DVectorEnv against the JAX package's, on the CPU.

Both envs step from the same fields (made by numpy from a seed) in
float64: the deterministic outputs (obs, reward, Nusselt number, episode
bookkeeping, fields) agree to 1e-10, the float64 tolerance of the env step
(tests/test_torch_solver3d.py). The two packages draw random numbers
differently, so whatever depends on them (fresh initial conditions after
an autoreset) is tested by its properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.envs.vector3d import EnvState3D as JEnvState3D
from rbc_gym_tpu.envs.vector3d import RBC3DVectorEnv as JRBC3DVectorEnv
from rbc_gym_tpu.sim import solver3d as jsolver
from rbc_gym_tpu_torch.envs.autoreset import seed_keys
from rbc_gym_tpu_torch.envs.vector3d import EnvState3D, RBC3DVectorEnv
from rbc_gym_tpu_torch.sim.solver3d import Fields3D
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

CFG = dict(
    state_shape=(8, 8, 8),
    heater_duration=0.0125,  # 0.05 time units: substeps of 0.04 and 0.01
    episode_length=0.15,  # 3 steps per episode
)
ATOL = 1e-10
ACT = (8, 8)


def _env(n, **kw):
    return RBC3DVectorEnv(n, **{**CFG, **kw}, dtype=torch.float64, device="cpu")


def _np_fields(n, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = CFG["state_shape"]
    u = 0.05 * rng.standard_normal((n, nx, ny, nz))
    v = 0.05 * rng.standard_normal((n, nx, ny, nz))
    w = 0.05 * rng.standard_normal((n, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + 0.05 * rng.standard_normal(u.shape), 1.0, 2.0)
    p_hy = np.asarray(jsolver._hydrostatic_pressure_3d(jnp.asarray(b), 2.0 / nz, 1.0))
    return jsolver.Fields3D(u, v, w, b, p_hy, np.zeros_like(u))


def _states(n, step, seed=0):
    """The same state for both packages, every env at episode step ``step``."""
    f = _np_fields(n, seed)
    t = (np.asarray(step) - 1) * 4 * CFG["heater_duration"] * np.ones(n)
    steps = np.asarray(step, np.int32) * np.ones(n, np.int32)
    jstate = JEnvState3D(
        fields=jax.tree_util.tree_map(jnp.asarray, f),
        t=jnp.asarray(t),
        step=jnp.asarray(steps),
        key=jax.random.split(jax.random.PRNGKey(seed), n),
    )
    state = EnvState3D(
        fields=fields_from_numpy(f, cls=Fields3D),
        t=torch.as_tensor(t),
        step=torch.as_tensor(steps),
        key=seed_keys(seed, n),
    )
    return jstate, state


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("start_step", [1, 3])
def test_step_matches_jax_env(start_step):
    """A plain step, and one that truncates every env (fields then come
    from fresh initial conditions, which differ between the packages)."""
    jenv = JRBC3DVectorEnv(2, **CFG, dtype=jnp.float64)
    env = _env(2)
    jstate, state = _states(2, step=start_step, seed=1)
    actions = np.random.default_rng(2).uniform(-1, 1, (2,) + ACT)
    jnext, jts = jenv.step(jstate, jnp.asarray(actions))
    nxt, ts = env.step(state, actions)
    assert tuple(ts.obs.shape) == (2, 4, 8, 8, 8)
    for name in ("final_obs", "reward", "nusselt", "t"):
        _close(getattr(ts, name), getattr(jts, name), name)
    for name in ("truncated", "terminated", "step"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(jts, name)))
    assert torch.equal(ts.reward, -ts.nusselt)
    assert bool(ts.truncated.all()) == (start_step == 3)
    if start_step == 1:
        _close(ts.obs, jts.obs, "obs")
        for name, got in fields_to_numpy(nxt.fields).items():
            _close(got, getattr(jnext.fields, name), name)
    else:
        assert torch.all(nxt.t == 0) and torch.all(nxt.step == 1)
        assert torch.equal(ts.obs, env._observe(nxt.fields))
        assert not torch.equal(ts.obs, ts.final_obs)


def test_observation_layout():
    env = _env(2)
    _, state = _states(2, step=1, seed=3)
    obs = env._observe(state.fields)
    f = state.fields
    # (E, 4, nz, ny, nx): channels b, u, v, w at the bottom faces
    for c, field in enumerate((f.b, f.u, f.v, f.w[..., :8])):
        assert torch.equal(obs[:, c], field.permute(0, 3, 2, 1))


def test_defaults_are_the_training_grid_and_truncate_at_600():
    env = RBC3DVectorEnv(1, dtype=torch.float64, device="cpu")
    g, p = env.grid, env.params
    assert (g.nz, g.ny, g.nx) == (16, 32, 32)
    np.testing.assert_allclose((g.lz, g.ly, g.lx), (2.0, 4 * np.pi, 4 * np.pi))
    assert (p.ra, p.pr, p.n_heaters, p.heater_limit, p.heater_duration) == (2500, 0.7, 8, 0.9, 0.125)
    assert env.episode_steps == 600 and len(p.substep_dts()) == 13


def test_shapes_truncation_and_autoreset():
    env = _env(3)
    state, obs = env.reset(seed=0)
    assert tuple(obs.shape) == (3, 4, 8, 8, 8)
    actions = torch.zeros((3,) + ACT, dtype=torch.float64)
    for _ in range(3):
        state, ts = env.step(state, actions)
    assert bool(ts.truncated.all())  # every env truncates at step 3
    assert torch.all(state.t == 0.0) and torch.all(state.step == 1)
    state, ts = env.step(state, actions)
    assert not bool(ts.truncated.any())
    np.testing.assert_allclose(ts.t.numpy(), 0.05)


def test_autoreset_only_truncated_envs():
    env = _env(3)
    _, state = _states(3, step=1, seed=4)
    state = state._replace(step=torch.tensor([3, 1, 2], dtype=torch.int32))
    no_reset = _env(3, auto_reset=False)
    actions = np.zeros((3,) + ACT)
    nxt, ts = env.step(state, actions)
    ref, ref_ts = no_reset.step(state, actions)
    assert ts.truncated.tolist() == [True, False, False]
    assert ts.step.tolist() == [1, 2, 3]
    for got, want in zip(nxt.fields, ref.fields):
        assert torch.equal(got[1:], want[1:])
    assert not torch.equal(nxt.fields.u[0], ref.fields.u[0])
    assert torch.equal(nxt.key[1:], state.key[1:]) and nxt.key[0] != state.key[0]
    assert torch.equal(ts.obs[1:], ts.final_obs[1:])
    assert torch.equal(ref_ts.obs, ref_ts.final_obs)


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
    env.step(state, torch.ones((2,) + ACT, dtype=torch.float64))
    for before, after in zip(snapshot, (*state.fields, state.t, state.step, state.key)):
        assert torch.equal(before, after)


def test_checkpoint_banks_are_not_ported_yet():
    """The bank options are validated. (The name is kept from when the
    port refused banks.) A bank that does not fit the env's grid is
    refused by name, an unknown sampling mode too, and pinning
    every env to one bank state contradicts sequential sampling; without
    a bank, sequential sampling and ic_noise are accepted, as the JAX env
    accepts them."""
    bank = "data/checkpoints/train/3D_ckpt_ra2500.h5"  # 16x32x32
    with pytest.raises(ValueError, match="do not fit"):
        _env(2, checkpoint=bank)
    with pytest.raises(ValueError, match="bank_sampling"):
        _env(2, bank_sampling="nope")
    with pytest.raises(ValueError, match="checkpoint_idx"):
        _env(2, bank_sampling="sequential", checkpoint_idx=0)
    _env(2, bank_sampling="sequential", auto_reset=False)
    _env(2, ic_noise=0.01)


def test_stage_xy_env_steps_and_refuses_unported_options():
    """The K5 path forced on the CPU (its wrapper runs the plain version):
    steps, leaves its input state alone, equals the plain path; the JAX
    env's ``fused="field"`` and its alias True take the field path in
    float32 and are refused in float64, as are ``"stage_qp"`` and
    ``"stage_ew"``, which take their own paths in float32; a
    ``poisson_precision`` the JAX package's 3D solver does not know is
    refused by name."""
    env = RBC3DVectorEnv(2, state_shape=(8, 16, 16), heater_duration=0.0125,
                         episode_length=0.15, fused="stage_xy", device="cpu")
    plain = RBC3DVectorEnv(2, state_shape=(8, 16, 16), heater_duration=0.0125,
                           episode_length=0.15, fused=False, device="cpu")
    assert (env.solver.path, plain.solver.path) == ("stage_xy", "plain")
    state, obs = env.reset(seed=6)
    assert tuple(obs.shape) == (2, 4, 8, 16, 16) and obs.dtype == torch.float32
    snapshot = [t.clone() for t in (*state.fields, state.t, state.step, state.key)]
    actions = np.random.default_rng(7).uniform(-1, 1, (2,) + ACT)
    nxt, ts = env.step(state, actions)
    for before, after in zip(snapshot, (*state.fields, state.t, state.step, state.key)):
        assert torch.equal(before, after)
    ref, ref_ts = plain.step(state, actions)
    assert all(torch.equal(a, b) for a, b in zip(nxt.fields, ref.fields))
    assert torch.equal(ts.reward, ref_ts.reward) and bool(torch.isfinite(ts.obs).all())
    for fused in ("field", True):  # float32 only, as the JAX package's field kernels
        assert RBC3DVectorEnv(2, **CFG, fused=fused, device="cpu").solver.path == "field"
        with pytest.raises(ValueError, match="float32"):
            _env(2, fused=fused)
    for fused in ("stage_qp", "stage_ew"):
        assert RBC3DVectorEnv(2, **CFG, fused=fused, device="cpu").solver.path == fused
        with pytest.raises(ValueError, match=repr(fused)):
            _env(2, fused=fused)
    for precision in (None, "highest", "high", "default"):
        assert _env(2, poisson_precision=precision).num_envs == 2
    with pytest.raises(ValueError, match="poisson_precision"):
        _env(2, poisson_precision="bf16x3")
