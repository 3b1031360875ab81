"""The port's PPO against the JAX package's, on the CPU.

GAE, the loss and its metrics match the JAX trainer's own functions on
the same float64 inputs (made by numpy from a seed) at 1e-12 and 1e-10;
one clipped Adam step under the linear schedule matches optax in float32
at 1e-6. The random parts (action noise, permutations) differ between
the packages, so ``learn``, ``target_kl`` and ``predict`` are tested by
their properties on a tiny 2D env.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rbc_gym_tpu.rl.ppo import PPO as JPPO
from rbc_gym_tpu.rl.ppo import PPOConfig as JPPOConfig
from rbc_gym_tpu.rl.ppo import Transition as JTransition
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D
from rbc_gym_tpu_torch.rl import NusseltCallback
from rbc_gym_tpu_torch.rl.ppo import (
    PPO,
    ClippedAdam,
    PPOConfig,
    Transition,
    linear_schedule,
)
from rbc_gym_tpu_torch.wrappers import functional as fn
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ENV = dict(state_shape=(16, 32), observation_shape=(8, 16), heater_duration=0.3,
           episode_length=0.9)  # 3 steps an episode


def _trainer(n_envs=2, dtype=torch.float64, **cfg):
    env = RBC2DVectorEnv(n_envs, **ENV, dtype=dtype, device="cpu")
    norm = fn.make_obs_norm_2d(heater_limit=0.75)
    config = PPOConfig(**{**dict(n_steps=4, n_epochs=2, n_minibatches=2), **cfg})
    return PPO(env, RBCActorCritic2D(obs_shape=(8, 16), log_std_init=-0.5), config,
               obs_transform=lambda o: fn.normalize_observation(o, norm), seed=0, device="cpu")


def test_gae_matches_jax_with_truncations():
    rng = np.random.default_rng(0)
    T, E = 7, 3
    value, reward = rng.standard_normal((T, E)), rng.standard_normal((T, E))
    boundary = rng.standard_normal((T, E))
    truncated = np.zeros((T, E), bool)
    truncated[2, :] = True
    truncated[5, 1] = True
    boundary[~truncated] = 0.0
    last_value = rng.standard_normal(E)
    cfg = dict(gamma=0.97, gae_lambda=0.9)
    jtraj = JTransition(obs=None, action=None, log_prob=None, value=jnp.asarray(value),
                        reward=jnp.asarray(reward), truncated=jnp.asarray(truncated),
                        boundary_value=jnp.asarray(boundary), nusselt=None)
    want = JPPO._gae(types.SimpleNamespace(config=JPPOConfig(**cfg)), jtraj,
                     jnp.asarray(last_value))
    traj = Transition(obs=None, action=None, log_prob=None, value=torch.as_tensor(value),
                      reward=torch.as_tensor(reward), truncated=torch.as_tensor(truncated),
                      boundary_value=torch.as_tensor(boundary), nusselt=None)
    got = PPO._gae(types.SimpleNamespace(config=PPOConfig(**cfg)), traj,
                   torch.as_tensor(last_value))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


@pytest.mark.parametrize("normalize", [True, False])
def test_loss_and_metrics_match_jax(normalize):
    """The JAX loss on a linear-Gaussian stand-in for the net (the nets'
    own parity is tests/test_torch_nets.py), so that only the loss is
    compared: surrogate, clipping, value loss, entropy, population-std
    advantage normalisation, KL, clip fraction."""
    rng = np.random.default_rng(1)
    n, d, a = 16, 5, 3
    w, b = rng.standard_normal((d, a)) * 0.3, rng.standard_normal(a) * 0.1
    v, log_std = rng.standard_normal(d), rng.standard_normal(a) * 0.2 - 0.5
    obs, action = rng.standard_normal((n, d)), rng.standard_normal((n, a))
    old_lp = rng.standard_normal(n) * 0.5 - 3.0
    adv, ret = rng.standard_normal(n) * 2.0 + 0.5, rng.standard_normal(n)
    cfg = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, normalize_advantage=normalize)

    def japply(params, x):
        return x @ params["w"] + params["b"], params["log_std"], x @ params["v"]

    jparams = {k: jnp.asarray(x) for k, x in dict(w=w, b=b, v=v, log_std=log_std).items()}
    fake = types.SimpleNamespace(config=JPPOConfig(**cfg),
                                 train_state=types.SimpleNamespace(apply_fn=japply))
    batch = JTransition(obs=jnp.asarray(obs), action=jnp.asarray(action),
                        log_prob=jnp.asarray(old_lp), value=None, reward=None,
                        truncated=None, boundary_value=None, nusselt=None)
    jloss, jmetrics = JPPO._loss(fake, jparams, batch, jnp.asarray(adv), jnp.asarray(ret))

    t = {k: torch.as_tensor(x) for k, x in dict(w=w, b=b, v=v, log_std=log_std).items()}
    me = types.SimpleNamespace(config=PPOConfig(**cfg),
                               model=lambda x: (x @ t["w"] + t["b"], t["log_std"], x @ t["v"]))
    loss, metrics = PPO._loss(me, *(torch.as_tensor(x) for x in (obs, action, old_lp, adv, ret)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-10)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=0, atol=1e-10,
                                   err_msg=k)
    assert 0.0 < float(metrics["clip_fraction"]) < 1.0  # both clip branches taken


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # below and above max_grad_norm
def test_clipped_adam_with_linear_schedule_matches_optax(grad_scale):
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    sched = optax.linear_schedule(init_value=3e-3, end_value=3e-5, transition_steps=2)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(sched, eps=1e-5))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.tensor(params[k]) for k in shapes]
    opt = ClippedAdam(tp, linear_schedule(3e-3, 3e-5, 2), max_norm=0.5)
    for g in grads:  # three steps: the schedule reaches its end value
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply([torch.tensor(g[k]) for k in shapes])
    for k, p in zip(shapes, tp):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)
    assert opt.count == 3 and int(state[1][0].count) == 3
    for k, m, v in zip(shapes, opt.mu, opt.nu):
        np.testing.assert_allclose(m.numpy(), np.asarray(state[1][0].mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(v.numpy(), np.asarray(state[1][0].nu[k]), rtol=1e-6, atol=1e-12)


def test_target_kl_freezes_params_moments_and_count():
    """SB3 target_kl: the first minibatch always applies (ratio 1, KL 0);
    with a vanishing target every later one is skipped, and the skipped
    ones touch neither params, Adam moments nor the count."""
    tiny = _trainer(target_kl=1e-12)
    applied = []
    real_apply = tiny.optimizer.apply

    def apply(grads, g_norm=None):
        real_apply(grads, g_norm)
        applied.append([p.detach().clone() for p in tiny.optimizer.params]
                       + [m.clone() for m in tiny.optimizer.mu])

    tiny.optimizer.apply = apply
    metrics = tiny.learn(2)
    assert metrics["n_updates"] == 1.0 and tiny.optimizer.count == 2 and len(applied) == 2
    final = [p.detach() for p in tiny.optimizer.params] + list(tiny.optimizer.mu)
    assert all(torch.equal(a, b) for a, b in zip(applied[-1], final))

    huge = _trainer(target_kl=10.0)
    metrics = huge.learn(1)
    assert metrics["n_updates"] == 2 * 2 and huge.optimizer.count == 4


def test_tiny_learn_runs_and_reports():
    trainer = _trainer(anneal_lr=True, total_iterations=2)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    records = []
    metrics = trainer.learn(2, callbacks=(NusseltCallback(), lambda m, t: records.append(m)))
    assert [r["iteration"] for r in records] == [0, 1]
    assert metrics["global_step"] == 2 * 4 * 2
    for k in ("loss", "policy_loss", "value_loss", "entropy", "approx_kl", "clip_fraction",
              "policy_std", "grad_norm", "n_updates", "rollout/reward_mean",
              "rollout/nusselt_mean", "rollout/value_mean", "rollout/nusselt_min"):
        assert np.isfinite(metrics[k]), k
    assert metrics["policy_std"] == pytest.approx(np.exp(-0.5), rel=0.05)
    assert not all(torch.equal(a, b) for a, b in zip(before, trainer.model.parameters()))
    assert trainer.optimizer.learning_rate() < 3e-4  # annealed


def test_rollout_bootstraps_only_at_truncations():
    trainer = _trainer()
    traj, last_value = trainer._rollout()  # 4 steps of 3-step episodes: step 3 truncates
    assert traj.truncated[:, 0].tolist() == [False, False, True, False]
    assert bool((traj.boundary_value[2] != 0).all())
    assert float(traj.boundary_value[[0, 1, 3]].abs().max()) == 0.0
    assert float(traj.action.abs().max()) > 0.0 and tuple(traj.obs.shape) == (4, 2, 3, 8, 16)
    assert tuple(last_value.shape) == (2,)


def test_predict_and_anneal_requirement():
    trainer = _trainer()
    obs = trainer.last_obs
    greedy = trainer.predict(obs)
    mean = trainer.model(obs)[0]
    assert torch.equal(greedy, torch.clamp(mean, -1.0, 1.0))
    sampled = trainer.predict(obs, deterministic=False)
    assert tuple(sampled.shape) == (2, 12) and float(sampled.abs().max()) <= 1.0
    assert not torch.equal(sampled, greedy)
    with pytest.raises(ValueError, match="total_iterations"):
        _trainer(anneal_lr=True)
