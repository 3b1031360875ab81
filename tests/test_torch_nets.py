"""The port's actor-critic nets against the JAX package's flax nets.

Flax params (a random init, and the repo's trained 2D and 3D policies) go
through the port's weight converter; both nets then see the same
observations, made by numpy from a seed, in float64: mean, log_std and
value agree to 1e-10, and so do the gradients of the PPO loss (against
``jax.grad`` of the JAX trainer's loss). The converter's inverse gives
back the flax tree exactly, and the port's own init has flax's
lecun_normal statistics.
"""

import types

import flax.serialization as serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.models import flax_nets as fx
from rbc_gym_tpu.rl.ppo import PPO as JPPO
from rbc_gym_tpu.rl.ppo import PPOConfig as JPPOConfig
from rbc_gym_tpu.rl.ppo import Transition as JTransition
from rbc_gym_tpu_torch.models import nets
from rbc_gym_tpu_torch.models.params import (
    flax_from_state_dict,
    load_params,
    state_dict_from_flax,
)
from rbc_gym_tpu_torch.rl.ppo import PPO, PPOConfig
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ATOL = 1e-10
OBS_2D = (3, 8, 48)
OBS_3D = (4, 16, 32, 32)


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in kp): np.asarray(v, np.float64) for kp, v in leaves}


def _pair(kind, shared=False, trained=None, seed=0):
    """(flax module, float64 flax params, float64 torch module)."""
    if kind == "2d":
        fm = fx.RBCActorCritic2D(n_heaters=12, log_std_init=-0.5, shared_trunk=shared)
        tm = nets.RBCActorCritic2D(log_std_init=-0.5, shared_trunk=shared)
        obs = np.zeros((1,) + OBS_2D, np.float32)
    else:
        fm = fx.RBCActorCritic(action_grid=(8, 8), share_features_extractor=shared)
        tm = nets.RBCActorCritic(share_features_extractor=shared)
        obs = np.zeros((1,) + OBS_3D, np.float32)
    params = jax.jit(fm.init)(jax.random.PRNGKey(seed), jnp.asarray(obs))
    if trained is not None:
        with open(trained, "rb") as f:
            params = serialization.from_bytes(params, f.read())
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    tm = tm.double()
    tm.load_state_dict(state_dict_from_flax(_flat(params), tm))
    return fm, params, tm


def _obs(kind, n, seed):
    shape = OBS_2D if kind == "2d" else OBS_3D
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n,) + shape)


def _assert_outputs_match(fm, params, tm, obs):
    want = jax.jit(fm.apply)(params, jnp.asarray(obs))
    with torch.no_grad():
        got = tm(torch.as_tensor(obs))
    for name, g, w in zip(("mean", "log_std", "value"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind,shared", [("2d", False), ("2d", True), ("3d", False),
                                         ("3d", True)])
def test_random_init_outputs_match_flax(kind, shared):
    fm, params, tm = _pair(kind, shared, seed=1)
    _assert_outputs_match(fm, params, tm, _obs(kind, 3, 2))


@pytest.mark.parametrize("kind,path", [
    ("2d", "results/sarl2d_ra10000/models/best_model.msgpack"),
    ("3d", "results/sarl_ra2500/models/best_model.msgpack"),
])
def test_trained_params_match_flax(kind, path):
    fm, params, tm = _pair(kind, trained=path)
    _assert_outputs_match(fm, params, tm, _obs(kind, 4, 3))
    # the port's loader reads the msgpack itself, and its inverse gives the
    # flax tree back exactly
    loaded = load_params(path, nets.RBCActorCritic2D() if kind == "2d" else nets.RBCActorCritic())
    back = flax_from_state_dict(loaded.state_dict())
    with open(path, "rb") as f:
        tree = _flat(serialization.msgpack_restore(f.read()))
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k].astype(np.float32), err_msg=k)


def test_converter_refuses_a_tree_of_another_architecture():
    _, params, _ = _pair("2d", shared=False)
    with pytest.raises(KeyError, match="Conv_2"):
        state_dict_from_flax(_flat(params), nets.RBCActorCritic2D(shared_trunk=True))
    with pytest.raises(ValueError, match="does not fit"):
        state_dict_from_flax(_flat(params), nets.RBCActorCritic2D(n_heaters=8))


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_ppo_loss_gradients_match_jax_grad(kind):
    fm, params, tm = _pair(kind, seed=4)
    rng = np.random.default_rng(5)
    n = 6
    obs = _obs(kind, n, 6)
    a_shape = (12,) if kind == "2d" else (8, 8)
    action = rng.standard_normal((n,) + a_shape)
    old_log_prob = rng.standard_normal(n) - 20.0
    adv, ret = rng.standard_normal(n), rng.standard_normal(n)
    jcfg = JPPOConfig(ent_coef=0.01)
    fake = types.SimpleNamespace(config=jcfg, train_state=types.SimpleNamespace(apply_fn=fm.apply))
    batch = JTransition(obs=jnp.asarray(obs), action=jnp.asarray(action),
                        log_prob=jnp.asarray(old_log_prob), value=None, reward=None,
                        truncated=None, boundary_value=None, nusselt=None)
    jgrads, _ = jax.jit(jax.grad(lambda p: JPPO._loss(fake, p, batch, jnp.asarray(adv),
                                                      jnp.asarray(ret)), has_aux=True))(params)
    me = types.SimpleNamespace(config=PPOConfig(ent_coef=0.01), model=tm)
    loss, _ = PPO._loss(me, *(torch.as_tensor(x) for x in (obs, action, old_log_prob, adv, ret)))
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    got = flax_from_state_dict(dict(zip(names, grads)))
    want = _flat(jgrads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_init_is_flax_lecun_normal(kind):
    """Each weight a truncated normal of variance 1/fan_in (within four
    standard errors of the sample std, never beyond two of its stds),
    biases zero, log_std its init, the same weights from the same seed."""
    make = ((lambda g: nets.RBCActorCritic2D(log_std_init=-0.5, generator=g)) if kind == "2d"
            else (lambda g: nets.RBCActorCritic(log_std_init=-0.5, generator=g)))
    model = make(torch.Generator().manual_seed(0))
    again = make(torch.Generator().manual_seed(0))
    n_weights = 0
    for name, p in model.named_parameters():
        p = p.detach().double()
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0, name
        elif name == "log_std":
            assert bool((p == -0.5).all())
        else:
            fan_in = p[0].numel()
            want = fan_in ** -0.5
            n = p.numel()
            assert abs(float(p.std()) / want - 1.0) < 4.0 * (0.5 / n) ** 0.5 + 0.02, name
            assert float(p.abs().max()) <= 2.0 * want / 0.87962566103423978 + 1e-12, name
            n_weights += 1
    assert n_weights == (8 if kind == "2d" else 11)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
