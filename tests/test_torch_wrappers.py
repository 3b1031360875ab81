"""The port's functional wrappers against the JAX package's, in float64.

Same inputs, made by numpy from a seed, through both packages; every
comparison at atol 1e-12 (the arithmetic is the same elementwise
formulas; only summation order may differ). The reference constants
(PARITY.md 4) are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.wrappers import functional as jfn
from rbc_gym_tpu.wrappers.rbc_normalize_observation import u_limit_3d as j_u_limit_3d
from rbc_gym_tpu_torch.wrappers import functional as fn
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

ATOL = 1e-12


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("clip", [False, True])
def test_normalize_observation_2d_and_3d(clip):
    rng = np.random.default_rng(0)
    obs2 = 1.5 * rng.standard_normal((4, 3, 8, 48)) + 1.0
    obs3 = 1.5 * rng.standard_normal((2, 4, 4, 6, 6)) + 1.0
    for obs, args, axis in ((obs2, dict(heater_limit=0.75, clip=clip), -3),
                            (obs3, dict(ra=2500, heater_limit=0.9, clip=clip), -4)):
        make, jmake = ((fn.make_obs_norm_2d, jfn.make_obs_norm_2d) if axis == -3
                       else (fn.make_obs_norm_3d, jfn.make_obs_norm_3d))
        norm, jnorm = make(**args), jmake(**args)
        np.testing.assert_array_equal(norm.min_vals.numpy(), np.asarray(jnorm.min_vals))
        np.testing.assert_array_equal(norm.max_vals.numpy(), np.asarray(jnorm.max_vals))
        got = fn.normalize_observation(torch.as_tensor(obs), norm, channel_axis=axis)
        want = jfn.normalize_observation(jnp.asarray(obs), jnorm, channel_axis=axis)
        assert got.dtype == torch.float64
        _close(got, want)
        if clip:
            assert float(got.abs().max()) <= 1.0


def test_reference_constants_are_verbatim():
    for ra in (500, 2500, 16000):
        assert fn.u_limit_3d(ra) == j_u_limit_3d(ra)
    for ra, three_d in ((1e4, False), (1e6, False), (2500, True), (8000, True)):
        assert fn.reward_scale(ra, three_d) == jfn.reward_scale(ra, three_d)
    norm = fn.make_obs_norm_2d(heater_limit=0.75)
    assert norm.min_vals.tolist() == np.float32([1.0, -1.3, -1.3]).tolist()
    assert norm.max_vals.tolist() == np.float32([2.75, 1.3, 1.3]).tolist()


def test_normalize_reward_and_shaped_reward():
    rng = np.random.default_rng(1)
    reward = -rng.uniform(1.0, 5.0, 16)
    dist = rng.uniform(0.0, np.pi, 16)
    scale = fn.reward_scale(1e4, three_d=False)
    _close(fn.normalize_reward(torch.as_tensor(reward), scale),
           jfn.normalize_reward(jnp.asarray(reward), scale))
    for w in (0.0, 0.3, 1.0):
        _close(fn.shaped_reward(torch.as_tensor(reward), torch.as_tensor(dist), w),
               jfn.shaped_reward(jnp.asarray(reward), jnp.asarray(dist), w))


def test_cell_distance_matches_jax_on_smooth_signals():
    nx = 96
    rng = np.random.default_rng(2)
    x = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    uy = np.zeros((3, 4, nx))
    for k in range(1, 5):
        uy += rng.normal(size=(3, 4, 1)) * np.sin(k * x + rng.uniform(0, 2 * np.pi, (3, 4, 1)))
    uy *= 0.1
    got = fn.cell_distance_2d(torch.as_tensor(uy))
    assert tuple(got.shape) == (3, 4)
    _close(got, jfn.cell_distance_2d(jnp.asarray(uy)))
    assert float(got.max()) > 0.0


def test_cell_distance_ties_and_edge_cases():
    nx = 32
    x = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    cases = [np.full(nx, -1.0)]  # no peaks
    one = np.full(nx, -0.5)
    one[10] = 1.0
    cases.append(one)  # one peak
    two = np.full(nx, -0.5)
    two[4] = two[20] = 1.0
    cases.append(two)  # two cells
    plateau = two.copy()
    plateau[5] = 1.0  # a tie: neither 4 nor 5 is a strict maximum
    cases.append(plateau)
    same_cell = np.full(nx, 0.2)
    same_cell[[3, 9]] = 1.0
    cases.append(same_cell)  # two peaks without down-welling between them
    wrap = np.full(nx, 0.2)
    wrap[[2, 29]] = 1.0
    wrap[15] = -0.3
    cases.append(wrap)  # down-welling only on the inner arc
    edge = np.full(nx, -0.5)
    edge[[0, 31, 12]] = 1.0  # the end points are never peaks
    cases.append(edge)
    uy = np.stack(cases)
    got = fn.cell_distance_2d(torch.as_tensor(uy))
    _close(got, jfn.cell_distance_2d(jnp.asarray(uy)))
    want_two = min(x[20] - x[4], 2 * np.pi - (x[20] - x[4]))
    assert got.tolist()[:3] == [0.0, 0.0, pytest.approx(want_two)]
    assert got[3] == 0.0 and got[4] == 0.0
