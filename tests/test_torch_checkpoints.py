"""The port's checkpoint banks and bank resets against the JAX package's.

The port reads the repo's reference HDF5 banks exactly as the JAX package
does, its committed ``.npz`` copies equal their sources, and a bank reset
gives the JAX env's fields (``ic_noise=0``, float64, atol 1e-12). The two
packages draw random numbers differently, so the random parts (bank index,
noise) are tested by their properties. PARITY.md 1-2 re-run on the port:
the divergence of every 2D bank under the port's operator, and one float64
env step from the Ra=1e4 bank at Nu 4.000 +- 0.005.
"""

import glob
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.envs.vector2d import RBC2DVectorEnv as JRBC2DVectorEnv
from rbc_gym_tpu.envs.vector3d import RBC3DVectorEnv as JRBC3DVectorEnv
from rbc_gym_tpu.utils import checkpoints as jckpt
import chip_smoke
from rbc_gym_tpu_torch.envs.autoreset import seed_keys
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.ops.kernels2d import hydrostatic_pressure
from rbc_gym_tpu_torch.sim.grid import Grid2D
from rbc_gym_tpu_torch.sim.solver2d import Fields2D, max_divergence
from rbc_gym_tpu_torch.utils import checkpoints as ckpt
from rbc_gym_tpu_torch.utils import convert

BANK_2D = "data/checkpoints/train/ckpt_ra10000.h5"
BANK_3D = "data/checkpoints/train/3D_ckpt_ra2500.h5"
NPZ_2D = "rbc_gym_tpu_torch/assets/ckpt_ra10000_train.npz"
F64_ATOL = 1e-12


def _env2d(n, **kw):
    return RBC2DVectorEnv(n, checkpoint=NPZ_2D, dtype=torch.float64, device="cpu", **kw)


def _env3d(n, **kw):
    return RBC3DVectorEnv(n, checkpoint=BANK_3D, dtype=torch.float64, device="cpu", **kw)


def _bank_index(env, fields):
    """Which bank episode each env's b equals (-1: none)."""
    bank_b = env._bank.arrays["b"]
    eq = (fields.b[:, None] == bank_b[None]).flatten(2).all(-1)
    return torch.where(eq.any(1), eq.to(torch.int64).argmax(1), -1)


@pytest.mark.parametrize("path,three_d", [(BANK_2D, False), (BANK_3D, True)])
def test_hdf5_banks_load_as_in_jax(path, three_d):
    load, jload = ((ckpt.load_bank_3d, jckpt.load_bank_3d) if three_d
                   else (ckpt.load_bank_2d, jckpt.load_bank_2d))
    got, want = load(path), jload(path)
    names = ("b", "u", "v", "w") if three_d else ("b", "u", "w")
    for name in names:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.start_seed == want.start_seed == 42 and got.num_episodes == 20
    assert got.w.shape[-1] == got.b.shape[-1] + 1  # staggered: nz+1 w faces


@pytest.mark.parametrize("three_d", [False, True])
def test_save_and_load_round_trip_both_formats(tmp_path, three_d):
    cls, save, load, jload = (
        (ckpt.CheckpointBank3D, ckpt.save_bank_3d, ckpt.load_bank_3d, jckpt.load_bank_3d)
        if three_d else
        (ckpt.CheckpointBank2D, ckpt.save_bank_2d, ckpt.load_bank_2d, jckpt.load_bank_2d))
    rng = np.random.default_rng(3)
    shape = (2, 6, 5, 4) if three_d else (2, 6, 4)
    names = ("b", "u", "v", "w") if three_d else ("b", "u", "w")
    bank = cls(**{n: rng.standard_normal(shape[:-1] + (shape[-1] + (n == "w"),))
                  for n in names}, start_seed=7)
    for suffix in (".npz", ".h5"):
        path = str(tmp_path / f"bank{suffix}")
        save(path, bank)
        for loaded in (load(path), jload(path)):  # the JAX package reads it too
            assert loaded.start_seed == 7
            for n in names:
                np.testing.assert_array_equal(getattr(loaded, n), getattr(bank, n))


@pytest.mark.parametrize("asset", sorted(convert.ASSETS))
def test_committed_assets_equal_their_sources(asset):
    src = str(convert.REPO / convert.ASSETS[asset])
    path = convert.ASSET_DIR / asset
    if src.endswith(".msgpack"):
        from flax import serialization

        with open(src, "rb") as f:
            tree = serialization.msgpack_restore(f.read())
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        want = {"/".join(p.key for p in kp): np.asarray(v) for kp, v in leaves}
        got = dict(np.load(path))
        # the 2D net's 17 leaves; the 3D net's 23
        assert set(got) == set(want) and len(got) == (23 if "sarl_ra2500" in asset else 17)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert convert.read_flax_msgpack(src).keys() == want.keys()
    else:
        three_d = asset.startswith("3D_")
        load, jload = ((ckpt.load_bank_3d, jckpt.load_bank_3d) if three_d
                       else (ckpt.load_bank_2d, jckpt.load_bank_2d))
        got, want = load(path), jload(src)
        assert got.start_seed == want.start_seed
        # float32 copies of float64 files that hold float32 values: equal
        for n in ("b", "u", "v", "w") if three_d else ("b", "u", "w"):
            assert getattr(got, n).dtype == np.float32
            np.testing.assert_array_equal(getattr(got, n), getattr(want, n))


def test_fields_from_bank_match_jax_2d():
    jenv = JRBC2DVectorEnv(2, checkpoint=BANK_2D, dtype=jnp.float64)
    env = _env2d(2)
    idx = [0, 7, 19]
    got = env._bank.fields(torch.tensor(idx), seed_keys(0, 3))
    for i, k in enumerate(idx):
        want = jenv._fields_from_bank(jnp.asarray(k), jax.random.PRNGKey(0))
        for name in Fields2D._fields:
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=0, atol=F64_ATOL, err_msg=name)


def test_fields_from_bank_match_jax_3d_and_checkpoint_idx_pins():
    jenv = JRBC3DVectorEnv(2, checkpoint=BANK_3D, dtype=jnp.float64)
    env = _env3d(3, checkpoint_idx=5)
    state, _ = env.reset(seed=1)
    want = jenv._fields_from_bank(jnp.asarray(5), jax.random.PRNGKey(0))
    for name in state.fields._fields:
        for i in range(3):
            np.testing.assert_allclose(getattr(state.fields, name)[i].numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=0, atol=F64_ATOL, err_msg=name)


def test_sequential_sampling_is_duplicate_free_and_wraps():
    env = _env2d(20, bank_sampling="sequential", auto_reset=False)
    state, _ = env.reset(seed=3)
    assert _bank_index(env, state.fields).tolist() == list(range(20))
    env = _env2d(23, bank_sampling="sequential", auto_reset=False)
    state, _ = env.reset(seed=3)
    assert _bank_index(env, state.fields).tolist() == list(range(20)) + [0, 1, 2]


def test_random_sampling_visits_more_than_one_index_also_on_autoreset():
    env = _env2d(12, heater_duration=0.03, episode_length=0.03)  # truncates every step
    state, _ = env.reset(seed=4)
    first = _bank_index(env, state.fields)
    assert (first >= 0).all() and len(set(first.tolist())) > 1
    again, _ = env.reset(seed=4)
    assert torch.equal(_bank_index(env, again.fields), first)  # seeded
    zero = torch.zeros(12, 12, dtype=torch.float64)
    state, ts = env.step(state, zero)
    assert bool(ts.truncated.all())
    fresh = _bank_index(env, state.fields)
    assert (fresh >= 0).all() and len(set(fresh.tolist())) > 1
    assert not torch.equal(fresh, first)


def test_ic_noise_clamps_b_zeroes_wall_faces_and_decorrelates():
    eps = 0.05
    env = _env2d(4, bank_sampling="sequential", auto_reset=False, ic_noise=eps)
    env._bank.size = 1  # every env on bank state 0
    state, _ = env.reset(seed=5)
    f, p = state.fields, env.params
    bank = {n: a[0] for n, a in env._bank.arrays.items()}
    assert float(f.b.min()) >= p.min_b and float(f.b.max()) <= p.min_b + p.delta_b
    assert float(f.w[..., 0].abs().max()) == 0.0 and float(f.w[..., -1].abs().max()) == 0.0
    for name in ("u", "w", "b"):
        d = getattr(f, name) - bank[name]
        assert 0.0 < float(d.abs().max()) < 6 * eps, name
    assert not torch.equal(f.u[0], f.u[1])  # envs sharing a bank state differ
    torch.testing.assert_close(f.p_hy, hydrostatic_pressure(f.b, env.grid.dz, p.min_b),
                               rtol=0, atol=0)
    assert float(f.p_nhs.abs().max()) == 0.0


def test_sequential_with_autoreset_warns(caplog):
    with caplog.at_level(logging.WARNING):
        _env2d(2, bank_sampling="sequential")
    assert "auto_reset=False" in caplog.text
    with caplog.at_level(logging.WARNING):
        _env3d(2, bank_sampling="sequential")
    assert caplog.text.count("auto_reset=False") == 2


def test_3d_sequential_conflicts_with_checkpoint_idx():
    with pytest.raises(ValueError, match="conflict"):
        _env3d(2, bank_sampling="sequential", checkpoint_idx=3, auto_reset=False)
    with pytest.raises(ValueError, match="conflict"):
        JRBC3DVectorEnv(2, checkpoint=BANK_3D, bank_sampling="sequential", checkpoint_idx=3)


def test_step_from_a_bank_state_leaves_state_and_bank_unmodified():
    env = _env2d(2, heater_duration=0.06, episode_length=0.06, ic_noise=1e-3)
    state, _ = env.reset(seed=6)
    snapshot = [t.clone() for t in (*state.fields, state.t, state.step, state.key)]
    bank = {n: a.clone() for n, a in env._bank.arrays.items()}
    _, ts = env.step(state, torch.zeros(2, 12, dtype=torch.float64))
    assert bool(ts.truncated.all())  # the autoreset gathers from the bank
    for before, after in zip(snapshot, (*state.fields, state.t, state.step, state.key)):
        assert torch.equal(before, after)
    assert all(torch.equal(bank[n], env._bank.arrays[n]) for n in bank)


def test_every_2d_bank_is_divergence_free_to_its_rounding():
    """PARITY.md 1 on the port. The repo's 2D banks hold float32 values
    (stored as float64), so their divergence under the port's operator is
    bounded by float32 rounding (``chip_smoke.bank_div_atol``), not by
    float64 roundoff; a wrong staggering would give ~0.2."""
    paths = sorted(glob.glob("data/checkpoints/*/ckpt_ra*.h5"))
    assert len(paths) >= 21  # train, val and test, seven Ra each
    for path in paths:
        data = ckpt.load_bank_2d(path)
        atol = chip_smoke.bank_div_atol(data)
        assert atol < 2e-5, path  # float32 data: the rounding bound applies
        grid = Grid2D(nx=data.u.shape[1], nz=data.u.shape[2], lx=2 * np.pi, lz=2.0)
        f = Fields2D(torch.as_tensor(data.u), torch.as_tensor(data.w), None, None, None)
        assert max_divergence(f, grid) < atol, path
        assert float(np.abs(data.w[..., [0, -1]]).max()) == 0.0
    float64 = ckpt.CheckpointBank2D(b=None, u=data.u + 1e-9, w=data.w)
    assert chip_smoke.bank_div_atol(float64) == chip_smoke.BANK_DIV_ATOL


def test_one_float64_step_from_the_ra1e4_bank_stays_at_its_fixed_point():
    """PARITY.md 2: the reference-converged Ra=1e4 roll, one env step of
    50 substeps at dt 0.03 in float64, zero action: Nu 4.000 +- 0.005."""
    env = _env2d(1, bank_sampling="sequential", auto_reset=False)
    state, _ = env.reset(seed=0)
    _, ts = env.step(state, torch.zeros(1, 12, dtype=torch.float64))
    assert abs(float(ts.nusselt_state[0]) - 4.0) <= 0.005
