"""The port's bank generation against the JAX package's, on the CPU.

The burn-in loop, started from the JAX package's own random initial
fields (``init_random`` under ``fold_in(seed, i + 1)``), equals the JAX
package's ``generate_bank_2d``/``generate_bank_3d`` in float64 to 1e-10
(2D on 32x16, 3D on 8x8x8, 3 windows each). torch cannot replay those
keys, so the port's own initial fields are tested by their properties
(one generator an episode, seeded from ``(seed, i + 1)``). The split
constants are the JAX package's; generated banks round-trip through
``.npz`` and ``.h5`` (read back by both packages) and feed the vector
envs; the ``create_checkpoints`` twin keeps the JAX script's flags and
output names.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.sim import burnin as jburnin
from rbc_gym_tpu.sim import grid as jgrid
from rbc_gym_tpu.sim.solver2d import SimParams2D as JSimParams2D
from rbc_gym_tpu.sim.solver2d import make_solver2d as jmake_solver2d
from rbc_gym_tpu.sim.solver3d import SimParams3D as JSimParams3D
from rbc_gym_tpu.sim.solver3d import make_solver3d as jmake_solver3d
from rbc_gym_tpu.utils import checkpoints as jckpt
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.experiments import create_checkpoints
from rbc_gym_tpu_torch.sim import burnin
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
from rbc_gym_tpu_torch.sim.solver2d import Fields2D, SimParams2D, make_solver2d
from rbc_gym_tpu_torch.sim.solver3d import Fields3D, SimParams3D, make_solver3d
from rbc_gym_tpu_torch.utils import checkpoints as ckpt
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-10
WINDOWS = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several processes
    on a few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_initial_fields(solver, n, seed):
    """The JAX generators' initial fields (rbc_gym_tpu/sim/burnin.py:54-58)."""
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(1, n + 1))
    return jax.tree_util.tree_map(np.asarray, jax.vmap(lambda k: solver.init_random(k))(keys))


@pytest.mark.parametrize("three_d", [False, True])
def test_burn_in_from_jax_initial_fields_equals_jax(three_d):
    n, seed = 2, 42
    if three_d:
        kw = dict(dt_solver=0.01, random_kick=0.01, snapshot_interval=0.125)
        jg = jgrid.Grid3D(nx=8, ny=8, nz=8, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
        jsolver = jmake_solver3d(jg, JSimParams3D(ra=2500, heater_duration=0.125,
                                                  random_kick=0.01), dtype=jnp.float64)
        want = jburnin.generate_bank_3d(2500, n, seed, grid=jg, duration=WINDOWS * 0.125,
                                        dtype=jnp.float64, **kw)
        solver = make_solver3d(Grid3D(nx=8, ny=8, nz=8, lx=4 * np.pi, ly=4 * np.pi, lz=2.0),
                               SimParams3D(ra=2500, heater_duration=0.125), dtype=torch.float64,
                               device="cpu")
        cls, names = Fields3D, ("b", "u", "v", "w")
    else:
        kw = dict(dt_solver=0.03, random_kick=0.2, snapshot_interval=0.3)
        jg = jgrid.Grid2D(nx=32, nz=16, lx=2 * np.pi, lz=2.0)
        jsolver = jmake_solver2d(jg, JSimParams2D(ra=1e4, heater_duration=0.3, random_kick=0.2),
                                 dtype=jnp.float64)
        want = jburnin.generate_bank_2d(1e4, n, seed, grid=jg, duration=WINDOWS * 0.3,
                                        dtype=jnp.float64, **kw)
        solver = make_solver2d(Grid2D(nx=32, nz=16, lx=2 * np.pi, lz=2.0),
                               SimParams2D(ra=1e4, heater_duration=0.3), dtype=torch.float64,
                               device="cpu")
        cls, names = Fields2D, ("b", "u", "w")
    start = fields_from_numpy(_jax_initial_fields(jsolver, n, seed), cls=cls)
    got = burnin.burn_in(solver, start, WINDOWS)
    moved = 0.0
    for name in names:
        g = getattr(got, name).numpy()
        np.testing.assert_allclose(g, getattr(want, name), rtol=0, atol=ATOL, err_msg=name)
        moved = max(moved, float(np.abs(g - getattr(start, name).numpy()).max()))
    assert moved > 1e-3  # the windows did integrate


def test_split_constants_are_the_jax_packages():
    assert burnin.SPLIT_SEEDS == jburnin.SPLIT_SEEDS == {"train": 42, "test": 62, "val": 72}
    assert burnin.SPLIT_EPISODES == jburnin.SPLIT_EPISODES


def test_initial_fields_one_generator_an_episode():
    """Episode i's fields depend on (seed, i) only: a larger bank starts
    with the smaller one's episodes, another seed gives other fields, and
    no two episodes are equal."""
    solver = make_solver2d(Grid2D(nx=32, nz=16, lx=2 * np.pi, lz=2.0),
                           SimParams2D(random_kick=0.2), dtype=torch.float64, device="cpu")
    two, three = burnin.initial_fields(solver, 2, 42), burnin.initial_fields(solver, 3, 42)
    for a, b in zip(two, three):
        assert torch.equal(a, b[:2])
    assert not torch.equal(three.b[1], three.b[2]) and not torch.equal(three.u[0], three.u[1])
    assert not torch.equal(burnin.initial_fields(solver, 1, 62).b[0], two.b[0])
    assert float(three.w[..., 0].abs().max()) == float(three.w[..., -1].abs().max()) == 0.0


@pytest.mark.parametrize("three_d", [False, True])
def test_generated_bank_round_trips_and_feeds_the_env(tmp_path, three_d):
    if three_d:
        bank = burnin.generate_bank_3d(2500, 2, 42, grid=Grid3D(
            nx=8, ny=8, nz=8, lx=4 * np.pi, ly=4 * np.pi, lz=2.0), duration=0.25, device="cpu")
        shapes = {"b": (2, 8, 8, 8), "w": (2, 8, 8, 9)}
        names, save, load, jload = ("b", "u", "v", "w"), ckpt.save_bank_3d, ckpt.load_bank_3d, \
            jckpt.load_bank_3d
    else:
        bank = burnin.generate_bank_2d(1e4, 3, 42, grid=Grid2D(nx=32, nz=16, lx=2 * np.pi,
                                                               lz=2.0), duration=0.9,
                                       device="cpu")
        shapes = {"b": (3, 32, 16), "w": (3, 32, 17)}
        names, save, load, jload = ("b", "u", "w"), ckpt.save_bank_2d, ckpt.load_bank_2d, \
            jckpt.load_bank_2d
    assert {k: getattr(bank, k).shape for k in shapes} == shapes
    assert all(getattr(bank, n).dtype == np.float64 for n in names)
    assert not np.allclose(bank.b[0], bank.b[1])  # episodes are distinct
    for ext in ("h5", "npz"):
        path = str(tmp_path / f"bank.{ext}")
        save(path, bank)
        for loaded in (load(path), jload(path)):
            assert loaded.start_seed == 42
            for n in names:
                np.testing.assert_array_equal(getattr(loaded, n), getattr(bank, n))
    path = str(tmp_path / "bank.npz")
    if three_d:
        env = RBC3DVectorEnv(2, state_shape=(8, 8, 8), heater_duration=0.0125, checkpoint=path,
                             device="cpu")
        action = torch.zeros(2, 8, 8)
    else:
        env = RBC2DVectorEnv(2, state_shape=(16, 32), observation_shape=(8, 16),
                             heater_duration=0.3, checkpoint=path, device="cpu")
        action = torch.zeros(2, 12)
    state, _ = env.reset(seed=0)
    state, ts = env.step(state, action)
    assert bool(torch.isfinite(ts.reward).all())


def test_nan_guard_raises():
    with pytest.raises(FloatingPointError, match="NaN"):
        burnin.generate_bank_2d(1e4, 1, 0, grid=Grid2D(nx=8, nz=4, lx=2 * np.pi, lz=2.0),
                                duration=1e6, dt_solver=1e5, snapshot_interval=1e6,
                                device="cpu")


def _options(help_text: str) -> list:
    return sorted(set(re.findall(r"(--\w+)", help_text)) - {"--help"})


def test_create_checkpoints_keeps_the_jax_scripts_flags_and_names(tmp_path, capsys):
    jax_help = subprocess.run([sys.executable, "scripts/create_checkpoints.py", "--help"],
                              cwd=REPO, capture_output=True, text=True, timeout=120).stdout
    with pytest.raises(SystemExit):
        create_checkpoints.parse_args(["--help"])
    assert _options(capsys.readouterr().out) == sorted(_options(jax_help) + ["--device"])
    defaults = create_checkpoints.parse_args(["3d"])
    assert (defaults.dir, defaults.seed, defaults.random_inits, defaults.Pr, defaults.format,
            defaults.device) == ("data/checkpoints", 42, 1, 0.7, "h5", "cuda")

    path = create_checkpoints.main(["2d", "--dir", str(tmp_path), "--Ra", "10000",
                                    "--random_inits", "2", "--N", "32", "16", "--duration",
                                    "0.3", "--format", "npz", "--device", "cpu"])
    assert Path(path).name == "ckpt_ra10000.npz" and ckpt.load_bank_2d(path).num_episodes == 2
    path = create_checkpoints.main(["3d", "--dir", str(tmp_path), "--random_inits", "1",
                                    "--N", "8", "8", "8", "--duration", "0.125", "--device",
                                    "cpu"])
    assert Path(path).name == "3D_ckpt_ra2500.h5" and ckpt.load_bank_3d(path).b.shape == (
        1, 8, 8, 8)
