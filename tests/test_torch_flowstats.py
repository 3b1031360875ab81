"""The port's flow-statistics twins against the JAX package, on the CPU.

The 3D statistics step both envs from the same float64 fields and agree
to 1e-10; the 2D sweep starts both packages from a one-state bank, so
both draw the same initial state, and agrees in float32 to 1e-5 relative;
the twin CLIs write the JAX scripts' record layouts; the fits twin on the
repo's sweep pickle reproduces the JAX fit to 1e-12. The JAX scripts are
loaded from their files under their own module names.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rbc_gym_tpu.envs.vector3d import EnvState3D as JEnvState3D
from rbc_gym_tpu.envs.vector3d import RBC3DVectorEnv as JRBC3DVectorEnv
from rbc_gym_tpu.sim import solver3d as jsolver
from rbc_gym_tpu.utils import checkpoints as jckpt
from rbc_gym_tpu_torch.envs.autoreset import seed_keys
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import EnvState3D, RBC3DVectorEnv
from rbc_gym_tpu_torch.experiments.flowstats import flowstats_fits as fits
from rbc_gym_tpu_torch.experiments.flowstats import flowstats_ra as fs3d
from rbc_gym_tpu_torch.experiments.flowstats import flowstats_ra_2d as fs2d
from rbc_gym_tpu_torch.sim import solver3d as s3d
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
from rbc_gym_tpu_torch.sim.solver2d import Fields2D, max_divergence
from rbc_gym_tpu_torch.sim.solver3d import Fields3D
from rbc_gym_tpu_torch.utils import checkpoints as ckpt
from rbc_gym_tpu_torch.utils import convert
from rbc_gym_tpu_torch.utils.interop import fields_from_numpy
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
JAX_DIR = REPO / "experiments" / "flowstats"
TINY_3D = dict(state_shape=(8, 16, 16), dt_solver=0.01, heater_duration=0.125)
TINY_CLI_3D = ["--state_shape", "8", "8", "8", "--dt_solver", "0.01",
               "--heater_duration", "0.0125", "--device", "cpu"]


def _jax_script(name):
    """A JAX script of experiments/flowstats as module ``jax_<name>``."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", JAX_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module




def _np_fields_3d(n, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = TINY_3D["state_shape"]
    u = 0.05 * rng.standard_normal((n, nx, ny, nz))
    v = 0.05 * rng.standard_normal((n, nx, ny, nz))
    w = 0.05 * rng.standard_normal((n, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    z_c = (np.arange(nz) + 0.5) * 2.0 / nz
    b = np.clip(1.0 + (2.0 - z_c) / 2.0 + 0.05 * rng.standard_normal(u.shape), 1.0, 2.0)
    p_hy = np.asarray(jsolver._hydrostatic_pressure_3d(jnp.asarray(b), 2.0 / nz, 1.0))
    return jsolver.Fields3D(u, v, w, b, p_hy, np.zeros_like(u))


def test_3d_statistics_match_jax_from_shared_fields():
    """flowstats_ra.py:46-49's reductions over the JAX env's steps and the
    twin's ``run_stats`` from the same float64 fields: 2 envs, 3 steps of
    13 substeps on 8x16x16, to 1e-10."""
    n, steps = 2, 3
    jenv = JRBC3DVectorEnv(n, rayleigh_number=500, **TINY_3D, episode_length=10**9,
                           dtype=jnp.float64)
    env = fs3d.make_env(500, num_envs=n, device="cpu", dtype=torch.float64, **TINY_3D)
    f = _np_fields_3d(n, seed=0)
    jstate = JEnvState3D(fields=jax.tree_util.tree_map(jnp.asarray, f), t=jnp.zeros(n),
                         step=jnp.ones(n, jnp.int32),
                         key=jax.random.split(jax.random.PRNGKey(0), n))
    state = EnvState3D(fields=fields_from_numpy(f, cls=Fields3D),
                       t=torch.zeros(n, dtype=torch.float64),
                       step=torch.ones(n, dtype=torch.int32), key=seed_keys(0, n))
    actions = jnp.zeros((n, 8, 8))

    @jax.jit
    def step_stats(state):  # experiments/flowstats/flowstats_ra.py:44-50
        state, ts = jenv.step(state, actions)
        o = ts.obs
        maxima = jnp.max(jnp.abs(o), axis=(0, 2, 3, 4))
        return state, ts.nusselt.mean(), maxima

    want = {"nusselt": [], "max_u": [], "max_v": [], "max_w": []}
    for _ in range(steps):
        jstate, nus, maxima = step_stats(jstate)
        want["nusselt"].append(float(nus))
        for c, k in ((1, "max_u"), (2, "max_v"), (3, "max_w")):
            want[k].append(float(maxima[c]))
    end, got = fs3d.run_stats(env, state, steps)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10, err_msg=k)
    assert len(set(got["nusselt"])) == steps  # the flow moved
    assert not bool(torch.equal(end.fields.b, state.fields.b))
    np.testing.assert_allclose(end.t.numpy(), np.asarray(jstate.t), rtol=0, atol=1e-12)


def test_2d_sweep_matches_jax_from_a_one_state_bank(tmp_path):
    """``perform_experiment`` of flowstats_ra_2d.py and of the twin, both
    from ``ckpt_ra30000.h5`` in a tmp dir holding one episode of the
    repo's Ra=3e4 train bank (so both draw it), 2 envs, 2 steps at 96x64
    in float32: the per-step Nu and maxima to 1e-5 relative."""
    bank = jckpt.load_bank_2d(str(REPO / "data/checkpoints/train/ckpt_ra30000.h5"))
    one = jckpt.CheckpointBank2D(b=bank.b[:1], u=bank.u[:1], w=bank.w[:1], start_seed=3)
    jckpt.save_bank_2d(str(tmp_path / "ckpt_ra30000.h5"), one)
    want = _jax_script("flowstats_ra_2d").perform_experiment(30_000, 2, 2, 0, str(tmp_path))
    got = fs2d.perform_experiment(30_000, 2, 2, 0, str(tmp_path), device="cpu")
    assert got["from_bank"] is True and want["from_bank"] is True
    assert set(got) == set(want)
    for k in ("nusselt", "max_u", "max_w"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    assert fs2d.bank_path(30_000, str(tmp_path)) == str(tmp_path / "ckpt_ra30000.h5")
    assert fs2d.bank_path(20_000, str(tmp_path)) is None
    assert fs2d.bank_path(30_000).endswith("assets/ckpt_ra30000_train.npz")


def test_3d_cli_writes_the_jax_layout_and_replaces_by_ra(tmp_path, capsys):
    out = tmp_path / "fs.pkl"
    fs3d.main(["--ra", "500", "--steps", "2", *TINY_CLI_3D, "--out", str(out)])
    with open(out, "rb") as f:
        first = pickle.load(f)
    summary = fs3d.main(["--ra", "500", "750", "--steps", "3", *TINY_CLI_3D, "--out", str(out)])
    with open(out, "rb") as f:
        records = pickle.load(f)
    with open(JAX_DIR / "flowstats_ra.pkl", "rb") as f:
        jax_records = pickle.load(f)
    assert [r["ra"] for r in records] == [500, 750]
    assert all(set(r) == set(jax_records[0]) for r in records + first)
    assert all(len(r[k]) == 3 for r in records for k in ("nusselt", "max_u", "max_v", "max_w"))
    assert len(first[0]["nusselt"]) == 2  # replaced by the second run's 3 steps
    assert all(np.isfinite(r[k]).all() for r in records for k in r if k != "ra")
    with open(str(out).replace(".pkl", ".json")) as f:
        written = json.load(f)
    with open(JAX_DIR / "flowstats_ra.json") as f:
        jax_summary = json.load(f)
    assert written == summary and list(written) == ["500", "750"]
    assert all(set(v) == set(jax_summary["500"]) for v in written.values())
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("Ra=750: Nu=") and "max|w|=" in line for line in lines)


def test_2d_cli_writes_the_jax_protocol_and_keys(tmp_path):
    out = tmp_path / "fs2d.json"
    args = ["--steps", "2", "--tail", "1", "--num_envs", "1", "--device", "cpu", "--out", str(out)]
    fs2d.main(["--ra", "10000", *args])
    fs2d.main(["--ra", "30000", *args])
    with open(out) as f:
        written = json.load(f)
    with open(JAX_DIR / "flowstats_ra_2d.json") as f:
        jax_record = json.load(f)
    assert set(written) == {"protocol", "points"}
    assert set(written["protocol"]) == set(jax_record["protocol"])
    assert written["protocol"] == {**jax_record["protocol"], "steps": 2, "tail": 1, "num_envs": 1}
    assert list(written["points"]) == ["10000", "30000"]  # the second run kept the first point
    for pt in written["points"].values():
        assert set(pt) == set(jax_record["points"]["10000"]) and pt["from_bank"] is True
    assert abs(written["points"]["10000"]["nu_mean"] - 4.0) < 0.02  # the bank's fixed point


def test_fits_twin_reproduces_the_jax_fit(tmp_path):
    """The repo's sweep pickle through the twin and through the JAX script
    (run here), and the committed JAX fit: equal to 1e-12."""
    pkl = JAX_DIR / "flowstats_ra.pkl"
    with open(pkl, "rb") as f:
        got = fits.fit(pickle.load(f))
    out = tmp_path / "fits.json"
    subprocess.run([sys.executable, str(JAX_DIR / "flowstats_fits.py"), "--pkl", str(pkl),
                    "--out", str(out)], check=True, cwd=REPO, capture_output=True)
    with open(out) as f:
        here = json.load(f)
    with open(JAX_DIR / "flowstats_fits.json") as f:
        committed = json.load(f)

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    for want in (here, committed):
        a, b = dict(flat(got)), dict(flat(want))
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-12 * max(1.0, abs(b[k])), k


def test_fits_cli_writes_json_and_plot(tmp_path):
    pkl = tmp_path / "fs.pkl"
    with open(JAX_DIR / "flowstats_ra.pkl", "rb") as f:
        records = pickle.load(f)
    with open(pkl, "wb") as f:
        pickle.dump(records, f)
    result = fits.main(["--pkl", str(pkl), "--out", str(tmp_path / "fits.json"), "--plot"])
    with open(tmp_path / "fits.json") as f:
        assert json.load(f) == result
    assert (tmp_path / "fs_fits.png").stat().st_size > 0
    assert abs(result["w_max_hill"]["ra_c"] - 665.0798543710846) < 1e-6


def test_run_flowstats_script_sweeps_a_process_per_ra_then_fits(tmp_path):
    env = {**os.environ, "DEVICE": "cpu", "RAS": "500 750 1000", "STEPS": "2",
           "OUT_DIR": str(tmp_path), "PYTHON": sys.executable, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        ["bash", str(REPO / "rbc_gym_tpu_torch/scripts/run_flowstats.sh"), "--state_shape",
         "8", "8", "8", "--dt_solver", "0.01", "--heater_duration", "0.0125"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert sum(line.startswith("Ra=") for line in proc.stdout.splitlines()) == 3
    with open(tmp_path / "flowstats_ra_torch.pkl", "rb") as f:
        assert [r["ra"] for r in pickle.load(f)] == [500, 750, 1000]
    with open(tmp_path / "flowstats_fits_torch.json") as f:
        assert set(json.load(f)) == {"nu_power_law", "w_max_hill", "points"}
    assert (tmp_path / "flowstats_ra_torch.json").exists()


@pytest.mark.parametrize("heater_duration", [0.0125, 1.5])
def test_a_billion_time_units_never_truncate(heater_duration):
    """episode_length=10**9, as the sweeps pass it: in 2D at the default
    step and in 3D at a short one, where the episode has more steps than an
    int32 holds, no env truncates and t grows."""
    if heater_duration == 1.5:
        env = RBC2DVectorEnv(1, state_shape=(16, 32), observation_shape=(8, 16),
                             episode_length=10**9, heater_duration=0.06, device="cpu")
        action = torch.zeros(1, 12)
    else:
        env = RBC3DVectorEnv(1, state_shape=(8, 8, 8), episode_length=10**9,
                             heater_duration=heater_duration, device="cpu")
        action = torch.zeros(1, 8, 8)
        assert env.episode_steps > torch.iinfo(torch.int32).max
    state, _ = env.reset(seed=0)
    for _ in range(2):
        state, ts = env.step(state, action)
        assert not bool(ts.truncated.any())
    assert int(state.step[0]) == 3 and float(state.t[0]) > 0.0


BANK_ASSETS = sorted(a for a in convert.ASSETS if "ckpt" in a)


@pytest.mark.parametrize("asset", BANK_ASSETS)
def test_bank_assets_read_back_divergence_free_to_their_rounding(asset):
    """Every bank in assets/ read back by the port and held to its float32
    rounding: ``chip_smoke.bank_div_atol`` in 2D; in 3D the same bound
    with the y term (two float32 ulps of each max |velocity| over its
    spacing)."""
    path = convert.ASSET_DIR / asset
    eps = float(np.finfo(np.float32).eps)
    if asset.startswith("3D_"):
        data = ckpt.load_bank_3d(path)
        nx, ny, nz = data.u.shape[1:]
        grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
        f = Fields3D(*(torch.as_tensor(getattr(data, n), dtype=torch.float64)
                       for n in ("u", "v", "w", "b")), None, None)
        atol = 2 * eps * (float(np.abs(data.u).max()) / grid.dx
                          + float(np.abs(data.v).max()) / grid.dy
                          + float(np.abs(data.w).max()) / grid.dz)
        div = s3d.max_divergence_3d(f, grid)
    else:
        data = ckpt.load_bank_2d(path)
        grid = Grid2D(nx=data.u.shape[1], nz=data.u.shape[2], lx=2 * np.pi, lz=2.0)
        f = Fields2D(*(torch.as_tensor(getattr(data, n), dtype=torch.float64)
                       for n in ("u", "w", "b")), None, None)
        atol = chip_smoke.bank_div_atol(data)
        div = max_divergence(f, grid)
    assert data.num_episodes in (10, 20) and atol < 2e-5
    assert div < atol, (asset, div, atol)
    assert float(np.abs(data.w[..., [0, -1]]).max()) == 0.0
