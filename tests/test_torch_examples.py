"""The port's example twins and launchers (``rbc_gym_tpu_torch/examples``,
``rbc_gym_tpu_torch/scripts/*.sh``, ``train_sa.sbatch``) on the CPU.

The checkpoint demo reads the same bank as the JAX gym env and prints the
same (t, Nu) within 1e-10 in float64; the other demos run at a tiny size
through their own functions with their printed lines; the bank launchers
write under OUT_DIR only and skip a bank present as .h5 or .npz; every
flag the sbatch twin passes parses in the port's ``run_sarl``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest
import torch

import rbc_gym_tpu  # noqa: F401  (registers the JAX gym IDs)
from rbc_gym_tpu.sim.solver2d import SimParams2D as JaxSimParams2D
from rbc_gym_tpu.utils import checkpoints as jckpt
from rbc_gym_tpu_torch.envs.single3d import RBC3DEnvCore
from rbc_gym_tpu_torch.examples import (
    run_2D,
    run_3D,
    run_checkpoint,
    run_ppo_native,
    run_vectorized,
    run_wandb,
    run_wrapped,
    timing,
)
from rbc_gym_tpu_torch.experiments import run_sarl
from rbc_gym_tpu_torch.sim.grid import Grid2D
from rbc_gym_tpu_torch.sim.solver2d import SimParams2D, make_solver2d
from rbc_gym_tpu_torch.utils.checkpoints import load_bank_2d, load_bank_3d

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "rbc_gym_tpu_torch" / "scripts"
JAX_ID = "rbc_gym/RayleighBenardConvection2D-v0"
SMALL = dict(state_shape=(16, 32), observation_shape=(8, 16), heater_duration=0.3)
BANK_EPISODES = 5
ATOL = 1e-10  # tests/test_torch_gym_env2d.py: float64, the same bank and actions
SPLITS = ("train", "test", "val")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on a few
    cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """A 5-episode bank at the small grid, written by the JAX package's
    writer (as tests/test_torch_gym_env2d.py builds it): random ICs of the
    port's solver after two plain float64 env steps."""
    nz, nx = SMALL["state_shape"]
    solver = make_solver2d(Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0),
                           SimParams2D(heater_duration=0.3), dtype=torch.float64,
                           device="cpu")
    f = solver.init_random(torch.Generator().manual_seed(5), (BANK_EPISODES,))
    for _ in range(2):
        f = solver.env_step(f, torch.zeros(BANK_EPISODES, 12, dtype=torch.float64))
    path = tmp_path_factory.mktemp("bank2d") / "ckpt_small.h5"
    jckpt.save_bank_2d(str(path), jckpt.CheckpointBank2D(
        b=f.b.numpy(), u=f.u.numpy(), w=f.w.numpy(), start_seed=5))
    return str(path)


def test_run_checkpoint_matches_the_jax_gym_env(bank, capsys):
    """Three zero-action steps from the same bank and seed: every printed
    t and Nu of the twin within 1e-10 of the JAX env's, and its lines are
    the JAX script's lines of the JAX env's values."""
    records = run_checkpoint.main(checkpoint=bank, episode_length=1.0, dtype="float64",
                                  device="cpu", **SMALL)
    lines = capsys.readouterr().out.splitlines()

    env = gym.make(JAX_ID, checkpoint=bank, episode_length=1.0, dtype="float64", **SMALL)
    obs, info = env.reset(seed=42)
    want = [(info["t"], info["nusselt_state"])]
    want_lines = [f"reset from bank: Nu_state={info['nusselt_state']:.3f} (turbulent)"]
    truncated = False
    while not truncated:
        obs, reward, terminated, truncated, info = env.step(
            np.zeros(env.action_space.shape, np.float32))
        want.append((info["t"], info["nusselt_state"]))
        want_lines.append(f"t={info['t']:5.1f} Nu={info['nusselt_state']:.3f}")
    env.close()
    assert len(records) == len(want) == 4
    np.testing.assert_allclose(np.array(records), np.array(want), rtol=0, atol=ATOL)
    assert lines == want_lines


def test_run_checkpoint_defaults_to_the_committed_bank(monkeypatch):
    monkeypatch.delenv("RBC_CHECKPOINT", raising=False)
    assert Path(run_checkpoint.DEFAULT_CHECKPOINT) == (
        REPO / "rbc_gym_tpu_torch" / "assets" / "ckpt_ra10000_train.npz")
    assert load_bank_2d(run_checkpoint.DEFAULT_CHECKPOINT).num_episodes == 20


def test_run_2D_observes_five_channels_with_pressure(monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    obs, info = run_2D.main(steps=2, device="cpu", **{**SMALL, "observation_shape": (8, 16)})
    assert obs.shape == (5, 8, 16) and np.isfinite(obs).all()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert all(re.fullmatch(r"t= +[0-9.]+ Nu_state=-?[0-9.]+ reward=-?[0-9.]+", x)
               for x in lines)


def test_run_3D_truncates_on_its_last_step(monkeypatch):
    monkeypatch.delenv("RBC3D_CHECKPOINT", raising=False)
    kwargs = dict(state_shape=(8, 8, 8), heater_duration=0.0125, episode_length=0.15)
    episode_steps = RBC3DEnvCore(rayleigh_number=2500, **kwargs, device="cpu").episode_steps
    assert episode_steps > 1
    steps, info, frame = run_3D.main(device="cpu", **kwargs)
    assert steps == episode_steps and info["step"] == episode_steps + 1
    assert np.isfinite(info["nusselt"])
    assert frame.ndim == 3 and frame.shape[-1] == 3


def test_run_wrapped_stacks_four_flat_observations(capsys):
    shape, steps = run_wrapped.main(episode_length=1.0, device="cpu", **SMALL)
    assert shape == (4, 3 * 8 * 16) and steps == 3
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"stacked obs shape: {shape}" and len(lines) == 1 + steps
    assert all(re.fullmatch(r"t= +[0-9.]+ reward=[+-][0-9.]+ cell_dist=[0-9.]+", x)
               for x in lines[1:])


def test_run_wandb_returns_0_without_wandb(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert run_wandb.main(device="cpu") == 0
    assert capsys.readouterr().out == "wandb is not installed; install it to run this demo.\n"


def test_run_wandb_runs_as_a_module_without_wandb():
    code = ("import sys, runpy; sys.modules['wandb'] = None; sys.argv = ['run_wandb', "
            "'--device', 'cpu']; runpy.run_module('rbc_gym_tpu_torch.examples.run_wandb', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "wandb is not installed; install it to run this demo.\n"


def test_run_vectorized_native_and_gymnasium_sync(capsys):
    rewards, rate = run_vectorized.native_lockstep(2, 2, device="cpu", **SMALL)
    assert rewards.shape == (2,) and np.isfinite(rewards).all() and rate > 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"native lockstep: 2 envs x 2 steps in [0-9.]+s \([0-9]+ env-steps/s\)",
                        lines[0])
    assert lines[1].startswith("rewards: [")
    # without the device reaching each sub-env they would default to CUDA
    # and raise here
    obs, rewards = run_vectorized.gymnasium_sync(2, 1, device="cpu", **SMALL)
    assert obs.shape == (2, 3, 8, 16) and rewards.shape == (2,)
    assert capsys.readouterr().out.startswith("gymnasium sync vec: (2, 3, 8, 16) [")


def test_timing_twin_native_and_gym(capsys):
    native = timing.time_native(2, 2, device="cpu", **{**SMALL, "heater_duration": 0.06})
    assert native["substeps"] == 2 and np.isfinite(native["rewards"]).all()
    gym_times = timing.time_gym_env(2, device="cpu", **{**SMALL, "heater_duration": 0.06})
    assert all(v > 0 for v in gym_times.values())
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"native vec \(2 envs\): [0-9.]+ us/env-step \(dt=0.06, 2 substeps\) "
                        r"-> [0-9]+x the reference's CPU time per unit of sim time", lines[0])
    assert re.fullmatch(r"gym env:   init [0-9.]+s \| reset [0-9.]+s \| step \(dt=0.06\) "
                        r"[0-9.]+s", lines[1])


def test_timing_heater_duration_is_the_multiple_of_dt_nearest_1():
    """The JAX script's 1.0 is no multiple of dt 0.03: both packages refuse
    it; the twin's 0.99 gives 33 substeps in both."""
    for params in (SimParams2D, JaxSimParams2D):
        with pytest.raises(ValueError, match="integer multiple"):
            params(heater_duration=1.0).substeps_per_env_step
        assert params(heater_duration=timing.HEATER_DURATION).substeps_per_env_step == 33


def test_run_ppo_native_trains_at_a_tiny_size(capsys):
    trainer, nusselt = run_ppo_native.main(num_envs=2, iterations=1, n_steps=2, n_epochs=1,
                                           n_minibatches=2, device="cpu",
                                           heater_duration=0.0125)
    assert trainer.global_step == 4 and len(nusselt.history) == 1
    assert np.isfinite(nusselt.best_nusselt)
    assert capsys.readouterr().out == f"best rollout nusselt: {nusselt.best_nusselt}\n"


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def _bash(script, env, *args, timeout=300):
    """``bash`` runs ``script`` with one torch thread and ``env`` over this
    process's environment."""
    proc = subprocess.run(["bash", str(SCRIPTS / script), *args],
                          env={**os.environ, "OMP_NUM_THREADS": "1", **env},
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.stat().st_mtime_ns for p in root.rglob("*")}


@pytest.mark.parametrize("script", ["create_checkpoints_2D.sh", "create_checkpoints_3D.sh",
                                    "fill_missing_banks.sh"])
def test_bank_launchers_default_to_an_ignored_directory(script):
    default = re.search(r'^OUT_DIR="\$\{OUT_DIR:-([^}]+)\}"$', (SCRIPTS / script).read_text(),
                        re.M).group(1)
    assert not Path(default).is_relative_to("data")
    ignored = subprocess.run(["git", "check-ignore", "-q", f"{default}/train/ckpt_ra10000.npz"],
                             cwd=REPO)
    assert ignored.returncode == 0


@pytest.mark.parametrize("dim", ["2D", "3D"])
def test_create_checkpoints_writes_under_out_dir_only(dim, tmp_path):
    """One Ra and one snapshot window on a small grid: the three splits
    under OUT_DIR with the launcher's seeds, nothing under data/checkpoints."""
    before = _tree(REPO / "data" / "checkpoints")
    three_d = dim == "3D"
    lines = _bash(f"create_checkpoints_{dim}.sh",
                  {"OUT_DIR": str(tmp_path), "DEVICE": "cpu", "FORMAT": "npz",
                   "RAS": "2500" if three_d else "10000",
                   "DURATION": "0.125" if three_d else "0.3", "PYTHON": sys.executable},
                  "--random_inits", "2", "--N", *(("8", "8", "8") if three_d else ("32", "16")))
    assert len(lines) == 3 and all(x.startswith("Saved 2 episodes to ") for x in lines)
    name = "3D_ckpt_ra2500.npz" if three_d else "ckpt_ra10000.npz"
    for split, seed in zip(SPLITS, (42, 62, 72)):
        data = (load_bank_3d if three_d else load_bank_2d)(tmp_path / split / name)
        assert data.num_episodes == 2 and data.start_seed == seed
        assert data.b.shape[1:] == ((8, 8, 8) if three_d else (32, 16))
        assert np.isfinite(data.b).all()
    assert _tree(REPO / "data" / "checkpoints") == before


def test_fill_missing_banks_skips_h5_and_npz_on_the_default_ladders(tmp_path):
    """Every bank of the default ladders present, as .h5 and .npz in turn:
    all skipped, nothing generated (PYTHON=false would fail the run)."""
    rungs = [("3D_ckpt_ra", ra) for ra in (2500, 500, 1000, 8000, 16000)] + [
        ("ckpt_ra", ra) for ra in (30000, 100000, 300000, 1000000, 3000000, 10000000)]
    want = []
    for i, (stem, ra) in enumerate(rungs):
        for j, split in enumerate(SPLITS):
            f = tmp_path / split / f"{stem}{ra}.{'h5' if (i + j) % 2 else 'npz'}"
            f.parent.mkdir(exist_ok=True)
            f.touch()
            want.append(f"skip {f}")
    lines = _bash("fill_missing_banks.sh", {"OUT_DIR": str(tmp_path), "PYTHON": "false"})
    assert lines == want + ["all banks present"]


def test_fill_missing_banks_generates_only_what_is_missing(tmp_path):
    (tmp_path / "train").mkdir()
    (tmp_path / "test").mkdir()
    (tmp_path / "train" / "ckpt_ra10000.h5").touch()
    (tmp_path / "test" / "ckpt_ra10000.npz").touch()
    lines = _bash("fill_missing_banks.sh",
                  {"OUT_DIR": str(tmp_path), "RAS_3D": "", "RAS_2D": "10000",
                   "DURATION_2D": "0.3", "DEVICE": "cpu", "PYTHON": sys.executable},
                  "--N", "32", "16", "--random_inits", "2")
    val = tmp_path / "val" / "ckpt_ra10000.npz"
    assert lines[:2] == [f"skip {tmp_path}/train/ckpt_ra10000.h5",
                         f"skip {tmp_path}/test/ckpt_ra10000.npz"]
    assert lines[2].startswith(f"Saved 2 episodes to {val} in ")
    assert lines[3:] == ["all banks present"]
    assert load_bank_2d(val).start_seed == 72


def test_train_sa_sbatch_flags_parse_in_run_sarl():
    """The twin of tests/test_experiments.py's sbatch round trip: every flag
    the launcher passes (its ARGS block and the conditional appends) parses
    in the port's run_sarl, with the JAX launcher's defaults and a card."""
    text = (SCRIPTS / "train_sa.sbatch").read_text()
    blocks = re.findall(r"ARGS\+?=\((.*?)\)", text, flags=re.S)
    flags = set(re.findall(r"(--[a-z_]+)", "\n".join(blocks)))
    assert flags == {"--output_dir", "--num_envs", "--iterations", "--n_steps", "--ra",
                     "--device", "--checkpoint", "--config", "--wandb", "--resume_training"}
    values = {"--output_dir": "/tmp/x", "--num_envs": "64", "--iterations": "200",
              "--n_steps": "96", "--ra": "2500", "--device": "cuda",
              "--checkpoint": "/tmp/bank.npz", "--config": "/tmp/cfg.yaml"}
    argv = []
    for f in sorted(flags):
        argv += [f, values[f]] if f in values else [f]
    args = run_sarl.parse_args(argv)
    assert (args.num_envs, args.iterations, args.n_steps, args.ra, args.device) == (
        64, 200, 96, 2500.0, "cuda")
    assert args.wandb and args.resume_training and args.checkpoint == "/tmp/bank.npz"
    for default in ('NUM_ENVS:-64', 'ITERATIONS:-200', 'N_STEPS:-96', 'RA:-2500',
                    'DEVICE:-cuda'):
        assert "${" + default + "}" in text
    assert "#SBATCH --gres=gpu:1" in text
    assert '"$PYTHON" -m rbc_gym_tpu_torch.experiments.run_sarl "${ARGS[@]}"' in text
