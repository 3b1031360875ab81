"""The port's control probes on the CPU.

The feedback laws on seeded observations equal a numpy transcription of
the JAX scripts' laws (scripts/probe_control2d.py:57-63,
scripts/probe_control3d.py:74-86); each probe's CLI runs at a tiny size
and prints lines in the format of the committed JAX logs
(results/probe2d_ra1000000.log, results/probe3d_ra500.log).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rbc_gym_tpu_torch.scripts import probe_control2d as pc2
from rbc_gym_tpu_torch.scripts import probe_control3d as pc3
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
LOG_2D = REPO / "results" / "probe2d_ra1000000.log"
LOG_3D = REPO / "results" / "probe3d_ra500.log"
FLOAT = r"-?\d+\.\d{4}"
PCT = r"[+-]\d+\.\d{2}%"
LINES_2D = [re.compile(rf"^zero-action Nu \(2nd half of \d+ steps\): {FLOAT}$"),
            re.compile(rf"^row=\d+ gain=[ \d]{{2}}\d\.\d: Nu={FLOAT}  "
                       rf"suppression vs zero = {PCT}$")]
LINES_3D = [re.compile(rf"^Ra=\S+ duration=\S+ burnin=\d+ zero-action Nu: {FLOAT}$"),
            re.compile(rf"^[Tw] row=[ \d]\d gain=[ +-]*\d+\.\d\d: Nu={FLOAT}  supp={PCT}$")]




def _dyadic_obs(seed, shape, lo, hi):
    """Observations on a grid of 2**-10: every sum the laws take is exact
    in float64, so torch's and numpy's reduction orders give the same bits
    and the laws must agree exactly."""
    rng = np.random.default_rng(seed)
    return rng.integers(int(lo * 1024), int(hi * 1024), shape) / 1024.0


def _law_2d_numpy(obs, gain, row, n_heaters):
    """scripts/probe_control2d.py:57-63 in numpy."""
    t_row = obs[:, 0, row, :]
    per_seg = t_row.shape[1] // n_heaters
    t_seg = t_row.reshape(t_row.shape[0], n_heaters, per_seg).mean(-1)
    fluct = t_seg - t_seg.mean(axis=-1, keepdims=True)
    return np.clip(-gain * fluct, -1.0, 1.0)


def _tiled_fluct_numpy(field2d, s):
    """scripts/probe_control3d.py:74-78 in numpy."""
    e, ny, nx = field2d.shape
    tiles = field2d.reshape(e, s, ny // s, s, nx // s).mean(axis=(2, 4))
    return tiles - tiles.mean(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("gain", [1.0, 30.0])
@pytest.mark.parametrize("row", [0, 1, 2, 4])
def test_2d_law_equals_the_jax_scripts(row, gain):
    obs = _dyadic_obs(row, (5, 3, 8, 48), 1.0, 2.75)
    got = pc2.law(torch.as_tensor(obs), gain, row, 12).numpy()
    np.testing.assert_array_equal(got, _law_2d_numpy(obs, gain, row, 12))
    assert got.shape == (5, 12) and (np.abs(got) <= 1.0).all()


@pytest.mark.parametrize("s", [8, 4])
def test_3d_laws_equal_the_jax_scripts(s):
    obs = _dyadic_obs(s, (3, 4, 16, 32, 32), -1.0, 2.0)
    t = torch.as_tensor(obs)
    for row in (1, 2, 4, 8):
        np.testing.assert_array_equal(pc3.tiled_fluct(t[:, 0, row], s).numpy(),
                                      _tiled_fluct_numpy(obs[:, 0, row], s))
        for gain in (0.3, -3.0, 10.0):
            want_t = np.clip(-gain * _tiled_fluct_numpy(obs[:, 0, row], s), -1.0, 1.0)
            want_w = np.clip(-gain * _tiled_fluct_numpy(obs[:, 3, row], s), -1.0, 1.0)
            np.testing.assert_array_equal(pc3.law_T(t, gain, row, s).numpy(), want_t)
            np.testing.assert_array_equal(pc3.law_w(t, gain, row, s).numpy(), want_w)


def test_line_formats_parse_the_committed_jax_logs():
    for log, formats, n in ((LOG_2D, LINES_2D, 17), (LOG_3D, LINES_3D, 33)):
        lines = [ln for ln in log.read_text().splitlines() if not ln.startswith("WARNING")]
        assert len(lines) == n
        assert formats[0].match(lines[0]) and all(formats[1].match(ln) for ln in lines[1:])


def _printed(capsys):
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("initial conditions: ")
    return lines[0], lines[1:]


def test_probe_2d_cli_prints_the_jax_lines(capsys):
    out = pc2.main(["--ra", "1000000", "--episodes", "2", "--n-steps", "1", "--gains", "30",
                    "--device", "cpu"])
    ic, lines = _printed(capsys)
    assert ic.endswith("assets/ckpt_ra1000000_test.npz")
    assert len(lines) == 1 + len(pc2.ROWS)
    assert LINES_2D[0].match(lines[0]) and all(LINES_2D[1].match(ln) for ln in lines[1:])
    assert set(out) == {"zero"} | {(row, 30.0) for row in pc2.ROWS}
    assert all(np.isfinite(v) for v in out.values())


def test_probe_3d_cli_prints_the_jax_lines(capsys):
    args = ["--ra", "500", "--episodes", "2", "--n-steps", "2", "--heater-duration", "0.0125",
            "--gains", "3.0", "--device", "cpu"]
    out = pc3.main(args)
    ic, lines = _printed(capsys)
    assert ic.endswith("assets/3D_ckpt_ra500_test.npz")
    assert len(lines) == 1 + 8  # zero, then T at rows 1, 2, 4 and w at row 8, both signs
    assert LINES_3D[0].match(lines[0]) and all(LINES_3D[1].match(ln) for ln in lines[1:])
    assert lines[0].startswith("Ra=500 duration=0.0125 burnin=0 ")
    assert ("w", 8, -3.0) in out and all(np.isfinite(v) for v in out.values())

    pc3.main(args + ["--no-bank", "--burnin", "1", "--segments", "4", "--heater-limit", "0.5"])
    ic, lines = _printed(capsys)
    assert ic == "initial conditions: random" and "burnin=1" in lines[0]


def test_probe_envs_take_the_flags():
    env = pc3.make_env(2, 500, 0.0125, None, segments=4, heater_limit=0.5, device="cpu")
    assert (env.params.n_heaters, env.params.heater_limit) == (4, 0.5)
    assert not env.auto_reset and env._bank is None
    assert list(pc3.sweep([1.0], 16)) == [("T", 1, 1.0), ("T", 1, -1.0), ("T", 2, 1.0),
                                          ("T", 2, -1.0), ("T", 4, 1.0), ("T", 4, -1.0),
                                          ("w", 8, 1.0), ("w", 8, -1.0)]
    env = pc2.make_env(2, 1e4, pc2.default_bank(1e4), device="cpu")
    assert env._bank is not None and not env.auto_reset
    assert Path(pc3.default_bank(2500)).exists()
