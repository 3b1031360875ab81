"""``utils/parity.py`` and the measurement scripts on the CPU.

The parity checks compare a kernel path with the plain path, which only
a card can do: here they must refuse the CPU by name (on the CPU both
sides would run the plain versions, and a 0.0 would prove nothing). The
scripts' argument parsing is the JAX scripts', and ``bench3d.run`` gives
a finite rate on the plain path.
"""

import math
from typing import NamedTuple

import pytest
import torch

from rbc_gym_tpu_torch.scripts import ablate3d, bench3d, probe_mxu_recon, smoke_times
from rbc_gym_tpu_torch.utils import parity


@pytest.mark.parametrize("check", [parity.fused_parity_2d, parity.fused_parity_3d])
def test_parity_refuses_the_cpu_by_name(check):
    with pytest.raises(ValueError, match=check.__name__):
        check(num_envs=1, device="cpu")


def test_max_abs_diff_over_named_fields():
    class F(NamedTuple):
        u: torch.Tensor
        w: torch.Tensor
        b: torch.Tensor

    a = F(torch.zeros(2, 3), torch.zeros(2, 4), torch.zeros(2, 3))
    b = F(torch.full((2, 3), 1e-6), torch.full((2, 4), -3e-6), torch.full((2, 3), 7.0))
    assert parity.max_abs_diff(a, b, ("u", "w")) == pytest.approx(3e-6)
    assert parity.max_abs_diff(a, b, ("u", "w", "b")) == 7.0


@pytest.mark.parametrize("path", ["stage", "stage_xy", "field"])
def test_bench3d_gates_a_kernel_path_before_timing(path, capsys):
    """``main`` runs ``fused_parity_3d`` before it times a kernel path, so
    on the CPU it stops at the gate's refusal and times nothing."""
    with pytest.raises(ValueError, match="fused_parity_3d"):
        bench3d.main([path, "1", "--device", "cpu"])
    assert "env-steps/s" not in capsys.readouterr().out


def test_env_steps_3d_starts_every_dtype_from_one_draw():
    """The float64 run starts from the float32 run's values, and the actions
    come from their own seed, so only the steps can differ."""
    f32, f64 = (parity.env_steps_3d((False,), 2, steps=0, state_shape=(8, 8, 8), device="cpu",
                                    seed=3, dtype=dtype)[0]
                for dtype in (torch.float32, torch.float64))
    for name in ("u", "v", "w", "b"):
        assert getattr(f64, name).dtype == torch.float64
        assert torch.equal(getattr(f64, name), getattr(f32, name).double())
    other = parity.env_steps_3d((False,), 2, steps=0, state_shape=(8, 8, 8), device="cpu",
                                seed=4)[0]
    assert not torch.equal(other.u, f32.u)


def test_env_steps_3d_paths_share_the_start():
    """On the CPU a forced kernel path runs the plain versions, so it and
    the plain path agree bit for bit from the shared start and actions."""
    plain, stage = parity.env_steps_3d((False, "stage"), 2, state_shape=(8, 8, 8),
                                       dt_solver=0.01, heater_duration=0.02, device="cpu")
    assert parity.max_abs_diff(plain, stage, ("u", "v", "w", "b", "p_nhs")) == 0.0
    assert bool(torch.isfinite(plain.u).all())


def test_smoke_times_stamps_each_phase(tmp_path, monkeypatch, capsys):
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "chip_smoke.py").write_text(
        'import json\nprint(json.dumps({"phase": "build", "seconds": 1.5}))\n'
        'print("NVIDIA H100 80GB HBM3, 700.00 W")\nprint(json.dumps({"ok": True}))\n')
    monkeypatch.chdir(tmp_path)
    assert smoke_times.main([str(tree), "change"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[4] for line in out[:3]] == ["build", "NVIDIA", "ok"]
    assert out[0].endswith(" 1.5") and out[-1].startswith("change rc=0 total=")
    logged = (tmp_path / "chiprun_out" / "change.log").read_text().splitlines()
    assert len(logged) == 3 and float(logged[0].split()[0]) >= 0.0


@pytest.mark.parametrize("module,argv,want", [
    (bench3d, [], {"path": "stage", "sizes": [1024, 4096], "device": "cuda"}),
    (bench3d, ["plain", "8", "16", "--device", "cpu"],
     {"path": "plain", "sizes": [8, 16], "device": "cpu"}),
    (bench3d, ["field", "1024"], {"path": "field", "sizes": [1024], "device": "cuda"}),
    (ablate3d, [], {"envs": 1024, "device": "cuda"}),
    (ablate3d, ["64", "--device", "cpu"], {"envs": 64, "device": "cpu"}),
    (probe_mxu_recon, [], {"envs": 1024, "device": "cuda"}),
    (probe_mxu_recon, ["256"], {"envs": 256, "device": "cuda"}),
])
def test_script_arguments(module, argv, want):
    assert vars(module.parse_args(argv)) == want


def test_bench3d_refuses_an_unknown_path():
    with pytest.raises(SystemExit):
        bench3d.parse_args(["xla"])


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on a few
    cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench3d_plain_rate_is_finite(one_torch_thread):
    lines = []
    rate = bench3d.run("plain", 2, steps=1, device="cpu", log=lines.append)
    assert math.isfinite(rate) and rate > 0
    assert lines and "env-steps/s" in lines[0]
