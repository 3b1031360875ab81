"""``utils/flopcount.py`` against the JAX package's jaxpr count.

The same env step, the plain PyTorch path of the port and the JAX
package's ``fused=False`` XLA path, counted by each package's
``count_fn_flops`` on small grids: GEMM FLOP equal to each other and to
the solve's closed form, elementwise FLOP within 1 %. The remaining gap
(the port counts 0.4 % less in 2D, 0.7 % in 3D) is the pHY' suffix sums
(cat, mul, add, cumsum, neg) that the JAX XLA substep recomputes at the
end of every substep, where the port computes pHY' once an env step, and
in 3D the mul and div of the JAX path's per-stage projection scaling
(div / dt_stage, dt_stage * grad p), which the port's lazy projection,
with its unscaled solve, does not need.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbc_gym_tpu.sim.grid import Grid2D as JaxGrid2D
from rbc_gym_tpu.sim.grid import Grid3D as JaxGrid3D
from rbc_gym_tpu.sim.solver2d import Fields2D as JaxFields2D
from rbc_gym_tpu.sim.solver2d import SimParams2D as JaxParams2D
from rbc_gym_tpu.sim.solver2d import make_solver2d as jax_solver2d
from rbc_gym_tpu.sim.solver3d import Fields3D as JaxFields3D
from rbc_gym_tpu.sim.solver3d import SimParams3D as JaxParams3D
from rbc_gym_tpu.sim.solver3d import make_solver3d as jax_solver3d
from rbc_gym_tpu.utils.flopcount import count_fn_flops as jax_count
from rbc_gym_tpu_torch.ops import kernels3d
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
from rbc_gym_tpu_torch.sim.solver2d import Fields2D, SimParams2D, make_solver2d
from rbc_gym_tpu_torch.sim.solver3d import Fields3D, SimParams3D, make_solver3d
from rbc_gym_tpu_torch.utils.flopcount import count_fn_flops


def _zero_fields(jax_cls, torch_cls, shapes):
    """Zero fields of ``shapes`` for both packages: a count depends on the
    shapes only."""
    return (jax_cls(*(jnp.zeros(s, jnp.float32) for s in shapes)),
            torch_cls(*(torch.zeros(s) for s in shapes)))


def _counts_2d(nz=16, nx=24, envs=2, heater_duration=0.09):
    """(JAX counts, port counts, points * stages, the solve's GEMM closed
    form) for the 2D env step (3 substeps)."""
    grid = dict(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
    js = jax_solver2d(JaxGrid2D(**grid), JaxParams2D(heater_duration=heater_duration),
                      dtype=jnp.float32, fused=False)
    params = SimParams2D(heater_duration=heater_duration)
    ps = make_solver2d(Grid2D(**grid), params, dtype=torch.float32, device="cpu", fused=False)
    cells = (envs, nx, nz)
    jf, pf = _zero_fields(JaxFields2D, Fields2D,
                          (cells, (envs, nx, nz + 1), cells, cells, cells))
    jc = jax_count(js.env_step, jf, jnp.zeros((envs, 12), jnp.float32))
    pc = count_fn_flops(ps.env_step, pf, torch.zeros(envs, 12))
    return jc, pc, nx * nz * envs * 3 * params.substeps_per_env_step, 2.0 * (2 * nx + nz)


def _counts_3d(nz=8, ny=8, nx=16, envs=1, heater_duration=0.02):
    """The same for the 3D env step (2 substeps, the dense solve)."""
    grid = dict(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    js = jax_solver3d(JaxGrid3D(**grid), JaxParams3D(heater_duration=heater_duration),
                      dtype=jnp.float32, fused=False)
    params = SimParams3D(heater_duration=heater_duration)
    ps = make_solver3d(Grid3D(**grid), params, dtype=torch.float32, device="cpu", fused=False)
    cells = (envs, nx, ny, nz)
    jf, pf = _zero_fields(JaxFields3D, Fields3D,
                          (cells, cells, (envs, nx, ny, nz + 1), cells, cells, cells))
    jc = jax_count(js.env_step, jf, jnp.zeros((envs, 8, 8), jnp.float32))
    pc = count_fn_flops(ps.env_step, pf, torch.zeros(envs, 8, 8))
    stages = 3 * len(params.substep_dts())
    return jc, pc, nx * ny * nz * envs * stages, 4.0 * nx * nz + 4.0 * ny


@pytest.mark.parametrize("counts", [_counts_2d, _counts_3d], ids=["2d", "3d"])
def test_plain_step_counts_the_jax_xla_paths_work(counts):
    jc, pc, per, gemm_closed_form = counts()
    assert not pc["unknown_ops"] and not jc.get("unknown_prims")
    assert pc["gemm"] == jc["mxu"]
    assert pc["gemm"] / per == gemm_closed_form
    assert pc["elementwise"] == pytest.approx(jc["vpu"], rel=0.01)


def test_unknown_ops_are_reported():
    x = torch.linspace(-1.0, 1.0, 12)
    got = count_fn_flops(lambda t: torch.erf(t) + t, x)
    assert got["unknown_ops"] == {"aten.erf"}
    assert got["elementwise"] == 12


@pytest.mark.parametrize("name,fn,want", [
    ("in-place", lambda a, b: a.clone().add_(b).mul_(2.0), 2),
    ("out=", lambda a, b: torch.mul(a, b, out=torch.empty_like(a)), 1),
    ("alpha", lambda a, b: torch.sub(a, b, alpha=2.0), 2),
    ("addcmul", lambda a, b: torch.addcmul(a, a, b, value=0.5), 3),
    ("lerp", lambda a, b: torch.lerp(a, b, 0.25), 3),
    ("cumsum", lambda a, b: torch.cumsum(a, 0), 1),
    ("select", lambda a, b: torch.where(a > b, a, b).flip(0).clamp(0.0, 1.0), 0),
])
def test_elementwise_conventions(name, fn, want):
    a, b = torch.rand(5, 7), torch.rand(5, 7)
    got = count_fn_flops(fn, a, b)
    assert got["elementwise"] == want * a.numel() and not got["unknown_ops"]


def test_gemm_is_2mnk():
    a, b = torch.rand(3, 4, 5), torch.rand(5, 6)
    got = count_fn_flops(torch.matmul, a, b)
    assert got["gemm"] == 2 * 3 * 4 * 6 * 5 and got["elementwise"] == 0


def test_a_kernel_launch_during_a_count_raises(monkeypatch):
    monkeypatch.setattr(kernels3d.stage_rk_3d, "launches", 0)

    def stub():
        kernels3d.stage_rk_3d.launches += 1

    with pytest.raises(ValueError, match="stage_rk_3d"):
        count_fn_flops(stub)
