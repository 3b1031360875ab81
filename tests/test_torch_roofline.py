"""The port's roofline model against the JAX package's, and the per-kernel
bounds against PERF.md section 6.

``utils/roofline.py``'s whole-step model must count exactly the JAX
model's work (after the key mapping ``vpu`` -> ``elementwise``, ``mxu`` ->
``gemm``), so that a port bench line and a JAX line count the same work.
The per-kernel work counts, moved there from ``chip_smoke.py``, must give
the bounds PERF.md section 6 quotes, to every digit it quotes.
"""

import pytest

from rbc_gym_tpu.utils import roofline as jax_roofline
from rbc_gym_tpu_torch.sim.solver3d import SimParams3D
from rbc_gym_tpu_torch.utils import roofline
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

KEY_MAP = {
    "vpu_flops_per_env_step": "elementwise_flops_per_env_step",
    "mxu_flops_per_env_step": "gemm_flops_per_env_step",
    "min_hbm_bytes_per_env_step": "min_hbm_bytes_per_env_step",
    "n_substeps": "n_substeps",
}
COSTS = [
    ("2d", {}),
    ("2d", {"state_shape": (64, 128)}),
    ("3d", {}),
    ("3d", {"state_shape": (32, 64, 64), "dt_solver": 0.005}),  # factored solve
    ("3d", {"state_shape": (16, 32, 30)}),
    ("3d", {"heater_duration": 0.375, "dt_solver": 0.01}),  # 38 clipped substeps
    ("3d", {"heater_duration": 0.02}),
]


@pytest.mark.parametrize("dim,kwargs", COSTS)
def test_cost_equals_the_jax_model(dim, kwargs):
    jax_cost = getattr(jax_roofline, f"cost_{dim}")(**kwargs)
    port_cost = getattr(roofline, f"cost_{dim}")(**kwargs)
    assert port_cost == {KEY_MAP[k]: v for k, v in jax_cost.items()}


@pytest.mark.parametrize("kwargs", [kw for dim, kw in COSTS if dim == "3d"])
def test_cost_3d_substeps_are_the_solvers(kwargs):
    shape_free = {k: v for k, v in kwargs.items() if k != "state_shape"}
    assert roofline.cost_3d(**kwargs)["n_substeps"] == len(
        SimParams3D(**shape_free).substep_dts())


@pytest.mark.parametrize("cost", [roofline.cost_2d, roofline.cost_3d])
def test_cost_refuses_a_misspelt_keyword(cost):
    """A keyword the model does not read is an error, never the default
    grid's cost."""
    with pytest.raises(TypeError):
        cost(state_shap=(8, 8, 8))


def test_roofline_metrics_at_a_fixed_rate():
    cost = {"elementwise_flops_per_env_step": 6.7e8, "gemm_flops_per_env_step": 1.34e9,
            "min_hbm_bytes_per_env_step": 3.35e6, "n_substeps": 1}
    m = roofline.roofline_metrics(cost, 1000.0)
    assert m["achieved_fp32_tflops"] == pytest.approx(0.67)
    assert m["fp32_utilization_pct"] == pytest.approx(1.0)
    assert m["achieved_gemm_tflops"] == pytest.approx(1.34)
    assert m["gemm_utilization_pct"] == pytest.approx(2.0)
    assert m["min_hbm_gbps"] == pytest.approx(3.35)
    assert m["hbm_min_utilization_pct"] == pytest.approx(0.1)
    assert m["model_gemm_flops_per_env_step"] == 1.34e9
    assert "H100" in m["roofline_platform"] and "700 W" in m["roofline_platform"]
    assert "tpu" not in m["roofline_platform"].lower()
    assert roofline.roofline_metrics(cost, 0.0) == {}


# PERF.md section 6's bounds (ms at 1024 envs, as quoted) and the work each is of
BOUNDS = [
    ("K1", lambda: roofline.env_step_work(1024, 96, 64, 50), "10.127"),
    ("K1 split-product", lambda: roofline.env_step_work(1024, 96, 64, 50, "high"), "5.844"),
    ("K1 one-pass", lambda: roofline.env_step_work(1024, 96, 64, 50, "default"), "3.892"),
    ("K2", lambda: roofline.tendencies_own_work(1024, 96, 64), "0.0454"),
    *[(f"K3 stage {m}", lambda m=m: roofline.stage_rk_3d_work(1024, 32, 32, 16, m), want)
      for m, want in enumerate(("0.2855", "0.3668", "0.2855"))],
    ("K4", lambda: roofline.correct_3d_work(1024, 32, 32, 16), "0.1427"),
    ("K4 big grid", lambda: roofline.correct_3d_work(1024, 64, 64, 32), "1.132"),
    *[(f"K5 stage {m}", lambda m=m: roofline.stage_rk_3d_work(1024, 64, 64, 32, m), want)
      for m, want in enumerate(("2.264", "2.910", "2.264"))],
    *[(f"K6 {f}", lambda f=f: roofline.field_tendency_3d_work(1024, 32, 32, 16, f), want)
      for f, want in zip("uvwb", ("0.1014", "0.1014", "0.0826", "0.1027"))],
    ("K7", lambda: roofline.div_3d_work(1024, 32, 32, 16), "0.0814"),
]


@pytest.mark.parametrize("name,work,want", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_kernel_bounds_are_perf_mds(name, work, want):
    got, _ = roofline.bound(work())
    assert f"{got:.{len(want.split('.')[1])}f}" == want


@pytest.mark.parametrize("dim,shape,want", [
    ("2d", (64, 96), roofline.poisson_gemm_flops_per_point_2d(96, 64)),
    ("3d", (16, 32, 32), 4.0 * 32 * 16 + 4.0 * 32),  # dense: nx * nz < 1024
    ("3d", (32, 64, 64), 4.0 * (64 + 32) + 4.0 * 64),  # factored
])
def test_counted_poisson_gemms_are_the_closed_forms(dim, shape, want):
    got = roofline.torch_poisson_flops_per_point(dim, shape, device="cpu")
    assert got == want
    if dim == "3d":
        nz, ny, nx = shape
        assert roofline.poisson_gemm_flops_per_point_3d(nx, ny, nz) == want


@pytest.mark.parametrize("precision,passes", [("high", 3), ("default", 1)])
def test_k1_tf32_work_moves_the_solve_to_the_tensor_cores(precision, passes):
    """K1's TF32 instances do the float32 instance's work with the solve's
    products, 2 (2 nx^2 nz + nx nz^2) FLOP a stage, on the tensor cores,
    once for each pass; their bound adds those at the TF32 peak to the rest
    at the float32 one. "highest" is the float32 instance's work."""
    e, nx, nz, n_sub = 1024, 96, 64, 50
    f32 = roofline.env_step_work(e, nx, nz, n_sub)
    work = roofline.env_step_work(e, nx, nz, n_sub, precision)
    solve = e * n_sub * 3 * 2 * (2 * nx * nx * nz + nx * nz * nz)
    assert work["bytes"] == f32["bytes"] and work["flops"] + solve == f32["flops"]
    assert work["tf32_flops"] == passes * solve
    assert roofline.bound(work) == (pytest.approx(1e3 * (
        work["flops"] / roofline.FP32_FLOPS + passes * solve / roofline.TF32_FLOPS)),
        "operations")
    assert roofline.env_step_work(e, nx, nz, n_sub, "highest") == f32
    assert roofline.bound(f32)[0] == pytest.approx(1e3 * f32["flops"] / roofline.FP32_FLOPS)
