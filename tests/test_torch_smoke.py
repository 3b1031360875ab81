"""Rehearse the card run of ``chip_smoke.py`` on the CPU.

Everything but the kernel launches runs here: the port imports with jax,
gymnasium, h5py and rbc_gym_tpu refused; the smoke's phases run at a tiny
size on their plain halves; the script refuses to run without a card; the
build command targets sm_90a into a git-ignored directory; and every
exported C function has its ctypes signature declared.
"""

import ast
import ctypes
import json
import re
import shutil
import sys
import textwrap
from pathlib import Path

import pytest

import chip_smoke
from rbc_gym_tpu_torch.ops import _build

from torch_smoke_common import PACKAGE, REPO, _run
from torch_smoke_common import one_thread_a_module  # noqa: F401 (autouse)

# the host-only modules: gymnasium types, or gym demos, so they need
# gymnasium at import
GYM_MODULES = (
    "rbc_gym_tpu_torch.envs.gym_vector",
    "rbc_gym_tpu_torch.envs.rbc2d",
    "rbc_gym_tpu_torch.envs.rbc3d",
    "rbc_gym_tpu_torch.examples.run_2D",
    "rbc_gym_tpu_torch.examples.run_3D",
    "rbc_gym_tpu_torch.examples.run_checkpoint",
    "rbc_gym_tpu_torch.examples.run_wandb",
    "rbc_gym_tpu_torch.examples.run_wrapped",
    "rbc_gym_tpu_torch.wrappers.rbc_normalize_observation",
    "rbc_gym_tpu_torch.wrappers.rbc_normalize_reward",
    "rbc_gym_tpu_torch.wrappers.rbc_reward_shaping",
)
# the card-side example twins import gymnasium only inside these functions
GYM_FUNCTIONS = {
    "rbc_gym_tpu_torch/examples/run_vectorized.py": {"gymnasium_sync"},
    "rbc_gym_tpu_torch/examples/timing.py": {"time_gym_env"},
}


def test_port_imports_with_reference_stack_refused():
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {"jax", "jaxlib", "gymnasium", "h5py", "rbc_gym_tpu"}
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"refused import of {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        import rbc_gym_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            rbc_gym_tpu_torch.__path__, "rbc_gym_tpu_torch.")]
        refused = []
        for name in names:
            try:
                importlib.import_module(name)
            except ImportError as e:
                assert "refused import of gymnasium" in str(e), (name, e)
                refused.append(name)
        import chip_smoke
        print(len(names), " ".join(sorted(refused)))
    """)
    proc = _run([sys.executable, "-c", code])
    assert proc.returncode == 0, proc.stderr
    count, *refused = proc.stdout.split()
    assert int(count) >= 12
    # the host-only gymnasium modules, and nothing else, need gymnasium
    assert refused == sorted(GYM_MODULES)


def _functions_importing(path: Path, module: str) -> set:
    """The names of the functions of ``path`` whose bodies import ``module``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for inner in ast.walk(node):
                imported = ([a.name for a in inner.names] if isinstance(inner, ast.Import)
                            else [inner.module] if isinstance(inner, ast.ImportFrom) else [])
                if any(m and m.split(".")[0] == module for m in imported):
                    names.add(node.name)
    return names


def test_no_reference_stack_imports_in_port_sources():
    """No jax stack anywhere; gymnasium only in the host-only gym modules
    (at their top), in the package's registration (inside a function,
    where it may be missing) and in the card-side example twins' gym
    functions (``GYM_FUNCTIONS``); h5py (and msgpack, yaml, wandb,
    matplotlib, pyvista, imageio, pygame) only inside the host functions
    that use them, never at a module's top level."""
    jax_stack = re.compile(r"^\s*(import|from) (jax|flax|optax|rbc_gym_tpu)\b", re.M)
    gym_any = re.compile(r"^\s*(import|from) gymnasium\b", re.M)
    gym_top = re.compile(r"^(import|from) gymnasium\b", re.M)
    top_level = re.compile(
        r"^(import|from) (h5py|msgpack|yaml|wandb|matplotlib|pyvista|imageio|pygame)\b", re.M)
    files = [f for f in sorted(PACKAGE.rglob("*.py"))
             if "_build" not in f.relative_to(PACKAGE).parts] + [REPO / "chip_smoke.py"]
    gym_files = sorted(PACKAGE.parent / (m.replace(".", "/") + ".py") for m in GYM_MODULES)
    texts = {f: f.read_text() for f in files}
    assert not [f for f in files if jax_stack.search(texts[f])]
    assert [f for f in files if gym_top.search(texts[f])] == gym_files
    gym_inside = [REPO / f for f in GYM_FUNCTIONS]
    assert [f for f in files if gym_any.search(texts[f])] == sorted(
        gym_files + gym_inside + [PACKAGE / "__init__.py"])
    for f, functions in GYM_FUNCTIONS.items():
        assert _functions_importing(REPO / f, "gymnasium") == functions
    assert not [f for f in files if top_level.search(texts[f])]


def test_smoke_rl_config_is_the_trained_policys():
    """The smoke trains and evaluates at results/sarl2d_ra10000's config."""
    import yaml

    from rbc_gym_tpu_torch.experiments.run_sarl_2d import DEFAULT_CONFIG

    with open(REPO / "results" / "sarl2d_ra10000" / "config.yaml") as f:
        trained = yaml.safe_load(f)
    smoke = {**DEFAULT_CONFIG, **chip_smoke.SARL2D_RA10000}
    assert {k: smoke[k] for k in trained} == trained
    assert set(smoke) - set(trained) == {"rl_shared_trunk"} and not smoke["rl_shared_trunk"]


def test_smoke_3d_rl_config_is_the_trained_policys():
    """The 3D smoke trains and evaluates at results/sarl_ra2500's config,
    which is experiments/configs/sarl3d_ra2500.yaml."""
    import yaml

    from rbc_gym_tpu_torch.experiments.run_sarl import DEFAULT_CONFIG

    with open(REPO / "results" / "sarl_ra2500" / "config.yaml") as f:
        trained = yaml.safe_load(f)
    with open(REPO / "experiments" / "configs" / "sarl3d_ra2500.yaml") as f:
        assert yaml.safe_load(f) == {k: v for k, v in trained.items()
                                     if k not in ("rbc_checkpoint_idx", "rl_stat_window_size")}
    smoke = {**DEFAULT_CONFIG, **chip_smoke.SARL3D_RA2500}
    assert {k: smoke[k] for k in trained} == trained
    assert set(smoke) - set(trained) == {"rl_share_features_extractor"}
    assert not smoke["rl_share_features_extractor"]


def test_field_bounds():
    """K6 and K7 at 1024 envs on 16x32x32 move more bytes than their FLOP
    hide: 339,738,624 bytes for gu and gv, 276,824,064 for gw, 343,932,928
    for gb and 272,629,760 for div."""
    works = {f: chip_smoke.field_tendency_3d_work(1024, 32, 32, 16, f) for f in "uvwb"}
    assert [works[f]["bytes"] for f in "uvwb"] == [339_738_624, 339_738_624, 276_824_064,
                                                   343_932_928]
    div = chip_smoke.div_3d_work(1024, 32, 32, 16)
    assert div["bytes"] == 272_629_760
    bounds = [chip_smoke.bound(w) for w in (*works.values(), div)]
    assert all(by == "bytes" for _, by in bounds)
    assert [round(ms, 4) for ms, _ in bounds] == [0.1014, 0.1014, 0.0826, 0.1027, 0.0814]


def test_bounds_at_main_path_shapes():
    k1_ms, k1_by = chip_smoke.bound(chip_smoke.env_step_work(1024, 96, 64, 50))
    k2_ms, k2_by = chip_smoke.bound(chip_smoke.tendencies_work(1024, 96, 64))
    assert (k1_by, k2_by) == ("operations", "bytes")
    # ~0.66 GFLOP per env per env step at 67 TFLOP/s; ~7 field slabs at 3.35 TB/s
    assert 9.5 < k1_ms < 11.0 and 0.04 < k2_ms < 0.08


def test_k2_bytes_with_and_without_p_hy():
    """K2's bound is its own function's, which takes b and no p_hy:
    152,174,592 bytes at 1024 envs on 96x64, 0.0454 ms, one (nx, nz) slab
    less than the Pallas kernel's 177,340,416 bytes (0.0529 ms), its
    yardstick beside it."""
    assert chip_smoke.tendencies_work(1024, 96, 64)["bytes"] == 177_340_416
    assert round(chip_smoke.bound(chip_smoke.tendencies_work(1024, 96, 64))[0], 4) == 0.0529
    own = chip_smoke.tendencies_own_work(1024, 96, 64)
    assert own["bytes"] == 152_174_592 == 177_340_416 - 4 * 1024 * 96 * 64
    assert chip_smoke.bound(own)[1] == "bytes"
    assert round(chip_smoke.bound(own)[0], 4) == 0.0454


def test_kernel_time_split_of_a_trace():
    """The substep's device split from a Chrome trace: kernels by name,
    largest first, their busy sum and the idle share of their span; CPU
    events are not device time."""
    events = [{"cat": "kernel", "name": "k2", "ts": 0.0, "dur": 100.0},
              {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 900.0},
              {"cat": "kernel", "name": "gemm", "ts": 150.0, "dur": 300.0},
              {"cat": "kernel", "name": "k2", "ts": 500.0, "dur": 100.0}]
    split = chip_smoke.kernel_time_split(events)
    assert split["device_busy_ms"] == 0.5 and split["span_ms"] == 0.6
    assert abs(split["idle_share"] - 1 / 6) < 1e-12
    assert split["kernels"] == [{"name": "gemm", "ms": 0.3, "count": 1},
                                {"name": "k2", "ms": 0.2, "count": 2}]
    assert "not_measured" in chip_smoke.kernel_time_split(events[1:2])


def test_3d_bounds_at_main_path_shapes():
    """K3 and K4 move more bytes than the card can hide behind their FLOP:
    ~1.2 MB per env per stage-1 launch at 3.35 TB/s (0.37 ms at 1024 envs)."""
    works = [chip_smoke.stage_rk_3d_work(1024, 32, 32, 16, m) for m in range(3)]
    bounds = [chip_smoke.bound(w) for w in works]
    assert all(by == "bytes" for _, by in bounds)
    assert works[0]["bytes"] == works[2]["bytes"] < works[1]["bytes"]
    assert 0.35 < bounds[1][0] < 0.38 and 0.27 < bounds[0][0] < 0.30
    k4_ms, k4_by = chip_smoke.bound(chip_smoke.correct_3d_work(1024, 32, 32, 16))
    assert k4_by == "bytes" and 0.1 < k4_ms < 0.15
    # the dense solve is ~36 MFLOP per env at 16x32x32; the factored one fewer
    dense = chip_smoke.poisson_3d_flops(1, 32, 32, 16, factored=False)
    assert 3.4e7 < dense < 3.8e7
    assert chip_smoke.poisson_3d_flops(1, 32, 32, 16, factored=True) < dense / 4


def test_big_grid_bounds():
    """K5 on 32x64x64 at 1024 envs: 7.4 MB per env at stages 0 and 2, 9.5 MB
    at stage 1, 2.264 and 2.910 ms at 3.35 TB/s; its FLOP need 0.76-0.78 ms."""
    works = [chip_smoke.stage_rk_3d_work(1024, 64, 64, 32, m) for m in range(3)]
    assert [w["bytes"] for w in works] == [7_583_301_632, 9_747_562_496, 7_583_301_632]
    bounds = [chip_smoke.bound(w) for w in works]
    assert all(by == "bytes" for _, by in bounds)
    assert [round(ms, 3) for ms, _ in bounds] == [2.264, 2.910, 2.264]
    assert all(0.76e-3 < w["flops"] / chip_smoke.FP32_FLOPS < 0.78e-3 for w in works)


@pytest.mark.parametrize("alone", [False, True])
def test_smoke_script_fails_without_a_card(tmp_path, alone):
    """No CUDA device: non-zero exit and no result; alone in a directory
    (without the package), the same."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
    proc = _run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_nvcc_targets_sm90a_into_an_ignored_directory(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    lib = _build.library_path()
    objects = [lib.with_suffix(f".{src.stem}.o") for src in _build.sources()]
    for src, obj in zip(_build.sources(), objects):  # one nvcc a source
        cmd = _build.compile_command(src, obj)
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert "-c" in cmd and cmd[-1] == str(src)
    cmd = _build.link_command(lib, objects)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and cmd[-len(objects):] == list(map(str, objects))
    assert lib.parent == _build.BUILD_DIR
    rel = lib.relative_to(REPO)
    assert "rbc_gym_tpu_torch/_build/" in (REPO / ".gitignore").read_text().splitlines()
    if _run(["git", "rev-parse", "--is-inside-work-tree"]).returncode == 0:
        assert _run(["git", "check-ignore", "-q", str(rel)]).returncode == 0
    for src in _build.sources():
        assert "torch/extension.h" not in src.read_text()


def _exports(text: str):
    """(name, [parameter declarations]) of every extern "C" function."""
    out = []
    for start in (m.end() for m in re.finditer(r'extern "C"\s*\{', text)):
        depth, end = 1, start
        while depth:
            depth += {"{": 1, "}": -1}.get(text[end], 0)
            end += 1
        block = text[start:end]
        for name, params in re.findall(r"^[A-Za-z_][\w\s\*]*?\b(\w+)\(([^)]*)\)", block, re.M):
            out.append((name, [p.strip() for p in params.split(",") if p.strip()]))
    return out


def test_every_export_has_matching_argtypes():
    exports = [e for src in _build.sources() for e in _exports(src.read_text())]
    assert {name for name, _ in exports} == set(_build.ARGTYPES)
    for name, params in exports:
        argtypes = _build.ARGTYPES[name]
        assert len(argtypes) == len(params), name
        for decl, argtype in zip(params, argtypes):
            if "*" in decl:
                want = ctypes.c_void_p
            elif decl.startswith("int "):
                want = ctypes.c_int
            else:
                want = ctypes.c_float
            assert argtype is want, f"{name}: {decl}"


def test_smoke_ablation_gates():
    """The JAX record passes its own gates; a zero row off by 3 %, unequal
    zero rows or a checkerboard falling with the amplitude fail."""
    jax_rows = {k: chip_smoke.JAX_ABLATION[k] for k in ("0", "0.4", "1")}
    assert chip_smoke.ablation_gates(jax_rows) == {}
    off = {**jax_rows, "0": {"random": 1.957 * 1.03, "checker": 1.957}}
    assert set(chip_smoke.ablation_gates(off)) == {"0", "0 random == checker"}
    falling = {**jax_rows, "1": {"random": 2.048, "checker": 2.0}}
    assert set(chip_smoke.ablation_gates(falling)) == {"1", "checker non-decreasing"}


def test_smoke_probe_gates_fail_off_the_jax_record():
    failed = {}
    rises = chip_smoke._probe_checks("2d", 10.0, {"row1": 10.5}, 13.2262, "2d", True, failed)
    assert rises == {"row1": pytest.approx(0.05)} and set(failed) == {"2d zero", "2d rise"}
    assert chip_smoke._near_jax(1.39, (1.3589, 0.00077), 0.03) == (True, pytest.approx(0.040767))
    assert not chip_smoke._near_jax(2.2, (1.7716, 0.0249), 0.03)[0]


def test_smoke_jax_records_are_the_committed_ones():
    """The JAX numbers the new phases gate on are the committed records':
    the flow-statistics JSONs and the probe logs."""
    with open(REPO / "experiments" / "flowstats" / "flowstats_ra_2d.json") as f:
        points = json.load(f)["points"]
    assert chip_smoke.JAX_FLOWSTATS_2D == {
        ra: (p["nu_mean"], p["nu_std"]) for ra, p in points.items()}
    with open(REPO / "experiments" / "flowstats" / "flowstats_ra.json") as f:
        points = json.load(f)
    assert chip_smoke.JAX_FLOWSTATS_3D == {
        ra: (points[ra]["nu_mean"], points[ra]["nu_std"]) for ra in ("500", "2000")}
    log2 = (REPO / "results" / "probe2d_ra1000000.log").read_text()
    assert f"steps): {chip_smoke.JAX_PROBE_2D['zero']:.4f}" in log2
    assert f"row=1 gain= 30.0: Nu={chip_smoke.JAX_PROBE_2D['row1_gain30']:.4f}" in log2
    log3 = (REPO / "results" / "probe3d_ra500.log").read_text()
    assert f"zero-action Nu: {chip_smoke.JAX_PROBE_3D['zero']:.4f}" in log3
    for sign in "+-":
        nu = chip_smoke.JAX_PROBE_3D[f"T_row1_gain{sign}3"]
        assert f"T row= 1 gain= {sign}3.00: Nu={nu:.4f}" in log3
