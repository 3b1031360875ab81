"""3D env throughput microbench: the stage, field and plain paths.

Twin of ``scripts/bench3d.py``. ``RBC3DVectorEnv`` on the 16x32x32
training grid (Ra 2500, heater_duration 0.125, dt 0.01: 13 substeps an
env step) steps zero actions: one warm step (the kernels' build on a
first call, as the JAX script's "compile+1"), then ``steps`` timed steps
closed by a synchronise. Before timing a kernel path, ``main`` checks the
path against the plain one on the card (``utils.parity.fused_parity_3d``
at 128 envs on the same grid); ``run`` times without that gate. The JAX
script's ``xla`` is ``plain`` here.

Usage:
  python -m rbc_gym_tpu_torch.scripts.bench3d [stage|stage_xy|field|plain] [num_envs ...] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

PATHS = ("stage", "stage_xy", "field", "plain")
DEFAULT_SIZES = (1024, 4096)
STATE_SHAPE = (16, 32, 32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(path: str, num_envs: int, steps: int = 10, device="cuda", log=print) -> float:
    """Env-steps/s of ``path`` at ``num_envs`` over ``steps`` timed steps;
    prints the JAX script's line."""
    from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv

    device = torch.device(device)
    env = RBC3DVectorEnv(
        num_envs=num_envs,
        rayleigh_number=2500,
        state_shape=STATE_SHAPE,
        heater_duration=0.125,
        dt_solver=0.01,
        episode_length=37.5,
        fused=False if path == "plain" else path,
        device=device,
    )
    state, _ = env.reset(seed=0)
    actions = torch.zeros((num_envs, 8, 8), dtype=torch.float32, device=device)

    start = time.perf_counter()
    state, ts = env.step(state, actions)
    _sync(device)
    first_s = time.perf_counter() - start

    start = time.perf_counter()
    for _ in range(steps):
        state, ts = env.step(state, actions)
    _sync(device)
    elapsed = time.perf_counter() - start
    eps = num_envs * steps / elapsed
    log(f"fused={path!r:10} envs={num_envs:5d}: {eps:9.1f} env-steps/s "
        f"({elapsed / steps * 1e3:8.2f} ms/batch-step, build+1 {first_s:.1f}s)")
    if not bool(torch.isfinite(ts.reward).all()):
        raise RuntimeError(f"non-finite rewards on the {path} path")
    return eps


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?", default="stage", choices=PATHS)
    p.add_argument("sizes", nargs="*", type=int, default=list(DEFAULT_SIZES))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    log = lambda line: print(line, flush=True)  # noqa: E731
    device = torch.device(args.device)
    if device.type == "cuda":
        log(f"device {torch.cuda.get_device_name(device)}")
    if args.path != "plain":
        from rbc_gym_tpu_torch.utils.parity import fused_parity_3d

        err = fused_parity_3d(num_envs=128, steps=1, state_shape=STATE_SHAPE, fused=args.path,
                              device=device)
        log(f"kernel parity ok (fused={args.path!r}: {err:.2e})")
    return {n: run(args.path, n, device=device, log=log) for n in args.sizes}


if __name__ == "__main__":
    main()
