"""The hand kernels' wrappers by name, each with its ``.launches`` counter.

A wrapper adds one to its counter where it launches its kernel, and
nowhere else (on a CPU tensor it runs its plain version and counts
nothing). ``utils.flopcount`` reads the counters to refuse a count that a
kernel launched in; ``chip_smoke.py`` reads them to show that a path went
through its kernels.
"""

from __future__ import annotations

from typing import Dict

from rbc_gym_tpu_torch.ops import kernels2d, kernels3d

KERNEL_WRAPPERS = {
    "env_step_2d": kernels2d.env_step_2d,
    "tendencies_2d": kernels2d.tendencies_2d,
    "stage_rk_3d": kernels3d.stage_rk_3d,
    "correct_3d": kernels3d.correct_3d,
    "stage_rk_3d_xy": kernels3d.stage_rk_3d_xy,
    "field_tendency_3d": kernels3d.field_tendency_3d,
    "div_3d": kernels3d.div_3d,
    "stage_rk_3d_rhat": kernels3d.stage_rk_3d_rhat,
    # K1's TF32 instances (``kernels2d.K1_PASSES``): ``env_step_2d`` at
    # precision "high" and "default" counts its launches on these
    "env_step_2d_tf32x3": kernels2d.env_step_2d_tf32x3,
    "env_step_2d_tf32": kernels2d.env_step_2d_tf32,
    # K1's cluster instance: ``env_step_2d`` on the grids that
    # ``limits.env_step_2d_cluster_size`` gives a cluster counts here
    "env_step_2d_cluster": kernels2d.env_step_2d_cluster,
}


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch counter."""
    return {name: wrapper.launches for name, wrapper in KERNEL_WRAPPERS.items()}
