"""PyTorch/CUDA port of ``rbc_gym_tpu`` for NVIDIA Hopper (H100).

The port imports torch and numpy only: no jax, gymnasium or h5py, and
nothing of ``rbc_gym_tpu``. Entry points take an explicit ``device`` that
defaults to ``"cuda"``; the CPU is used only when the caller asks for it.
On CUDA the hot path runs hand-written kernels (``csrc/``, built with nvcc
at first use); on the CPU it runs their plain PyTorch versions.

Where gymnasium is installed, importing the package registers the gym IDs
``rbc_gym_tpu_torch/RayleighBenardConvection2D-v0`` and ``...3D-v0`` with
the JAX package's defaults plus ``device="cuda"``; without gymnasium it
registers nothing (the gym-free cores ``envs.single2d`` and
``envs.single3d`` carry the same envs).
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"

# Float32 products on the card run in full float32: the solver's spectral
# constants and the parity gates assume it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Resolve ``device``; raise if CUDA is asked for (the default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rbc_gym_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


ENV_ID_2D = "rbc_gym_tpu_torch/RayleighBenardConvection2D-v0"
ENV_ID_3D = "rbc_gym_tpu_torch/RayleighBenardConvection3D-v0"


def _register() -> None:
    """Register the gym IDs: the kwargs of ``rbc_gym_tpu/__init__.py:28-61``,
    plus the device. ``use_gpu`` stays False and is ignored, as in the JAX
    envs; ``device`` says where an env runs."""
    try:
        from gymnasium.envs.registration import register, registry
    except ImportError:  # no gymnasium (e.g. the card's image): nothing to register
        return
    if ENV_ID_2D in registry:
        return
    register(
        id=ENV_ID_2D,
        entry_point="rbc_gym_tpu_torch.envs:RayleighBenardConvection2DEnv",
        kwargs={
            "rayleigh_number": 10_000,
            "episode_length": 300,
            "observation_shape": (8, 48),
            "state_shape": (64, 96),
            "heater_segments": 12,
            "heater_limit": 0.75,
            "heater_duration": 1.5,
            "checkpoint": None,
            "use_gpu": False,
            "render_mode": None,
            "device": "cuda",
        },
    )
    register(
        id=ENV_ID_3D,
        entry_point="rbc_gym_tpu_torch.envs:RayleighBenardConvection3DEnv",
        kwargs={
            "rayleigh_number": 500,
            "prandtl_number": 0.7,
            "domain": [2, 4 * np.pi, 4 * np.pi],
            "state_shape": (16, 32, 32),
            "temperature_difference": [1, 2],
            "heater_segments": 8,
            "heater_limit": 0.9,
            "heater_duration": 0.125,
            "episode_length": 300,
            "checkpoint": None,
            "use_gpu": False,
            "render_mode": None,
            "device": "cuda",
        },
    )


_register()
