"""Environment layer: the gym-free single-env cores and vector envs, and
the gymnasium envs and vector adapters over them.

The export list is the JAX package's (``rbc_gym_tpu/envs/__init__.py``).
Every name resolves when it is first read, so importing this package
imports neither gymnasium nor a solver: the gymnasium classes
(``RayleighBenardConvection2DEnv``, ``...3DEnv``, ``RBC2DGymVectorEnv``,
``RBC3DGymVectorEnv``) need gymnasium, the rest do not.
"""

import importlib

__all__ = [
    "RayleighBenardConvection2DEnv",
    "RayleighBenardConvection3DEnv",
    "RBC3DField",
    "RBCField",
    "RBC2DVectorEnv",
    "RBC2DGymVectorEnv",
    "RBC3DVectorEnv",
    "RBC3DGymVectorEnv",
    "EnvState2D",
    "TimeStep",
]

_LAZY = {
    "RayleighBenardConvection2DEnv": "rbc_gym_tpu_torch.envs.rbc2d",
    "RBCField": "rbc_gym_tpu_torch.envs.single2d",
    "RBC2DVectorEnv": "rbc_gym_tpu_torch.envs.vector2d",
    "EnvState2D": "rbc_gym_tpu_torch.envs.vector2d",
    "TimeStep": "rbc_gym_tpu_torch.envs.vector2d",
    "RBC2DGymVectorEnv": "rbc_gym_tpu_torch.envs.gym_vector",
    "RayleighBenardConvection3DEnv": "rbc_gym_tpu_torch.envs.rbc3d",
    "RBC3DField": "rbc_gym_tpu_torch.envs.single3d",
    "RBC3DVectorEnv": "rbc_gym_tpu_torch.envs.vector3d",
    "EnvState3D": "rbc_gym_tpu_torch.envs.vector3d",
    "TimeStep3D": "rbc_gym_tpu_torch.envs.vector3d",
    "RBC3DGymVectorEnv": "rbc_gym_tpu_torch.envs.gym_vector",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
