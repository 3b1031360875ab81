"""Wrapper layer: the gym wrappers (host-only, they need gymnasium) and
their batched on-device kin in ``functional``.

The three gym wrappers resolve when first read, so importing this package
imports no gymnasium.
"""

import importlib

__all__ = ["RBCNormalizeObservation", "RBCNormalizeReward", "RBCRewardShaping"]

_LAZY = {
    "RBCNormalizeObservation": "rbc_gym_tpu_torch.wrappers.rbc_normalize_observation",
    "RBCNormalizeReward": "rbc_gym_tpu_torch.wrappers.rbc_normalize_reward",
    "RBCRewardShaping": "rbc_gym_tpu_torch.wrappers.rbc_reward_shaping",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
