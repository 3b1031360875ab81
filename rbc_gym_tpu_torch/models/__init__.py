"""Policy/value models: the port's actor-critic nets (``nets``, the twins
of the JAX package's flax nets) and the SB3-style torch modules
(``torch_nets``), which resolve when first read."""

from rbc_gym_tpu_torch.models.nets import (
    ActorCriticNetwork,
    FluidCNNExtractor,
    RBCActorCritic,
    RBCActorCritic2D,
    periodic_pad_3d,
)

__all__ = [
    "ActorCriticNetwork",
    "FluidCNNExtractor",
    "RBCActorCritic",
    "RBCActorCritic2D",
    "periodic_pad_3d",
]


def __getattr__(name):
    # the SB3 module is imported lazily (with SB3 installed it imports SB3)
    if name in ("PeriodicPad3D", "FluidCNN", "ActorCriticTorso",
                "CustomActorCriticPolicy"):
        from rbc_gym_tpu_torch.models import torch_nets

        return getattr(torch_nets, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
