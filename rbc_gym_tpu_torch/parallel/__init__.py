"""Multi-rank scale-out over ``torch.distributed``: the env axis split over
ranks, parameters replicated, PPO's collectives written out.

Twin of ``rbc_gym_tpu/parallel``; imports torch, numpy and the port only.
"""

from rbc_gym_tpu_torch.parallel.mesh import (
    make_env_mesh,
    shard_batch,
    replicate,
    shard_vector_env,
)
from rbc_gym_tpu_torch.parallel.distributed import (
    initialize_distributed,
    shutdown_distributed,
    make_host_env_mesh,
    shard_ppo_trainer,
    host_local_slice,
)

__all__ = [
    "make_env_mesh",
    "shard_batch",
    "replicate",
    "shard_vector_env",
    "initialize_distributed",
    "shutdown_distributed",
    "make_host_env_mesh",
    "shard_ppo_trainer",
    "host_local_slice",
]
