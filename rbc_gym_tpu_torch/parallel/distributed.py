"""Multi-rank runtime over ``torch.distributed``.

Twin of ``rbc_gym_tpu/parallel/distributed.py``. The JAX package runs one
SPMD program over a ('host', 'env') mesh and XLA emits the gradient psum.
Here every rank is a process with one device; the env axis is split over
the ranks, parameters are replicated, and PPO's collectives are written
out (``rl.ppo``): one gradient all-reduce a minibatch, the advantage
statistics and the KL, so that R ranks reproduce one process to float
rounding.

Launch with torchrun (``rbc_gym_tpu_torch/scripts/launch_multihost.sh``)
or under Slurm; in a single process every helper here degrades to a
no-op, so the same training script runs with and without ranks.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from rbc_gym_tpu_torch.parallel.mesh import EnvMesh, env_rows, layout, replicate, world_size

logger = logging.getLogger(__name__)

# How long a rank waits at the rendezvous and in a collective before it
# fails, so that a rank that died does not leave the others hung.
TIMEOUT_S = 1800.0


def _int_env(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def rank_device_index(backend: str, local_rank: int, local_world_size: int,
                      device_count: int) -> int:
    """The CUDA device of local rank ``local_rank``: one device a rank,
    wrapping round where there are fewer devices than ranks. NCCL refuses
    two ranks on one device, so that case raises unless the backend is gloo."""
    if device_count < 1:
        raise ValueError("no CUDA device for a CUDA rank")
    if backend == "nccl" and local_world_size > device_count:
        raise ValueError(
            f"{local_world_size} ranks on {device_count} CUDA device(s) would put two NCCL ranks "
            "on one device, which NCCL refuses: run one rank per card (NPROC <= "
            f"{device_count}), or pass backend='gloo' to let ranks share a card")
    return local_rank % device_count


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None,
                           timeout: float = TIMEOUT_S) -> bool:
    """Join the process group if a multi-rank launch is configured; a
    no-op that returns False in a single process. Safe to call twice.

    Each value comes from the explicit argument, then torchrun's variables
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), then Slurm's (``SLURM_NTASKS``,
    ``SLURM_PROCID``, ``SLURM_LOCALID``). ``device`` (default CUDA where
    there is a card) picks the default backend: NCCL on CUDA, gloo on the
    CPU. On CUDA each rank takes the device of its local rank; two ranks
    share a card only under ``backend="gloo"``, asked for by name. The
    tensors stay on the device either way. ``timeout`` bounds the
    rendezvous and every collective."""
    if dist.is_initialized():
        return True
    world = world_size if world_size is not None else _int_env("WORLD_SIZE", "SLURM_NTASKS")
    if world is None or world == 1:
        return False
    rank = rank if rank is not None else _int_env("RANK", "SLURM_PROCID")
    if init_method is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if rank is None or init_method is None:
        raise ValueError(f"a {world}-rank launch needs this rank's RANK and a rendezvous "
                         "(MASTER_ADDR and MASTER_PORT, or init_method)")
    local_rank = _int_env("LOCAL_RANK", "SLURM_LOCALID")
    local_rank = rank if local_rank is None else local_rank
    local_world = _int_env("LOCAL_WORLD_SIZE") or world
    dev = torch.device(device if device is not None
                       else "cuda" if torch.cuda.is_available() else "cpu")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device_index(backend, local_rank, local_world,
                                                torch.cuda.device_count()))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    logger.info("torch.distributed initialized: rank %d/%d (local %d/%d), backend %s, %s",
                rank, world, local_rank, local_world, backend,
                f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu")
    return True


def shutdown_distributed(barrier: bool = True) -> None:
    """End the process group that ``initialize_distributed`` joined; a
    no-op where there is none. With ``barrier`` every rank first meets the
    others, so that no rank tears its group down while another still talks
    to it; a rank that is leaving on an error passes False, since the others
    may never reach the barrier. A rank that exits with its group alive can
    abort as the interpreter ends ("terminate called without an active
    exception": the group's threads are still running), so every entry
    point that joins a group ends it here, in a ``finally``."""
    if not dist.is_initialized():
        return
    try:
        if barrier:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def host_shape() -> Tuple[int, int]:
    """(hosts, ranks a host) of the process group: ``LOCAL_WORLD_SIZE``
    ranks a host (torchrun's), all of them on one host without it."""
    world = world_size()
    local = _int_env("LOCAL_WORLD_SIZE") or world
    if world % local != 0:
        raise RuntimeError(f"{world} ranks do not split evenly over hosts of {local}")
    return world // local, local


def make_host_env_mesh(axis_names: Tuple[str, str] = ("host", "env"), device=None) -> EnvMesh:
    """The ranks as a ('host', 'env') layout: hosts on the outer axis, each
    host's ranks (one a device) on the inner one. The env axis is split
    over both; in one process this is a (1, 1) layout."""
    return layout(dict(zip(axis_names, host_shape())), device)


def shard_ppo_trainer(trainer, mesh: EnvMesh):
    """Run ``trainer`` (a ``rl.ppo.PPO``) over ``mesh``: its env must be
    this rank's shard (``shard_vector_env``), so that its env state and
    observations are already this rank's rows; the parameters, Adam
    moments and the states of the two generators are broadcast from rank
    0, and the update all-reduces the gradients (``PPO.mesh``)."""
    env = trainer.env
    lo, _ = mesh.rows(env.fleet_size)
    if env.fleet_size != env.num_envs * mesh.size or env.env_offset != lo:
        raise ValueError(
            f"the trainer's env holds envs [{env.env_offset}, {env.env_offset + env.num_envs}) "
            f"of {env.fleet_size}, not rank {mesh.rank}'s rows of the fleet over {mesh.size} "
            "ranks: build it with shard_vector_env(env_cls, num_envs, mesh, ...)")
    opt = trainer.optimizer
    replicate([list(opt.params), opt.mu, opt.nu], mesh)
    for gen in (trainer.action_gen, trainer.perm_gen):
        state = gen.get_state()
        if mesh.size > 1:
            dist.broadcast(state, src=0, group=mesh.host_group)
        gen.set_state(state)
    trainer.mesh = mesh
    return trainer


def host_local_slice(num_envs: int) -> slice:
    """This rank's slice of a fleet of ``num_envs`` envs split over the
    process group, for host-local I/O without a gather."""
    rank = dist.get_rank() if world_size() > 1 else 0
    return slice(*env_rows(num_envs, world_size(), rank))
