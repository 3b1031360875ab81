"""Env-axis layouts over ``torch.distributed`` ranks.

Twin of ``rbc_gym_tpu/parallel/mesh.py``. There a mesh is a grid of
devices inside one SPMD program and XLA places the collectives. Here each
rank is a process that drives one device, and the mesh is the layout of
the ranks: its (dp, env) factoring, this rank's place in it, its device
and the process groups its collectives run on. The env axis is split over
every rank: rank r holds the rows ``[r * E / R, (r + 1) * E / R)`` of a
fleet of E envs. Model parameters are replicated.

Device tensors take only ``all_reduce`` and ``broadcast`` (all that gloo
takes for CUDA tensors); gathers for host I/O run on CPU tensors over a
gloo group, which is the default group when the backend is gloo and a
second group beside an NCCL one.

In one process every collective is a no-op, so the same code runs with
and without ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


def mesh_shape(n: int, dp: Optional[int] = None) -> Tuple[int, int]:
    """The (dp, env) factoring of ``n`` devices, as ``make_env_mesh`` in
    the JAX package: dp is 2 where n is even and above 1, else 1."""
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    if dp < 1 or n % dp != 0:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    return dp, n // dp


def env_rows(num_envs: int, size: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s rows ``[lo, hi)`` of a fleet of ``num_envs`` envs
    split over ``size`` ranks. A fleet that does not divide is refused:
    the JAX run_sarl then trains unsharded, which with ranks would be R
    copies of one training writing the same files."""
    if num_envs % size != 0:
        raise ValueError(f"num_envs={num_envs} does not divide over {size} ranks: the env "
                         "axis is split evenly, so num_envs must be a multiple of the world size")
    per = num_envs // size
    return rank * per, (rank + 1) * per


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` (default CUDA where there is a card,
    else the CPU), on CUDA with the index that ``initialize_distributed``
    made current."""
    dev = torch.device(device if device is not None
                       else "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """The layout of the ranks: ``shape`` maps each axis name to its size
    (as a JAX mesh's ``shape``). Device collectives run on the default
    group, the CPU ones on ``host_group`` (None: the default group)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    host_group: Optional[object] = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def rows(self, num_envs: int) -> Tuple[int, int]:
        """This rank's rows of a fleet of ``num_envs`` envs."""
        return env_rows(num_envs, self.size, self.rank)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same bytes."""
        if self.size > 1:
            dist.all_reduce(t)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` with rank ``src``'s, in place."""
        if self.size > 1:
            dist.broadcast(t, src=src)
        return t

    def gather_rows(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """On rank 0 every rank's ``t`` (equal shapes) concatenated along
        the first axis in rank order, on the CPU; None on the others."""
        t = t.detach().cpu()
        if self.size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(t.contiguous(), parts, dst=0, group=self.host_group)
        return torch.cat(parts) if self.rank == 0 else None

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.host_group)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if _initialized() else 1


def layout(shape: Dict[str, int], device=None) -> EnvMesh:
    """An ``EnvMesh`` of ``shape`` over the process group's ranks. Beside
    an NCCL default group it makes a gloo group for the CPU collectives,
    so every rank must call it, in the same order."""
    n, world = math.prod(shape.values()), world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} devices over {world} rank(s): a rank drives one device, "
                         "so the mesh spans exactly the ranks of the process group")
    if not _initialized():
        return EnvMesh(dict(shape), 0, rank_device(device))
    host = dist.new_group(backend="gloo") if dist.get_backend() == "nccl" else None
    return EnvMesh(dict(shape), dist.get_rank(), rank_device(device), host)


def make_env_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
                  axis_names: Tuple[str, str] = ("dp", "env"), device=None) -> EnvMesh:
    """The ranks factored as (dp, env) by the JAX package's rule.
    ``n_devices`` defaults to the world size and must equal it."""
    n = n_devices or world_size()
    return layout(dict(zip(axis_names, mesh_shape(n, dp))), device)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(tree, mesh: EnvMesh):
    """This rank's rows of every (E, ...) tensor of ``tree``."""

    def rows(x):
        lo, hi = mesh.rows(x.shape[0])
        return x[lo:hi]

    return _tree_map(rows, tree)


def replicate(tree, mesh: EnvMesh):
    """Broadcast every tensor of ``tree`` from rank 0, in place; returns
    ``tree``."""
    tensors = []
    _tree_map(tensors.append, tree)
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t.data if isinstance(t, nn.Parameter) else t)
    return tree


def shard_vector_env(env_cls, num_envs: int, mesh: EnvMesh, **kwargs):
    """This rank's ``env_cls`` (``RBC2DVectorEnv`` or ``RBC3DVectorEnv``)
    over its rows ``[lo, hi)`` of a fleet of ``num_envs`` envs, on the
    mesh's device unless ``device`` is given: its resets and steps equal
    those rows of the whole fleet's (``ic_noise`` aside, see
    ``envs.bank``), and they need no collective."""
    lo, hi = mesh.rows(num_envs)
    kwargs.setdefault("device", mesh.device)
    return env_cls(hi - lo, env_slice=(lo, num_envs), **kwargs)
