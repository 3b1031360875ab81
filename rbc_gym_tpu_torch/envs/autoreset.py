"""Shared lockstep autoreset and the per-env key discipline.

Port of ``rbc_gym_tpu.envs.autoreset``. The N lockstep envs live in one
batch, so episode resets are a masked swap of the field tuple. Every env
carries its own key (a 64-bit integer, kept on the host as an int64 tensor);
a fresh initial condition is drawn from a ``torch.Generator`` seeded by a
key derived from it. Keys are split and folded with the splitmix64 mixer,
the counterpart of ``jax.random.split``/``fold_in``: the numbers differ
from JAX's, the discipline is the same.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
# odd constants that keep the three derivations apart
_SPLIT_STRIDE = np.uint64(0xD1B54A32D192ED03)
_FOLD_SALT = np.uint64(0x8CB92BA72F3D8DD7)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 arrays (wrapping arithmetic)."""
    x = x + _GOLDEN
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _to_u64(keys: torch.Tensor) -> np.ndarray:
    return np.atleast_1d(keys.cpu().numpy()).view(np.uint64)


def _from_u64(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def seed_keys(seed: int, n: int) -> torch.Tensor:
    """n independent per-env keys from one seed (``jax.random.split``)."""
    base = _mix(np.array([seed], np.uint64))
    return _from_u64(_mix(base + np.arange(n, dtype=np.uint64) * _SPLIT_STRIDE))


def fleet_slice(num_envs: int, env_slice=None) -> Tuple[int, int]:
    """(offset, fleet size) of an env of ``num_envs`` envs: ``env_slice``
    checked to hold them, or the whole fleet."""
    offset, fleet = (0, num_envs) if env_slice is None else map(int, env_slice)
    if not 0 <= offset <= fleet - num_envs:
        raise ValueError(f"env_slice={env_slice}: envs [{offset}, {offset + num_envs}) do not lie "
                         f"in a fleet of {fleet}")
    return offset, fleet


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """Derive one key per key from an integer (``jax.random.fold_in``)."""
    return _from_u64(_mix(_to_u64(keys) + _mix(np.array([data], np.uint64) + _FOLD_SALT)))


def split_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(carried stream, sub-key) per key (``jax.random.split``)."""
    k = _to_u64(keys)
    two = np.uint64(2)
    return _from_u64(_mix(k * two)), _from_u64(_mix(k * two + np.uint64(1)))


def key_index(keys: torch.Tensor, n: int) -> torch.Tensor:
    """One index in [0, n) per key (``jax.random.randint(key, (), 0, n)``)."""
    return torch.from_numpy((_mix(_to_u64(keys)) % np.uint64(n)).astype(np.int64))


def batch_generator(keys: torch.Tensor, device) -> torch.Generator:
    """One generator for a batch of keys, seeded from all of them, so that a
    batch's random draws are one call on ``device``, not one per env."""
    k = _to_u64(keys)
    seed = np.bitwise_xor.reduce(_mix(k + np.arange(k.size, dtype=np.uint64) * _SPLIT_STRIDE))
    return torch.Generator(device=device).manual_seed(int(seed))


def autoreset_step(
    fields,
    key: torch.Tensor,
    truncated: torch.Tensor,
    final_obs: torch.Tensor,
    init_fields: Callable,
    observe: Callable,
):
    """Masked per-env autoreset: returns (fields, key, obs).

    Each autoreset SPLITS the per-env key: one half becomes the new carried
    stream, the other seeds the fresh IC, so every episode starts from a
    different initial condition. Envs that did not truncate keep their
    fields and key; with no truncation the inputs come back unchanged.
    Nothing is written in place.

    ``fields`` is a NamedTuple of tensors with a leading env axis;
    ``init_fields(keys)`` builds fresh fields for a batch of keys;
    ``observe(fields)`` maps the batched fields to the batched observation.
    """
    mask = truncated.cpu()
    if not bool(mask.any()):
        return fields, key, final_obs
    carry, init_keys = split_keys(key)
    idx = mask.nonzero().flatten()
    fresh = init_fields(init_keys[idx])
    idx_dev = idx.to(fields[0].device)
    new_fields = type(fields)(
        *(old.index_copy(0, idx_dev, new) for old, new in zip(fields, fresh))
    )
    new_key = torch.where(mask, carry, key)
    return new_fields, new_key, observe(new_fields)
