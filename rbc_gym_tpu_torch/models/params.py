"""Carry network weights between flax's layout and the port's modules.

A flax params tree, flattened, is keyed by path (``params/Conv_0/kernel``,
``params/FluidCNNExtractor_1/Conv_1/bias``, ``params/log_std``); the
port's modules (``models.nets``) carry the same names, so a flax path maps
to a ``state_dict`` key by dropping ``params/``, writing ``.`` for ``/``
and ``weight`` for ``kernel``. Layouts:

* conv kernels: flax (k_1, ..., k_n, in, out) -> torch (out, in, k_1, ..., k_n);
* dense kernels: flax (in, out) -> torch (out, in);
* biases and ``log_std``: unchanged.

Saved params are one ``.npz`` in flax's layout (what
``utils.convert params`` writes from a flax ``.msgpack``), so a run of the
port and a run of the JAX package can exchange weights.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

_PREFIX = "params/"


def _torch_key(flax_path: str) -> str:
    if not flax_path.startswith(_PREFIX):
        raise KeyError(f"{flax_path}: not under {_PREFIX!r}")
    parts = flax_path[len(_PREFIX):].split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _flax_path(torch_key: str) -> str:
    parts = torch_key.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return _PREFIX + "/".join(parts)


def _to_torch_layout(key: str, a: np.ndarray) -> np.ndarray:
    if not key.endswith(".weight"):
        return a
    if a.ndim == 2:
        return a.T
    n = a.ndim - 2  # spatial dims of a conv kernel
    return np.transpose(a, (n + 1, n) + tuple(range(n)))


def _to_flax_layout(key: str, a: np.ndarray) -> np.ndarray:
    if not key.endswith(".weight"):
        return a
    if a.ndim == 2:
        return a.T
    n = a.ndim - 2
    return np.transpose(a, tuple(range(2, n + 2)) + (1, 0))


def state_dict_from_flax(tree: Dict[str, np.ndarray], model: nn.Module) -> Dict[str, torch.Tensor]:
    """A flattened flax params tree -> a ``state_dict`` for ``model``, in
    the model's dtype and on its device. Every key of either side must
    have its counterpart and shape, else ``KeyError``/``ValueError``."""
    want = model.state_dict()
    got = {_torch_key(k): _to_torch_layout(_torch_key(k), np.asarray(v)) for k, v in tree.items()}
    if set(got) != set(want):
        raise KeyError(f"flax params {sorted(set(got) ^ set(want))} have no counterpart")
    out = {}
    for k, ref in want.items():
        if tuple(got[k].shape) != tuple(ref.shape):
            raise ValueError(f"{_flax_path(k)}: {got[k].shape} does not fit {tuple(ref.shape)}")
        out[k] = torch.tensor(got[k], dtype=ref.dtype, device=ref.device)
    return out


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse: a module's ``state_dict`` -> a flattened flax tree."""
    return {_flax_path(k): np.ascontiguousarray(_to_flax_layout(k, v.detach().cpu().numpy()))
            for k, v in state_dict.items()}


def save_params(model: nn.Module, path) -> None:
    """Write ``model``'s weights as a flax-layout ``.npz``."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flax_from_state_dict(model.state_dict()))


def load_params(path, model: nn.Module) -> nn.Module:
    """Load weights into ``model`` from a flax-layout ``.npz`` (the port's
    saves and ``utils.convert``'s output) or, on a host with msgpack, a
    flax ``.msgpack``. Returns ``model``."""
    if str(path).endswith(".msgpack"):
        from rbc_gym_tpu_torch.utils.convert import read_flax_msgpack

        tree = read_flax_msgpack(path)
    else:
        with np.load(path) as z:
            tree = {k: z[k] for k in z.files}
    model.load_state_dict(state_dict_from_flax(tree, model))
    return model
