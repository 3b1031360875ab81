"""Carry solver state between the JAX package and the port.

The env holds no weights: its whole state is the field tuple, and the
spectral constants are rebuilt in each package from the same float64 numpy
formulas. ``fields_from_numpy`` takes a JAX ``Fields2D`` given as numpy
arrays (``jax.tree_util.tree_map(np.asarray, fields)``, or any object with
``u, w, b, p_hy, p_nhs`` attributes) to the port's ``Fields2D``;
``fields_to_numpy`` goes back. Both packages use the batch-major
(..., nx, nz[+1]) layout at their public functions, so no axis moves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rbc_gym_tpu_torch.sim.solver2d import Fields2D


def fields_from_numpy(fields, device="cpu", dtype: torch.dtype = torch.float64) -> Fields2D:
    """Numpy (or array-like) fields -> the port's Fields2D on device/dtype."""
    return Fields2D(
        *(
            torch.tensor(np.asarray(getattr(fields, name)), dtype=dtype, device=device)
            for name in Fields2D._fields
        )
    )


def fields_to_numpy(fields: Fields2D) -> Dict[str, np.ndarray]:
    """The port's Fields2D -> {name: numpy array}, in the same layout."""
    return {name: getattr(fields, name).detach().cpu().numpy() for name in Fields2D._fields}
