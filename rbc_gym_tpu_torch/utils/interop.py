"""Carry solver state between the JAX package and the port.

The env holds no weights: its whole state is the field tuple, and the
spectral constants are rebuilt in each package from the same float64 numpy
formulas. ``fields_from_numpy`` takes a JAX ``Fields2D`` or ``Fields3D``
given as numpy arrays (``jax.tree_util.tree_map(np.asarray, fields)``, or
any object with the field attributes) to the port's tuple of the same
name; ``fields_to_numpy`` goes back. Both packages use the batch-major
(..., nx, [ny,] nz[+1]) layout at their public functions, so no axis moves.
"""

from __future__ import annotations

from typing import Dict, Type, Union

import numpy as np
import torch

from rbc_gym_tpu_torch.sim.solver2d import Fields2D
from rbc_gym_tpu_torch.sim.solver3d import Fields3D


def fields_from_numpy(
    fields,
    device="cpu",
    dtype: torch.dtype = torch.float64,
    cls: Type[Union[Fields2D, Fields3D]] = Fields2D,
) -> Union[Fields2D, Fields3D]:
    """Numpy (or array-like) fields -> the port's ``cls`` on device/dtype."""
    return cls(
        *(
            torch.tensor(np.asarray(getattr(fields, name)), dtype=dtype, device=device)
            for name in cls._fields
        )
    )


def fields_to_numpy(fields: Union[Fields2D, Fields3D]) -> Dict[str, np.ndarray]:
    """The port's Fields2D or Fields3D -> {name: numpy array}, same layout."""
    return {name: t.detach().cpu().numpy() for name, t in fields._asdict().items()}
