"""Initial-condition checkpoint banks.

Port of ``rbc_gym_tpu.utils.checkpoints``. A bank holds burned-in turbulent
states, one per episode, that the vector envs start episodes from. Two
file formats:

* ``.npz`` (the port's own, and the JAX package's native one): arrays
  ``b``/``u``/``w`` (+ ``v`` in 3D) in solver order (episodes, nx, [ny,]
  nz[+1]) and ``start_seed``. It needs numpy only, so it is the format a
  CUDA machine reads.
* HDF5 as the reference writes it: datasets in Julia order (episodes, nx,
  [1 or ny,] nz), which h5py sees with the axes reversed, and attrs
  ``num_episodes`` / ``start_seed``. ``w`` has nz+1 vertical face points
  (staggered grid). h5py is imported only when such a file is read or
  written, on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CheckpointBank2D:
    """Episode bank in solver order: (episodes, nx, nz[+1])."""

    b: np.ndarray  # (E, nx, nz)
    u: np.ndarray  # (E, nx, nz)
    w: np.ndarray  # (E, nx, nz + 1)
    start_seed: int = 0

    @property
    def num_episodes(self) -> int:
        return self.b.shape[0]


@dataclasses.dataclass
class CheckpointBank3D:
    """Episode bank in solver order: (episodes, nx, ny, nz[+1])."""

    b: np.ndarray
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    start_seed: int = 0

    @property
    def num_episodes(self) -> int:
        return self.b.shape[0]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is needed for HDF5 checkpoint banks; convert the bank to .npz on a "
            "host that has it: python -m rbc_gym_tpu_torch.utils.convert bank IN.h5 OUT.npz"
        ) from e
    return h5py


def _is_npz(path) -> bool:
    return str(path).endswith(".npz")


def _load_npz(path, cls):
    with np.load(path) as d:
        names = [f.name for f in dataclasses.fields(cls) if f.name != "start_seed"]
        seed = int(d["start_seed"]) if "start_seed" in d.files else 0
        return cls(**{n: d[n] for n in names}, start_seed=seed)


def _save_npz(path, bank) -> None:
    np.savez_compressed(path, **dataclasses.asdict(bank))


def load_bank_2d(path) -> CheckpointBank2D:
    """Load a 2D bank from the reference's HDF5 or from .npz."""
    if _is_npz(path):
        return _load_npz(path, CheckpointBank2D)
    with _h5py().File(path, "r") as f:
        # file dims (Julia order): (E, nx, 1, nz); h5py view: (nz, 1, nx, E)
        def rd(name):
            return np.transpose(f[name][...], (3, 2, 0, 1))[..., 0]  # (E, nx, nz)

        return CheckpointBank2D(b=rd("b"), u=rd("u"), w=rd("w"),
                                start_seed=int(f.attrs.get("start_seed", 0)))


def save_bank_2d(path, bank: CheckpointBank2D) -> None:
    if _is_npz(path):
        _save_npz(path, bank)
        return
    with _h5py().File(path, "w") as f:
        f.attrs["num_episodes"] = bank.num_episodes
        f.attrs["start_seed"] = bank.start_seed
        # the layout h5py sees for reference files: (nz, 1, nx, E)
        for name in ("b", "u", "w"):
            arr = getattr(bank, name)
            f.create_dataset(name, data=np.transpose(arr[:, :, None, :], (3, 2, 1, 0)))


def load_bank_3d(path) -> CheckpointBank3D:
    """Load a 3D bank from the reference's HDF5 or from .npz."""
    if _is_npz(path):
        return _load_npz(path, CheckpointBank3D)
    with _h5py().File(path, "r") as f:
        # file dims (E, nx, ny, nz); h5py view: (nz, ny, nx, E)
        def rd(name):
            return np.transpose(f[name][...], (3, 2, 1, 0))  # (E, nx, ny, nz)

        return CheckpointBank3D(b=rd("b"), u=rd("u"), v=rd("v"), w=rd("w"),
                                start_seed=int(f.attrs.get("start_seed", 0)))


def save_bank_3d(path, bank: CheckpointBank3D) -> None:
    if _is_npz(path):
        _save_npz(path, bank)
        return
    with _h5py().File(path, "w") as f:
        f.attrs["num_episodes"] = bank.num_episodes
        f.attrs["start_seed"] = bank.start_seed
        for name in ("b", "u", "v", "w"):
            f.create_dataset(name, data=np.transpose(getattr(bank, name), (3, 2, 1, 0)))
