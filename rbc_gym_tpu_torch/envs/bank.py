"""Checkpoint-bank initial conditions on the device.

The JAX envs' ``_fields_from_bank`` (``rbc_gym_tpu/envs/vector2d.py:141-158``,
``vector3d.py:153-171``) for a batch of envs: the bank lives on the env's
device, and a reset gathers the chosen episodes from it in one call per
field. With ``ic_noise`` the gathered state gets a Gaussian kick of that
amplitude (b clamped to the plate range, the wall faces of w set to zero),
drawn for the whole batch from one generator seeded by the envs' keys
(``autoreset.batch_generator``). pHY' is recomputed from b.
"""

from __future__ import annotations

import torch

from rbc_gym_tpu_torch.envs.autoreset import batch_generator, fold_in
from rbc_gym_tpu_torch.ops.kernels2d import hydrostatic_pressure
from rbc_gym_tpu_torch.utils import checkpoints as ckpt


class DeviceBank:
    """A bank's velocity and buoyancy fields on ``device`` in ``dtype``,
    and what turns episodes of it into an env's initial fields."""

    def __init__(self, path, cls, shape: tuple, dtype: torch.dtype, device, ic_noise: float,
                 min_b: float, delta_b: float, dz: float):
        """``cls`` is Fields2D or Fields3D and ``shape`` the env's (nx, [ny,]
        nz); the bank must fit it."""
        three_d = len(shape) == 3
        bank = (ckpt.load_bank_3d if three_d else ckpt.load_bank_2d)(path)
        self.names = ("u", "v", "w", "b") if three_d else ("u", "w", "b")
        want = {n: tuple(shape[:-1]) + (shape[-1] + (n == "w"),) for n in self.names}
        got = {n: tuple(getattr(bank, n).shape[1:]) for n in self.names}
        if got != want:
            raise ValueError(f"{path}: bank fields {got} do not fit the env's grid {want}")
        self.arrays = {n: torch.as_tensor(getattr(bank, n), dtype=dtype, device=device)
                       for n in self.names}
        self.size = bank.num_episodes
        self.device = torch.device(device)
        self.cls, self.ic_noise = cls, float(ic_noise)
        self.min_b, self.delta_b, self.dz = min_b, delta_b, dz

    def fields(self, idx: torch.Tensor, keys: torch.Tensor):
        """Initial fields from bank episodes ``idx``, one per env; ``keys``
        are the envs' init keys, which seed the noise."""
        idx = idx.to(self.device)
        f = {n: a.index_select(0, idx) for n, a in self.arrays.items()}
        if self.ic_noise > 0.0:
            gen = batch_generator(fold_in(keys, 1), self.device)
            for n in ("b",) + self.names[:-1]:
                a = f[n]
                f[n] = a + self.ic_noise * torch.randn(a.shape, generator=gen, dtype=a.dtype,
                                                       device=a.device)
            f["w"][..., 0] = 0.0
            f["w"][..., -1] = 0.0
            f["b"] = torch.clamp(f["b"], self.min_b, self.min_b + self.delta_b)
        b = f["b"]
        return self.cls(**f, p_hy=hydrostatic_pressure(b, self.dz, self.min_b),
                        p_nhs=torch.zeros_like(b))
