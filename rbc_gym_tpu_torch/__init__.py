"""PyTorch/CUDA port of ``rbc_gym_tpu`` for NVIDIA Hopper (H100).

The port imports torch and numpy only: no jax, gymnasium or h5py, and
nothing of ``rbc_gym_tpu``. Entry points take an explicit ``device`` that
defaults to ``"cuda"``; the CPU is used only when the caller asks for it.
On CUDA the hot path runs hand-written kernels (``csrc/``, built with nvcc
at first use); on the CPU it runs their plain PyTorch versions.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Float32 products on the card run in full float32: the solver's spectral
# constants and the parity gates assume it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Resolve ``device``; raise if CUDA is asked for (the default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rbc_gym_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
