"""Actor-critic policy networks, the twins of the JAX package's flax nets.

Port of ``rbc_gym_tpu.models.flax_nets``. Each module returns
``(mean, log_std, value)`` of a diagonal Gaussian policy with a
state-independent ``log_std`` and a value head. What keeps them equal to
flax, so that trained flax weights carry over (``models.params``):

* submodules and parameters carry flax's names (``Conv_0``, ``Dense_2``,
  ``FluidCNNExtractor_1``, ``log_std``), so a ``state_dict`` key is the
  flax path with ``.`` for ``/`` and ``weight`` for ``kernel``;
* tensors stay channels-first (NCHW / NCDHW, the env's layout), but every
  flatten goes through channels-last first, since flax flattens NHWC and
  the first dense layer's rows follow that order;
* ``nn.gelu`` in flax is the tanh approximation;
* the periodic pad is circular in the horizontal axes and zero in z;
* Conv and Dense weights start from flax's ``lecun_normal`` (truncated
  normal of variance 1/fan_in) with zero biases, not torch's defaults;
  the training configs were tuned on that init.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# std of a standard normal truncated to [-2, 2], which lecun_normal divides by
_TRUNC_STD = 0.87962566103423978


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def periodic_pad_2d(x: torch.Tensor, pad_h: int = 1, pad_w: int = 1) -> torch.Tensor:
    """(B, C, H, W): circular pad in W (periodic x), zero pad in H (bounded z)."""
    x = torch.cat([x[..., -pad_w:], x, x[..., :pad_w]], dim=-1)
    return F.pad(x, (0, 0, pad_h, pad_h))


def periodic_pad_3d(x: torch.Tensor, pad_d: int = 1, pad_h: int = 1,
                    pad_w: int = 1) -> torch.Tensor:
    """(B, C, D, H, W): circular pad in H and W (periodic), zero pad in D
    (bounded vertical)."""
    if pad_h > 0:
        x = torch.cat([x[..., -pad_h:, :], x, x[..., :pad_h, :]], dim=-2)
    if pad_w > 0:
        x = torch.cat([x[..., -pad_w:], x, x[..., :pad_w]], dim=-1)
    if pad_d > 0:
        x = F.pad(x, (0, 0, 0, 0, pad_d, pad_d))
    return x


def channels_last_flatten(x: torch.Tensor) -> torch.Tensor:
    """(B, C, *spatial) -> (B, prod(spatial) * C) in flax's NHWC order."""
    return torch.movedim(x, 1, -1).flatten(1)


def lecun_normal_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default init for every Conv and Linear inside ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                m.bias.zero_()


class RBCActorCritic2D(nn.Module):
    """Diagonal-Gaussian actor-critic for the 2D env (flax_nets.py:113-159).

    Input obs: (B, C, nz_o, nx_o) as the env produces it; the action mean
    is (B, n_heaters). Separate actor and critic conv trunks by default;
    ``shared_trunk=True`` shares one (the reference's
    share_features_extractor=True) at the cost of the critic's gradients
    moving the policy's features.
    """

    def __init__(self, n_heaters: int = 12, hidden_channels: int = 32,
                 log_std_init: float = 0.0, shared_trunk: bool = False,
                 in_channels: int = 3, obs_shape: Tuple[int, int] = (8, 48),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shared_trunk = shared_trunk
        h = hidden_channels
        n_convs = 2 if shared_trunk else 4
        for i in range(n_convs):
            setattr(self, f"Conv_{i}", nn.Conv2d(in_channels if i % 2 == 0 else h, h, 3))
        nz, nx = obs_shape
        features = h * (nz // 4) * (nx // 4)
        self.Dense_0 = nn.Linear(features, 128)
        self.Dense_1 = nn.Linear(features, 128)
        self.Dense_2 = nn.Linear(128, n_heaters)
        self.Dense_3 = nn.Linear(128, 1)
        self.log_std = nn.Parameter(torch.full((n_heaters,), float(log_std_init)))
        lecun_normal_(self, generator)

    def _trunk(self, x: torch.Tensor, first: int) -> torch.Tensor:
        for i in (first, first + 1):
            x = gelu(getattr(self, f"Conv_{i}")(periodic_pad_2d(x)))
            x = F.max_pool2d(x, 2)
        return channels_last_flatten(x)

    def forward(self, obs: torch.Tensor):
        pi_feats = self._trunk(obs, 0)
        vf_feats = pi_feats if self.shared_trunk else self._trunk(obs, 2)
        pi = gelu(self.Dense_0(pi_feats))
        vf = gelu(self.Dense_1(vf_feats))
        return self.Dense_2(pi), self.log_std, self.Dense_3(vf)[..., 0]


class FluidCNNExtractor(nn.Module):
    """(B, C_in, D, H, W) -> (B, features_dim): two blocks of periodic pad,
    Conv3d(k=3), GELU, MaxPool3d(2) (reference models/CNN.py:33-73)."""

    def __init__(self, in_channels: int = 4, hidden_channels: int = 8,
                 features_dim: int = 8 * 4 * 8 * 8):
        super().__init__()
        self.features_dim = features_dim
        self.Conv_0 = nn.Conv3d(in_channels, hidden_channels, 3)
        self.Conv_1 = nn.Conv3d(hidden_channels, hidden_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.Conv_0, self.Conv_1):
            x = F.max_pool3d(gelu(conv(periodic_pad_3d(x))), 2)
        feats = channels_last_flatten(x)
        if feats.shape[-1] != self.features_dim:
            raise ValueError(f"expected {self.features_dim} features, got {feats.shape[-1]}")
        return feats


class ActorCriticNetwork(nn.Module):
    """Latent actor and critic heads over the extractor's (B, 4, 8, 8, 8)
    channels-last map (reference models/CustomNetwork.py:14-81)."""

    def __init__(self, latent_shape: Tuple[int, int, int, int] = (4, 8, 8, 8)):
        super().__init__()
        d, _, _, c = latent_shape
        self.latent_shape = latent_shape
        self.Conv_0 = nn.Conv3d(c, 4, 3)
        self.Conv_1 = nn.Conv3d(4, 1, 3)
        self.Conv_2 = nn.Conv3d(1, 1, (d, 1, 1))  # collapses depth
        self.Conv_3 = nn.Conv3d(c, 4, 3)
        self.Conv_4 = nn.Conv3d(4, 2, 3)

    def _latent(self, feats: torch.Tensor) -> torch.Tensor:
        d, h, w, c = self.latent_shape
        return feats.reshape(feats.shape[0], d, h, w, c).permute(0, 4, 1, 2, 3)

    def forward(self, pi_feats: torch.Tensor, vf_feats: torch.Tensor):
        a = self._latent(pi_feats)
        a = gelu(self.Conv_0(periodic_pad_3d(a)))
        a = gelu(self.Conv_1(periodic_pad_3d(a)))
        a = self.Conv_2(a)
        pi_latent = channels_last_flatten(a)  # (B, H*W)

        v = self._latent(vf_feats)
        v = gelu(self.Conv_3(periodic_pad_3d(v)))
        v = gelu(self.Conv_4(periodic_pad_3d(v)))
        vf_latent = channels_last_flatten(F.max_pool3d(v, 2))  # (B, 64)
        return pi_latent, vf_latent


class RBCActorCritic(nn.Module):
    """Diagonal-Gaussian actor-critic for the 3D env (flax_nets.py:162-195).

    Input obs: (B, 4, nz, ny, nx) as the env produces it; the action mean
    is (B, S, S) over the heater grid. ``share_features_extractor=True``
    is the reference's setting; False (the default) gives the critic its
    own extractor."""

    def __init__(self, action_grid: Tuple[int, int] = (8, 8), log_std_init: float = 0.0,
                 share_features_extractor: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_grid = tuple(action_grid)
        self.share_features_extractor = share_features_extractor
        self.FluidCNNExtractor_0 = FluidCNNExtractor()
        if not share_features_extractor:
            self.FluidCNNExtractor_1 = FluidCNNExtractor()
        self.ActorCriticNetwork_0 = ActorCriticNetwork()
        s1, s2 = self.action_grid
        self.Dense_0 = nn.Linear(64, s1 * s2)
        self.Dense_1 = nn.Linear(64, 1)
        self.log_std = nn.Parameter(torch.full(self.action_grid, float(log_std_init)))
        lecun_normal_(self, generator)

    def forward(self, obs: torch.Tensor):
        feats = self.FluidCNNExtractor_0(obs)
        vf_feats = feats if self.share_features_extractor else self.FluidCNNExtractor_1(obs)
        pi_latent, vf_latent = self.ActorCriticNetwork_0(feats, vf_feats)
        mean = self.Dense_0(pi_latent).reshape(-1, *self.action_grid)
        return mean, self.log_std, self.Dense_1(vf_latent)[..., 0]
