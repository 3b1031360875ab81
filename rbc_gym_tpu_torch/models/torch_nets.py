"""The SB3-style torch networks: the port's copy of ``rbc_gym_tpu.models.torch_nets``.

The reference trains with Stable-Baselines3 (experiments/run_sarl.py); users
migrating from it may want the same torch modules. SB3 itself is an optional
dependency: ``FluidCNNExtractor``'s SB3 base class and
``CustomActorCriticPolicy`` are only defined when SB3 imports. The port's
own training path (``rbc_gym_tpu_torch.rl``) uses ``models.nets`` instead.

Architecture parity: reference models/CNN.py and models/CustomNetwork.py
(periodic pad in horizontal axes, zero pad vertical; same channel widths).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

try:
    from stable_baselines3.common.torch_layers import BaseFeaturesExtractor
    from stable_baselines3.common.policies import ActorCriticPolicy

    HAS_SB3 = True
except ImportError:  # SB3 is optional (and pulls in gymnasium)
    BaseFeaturesExtractor = None
    ActorCriticPolicy = None
    HAS_SB3 = False


class PeriodicPad3D(nn.Module):
    """Circular pad in H/W (periodic horizontal), zero pad in D (vertical)."""

    def __init__(self, pad_d: int = 0, pad_h: int = 1, pad_w: int = 1):
        super().__init__()
        self.pad_d = pad_d
        self.pad_h = pad_h
        self.pad_w = pad_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, C, D, H, W)
        if self.pad_h > 0:
            x = torch.cat(
                [x[:, :, :, -self.pad_h:, :], x, x[:, :, :, : self.pad_h, :]],
                dim=3,
            )
        if self.pad_w > 0:
            x = torch.cat(
                [x[:, :, :, :, -self.pad_w:], x, x[:, :, :, :, : self.pad_w]],
                dim=4,
            )
        if self.pad_d > 0:
            x = F.pad(
                x, (0, 0, 0, 0, self.pad_d, self.pad_d), mode="constant", value=0
            )
        return x


def _extractor_cnn(n_input_channels: int, hidden: int = 8) -> nn.Sequential:
    return nn.Sequential(
        PeriodicPad3D(pad_d=1, pad_h=1, pad_w=1),
        nn.Conv3d(n_input_channels, hidden, kernel_size=3),
        nn.GELU(),
        nn.MaxPool3d(2, 2),
        PeriodicPad3D(pad_d=1, pad_h=1, pad_w=1),
        nn.Conv3d(hidden, hidden, kernel_size=3),
        nn.GELU(),
        nn.MaxPool3d(2, 2),
        nn.Flatten(),
    )


class FluidCNN(nn.Module):
    """Standalone extractor usable without SB3."""

    def __init__(self, n_input_channels: int = 4,
                 features_dim: int = 8 * 4 * 8 * 8):
        super().__init__()
        self.features_dim = features_dim
        self.cnn = _extractor_cnn(n_input_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn(x)


class ActorCriticTorso(nn.Module):
    """Actor/critic latent heads (reference CustomNetwork, 64+64 latents)."""

    def __init__(self, feature_dim: int = 8 * 4 * 8 * 8):
        super().__init__()
        self.feature_dim = feature_dim
        self.latent_dim_pi = 8 * 8
        self.latent_dim_vf = 8 * 8
        self.policy_net = nn.Sequential(
            PeriodicPad3D(1, 1, 1),
            nn.Conv3d(8, 4, 3),
            nn.GELU(),
            PeriodicPad3D(1, 1, 1),
            nn.Conv3d(4, 1, 3),
            nn.GELU(),
            nn.Conv3d(1, 1, kernel_size=(4, 1, 1)),
            nn.Flatten(),
        )
        self.value_net = nn.Sequential(
            PeriodicPad3D(1, 1, 1),
            nn.Conv3d(8, 4, 3),
            nn.GELU(),
            PeriodicPad3D(1, 1, 1),
            nn.Conv3d(4, 2, 3),
            nn.GELU(),
            nn.MaxPool3d(2, 2),
            nn.Flatten(),
        )

    def _unflatten(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(x.size(0), 8, 4, 8, 8)

    def forward_actor(self, x: torch.Tensor) -> torch.Tensor:
        return self.policy_net(self._unflatten(x))

    def forward_critic(self, x: torch.Tensor) -> torch.Tensor:
        return self.value_net(self._unflatten(x))

    def forward(self, x: torch.Tensor):
        return self.forward_actor(x), self.forward_critic(x)


if HAS_SB3:

    class FluidCNNExtractor(BaseFeaturesExtractor):
        """SB3 feature extractor (reference models/CNN.py:33-73)."""

        def __init__(self, observation_space, features_dim: int = 8 * 4 * 8 * 8):
            super().__init__(observation_space, features_dim)
            self.cnn = _extractor_cnn(observation_space.shape[0])
            with torch.no_grad():
                sample = torch.as_tensor(
                    observation_space.sample()[None]
                ).float()
                n_flatten = self.cnn(sample).shape[1]
            assert n_flatten == features_dim, (
                f"Expected {features_dim} features, got {n_flatten}."
            )

        def forward(self, observation: torch.Tensor) -> torch.Tensor:
            return self.cnn(observation)

    class CustomActorCriticPolicy(ActorCriticPolicy):
        """SB3 actor-critic policy with the conv torso (reference
        models/CustomNetwork.py:85-106)."""

        def __init__(self, observation_space, action_space, lr_schedule,
                     *args, **kwargs):
            kwargs["ortho_init"] = False
            super().__init__(
                observation_space, action_space, lr_schedule, *args, **kwargs
            )

        def _build_mlp_extractor(self) -> None:
            self.mlp_extractor = ActorCriticTorso(self.features_dim)
