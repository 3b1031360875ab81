"""On-device RL for the port: PPO, callbacks and full-state checkpoints."""

from rbc_gym_tpu_torch.models.params import load_params, save_params
from rbc_gym_tpu_torch.rl.callbacks import (
    CheckpointCallback,
    EvaluationCallback,
    MetricsLogger,
    NusseltCallback,
    WandbCallback,
)
from rbc_gym_tpu_torch.rl.checkpoint import (
    restore_training_state,
    restore_training_state_with_fallback,
    save_training_state,
    truncate_metrics_jsonl,
)
from rbc_gym_tpu_torch.rl.ppo import PPO, PPOConfig, Transition

__all__ = [
    "PPO",
    "PPOConfig",
    "Transition",
    "CheckpointCallback",
    "EvaluationCallback",
    "MetricsLogger",
    "NusseltCallback",
    "WandbCallback",
    "load_params",
    "save_params",
    "restore_training_state",
    "restore_training_state_with_fallback",
    "save_training_state",
    "truncate_metrics_jsonl",
]
