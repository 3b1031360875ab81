"""Single-agent PPO on the 3D RBC environment, on the port.

Twin of ``experiments/run_sarl.py``: the same ``DEFAULT_CONFIG``, flags
(``--config``, ``--output_dir``, ``--resume_training``, ``--wandb``,
``--num_envs``, ``--iterations``, ``--n_steps``, ``--ra``,
``--checkpoint``), frozen config on resume, batch-size repair, callback
order and output layout, plus ``--device`` (default ``cuda``). The bank
(``rbc_checkpoint``) may be the reference's HDF5 (on a host with h5py) or
``.npz``; ``rbc_gym_tpu_torch/assets/3D_ckpt_ra2500_train.npz`` is the
Ra=2500 training bank as a card reads it. Params are saved as flax-layout
``.npz``.

The JAX script's multi-host steps (``initialize_distributed`` and
``shard_ppo_trainer`` over a host x env mesh) have no counterpart here:
the port trains on one card (multi-GPU is ROADMAP A.9).

Usage:
  python -m rbc_gym_tpu_torch.experiments.run_sarl \\
      --config experiments/configs/sarl3d_ra2500.yaml --output_dir results/run1 \\
      [--checkpoint rbc_gym_tpu_torch/assets/3D_ckpt_ra2500_train.npz] \\
      [--iterations K] [--wandb] [--resume_training] [--device cpu]

Output: ``<output_dir>/config.yaml`` (the frozen config), ``metrics.jsonl``,
``models/best_model.npz``, ``models/final_model.npz``,
``models/checkpoints/rl_model_<steps>_steps.npz`` and the full resumable
state ``models/checkpoints/latest_full.npz``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from datetime import datetime

logger = logging.getLogger("run_sarl")

DEFAULT_CONFIG = {
    # reference defaults (experiments/run_sarl.py:61-92), with n_envs raised
    # because lockstep envs are nearly free compared to subprocesses
    "rl_n_steps": 4,
    "rl_n_envs": 16,
    "rl_batch_size": 16,
    "rl_n_epochs": 10,
    "rl_ent_coef": 0.01,
    "rl_learning_rate": 3e-4,
    "rl_target_kl": 0.02,
    "rl_anneal_lr": False,
    # reference RBCNormalizeReward: keeps the critic's return scale O(10)
    "rl_normalize_reward": True,
    "rl_stat_window_size": 50,
    "rl_nr_iterations": 10,
    "rbc_heater_duration": 0.375,
    "rbc_heater_limit": 0.9,
    "rbc_rayleigh_number": 2500,
    "rbc_episode_length": 10,
    "rbc_state_shape": [16, 32, 32],
    "rbc_dt_solver": 0.01,
    "rbc_checkpoint": None,  # path to a 3D bank; None = random ICs
    "rbc_checkpoint_idx": None,
    "rl_log_std_init": 0.0,  # reference/SB3 default exploration scale
    # persisted architecture flag: separate actor/critic extractors (False)
    # is what learns; True is the reference's shared extractor
    "rl_share_features_extractor": False,
    "seed": 0,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    datestring = datetime.now().strftime("%Y%m%d_%H%M%S")
    p.add_argument("--output_dir", type=str, default=f"results/run_local_{datestring}")
    p.add_argument("--resume_training", action="store_true",
                   help="resume from <output_dir>/models/checkpoints/latest_full.npz "
                        "(full state: optimizer, env, generators)")
    p.add_argument("--wandb", action="store_true",
                   help="enable W&B logging (requires wandb installed)")
    p.add_argument("--num_envs", type=int, default=None, help="override rl_n_envs")
    p.add_argument("--iterations", type=int, default=None, help="override rl_nr_iterations")
    p.add_argument("--n_steps", type=int, default=None, help="override rl_n_steps")
    p.add_argument("--ra", type=float, default=None, help="override rbc_rayleigh_number")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="override rbc_checkpoint (3D bank path)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_config(args) -> dict:
    """``DEFAULT_CONFIG``, then the YAML (the frozen one on resume), then
    the flags; the JAX script's batch-size repair and divisibility rule."""
    config = dict(DEFAULT_CONFIG)
    # a resumed run must rebuild the same trainer: the frozen snapshot in
    # the output dir is the source of truth there
    frozen = os.path.join(args.output_dir, "config.yaml")
    if args.resume_training and os.path.isfile(frozen) and args.config is None:
        args.config = frozen
    if args.config and os.path.isfile(args.config):
        import yaml

        with open(args.config) as f:
            config.update(yaml.safe_load(f))
        logger.info("Loaded config from %s", args.config)
    overrides = {
        "rl_n_envs": args.num_envs,
        "rl_nr_iterations": args.iterations,
        "rl_n_steps": args.n_steps,
        "rbc_rayleigh_number": args.ra,
        "rbc_checkpoint": args.checkpoint,
    }
    for key, val in overrides.items():
        if val is not None:
            config[key] = val
    buffer = config["rl_n_steps"] * config["rl_n_envs"]
    # a buffer resized by a flag batches one env-batch worth of timesteps
    if (args.num_envs is not None or args.n_steps is not None) and (
            buffer % config["rl_batch_size"] != 0):
        config["rl_batch_size"] = config["rl_n_envs"]
    if buffer % config["rl_batch_size"] != 0:
        raise ValueError("rollout_buffer_size must be divisible by batch_size")
    return config


def make_trainer(config: dict, device: str):
    """The PPO trainer of ``config``, its eval env and its obs transform,
    on ``device``."""
    import torch

    from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
    from rbc_gym_tpu_torch.models.nets import RBCActorCritic
    from rbc_gym_tpu_torch.rl import PPO, PPOConfig
    from rbc_gym_tpu_torch.wrappers import functional as fn

    env_kwargs = dict(
        rayleigh_number=config["rbc_rayleigh_number"],
        state_shape=tuple(config["rbc_state_shape"]),
        heater_segments=int(config.get("rbc_heater_segments", 8)),
        heater_duration=config["rbc_heater_duration"],
        heater_limit=config["rbc_heater_limit"],
        episode_length=config["rbc_episode_length"],
        dt_solver=config["rbc_dt_solver"],
        checkpoint=config["rbc_checkpoint"],
        checkpoint_idx=config["rbc_checkpoint_idx"],
        device=device,
    )
    n_envs = config["rl_n_envs"]
    env = RBC3DVectorEnv(num_envs=n_envs, **env_kwargs)
    eval_env = RBC3DVectorEnv(num_envs=max(1, n_envs // 4), **env_kwargs)
    norm = fn.make_obs_norm_3d(ra=config["rbc_rayleigh_number"],
                               heater_limit=config["rbc_heater_limit"])

    def obs_transform(o):
        return fn.normalize_observation(o, norm, channel_axis=-4)

    reward_transform = None
    if config.get("rl_normalize_reward", False):
        scale = fn.reward_scale(config["rbc_rayleigh_number"], three_d=True)

        def reward_transform(r):
            return fn.normalize_reward(r, scale)

    s = env.params.n_heaters
    trainer = PPO(
        env,
        RBCActorCritic(action_grid=(s, s), log_std_init=config.get("rl_log_std_init", 0.0),
                       share_features_extractor=bool(
                           config.get("rl_share_features_extractor", False))),
        PPOConfig(
            n_steps=config["rl_n_steps"],
            n_epochs=config["rl_n_epochs"],
            n_minibatches=config["rl_n_steps"] * n_envs // config["rl_batch_size"],
            ent_coef=config["rl_ent_coef"],
            learning_rate=config["rl_learning_rate"],
            target_kl=config.get("rl_target_kl"),
            anneal_lr=bool(config.get("rl_anneal_lr", False)),
            total_iterations=config["rl_nr_iterations"],
        ),
        obs_transform=obs_transform,
        reward_transform=reward_transform,
        seed=config["seed"],
        device=torch.device(device),
    )
    return trainer, eval_env, obs_transform


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = parse_args(argv)
    config = load_config(args)
    os.makedirs(args.output_dir, exist_ok=True)
    import yaml

    with open(os.path.join(args.output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)

    from rbc_gym_tpu_torch.rl import (
        CheckpointCallback,
        EvaluationCallback,
        MetricsLogger,
        NusseltCallback,
        WandbCallback,
        restore_training_state_with_fallback,
        save_params,
        truncate_metrics_jsonl,
    )

    trainer, eval_env, obs_transform = make_trainer(config, args.device)
    logger.info("Rollout buffer: %d timesteps per rollout (%d envs x %d steps)",
                config["rl_n_steps"] * config["rl_n_envs"], config["rl_n_envs"],
                config["rl_n_steps"])
    models = os.path.join(args.output_dir, "models")
    ckpt_cb = CheckpointCallback(os.path.join(models, "checkpoints"), save_freq=4)
    metrics_path = os.path.join(args.output_dir, "metrics.jsonl")
    # callbacks that add metrics precede the sinks (MetricsLogger, W&B);
    # CheckpointCallback runs last so the full-state snapshot holds the
    # others' post-iteration state
    callbacks = [
        NusseltCallback(),
        EvaluationCallback(eval_env, n_steps=trainer.env.episode_steps, freq=10,
                           save_model=True, save_path=models, obs_transform=obs_transform),
        MetricsLogger(metrics_path),
    ]
    if args.wandb:
        callbacks.append(WandbCallback(project="rbc-3D-rl", config=config, dir=args.output_dir,
                                       model_save_path=models))
    callbacks = tuple(callbacks) + (ckpt_cb,)
    ckpt_cb.sibling_callbacks = callbacks

    start_iteration = 0
    if args.resume_training:
        # falls back to latest_full.npz.new / previous_full.npz when the
        # primary is missing or corrupt
        start_iteration = restore_training_state_with_fallback(ckpt_cb.full_path, trainer,
                                                               callbacks=callbacks)
        kept = truncate_metrics_jsonl(metrics_path, start_iteration - 1)
        logger.info("Resuming at iteration %d (%d metrics records kept)", start_iteration, kept)

    metrics = trainer.learn(config["rl_nr_iterations"], callbacks=callbacks,
                            start_iteration=start_iteration)
    logger.info("Final metrics: %s", json.dumps(metrics, indent=2))
    save_params(trainer.model, os.path.join(models, "final_model.npz"))


if __name__ == "__main__":
    main()
