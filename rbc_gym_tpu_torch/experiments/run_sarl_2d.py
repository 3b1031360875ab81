"""Single-agent PPO on the 2D RBC environment, on the port.

Twin of ``experiments/run_sarl_2d.py``: the same ``DEFAULT_CONFIG``, flags,
output layout and resume, plus ``--device`` (default ``cuda``). The bank
(``rbc_checkpoint``) may be the reference's HDF5 (on a host with h5py) or
``.npz``; ``rbc_gym_tpu_torch/assets/ckpt_ra10000_train.npz`` is the Ra=1e4
training bank as a card reads it. Params are saved as flax-layout ``.npz``.

Usage:
  python -m rbc_gym_tpu_torch.experiments.run_sarl_2d --output_dir results/sarl2d \\
      [--config cfg.yaml] [--num_envs N] [--iterations K] [--device cpu]

Output: ``<output_dir>/config.yaml`` (the frozen config), ``metrics.jsonl``,
``models/best_model.npz``, ``models/final_model.npz``,
``models/checkpoints/rl_model_<steps>_steps.npz`` and the full resumable
state ``models/checkpoints/latest_full.npz`` (``--resume_training``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from datetime import datetime

logger = logging.getLogger("run_sarl_2d")

DEFAULT_CONFIG = {
    "rl_n_steps": 64,
    "rl_n_envs": 256,
    "rl_batch_size": 2048,
    "rl_n_epochs": 10,
    "rl_ent_coef": 0.01,
    "rl_learning_rate": 3e-4,
    "rl_target_kl": 0.02,
    "rl_anneal_lr": True,
    # reference RBCNormalizeReward: reward=-Nu mapped into ~[0, 1] by the
    # Nu_max power law, keeping the critic's return scale O(10)
    "rl_normalize_reward": True,
    "rl_nr_iterations": 300,
    "rl_log_std_init": -0.5,
    "rbc_heater_duration": 1.5,
    "rbc_heater_segments": 12,
    "rbc_heater_limit": 0.75,
    "rbc_rayleigh_number": 10_000,
    "rbc_episode_length": 300,
    "rbc_observation_shape": [8, 48],
    "rbc_state_shape": [64, 96],
    "rbc_checkpoint": "data/checkpoints/train/ckpt_ra10000.h5",
    # persisted so evaluation rebuilds the trained architecture: separate
    # actor and critic trunks (False) is the configuration that learns
    "rl_shared_trunk": False,
    "seed": 0,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    datestring = datetime.now().strftime("%Y%m%d_%H%M%S")
    p.add_argument("--output_dir", type=str, default=f"results/run2d_{datestring}")
    p.add_argument("--resume_training", action="store_true",
                   help="resume from <output_dir>/models/checkpoints/latest_full.npz "
                        "(full state: optimizer, env, generators)")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--n_steps", type=int, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_config(args) -> dict:
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
    for key, val in (("rl_n_envs", args.num_envs), ("rl_nr_iterations", args.iterations),
                     ("rl_n_steps", args.n_steps), ("rbc_checkpoint", args.checkpoint)):
        if val is not None:
            config[key] = val
    buffer = config["rl_n_steps"] * config["rl_n_envs"]
    if buffer % config["rl_batch_size"] != 0:
        logger.warning("rl_batch_size %d does not divide the rollout buffer (%d); using "
                       "rl_batch_size=%d instead", config["rl_batch_size"], buffer,
                       config["rl_n_envs"])
        config["rl_batch_size"] = config["rl_n_envs"]
    return config


def make_trainer(config: dict, device: str, mesh=None):
    """The PPO trainer of ``config`` and its eval env, on ``device``; over
    the ranks of ``mesh`` as ``run_sarl.make_trainer``."""
    import torch

    from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
    from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D
    from rbc_gym_tpu_torch.parallel import shard_ppo_trainer, shard_vector_env
    from rbc_gym_tpu_torch.rl import PPO, PPOConfig
    from rbc_gym_tpu_torch.wrappers import functional as fn

    n_envs = config["rl_n_envs"]
    env_kwargs = dict(
        rayleigh_number=config["rbc_rayleigh_number"],
        observation_shape=tuple(config["rbc_observation_shape"]),
        state_shape=tuple(config["rbc_state_shape"]),
        heater_duration=config["rbc_heater_duration"],
        heater_segments=config.get("rbc_heater_segments", 12),
        heater_limit=config["rbc_heater_limit"],
        episode_length=config["rbc_episode_length"],
        checkpoint=config["rbc_checkpoint"],
        device=device,
    )
    if mesh is None:
        env = RBC2DVectorEnv(num_envs=n_envs, **env_kwargs)
    else:
        env = shard_vector_env(RBC2DVectorEnv, n_envs, mesh, **env_kwargs)
    eval_env = (RBC2DVectorEnv(num_envs=max(1, n_envs // 4), **env_kwargs)
                if mesh is None or mesh.rank == 0 else None)
    norm = fn.make_obs_norm_2d(heater_limit=config["rbc_heater_limit"])

    def obs_transform(o):
        return fn.normalize_observation(o, norm, channel_axis=-3)

    reward_transform = None
    if config.get("rl_normalize_reward", False):
        scale = fn.reward_scale(config["rbc_rayleigh_number"], three_d=False)

        def reward_transform(r):
            return fn.normalize_reward(r, scale)

    n_minibatches = config["rl_n_steps"] * n_envs // config["rl_batch_size"]
    trainer = PPO(
        env,
        RBCActorCritic2D(
            n_heaters=env.params.n_heaters,
            log_std_init=config["rl_log_std_init"],
            shared_trunk=bool(config.get("rl_shared_trunk", False)),
            obs_shape=env.observation_shape,
        ),
        PPOConfig(
            n_steps=config["rl_n_steps"],
            n_epochs=config["rl_n_epochs"],
            n_minibatches=n_minibatches,
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
    if mesh is not None:
        shard_ppo_trainer(trainer, mesh)
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
        restore_training_state_with_fallback,
        save_params,
        truncate_metrics_jsonl,
    )

    trainer, eval_env, obs_transform = make_trainer(config, args.device)
    logger.info("Rollout buffer: %d timesteps (%d envs x %d steps)",
                config["rl_n_steps"] * config["rl_n_envs"], config["rl_n_envs"],
                config["rl_n_steps"])
    models = os.path.join(args.output_dir, "models")
    ckpt_cb = CheckpointCallback(os.path.join(models, "checkpoints"), save_freq=10)
    metrics_path = os.path.join(args.output_dir, "metrics.jsonl")
    # metric-adding callbacks precede the sinks; CheckpointCallback runs
    # last so the full-state snapshot holds the others' post-iteration state
    callbacks = (
        NusseltCallback(),
        EvaluationCallback(eval_env, n_steps=min(eval_env.episode_steps, 100), freq=10,
                           save_model=True, save_path=models, obs_transform=obs_transform),
        MetricsLogger(metrics_path),
        ckpt_cb,
    )
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
