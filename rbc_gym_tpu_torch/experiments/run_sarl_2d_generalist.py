"""Multi-Ra generalist 2D PPO on the port: one policy across a bank ladder.

Twin of ``experiments/run_sarl_2d_generalist.py``, plus ``--device``
(default ``cuda``) and ``--bank_pattern`` (where each rung's training bank
is; ``rbc_gym_tpu_torch/assets/ckpt_ra{ra}_train.npz`` as a card reads
them). K vector envs, one per Ra, each with its own Ra-correct reward
scale, env state, carried observation and generators; iteration i
collects its rollout from env i % K and applies the PPO update to the one
shared model. Per-rung result dirs (a ``config.yaml`` naming that rung
and the shared model as ``models/best_model.npz``) are what the port's
``eval_baselines`` reads.

The JAX script builds K trainers (seeds ``seed + i``) and then gives all
of them trainer 0's ``TrainState``: one set of params and one optimizer,
so one Adam count and one anneal schedule. The port's ``PPO`` owns a
module and a ``ClippedAdam``, so ``make_trainers`` hands every trainer
trainer 0's model and optimizer after building them.

Usage:
  python -m rbc_gym_tpu_torch.experiments.run_sarl_2d_generalist \\
      --ras 10000 30000 100000 1000000 --iterations 800 \\
      --output_dir results/sarl2d_generalist [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

logger = logging.getLogger("run_sarl_2d_generalist")

BASE = dict(
    rl_n_steps=64,
    rl_n_envs=256,
    rl_batch_size=2048,
    rl_n_epochs=10,
    rl_ent_coef=0.01,
    rl_learning_rate=3.0e-4,
    rl_target_kl=0.02,
    rl_anneal_lr=True,
    rl_normalize_reward=True,
    rl_log_std_init=-0.5,
    rbc_heater_duration=1.5,
    rbc_heater_segments=12,
    rbc_heater_limit=0.75,
    rbc_episode_length=300,
    rbc_observation_shape=[8, 48],
    rbc_state_shape=[64, 96],
    seed=0,
)
BANK_PATTERN = "data/checkpoints/train/ckpt_ra{ra}.h5"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ras", type=int, nargs="+", default=[10_000, 30_000, 100_000, 1_000_000])
    p.add_argument("--iterations", type=int, default=800)
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--n_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--output_dir", default="results/sarl2d_generalist")
    p.add_argument("--bank_pattern", default=BANK_PATTERN,
                   help="each rung's training bank, formatted with ra=")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def make_config(args) -> dict:
    cfg = dict(BASE, rl_n_envs=args.num_envs, rl_nr_iterations=args.iterations,
               rbc_ras=list(args.ras))
    if args.n_steps:
        cfg["rl_n_steps"] = args.n_steps
    if args.batch_size:
        cfg["rl_batch_size"] = args.batch_size
    return cfg


def make_trainers(cfg: dict, device, bank_pattern: str = BANK_PATTERN) -> list:
    """One ``PPO`` a rung of ``cfg["rbc_ras"]`` (seeds ``seed + i``), all
    sharing trainer 0's model and optimizer."""
    from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
    from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D
    from rbc_gym_tpu_torch.rl import PPO, PPOConfig
    from rbc_gym_tpu_torch.wrappers import functional as fn

    norm = fn.make_obs_norm_2d(heater_limit=cfg["rbc_heater_limit"])

    def obs_transform(o):
        return fn.normalize_observation(o, norm, channel_axis=-3)

    ppo_cfg = PPOConfig(
        n_steps=cfg["rl_n_steps"],
        n_epochs=cfg["rl_n_epochs"],
        n_minibatches=cfg["rl_n_steps"] * cfg["rl_n_envs"] // cfg["rl_batch_size"],
        ent_coef=cfg["rl_ent_coef"],
        learning_rate=cfg["rl_learning_rate"],
        target_kl=cfg["rl_target_kl"],
        anneal_lr=True,
        total_iterations=cfg["rl_nr_iterations"],
    )
    trainers = []
    for i, ra in enumerate(cfg["rbc_ras"]):
        env = RBC2DVectorEnv(
            num_envs=cfg["rl_n_envs"],
            rayleigh_number=ra,
            observation_shape=tuple(cfg["rbc_observation_shape"]),
            state_shape=tuple(cfg["rbc_state_shape"]),
            heater_duration=cfg["rbc_heater_duration"],
            heater_segments=cfg["rbc_heater_segments"],
            heater_limit=cfg["rbc_heater_limit"],
            episode_length=cfg["rbc_episode_length"],
            checkpoint=bank_pattern.format(ra=ra),
            device=device,
        )
        scale = fn.reward_scale(float(ra), three_d=False)
        model = RBCActorCritic2D(n_heaters=cfg["rbc_heater_segments"],
                                 log_std_init=cfg["rl_log_std_init"],
                                 obs_shape=env.observation_shape)
        trainers.append(PPO(env, model, ppo_cfg, obs_transform=obs_transform,
                            reward_transform=lambda r, s=scale: fn.normalize_reward(r, s),
                            seed=cfg["seed"] + i, device=device))
    # one model and one optimizer (one Adam count, one anneal schedule) for
    # every rung: trainer 0's; each trainer keeps its env state, obs and
    # generators
    for tr in trainers[1:]:
        tr.model, tr.optimizer = trainers[0].model, trainers[0].optimizer
    return trainers


def train(trainers: list, cfg: dict, metrics_path: str) -> list:
    """Round-robin iterations over the rungs; appends one record an
    iteration to ``metrics_path`` and returns the records."""
    ras = cfg["rbc_ras"]
    records, global_step, t0 = [], 0, time.time()
    with open(metrics_path, "a") as mf:
        for it in range(cfg["rl_nr_iterations"]):
            metrics = trainers[it % len(ras)]._iteration()
            global_step += cfg["rl_n_steps"] * cfg["rl_n_envs"]
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(iteration=it, global_step=global_step, ra=ras[it % len(ras)],
                       wall_time=round(time.time() - t0, 2))
            mf.write(json.dumps(rec) + "\n")
            mf.flush()
            records.append(rec)
            if it % 20 == 0:
                logger.info("iter %d (Ra=%d) nusselt %.3f", it, rec["ra"],
                            rec["rollout/nusselt_mean"])
    return records


def write_rungs(model, cfg: dict, output_dir: str, bank_pattern: str = BANK_PATTERN) -> None:
    """The shared model as ``models/final_model.npz`` and, per rung,
    ``ra<Ra>/config.yaml`` and ``ra<Ra>/models/best_model.npz``."""
    import yaml

    from rbc_gym_tpu_torch.rl import save_params

    save_params(model, os.path.join(output_dir, "models", "final_model.npz"))
    for ra in cfg["rbc_ras"]:
        d = os.path.join(output_dir, f"ra{ra}")
        os.makedirs(os.path.join(d, "models"), exist_ok=True)
        rung_cfg = {k: v for k, v in cfg.items() if k != "rbc_ras"}
        rung_cfg["rbc_rayleigh_number"] = ra
        rung_cfg["rbc_checkpoint"] = bank_pattern.format(ra=ra)
        with open(os.path.join(d, "config.yaml"), "w") as f:
            yaml.safe_dump(rung_cfg, f)
        save_params(model, os.path.join(d, "models", "best_model.npz"))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    import yaml

    cfg = make_config(args)
    with open(os.path.join(args.output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    trainers = make_trainers(cfg, args.device, args.bank_pattern)
    logger.info("Generalist over Ra=%s: %d iterations round-robin (%d per rung)", args.ras,
                args.iterations, args.iterations // len(args.ras))
    train(trainers, cfg, os.path.join(args.output_dir, "metrics.jsonl"))
    write_rungs(trainers[0].model, cfg, args.output_dir, args.bank_pattern)
    logger.info("Done: %s", args.output_dir)


if __name__ == "__main__":
    main()
