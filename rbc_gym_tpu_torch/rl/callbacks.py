"""Training callbacks: the reference's SB3 callback roles, on the port.

Port of ``rbc_gym_tpu.rl.callbacks``. A callback is any callable
``cb(metrics: dict, trainer: PPO)`` invoked once per training iteration.
NusseltCallback logs the running-min rollout Nusselt; EvaluationCallback
runs a greedy evaluation rollout and keeps the best model;
CheckpointCallback snapshots the params and the full training state;
WandbCallback logs to Weights & Biases. Params are saved as flax-layout
``.npz`` (``models.params``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from rbc_gym_tpu_torch.models.params import save_params
from rbc_gym_tpu_torch.rl.checkpoint import save_training_state

logger = logging.getLogger(__name__)


class MetricsLogger:
    """Append metrics to a JSONL file, with an optional console echo."""

    def __init__(self, path: Optional[str] = None, echo_every: int = 1):
        self.path = path
        self.echo_every = echo_every
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # resume: carry the wall-clock offset across restarts so wall_time in
    # metrics.jsonl stays monotone over a resumed run
    def state_dict(self) -> dict:
        return {"elapsed": time.time() - self._t0}

    def load_state_dict(self, state: dict) -> None:
        self._t0 = time.time() - state["elapsed"]

    def __call__(self, metrics: dict, trainer) -> None:
        record = dict(metrics, wall_time=round(time.time() - self._t0, 2))
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.echo_every and metrics["iteration"] % self.echo_every == 0:
            logger.info(
                "iter %(iteration)d step %(global_step)d "
                "nusselt %(rollout/nusselt_mean).3f "
                "reward %(rollout/reward_mean).3f loss %(loss).4f",
                metrics,
            )


class NusseltCallback:
    """Track the running-min rollout Nusselt (reference NusseltCallback and
    the W&B min-summary in run_sarl.py:193-198)."""

    def __init__(self):
        self.best_nusselt = np.inf
        self.history = []

    def __call__(self, metrics: dict, trainer) -> None:
        nu = metrics["rollout/nusselt_mean"]
        self.history.append(nu)
        if nu < self.best_nusselt:
            self.best_nusselt = nu
        metrics["rollout/nusselt_min"] = self.best_nusselt

    def state_dict(self) -> dict:
        return {"best_nusselt": float(self.best_nusselt),
                "history": [float(h) for h in self.history]}

    def load_state_dict(self, state: dict) -> None:
        self.best_nusselt = state["best_nusselt"]
        self.history = list(state["history"])


class CheckpointCallback:
    """Periodic snapshots (SB3 CheckpointCallback role), every ``save_freq``
    iterations:

    * a params-only ``rl_model_<global_step>_steps.npz`` (what evaluation
      reads), and
    * ``latest_full.npz``, the full resumable training state
      (``rl.checkpoint``), kept as one rolling file with a
      ``previous_full.npz`` backup.

    Set ``sibling_callbacks`` (after the callback list is assembled) to the
    full callback tuple, so their state rides along.
    """

    def __init__(self, save_path: str, save_freq: int = 4):
        self.save_path = save_path
        self.save_freq = save_freq
        self.sibling_callbacks: tuple = ()

    @property
    def full_path(self) -> str:
        return os.path.join(self.save_path, "latest_full.npz")

    def __call__(self, metrics: dict, trainer) -> None:
        it = metrics["iteration"]
        if it % self.save_freq != 0:
            return
        save_params(trainer.model, os.path.join(
            self.save_path, f"rl_model_{metrics['global_step']}_steps.npz"))
        # Crash-safe rotation: write the new snapshot under a temp name
        # first, only then rotate latest -> previous -> new, so any crash
        # leaves at least one complete snapshot on disk
        # (restore_training_state_with_fallback walks latest -> latest.new
        # -> previous).
        full = self.full_path
        new = full + ".new"
        save_training_state(new, trainer, it, callbacks=self.sibling_callbacks)
        if os.path.exists(full):
            os.replace(full, os.path.join(self.save_path, "previous_full.npz"))
        os.replace(new, full)


class EvaluationCallback:
    """Greedy evaluation rollout; saves the best model (reference
    EvaluationCallback, callbacks/callbacks.py:47-93).

    The reset seed is pinned: every evaluation resets the eval env with the
    same seed, so all iterations are scored on the same initial conditions
    and best-model selection compares paired trajectories.
    """

    def __init__(self, eval_env, n_steps: int, freq: int = 1, save_model: bool = False,
                 save_path: Optional[str] = None, obs_transform=None, seed: int = 0):
        self.eval_env = eval_env
        self.n_steps = n_steps
        self.freq = freq
        self.save_model = save_model
        self.save_path = save_path
        self.obs_transform = obs_transform or (lambda o: o)
        self.best_mean_reward = -np.inf
        self.seed = seed

    def state_dict(self) -> dict:
        return {"best_mean_reward": float(self.best_mean_reward)}

    def load_state_dict(self, state: dict) -> None:
        self.best_mean_reward = state["best_mean_reward"]

    @torch.no_grad()
    def evaluate(self, model) -> tuple:
        """(mean reward, mean Nusselt) of ``n_steps`` greedy steps."""
        env = self.eval_env
        state, obs = env.reset(seed=self.seed)
        rewards, nusselts = [], []
        for _ in range(self.n_steps):
            mean, _, _ = model(self.obs_transform(obs))
            state, ts = env.step(state, torch.clamp(mean, -1.0, 1.0))
            obs = ts.obs
            rewards.append(ts.reward)
            nusselt = getattr(ts, "nusselt", None)
            nusselts.append(ts.nusselt_state if nusselt is None else nusselt)
        return float(torch.stack(rewards).mean()), float(torch.stack(nusselts).mean())

    def __call__(self, metrics: dict, trainer) -> None:
        if metrics["iteration"] % self.freq != 0:
            return
        mean_reward, mean_nusselt = self.evaluate(trainer.model)
        metrics["eval/reward"] = mean_reward
        metrics["eval/nusselt"] = mean_nusselt
        if mean_reward > self.best_mean_reward:
            self.best_mean_reward = mean_reward
            logger.info("New best model with mean reward %s", mean_reward)
            if self.save_model and self.save_path:
                save_params(trainer.model, os.path.join(self.save_path, "best_model.npz"))


class WandbCallback:
    """Optional Weights & Biases logging (wandb is imported here, on the
    host that asks for it; neither the card nor the port needs it).

    ``model_save_path``: directory whose model files (best_model /
    final_model / checkpoints, ``.npz`` or ``.msgpack``) are live-synced to
    the W&B run whenever their mtime changes, as the JAX package's
    ``WandbCallback`` does (reference experiments/run_sarl.py:202-205).
    """

    def __init__(self, model_save_path: Optional[str] = None, **wandb_init_kwargs):
        import wandb  # raises if unavailable: this callback is optional

        self._wandb = wandb
        if wandb.run is None:
            wandb.init(**wandb_init_kwargs)
        wandb.define_metric("rollout/nusselt_mean", summary="min", step_metric="global_step")
        wandb.define_metric("*", step_metric="global_step")
        self.model_save_path = model_save_path
        self._synced_mtimes: dict = {}
        if model_save_path:
            os.makedirs(model_save_path, exist_ok=True)

    def _sync_models(self) -> None:
        for name in os.listdir(self.model_save_path):
            if not name.endswith((".msgpack", ".npz")):
                continue
            path = os.path.join(self.model_save_path, name)
            mtime = os.path.getmtime(path)
            if self._synced_mtimes.get(name) != mtime:
                self._wandb.save(path, base_path=self.model_save_path, policy="live")
                self._synced_mtimes[name] = mtime

    def __call__(self, metrics: dict, trainer) -> None:
        self._wandb.log(metrics, step=metrics["global_step"])
        if self.model_save_path:
            self._sync_models()
