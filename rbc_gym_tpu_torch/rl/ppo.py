"""PPO on the device, beside the vectorized environments.

Port of ``rbc_gym_tpu.rl.ppo``. Rollout collection, GAE and the
clipped-surrogate update run on the env's device; the data never leaves
it, except the scalars the host needs (the truncation flag of each step
and, with ``target_kl``, each minibatch's KL).

Algorithmic parity with the JAX trainer and SB3's PPO (lr 3e-4, gamma
0.99, gae_lambda 0.95, clip 0.2, vf_coef 0.5, max_grad_norm 0.5,
advantages normalised per minibatch with the population std, a diagonal
Gaussian policy with state-independent log_std). Actions are clipped to
the box when the env steps, while the log-prob is that of the unclipped
sample. Truncation is bootstrapped with V(final_obs), computed only on
steps where some env truncated. The optimizer is optax's
``chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5))`` written
out (``ClippedAdam``), with ``anneal_lr`` following optax's
``linear_schedule`` over applied updates.

Random numbers come from two ``torch.Generator``s on the device, one for
the action noise and one for the minibatch permutations; the model's
initial weights from a CPU generator, so they are the same on every
device. All three are seeded from ``seed``.

Over ranks (``parallel.shard_ppo_trainer``, which sets ``mesh``) each rank
steps its rows of the fleet and R ranks reproduce one process to float
rounding: every rank draws the whole fleet's action noise and keeps its
rows, and the same global permutation, from which it takes the samples of
its envs; a minibatch's advantage mean and population std, its losses,
KL and clip fraction are sums over the ranks divided by the global
minibatch size, the entropy term counts once (1/R on each rank), and the
gradients are summed by one all-reduce a minibatch before the clip and
Adam, so every rank applies the same update and takes the same
``target_kl`` decision. A rank with no sample in a minibatch joins every
collective all the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rbc_gym_tpu_torch import default_device
from rbc_gym_tpu_torch.models.nets import lecun_normal_

_LOG_2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_steps: int = 16  # rollout length per iteration
    n_epochs: int = 10  # SGD epochs per iteration (reference rl_n_epochs)
    n_minibatches: int = 4
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01  # reference rl_ent_coef
    max_grad_norm: float = 0.5
    normalize_advantage: bool = True
    # SB3 target_kl: before applying each minibatch, compute approx_kl on
    # it; if > 1.5 * target_kl, skip that update and every later one this
    # iteration. None disables the check.
    target_kl: Optional[float] = None
    # Linear LR decay to lr/100 over the expected number of applied
    # gradient steps (total_iterations * n_epochs * n_minibatches); steps
    # skipped by target_kl do not advance it.
    anneal_lr: bool = False
    total_iterations: Optional[int] = None


class Transition(NamedTuple):
    """One rollout, each field stacked over (n_steps, num_envs, ...)."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    truncated: torch.Tensor
    # V(final_obs) at truncation boundaries only (zeros elsewhere): on other
    # steps final_obs is the next obs, whose value is the next stored value.
    boundary_value: torch.Tensor
    nusselt: torch.Tensor


def gaussian_log_prob(action, mean, log_std):
    var = torch.exp(2.0 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI)
    return lp.flatten(1).sum(-1)


def gaussian_entropy(log_std):
    return (log_std + 0.5 * (_LOG_2PI + 1.0)).sum()


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def _mean_std(x: torch.Tensor, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std of ``x`` over ``count`` samples."""
    mean = x.sum() / count
    return mean, torch.sqrt(((x - mean) ** 2).sum() / count)


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))``.

    ``lr`` is a float or a schedule of the count of applied updates. Unlike
    ``torch.nn.utils.clip_grad_norm_`` the clip divides by the norm itself
    (no 1e-6), and only when the norm is not below ``max_norm``."""

    def __init__(self, params: List[nn.Parameter], lr, max_norm: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-5):
        self.params = list(params)
        self.lr = lr
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self) -> float:
        return self.lr(self.count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def apply(self, grads, g_norm: Optional[torch.Tensor] = None) -> None:
        if g_norm is None:
            g_norm = global_norm(grads)
        # optax: (t / g_norm) * max_norm where clipped
        grads = [torch.where(g_norm < self.max_norm, g, (g / g_norm) * self.max_norm)
                 for g in grads]
        lr = self.learning_rate()
        count = self.count + 1
        c1, c2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_((1.0 - self.b2) * (g * g) + self.b2 * v)
            update = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.add_(-lr * update)
        self.count = count


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """optax ``linear_schedule``: init -> end over ``transition_steps``, then end."""

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


class PPO:
    """PPO trainer over a vector env of the port (RBC2DVectorEnv/RBC3DVectorEnv).

    ``obs_transform`` maps raw env observations to policy inputs (e.g. the
    functional observation normalizer) and ``reward_transform`` raw rewards
    to training rewards; both run on the device. The trainer initialises
    ``model``'s Conv and Dense weights from ``seed`` (lecun_normal, zero
    biases), as the JAX trainer's ``model.init`` does, and moves it to the
    env's device and dtype.
    """

    def __init__(
        self,
        env,
        model: nn.Module,
        config: PPOConfig = PPOConfig(),
        obs_transform: Optional[Callable] = None,
        reward_transform: Optional[Callable] = None,
        seed: int = 0,
        device: str | torch.device | None = "cuda",
    ):
        self.device = default_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"the env runs on {env.device}, the trainer on {self.device}")
        self.env = env
        self.config = config
        self.obs_transform = obs_transform or (lambda o: o)
        self.reward_transform = reward_transform or (lambda r: r)
        if config.anneal_lr and config.total_iterations is None:
            raise ValueError("anneal_lr requires total_iterations")

        lecun_normal_(model.cpu(), torch.Generator().manual_seed(seed))
        self.model = model.to(device=self.device, dtype=env.dtype)
        self.action_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.perm_gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        self.env_state, obs0 = env.reset(seed=seed)
        self.last_obs = self.obs_transform(obs0)
        if config.anneal_lr:
            lr = linear_schedule(config.learning_rate, config.learning_rate * 1e-2,
                                 config.total_iterations * config.n_epochs * config.n_minibatches)
        else:
            lr = config.learning_rate
        self.optimizer = ClippedAdam(list(self.model.parameters()), lr, config.max_grad_norm)
        self.global_step = 0
        # the env's rows [offset, offset + num_envs) of a fleet of fleet_size
        self.env_offset = getattr(env, "env_offset", 0)
        self.fleet_size = getattr(env, "fleet_size", env.num_envs)
        self.mesh = None  # the ranks' layout (parallel.shard_ppo_trainer)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (itself in one process)."""
        return t if self.mesh is None else self.mesh.all_reduce_(t)

    # ------------------------------------------------------------------
    def _rollout(self) -> Tuple[Transition, torch.Tensor]:
        cfg = self.config
        steps: List[Transition] = []
        env_state, obs = self.env_state, self.last_obs
        with torch.no_grad():
            for _ in range(cfg.n_steps):
                mean, log_std, value = self.model(obs)
                # the whole fleet's noise, so that a rank's rows are the
                # one-process draw's
                lo = self.env_offset
                noise = torch.randn((self.fleet_size,) + tuple(mean.shape[1:]),
                                    generator=self.action_gen, dtype=mean.dtype,
                                    device=mean.device)[lo:lo + mean.shape[0]]
                action = mean + torch.exp(log_std) * noise
                log_prob = gaussian_log_prob(action, mean, log_std)
                env_state, ts = self.env.step(env_state, torch.clamp(action, -1.0, 1.0))
                next_obs = self.obs_transform(ts.obs)
                # V(final_obs) only where the obs was replaced by an autoreset
                if bool(ts.truncated.any()):
                    boundary_value = self.model(self.obs_transform(ts.final_obs))[2]
                else:
                    boundary_value = torch.zeros_like(value)
                nusselt = getattr(ts, "nusselt", None)
                steps.append(Transition(
                    obs=obs, action=action, log_prob=log_prob, value=value,
                    reward=self.reward_transform(ts.reward), truncated=ts.truncated,
                    boundary_value=boundary_value,
                    nusselt=ts.nusselt_state if nusselt is None else nusselt))
                obs = next_obs
            last_value = self.model(obs)[2]
        self.env_state, self.last_obs = env_state, obs
        traj = Transition(*(torch.stack(xs) for xs in zip(*steps)))
        return traj, last_value

    def _gae(self, traj: Transition, last_value: torch.Tensor):
        cfg = self.config
        next_values = torch.cat([traj.value[1:], last_value[None]], dim=0)
        next_values = torch.where(traj.truncated, traj.boundary_value, next_values)
        advantages = torch.empty_like(traj.value)
        adv = torch.zeros_like(traj.value[0])
        for t in reversed(range(traj.value.shape[0])):
            # episodes never terminate: always bootstrap from next_value;
            # the accumulation stops at episode boundaries (truncation)
            delta = traj.reward[t] + cfg.gamma * next_values[t] - traj.value[t]
            adv = delta + cfg.gamma * cfg.gae_lambda * torch.where(
                traj.truncated[t], torch.zeros_like(adv), adv)
            advantages[t] = adv
        return advantages, advantages + traj.value

    def _loss(self, obs, action, old_log_prob, advantages, returns, count=None, adv_stats=None,
              ranks: int = 1):
        """The clipped-surrogate loss of a minibatch and its metrics.

        Over ranks these rows are one rank's part of the minibatch:
        ``count`` is the minibatch's size over all ranks (default: these
        rows'), ``adv_stats`` its advantages' mean and population std
        (default: these rows'), and each of the ``ranks`` ranks counts 1/R
        of the entropy term, so that the ranks' losses, metrics and
        gradients sum to the whole minibatch's."""
        cfg = self.config
        count = advantages.shape[0] if count is None else count
        mean, log_std, value = self.model(obs)
        log_prob = gaussian_log_prob(action, mean, log_std)
        ratio = torch.exp(log_prob - old_log_prob)
        if cfg.normalize_advantage:
            adv_mean, adv_std = (_mean_std(advantages, count) if adv_stats is None
                                 else adv_stats)
            advantages = (advantages - adv_mean) / (adv_std + 1e-8)
        pg1 = -advantages * ratio
        pg2 = -advantages * torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
        pg_loss = torch.maximum(pg1, pg2).sum() / count
        v_loss = 0.5 * ((value - returns) ** 2).sum() / count
        entropy = gaussian_entropy(log_std)
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy / ranks
        with torch.no_grad():
            approx_kl = ((ratio - 1.0) - torch.log(ratio)).sum() / count
            clip_frac = ((ratio - 1.0).abs() > cfg.clip_eps).to(ratio.dtype).sum() / count
            metrics = {"loss": loss.detach(), "policy_loss": pg_loss.detach(),
                       "value_loss": v_loss.detach(), "entropy": entropy.detach(),
                       "approx_kl": approx_kl, "clip_fraction": clip_frac,
                       "policy_std": torch.exp(log_std).mean()}
        return loss, metrics

    def _owned(self, idx: torch.Tensor) -> torch.Tensor:
        """This rank's local rows of the global flat indices ``idx`` (index
        ``t * fleet + e`` is env e at step t), in the order of ``idx``."""
        if self.mesh is None:
            return idx
        n, lo = self.env.num_envs, self.env_offset
        t, e = idx // self.fleet_size, idx % self.fleet_size - lo
        mine = (e >= 0) & (e < n)
        return t[mine] * n + e[mine]

    def _advantage_stats(self, adv: torch.Tensor, minibatches, count: int):
        """(mean, population std) of each minibatch's advantages over the
        ranks: all-reduced sums, then all-reduced squared deviations."""
        sums = torch.stack([adv.index_select(0, i).sum() for i in minibatches])
        means = self._all_reduce(sums) / count
        squares = torch.stack([((adv.index_select(0, i) - m) ** 2).sum()
                               for i, m in zip(minibatches, means)])
        return list(zip(means, torch.sqrt(self._all_reduce(squares) / count)))

    def _reduce(self, grads, metrics):
        """The gradients and the per-sample metrics summed over the ranks in
        one flat all-reduce; the loss rebuilt from the summed parts."""
        if self.mesh is None:
            return grads, metrics
        cfg = self.config
        keys = ("policy_loss", "value_loss", "approx_kl", "clip_fraction")
        flat = self._all_reduce(torch.cat([g.reshape(-1) for g in grads]
                                          + [torch.stack([metrics[k] for k in keys])]))
        out, start = [], 0
        for g in grads:
            out.append(flat[start:start + g.numel()].view_as(g))
            start += g.numel()
        metrics.update(zip(keys, flat[start:]))
        metrics["loss"] = (metrics["policy_loss"] + cfg.vf_coef * metrics["value_loss"]
                           - cfg.ent_coef * metrics["entropy"])
        return out, metrics

    def _update(self, traj: Transition, advantages, returns) -> Dict[str, torch.Tensor]:
        cfg = self.config
        local = cfg.n_steps * self.env.num_envs
        # the global minibatch: over ranks the permutation runs over the
        # whole fleet's samples, of which each rank takes its own
        mb = cfg.n_steps * self.fleet_size // cfg.n_minibatches
        ranks = 1 if self.mesh is None else self.mesh.size
        flat = [x.reshape((local,) + tuple(x.shape[2:]))
                for x in (traj.obs, traj.action, traj.log_prob, advantages, returns)]
        params = self.optimizer.params
        sums: Dict[str, torch.Tensor] = {}
        n_updates, cont = 0, True
        for _ in range(cfg.n_epochs):
            # drawn every epoch, also after target_kl stopped the updates,
            # so the stream does not depend on where they stopped
            perm = torch.randperm(cfg.n_steps * self.fleet_size, generator=self.perm_gen,
                                  device=self.device)
            if not cont:
                continue
            minibatches = [self._owned(perm[i * mb:(i + 1) * mb])
                           for i in range(cfg.n_minibatches)]
            stats = (self._advantage_stats(flat[3], minibatches, mb) if cfg.normalize_advantage
                     else [None] * cfg.n_minibatches)
            for idx, adv_stats in zip(minibatches, stats):
                loss, metrics = self._loss(*(x.index_select(0, idx) for x in flat), count=mb,
                                           adv_stats=adv_stats, ranks=ranks)
                grads, metrics = self._reduce(torch.autograd.grad(loss, params), metrics)
                metrics["grad_norm"] = global_norm(grads)
                if cfg.target_kl is not None and not (
                        float(metrics["approx_kl"]) <= 1.5 * cfg.target_kl):
                    cont = False
                    break
                self.optimizer.apply(grads, metrics["grad_norm"])
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
                n_updates += 1
        # averaged over applied minibatches; the first always applies (its
        # ratio is 1, so its KL is 0)
        out = {k: v / n_updates for k, v in sums.items()}
        out["n_updates"] = torch.tensor(float(n_updates))
        return out

    def _iteration(self) -> Dict[str, torch.Tensor]:
        traj, last_value = self._rollout()
        advantages, returns = self._gae(traj, last_value)
        metrics = self._update(traj, advantages, returns)
        # means over the whole fleet
        sums = self._all_reduce(torch.stack([traj.reward.sum(), traj.nusselt.sum(),
                                             traj.value.sum()]))
        means = sums / (self.config.n_steps * self.fleet_size)
        for k, v in zip(("reward_mean", "nusselt_mean", "value_mean"), means):
            metrics["rollout/" + k] = v
        return metrics

    # ------------------------------------------------------------------
    def learn(self, iterations: int, callbacks: Tuple[Callable, ...] = (),
              start_iteration: int = 0) -> Dict[str, float]:
        """Run training iterations; ``cb(metrics_dict, trainer)`` per iteration.

        ``start_iteration`` continues the numbering after a checkpoint
        restore (``rl.checkpoint``): the loop runs ``iterations -
        start_iteration`` more iterations, the remainder of an interrupted
        ``iterations``-long run.
        """
        metrics_np: Dict[str, float] = {}
        for it in range(start_iteration, iterations):
            metrics = self._iteration()
            self.global_step += self.config.n_steps * self.fleet_size
            metrics_np = {k: float(v) for k, v in metrics.items()}
            metrics_np["global_step"] = self.global_step
            metrics_np["iteration"] = it
            for cb in callbacks:
                cb(metrics_np, self)
        return metrics_np

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, obs: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """Greedy (or sampled) action for evaluation, as SB3's predict."""
        mean, log_std, _ = self.model(obs)
        if deterministic:
            return torch.clamp(mean, -1.0, 1.0)
        noise = torch.randn(mean.shape, generator=self.action_gen, dtype=mean.dtype,
                            device=mean.device)
        return torch.clamp(mean + torch.exp(log_std) * noise, -1.0, 1.0)
