"""Trained-policy vs baseline Nusselt comparison with bootstrap CIs, on the port.

Twin of ``experiments/eval_baselines.py``, plus ``--device`` (default
``cuda``) and ``--out``. It writes ``baseline_eval_torch.json`` beside the
JAX twin's ``baseline_eval.json``, which it never overwrites unless
``--out`` names it. On a held-out checkpoint bank:

* initial conditions are drawn without replacement from the bank
  (``bank_sampling="sequential"``, ``auto_reset=False``); with more
  episodes than bank states a small thermal kick (``--ic_noise``)
  decorrelates the extra trajectories, and the IC multiplicity is reported;
* every policy (trained, zero, random, proportional) rolls from the same
  initial states, so contrasts are paired per episode;
* the headline, ``suppression_vs_zero_pct``, carries a clustered
  paired-bootstrap 95% CI over episodes (episodes sharing a bank state
  resample together).

The env's dimensionality comes from the result dir's ``config.yaml``. The
model may be the port's ``.npz`` or, on a host with msgpack, the JAX
package's ``.msgpack``; the bank ``.npz`` or, with h5py, HDF5.

Usage:
  python -m rbc_gym_tpu_torch.experiments.eval_baselines results/sarl2d_ra10000 \\
      --model models/best_model.msgpack [--bank data/checkpoints/test/ckpt_ra10000.h5] \\
      [--episodes 64] [--n_steps 200] [--ic_noise 1e-3] [--device cpu] [--out eval.json]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict

import numpy as np
import torch


def bootstrap_ci(stat_fn, data, n_boot=10_000, alpha=0.05, seed=0, clusters=None):
    """Percentile bootstrap CI for ``stat_fn`` over episode-axis resamples.

    ``data`` is a tuple of arrays whose first axis is episodes; resampling
    is paired. With ``clusters`` ((episodes,) ints), episodes sharing a
    bank initial condition resample together (cluster bootstrap), since
    the ic_noise kick decorrelates them only a little. Degenerate resamples
    (``stat_fn`` returns NaN) are dropped by nanquantile.
    """
    rng = np.random.default_rng(seed)
    n = data[0].shape[0]
    stats = np.empty(n_boot)
    if clusters is not None and len(np.unique(clusters)) < n:
        groups = [np.where(clusters == c)[0] for c in np.unique(clusters)]
        m = len(groups)
        for i in range(n_boot):
            gidx = rng.integers(0, m, size=m)
            idx = np.concatenate([groups[g] for g in gidx])
            stats[i] = stat_fn(*(d[idx] for d in data))
    else:
        for i in range(n_boot):
            idx = rng.integers(0, n, size=n)
            stats[i] = stat_fn(*(d[idx] for d in data))
    lo, hi = np.nanquantile(stats, [alpha / 2, 1 - alpha / 2])
    return float(lo), float(hi)


def make_eval(config: dict, bank: str, episodes: int, ic_noise: float, model_path: str,
              device, prop_gain=None, prop_row: int = 1):
    """The eval env of ``config`` on ``bank`` and its four policies.

    Returns (env, policies, nusselt_of, prop_gain): ``policies`` maps a
    name to ``fn(obs, generator) -> actions``."""
    from rbc_gym_tpu_torch.models.params import load_params
    from rbc_gym_tpu_torch.scripts import probe_control2d, probe_control3d
    from rbc_gym_tpu_torch.wrappers import functional as fn

    device = torch.device(device)
    is_3d = len(config["rbc_state_shape"]) == 3
    env_kwargs = dict(
        num_envs=episodes,
        rayleigh_number=config["rbc_rayleigh_number"],
        state_shape=tuple(config["rbc_state_shape"]),
        heater_duration=config["rbc_heater_duration"],
        heater_limit=config["rbc_heater_limit"],
        episode_length=config["rbc_episode_length"],
        checkpoint=bank,
        auto_reset=False,
        bank_sampling="sequential",
        ic_noise=ic_noise,
        device=device,
    )
    if is_3d:
        from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
        from rbc_gym_tpu_torch.models.nets import RBCActorCritic

        s = int(config.get("rbc_heater_segments", 8))
        env = RBC3DVectorEnv(dt_solver=config.get("rbc_dt_solver", 0.01), heater_segments=s,
                             **env_kwargs)
        # the trunk flag persisted by the trainer rebuilds its architecture
        model = RBCActorCritic(action_grid=(s, s), share_features_extractor=bool(
            config.get("rl_share_features_extractor", False)))
        norm = fn.make_obs_norm_3d(ra=config["rbc_rayleigh_number"],
                                   heater_limit=config["rbc_heater_limit"])
        channel_axis, a_shape = -4, (episodes, s, s)
        prop_gain = 0.3 if prop_gain is None else prop_gain

        def proportional(obs, gen):
            # oppose the tile-averaged near-bottom temperature fluctuation
            return probe_control3d.law_T(obs, prop_gain, prop_row, s)

        def nusselt_of(ts):
            return ts.nusselt
    else:
        from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
        from rbc_gym_tpu_torch.models.nets import RBCActorCritic2D

        s = int(config.get("rbc_heater_segments", 12))
        env = RBC2DVectorEnv(observation_shape=tuple(config["rbc_observation_shape"]),
                             heater_segments=s, **env_kwargs)
        model = RBCActorCritic2D(n_heaters=s, log_std_init=config.get("rl_log_std_init", 0.0),
                                 shared_trunk=bool(config.get("rl_shared_trunk", False)),
                                 obs_shape=env.observation_shape)
        norm = fn.make_obs_norm_2d(heater_limit=config["rbc_heater_limit"])
        channel_axis, a_shape = -3, (episodes, s)
        prop_gain = 10.0 if prop_gain is None else prop_gain

        def proportional(obs, gen):
            # oppose the segment-averaged near-bottom temperature fluctuation
            return probe_control2d.law(obs, prop_gain, prop_row, s)

        def nusselt_of(ts):
            return ts.nusselt_state

    model = load_params(model_path, model.to(dtype=env.dtype)).to(device).eval()

    @torch.no_grad()
    def trained(obs, gen):
        mean, _, _ = model(fn.normalize_observation(obs, norm, channel_axis=channel_axis))
        return torch.clamp(mean, -1.0, 1.0)

    def zero(obs, gen):
        return torch.zeros(a_shape, dtype=env.dtype, device=device)

    def random(obs, gen):
        return 2.0 * torch.rand(a_shape, generator=gen, dtype=env.dtype, device=device) - 1.0

    policies = {"trained": trained, "zero": zero, "random": random,
                "proportional": proportional}
    return env, policies, nusselt_of, prop_gain


def rollout(env, state0, obs0, action_fn: Callable, n_steps: int, nusselt_of: Callable,
            seed: int) -> np.ndarray:
    """(n_steps, episodes) Nusselt numbers of ``action_fn`` from (state0, obs0)."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state, obs, nus = state0, obs0, []
    for _ in range(n_steps):
        state, ts = env.step(state, action_fn(obs, gen))
        obs = ts.obs
        nus.append(nusselt_of(ts))
    return torch.stack(nus).cpu().numpy()


def suppression(per_episode: Dict[str, np.ndarray], name: str, clusters) -> dict | None:
    """Paired suppression % of ``name`` against zero action, with its
    bootstrap CI; None if the zero baseline is degenerate."""
    t, z = per_episode[name], per_episode["zero"]
    denom = z.mean()
    if not np.isfinite(denom) or abs(denom) < 1e-9:
        return None

    def stat(te, ze):
        zm = ze.mean()
        if not np.isfinite(zm) or abs(zm) < 1e-9:
            return np.nan
        return 100.0 * (zm - te.mean()) / zm

    lo, hi = bootstrap_ci(stat, (t, z), clusters=clusters)
    return {"pct": float(100.0 * (denom - t.mean()) / denom), "ci95": [lo, hi]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("result_dir")
    p.add_argument("--bank", default=None,
                   help="held-out checkpoint bank for initial conditions (default: the "
                        "Ra-matched test bank)")
    p.add_argument("--episodes", type=int, default=64, help="lockstep episodes per policy")
    p.add_argument("--n_steps", type=int, default=None,
                   help="rollout horizon in env steps (default: one episode)")
    p.add_argument("--ic_noise", type=float, default=1e-3,
                   help="thermal kick decorrelating episodes that share a bank state")
    p.add_argument("--model", default="models/best_model.npz")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--prop_gain", type=float, default=None,
                   help="gain of the proportional baseline (default 10.0 in 2D, 0.3 in 3D)")
    p.add_argument("--prop_row", type=int, default=1,
                   help="observation z-row the proportional law senses")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="result file (default <result_dir>/baseline_eval_torch.json)")
    args = p.parse_args(argv)

    import yaml

    with open(os.path.join(args.result_dir, "config.yaml")) as f:
        config = yaml.safe_load(f)
    is_3d = len(config["rbc_state_shape"]) == 3
    ra = int(config["rbc_rayleigh_number"])
    bank = args.bank or (f"data/checkpoints/test/3D_ckpt_ra{ra}.h5" if is_3d
                         else f"data/checkpoints/test/ckpt_ra{ra}.h5")
    env, policies, nusselt_of, prop_gain = make_eval(
        config, bank, args.episodes, args.ic_noise,
        os.path.join(args.result_dir, args.model), args.device, args.prop_gain, args.prop_row)

    bank_size = env._bank.size
    # sequential sampling: episode i starts from bank state i % bank_size
    ic_clusters = np.arange(args.episodes) % bank_size
    state0, obs0 = env.reset(seed=args.seed)
    n_steps = args.n_steps or env.episode_steps

    results, per_episode = {}, {}
    for name, action_fn in policies.items():
        nus = rollout(env, state0, obs0, action_fn, n_steps, nusselt_of, args.seed + 1)
        ep = nus[nus.shape[0] // 2:].mean(axis=0)  # (episodes,) second-half mean Nu
        per_episode[name] = ep
        lo, hi = bootstrap_ci(lambda e: e.mean(), (ep,), clusters=ic_clusters)
        results[name] = {
            "nusselt_mean": float(nus.mean()),
            "nusselt_std_across_episodes": float(nus.mean(axis=0).std()),
            "nusselt_mean_second_half": float(ep.mean()),
            "nusselt_second_half_ci95": [lo, hi],
            "nusselt_trace": [float(v) for v in nus.mean(axis=1)],
            "n_steps": int(nus.shape[0]),
            "episodes": int(nus.shape[1]),
        }
        print(f"{name:12}: Nu = {results[name]['nusselt_mean']:.4f} "
              f"(2nd half {ep.mean():.4f} [{lo:.4f}, {hi:.4f}])", flush=True)

    supp = suppression(per_episode, "trained", ic_clusters)
    results["suppression_vs_zero_pct"] = supp["pct"] if supp else None
    results["suppression_vs_zero_ci95"] = supp["ci95"] if supp else None
    for name in ("random", "proportional"):
        results[f"suppression_{name}_vs_zero"] = suppression(per_episode, name, ic_clusters)
    results.update(bank=bank, bank_size=bank_size, prop_gain=prop_gain, prop_row=args.prop_row,
                   ic_duplication=-(-args.episodes // bank_size), ic_noise=args.ic_noise,
                   model=args.model, device=str(env.device))
    out = args.out or os.path.join(args.result_dir, "baseline_eval_torch.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    if supp:
        print(f"suppression vs zero-action: {supp['pct']:.2f}% "
              f"[{supp['ci95'][0]:.2f}, {supp['ci95'][1]:.2f}]  -> {out}")
    else:
        print(f"suppression vs zero-action: undefined (degenerate zero baseline)  -> {out}")


if __name__ == "__main__":
    main()
