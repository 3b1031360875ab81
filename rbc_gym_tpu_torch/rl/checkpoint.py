"""Resumable training checkpoints: the full training state, not just params.

Port of ``rbc_gym_tpu.rl.checkpoint``, in the port's own format. A
params-only snapshot loses the Adam moments, the schedule position, the
env fields and the random streams, so a "resume" from it restarts the
optimization from a warm init. This module saves everything the training
loop carries between iterations:

* the model's parameters, the Adam moments and the count of applied
  updates (which drives ``anneal_lr``);
* the env state (fields, episode clocks, the per-env host keys), the
  carried observation, and the states of the trainer's two generators;
* the ``iteration`` / ``global_step`` counters;
* callback state (best-model scores, running-min Nusselt, wall-clock
  offset) through an optional ``state_dict()/load_state_dict()`` protocol.

Format: one ``.npz`` of named arrays (``model/<name>``, ``adam/mu/<name>``,
``adam/nu/<name>``, ``env/<field>``, ``last_obs``, ``gen/action``,
``gen/perm``) plus a JSON ``meta`` record. Restore checks that the file
holds exactly the live trainer's arrays, each with its shape and dtype, so
resuming with a changed architecture or env size fails loudly instead of
corrupting state.

Over ranks (``parallel.shard_ppo_trainer``) the file keeps the one-process
layout: the ranks' env rows and observations are gathered to rank 0,
which alone writes, and the replicated parameters, moments and generator
states are rank 0's (every generator is drawn for the whole fleet, so the
streams are the one process's). A restore takes each rank's rows of the
fleet, so a checkpoint resumes at any world size that divides the fleet,
one process included. Every rank reads the file: the checkpoint directory
must be visible to all of them.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import zipfile
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1


def _sharded(name: str) -> bool:
    """Whether the state ``name`` holds one row per env (split over ranks)."""
    return name.startswith("env/") or name == "last_obs"


def _env_tensors(env_state) -> Dict[str, torch.Tensor]:
    out = {f"env/fields/{k}": v for k, v in env_state.fields._asdict().items()}
    out.update({f"env/{k}": v for k, v in env_state._asdict().items() if k != "fields"})
    return out


def trainer_tensors(trainer) -> Dict[str, torch.Tensor]:
    """Every tensor of a PPO trainer's mutable state, by name."""
    opt = trainer.optimizer
    names = [k for k, _ in trainer.model.named_parameters()]
    out = {f"model/{k}": p.detach() for k, p in zip(names, opt.params)}
    out.update({f"adam/mu/{k}": m for k, m in zip(names, opt.mu)})
    out.update({f"adam/nu/{k}": v for k, v in zip(names, opt.nu)})
    out.update(_env_tensors(trainer.env_state))
    out["last_obs"] = trainer.last_obs
    out["gen/action"] = trainer.action_gen.get_state()
    out["gen/perm"] = trainer.perm_gen.get_state()
    return out


def _callback_states(callbacks: Iterable) -> dict:
    out = {}
    for cb in callbacks or ():
        if hasattr(cb, "state_dict"):
            name = type(cb).__name__
            key, i = name, 1
            while key in out:  # two callbacks of one class get indexed keys
                i += 1
                key = f"{name}_{i}"
            out[key] = cb.state_dict()
    return out


def save_training_state(path: str, trainer, iteration: int, callbacks: Sequence = ()) -> None:
    """Atomically write a full training checkpoint to ``path`` (.npz).
    Over ranks every rank calls this (it gathers the env rows) and rank 0
    writes."""
    mesh = getattr(trainer, "mesh", None)
    arrays = {k: mesh.gather_rows(v) if mesh is not None and _sharded(k) else v.detach().cpu()
              for k, v in trainer_tensors(trainer).items()}
    if mesh is not None and mesh.rank != 0:
        return
    arrays = {k: v.numpy() for k, v in arrays.items()}
    meta = {
        "format_version": FORMAT_VERSION,
        "iteration": int(iteration),
        "global_step": int(trainer.global_step),
        "adam_count": int(trainer.optimizer.count),
        "names": sorted(arrays),
        "callbacks": _callback_states(callbacks),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_training_state(path: str, trainer, callbacks: Sequence = ()) -> int:
    """Restore ``trainer`` (and callbacks) in place from ``path``.

    Returns the iteration to continue from (checkpoint iteration + 1), for
    ``PPO.learn(..., start_iteration=...)``.
    """
    live = trainer_tensors(trainer)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint format {meta.get('format_version')} "
                             f"!= supported {FORMAT_VERSION}")
        if sorted(meta["names"]) != sorted(live):
            diff = sorted(set(meta["names"]) ^ set(live))
            raise ValueError(f"{path}: state {diff} differs from the live trainer's: "
                             "config/architecture mismatch (did the model, env or optimizer "
                             "change?)")
        saved = {k: z[k] for k in live}
    lo, fleet = trainer.env_offset, trainer.fleet_size
    for k in filter(_sharded, live):
        if saved[k].shape[0] != fleet:
            raise ValueError(f"{path}: state {k} holds {saved[k].shape[0]} envs, the live "
                             f"trainer's fleet {fleet}: config mismatch")
        saved[k] = saved[k][lo:lo + trainer.env.num_envs]
    for k, want in live.items():
        got = saved[k]
        want_dtype = str(want.dtype).replace("torch.", "")
        if tuple(got.shape) != tuple(want.shape) or got.dtype != np.dtype(want_dtype):
            raise ValueError(f"{path}: state {k} is {got.dtype}{got.shape}, the live trainer "
                             f"expects {want_dtype}{tuple(want.shape)}: config/architecture "
                             "mismatch")

    def tensor(k):
        return torch.from_numpy(saved[k]).to(live[k].device)

    opt = trainer.optimizer
    names = [k for k, _ in trainer.model.named_parameters()]
    with torch.no_grad():
        for k, p, m, v in zip(names, opt.params, opt.mu, opt.nu):
            p.copy_(tensor(f"model/{k}"))
            m.copy_(tensor(f"adam/mu/{k}"))
            v.copy_(tensor(f"adam/nu/{k}"))
    opt.count = meta["adam_count"]
    st = trainer.env_state
    fields = type(st.fields)(*(tensor(f"env/fields/{k}") for k in st.fields._fields))
    trainer.env_state = type(st)(fields=fields, **{
        k: tensor(f"env/{k}") for k in st._fields if k != "fields"})
    trainer.last_obs = tensor("last_obs")
    trainer.action_gen.set_state(torch.from_numpy(saved["gen/action"]))
    trainer.perm_gen.set_state(torch.from_numpy(saved["gen/perm"]))
    trainer.global_step = meta["global_step"]

    cb_states = dict(meta.get("callbacks", {}))
    for cb in callbacks or ():
        name = type(cb).__name__
        if hasattr(cb, "load_state_dict") and name in cb_states:
            cb.load_state_dict(cb_states.pop(name))
    if cb_states:
        logger.warning("Checkpoint callback state not consumed by any live callback: %s",
                       sorted(cb_states))
    logger.info("Restored training state from %s (iteration %d, global_step %d)",
                path, meta["iteration"], meta["global_step"])
    return meta["iteration"] + 1


def restore_training_state_with_fallback(path: str, trainer, callbacks: Sequence = ()) -> int:
    """``restore_training_state`` with crash-window recovery.

    The CheckpointCallback rotation (save new -> rotate latest to previous
    -> promote new) leaves at least one complete snapshot after any crash;
    this walks the candidates newest first: ``latest_full.npz``, then
    ``latest_full.npz.new`` (a completed save that died before promotion),
    then ``previous_full.npz``. A missing or corrupt candidate logs a
    warning and falls through; only when every candidate fails does this
    raise.
    """
    candidates = [path, path + ".new", os.path.join(os.path.dirname(path), "previous_full.npz")]
    errors = []
    for cand in candidates:
        if not os.path.isfile(cand):
            errors.append(f"{cand}: not found")
            continue
        try:
            it = restore_training_state(cand, trainer, callbacks=callbacks)
        except (OSError, ValueError, KeyError, json.JSONDecodeError, zipfile.BadZipFile) as e:
            logger.warning("Checkpoint %s unusable (%s: %s); trying the next fallback",
                           cand, type(e).__name__, e)
            errors.append(f"{cand}: {type(e).__name__}: {e}")
            continue
        if cand != path:
            logger.warning("Resumed from fallback checkpoint %s (%s was missing or corrupt)",
                           cand, path)
        return it
    raise FileNotFoundError("--resume_training: no usable full checkpoint; tried "
                            + "; ".join(errors))


def truncate_metrics_jsonl(path: str, last_iteration: int) -> int:
    """Drop metrics records beyond ``last_iteration`` so a resumed run's
    metrics.jsonl continues from the checkpoint. The rewrite is atomic
    (temp file + rename). Returns the number of records kept."""
    if not os.path.isfile(path):
        return 0
    kept = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("iteration", -1) <= last_iteration:
                kept.append(line)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".jsonl.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            for line in kept:
                f.write(line + "\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return len(kept)
