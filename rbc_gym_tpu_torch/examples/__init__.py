"""Demo scripts of the port: twins of the JAX package's ``example/`` scripts.

Each twin does its work in ``main(...)`` (or the functions the JAX script
names), never at import, and runs as a module::

    python -m rbc_gym_tpu_torch.examples.<name>

On the card (torch and numpy only; gymnasium is imported inside the one
function that needs it):

- ``run_vectorized``: ``native_lockstep`` steps ``RBC2DVectorEnv`` (K1 once
  an env step); ``gymnasium_sync`` is the host's ``gym.make_vec`` path.
- ``timing``: ``time_native`` times ``RBC2DVectorEnv`` at 1024 envs (K1);
  ``time_gym_env`` times the host's gym env.
- ``run_ppo_native``: PPO on ``RBC3DVectorEnv`` (K3 and K4 each env step).

Host-only (gymnasium at their top, as the port's gym modules): ``run_2D``,
``run_3D``, ``run_checkpoint``, ``run_wrapped`` and ``run_wandb``. Their envs
run on the card where one is present (``device="cuda"``, the default);
the card's own image has no gymnasium, and ``envs.single2d`` and
``envs.single3d`` carry the same envs there.
"""
