#!/bin/bash
# Multi-rank PPO launch, the twin of scripts/launch_multihost.sh: torchrun
# starts NPROC ranks of rbc_gym_tpu_torch.experiments.run_sarl on this host.
# run_sarl joins them (parallel.initialize_distributed reads torchrun's
# variables) and splits the env axis over them: rank r steps its rows of
# the fleet, the gradients are summed over the ranks, and only rank 0
# evaluates and writes files. The arguments go to run_sarl:
#   NPROC=2 bash rbc_gym_tpu_torch/scripts/launch_multihost.sh --num_envs 256 ...
#
# Env:
#   NPROC          ranks on this host (default 1)
#   BACKEND        nccl (one rank a card; run_sarl's default on CUDA) or
#                  gloo (the CPU, or ranks that share one card)
#   RDZV_ENDPOINT  host:port of the rendezvous for several hosts, with
#                  NNODES; without it a standalone rendezvous on a free
#                  local port. (Several hosts have not been run.)
#   PYTHON
# Under Slurm without torchrun, run_sarl reads SLURM_NTASKS / SLURM_PROCID
# / SLURM_LOCALID and MASTER_ADDR / MASTER_PORT itself.
set -euo pipefail
cd "$(dirname "$0")/../.."

PYTHON=${PYTHON:-python}
if [ -n "${RDZV_ENDPOINT:-}" ]; then
  RDZV=(--nnodes "${NNODES:-1}" --rdzv_backend c10d --rdzv_endpoint "$RDZV_ENDPOINT")
else
  RDZV=(--standalone)
fi
BACKEND_ARGS=()
if [ -n "${BACKEND:-}" ]; then
  BACKEND_ARGS=(--backend "$BACKEND")
fi

exec "$PYTHON" -m torch.distributed.run "${RDZV[@]}" --nproc_per_node "${NPROC:-1}" \
  -m rbc_gym_tpu_torch.experiments.run_sarl "${BACKEND_ARGS[@]}" "$@"
