#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repo root on a machine with one CUDA card (H100, sm_90a) and
nvcc under $CUDA_HOME (default /usr/local/cuda). It builds the kernels from
``rbc_gym_tpu_torch/csrc`` and runs, printing one JSON line per phase:

1. build             nvcc into rbc_gym_tpu_torch/_build/ (ctypes, no torch headers)
2. kernel_parity     K1 and K2 against their plain PyTorch versions on the card
                     (K2's three instances: 96x64, the runtime march on
                     128x64, the general instance on 96x80; K2, which sums
                     pHY' in float64, against its plain version run in
                     float64); K1 and its plain version beside a float64 run;
                     K1's cluster instance on 128x64 (6 substeps at 128
                     envs, 50 at 1024) and 192x64 (6 at 128) and its
                     off-chip instance on 127x64
3. main_path         RBC2DVectorEnv(num_envs=1024) at 96x64, Ra=1e4: reset, 3
                     steps with random actions, one Solver2D.substep; checks
                     shapes, finiteness, Nu, divergence, the launch counters
                     and the substep's one PyTorch pHY' call
4. timing            K1, K2, their plain versions and bounds (their shares of
                     them; K2's beside the Pallas kernel's), in ms, K1's
                     cluster instance on 128x64 and off-chip one on 127x64
                     the same way, and every K1 instance's registers, local
                     memory, shared bytes, blocks an SM and resident clusters;
                     pHY' in PyTorch and Solver2D.substep with its
                     split (3 K2, pHY', RK update, projection)
5. kernel_parity_3d  K3 (each stage variant) and K4 against their plain
                     versions at the 3D main path's shapes, K3's stage 0 beside
                     a float64 run; one env step of the kernel path against
                     the all-plain path
6. main_path_3d      RBC3DVectorEnv(num_envs=1024) at 16x32x32, Ra=2500: reset,
                     3 steps with random (E, 8, 8) actions, one Solver3D.substep;
                     the same checks, launch counters 117 (K3) and 3 (K4)
7. timing_3d         K3 per stage with its share of the bound, K5 forced on the
                     same inputs (K3's yardstick), K4, both Poisson forms, the
                     split of one 3D env step
8. selection         the path rule: 16x32x32 float32 -> K3, 32x64x64
                     float32 -> K5, 16x32x30 float32 -> the field path (a step
                     there launches K6 and K7), fused=True -> the field path,
                     float64 in 2D and 3D -> the plain path with no launch, K3
                     forced at 32x64x64 and the field path forced in float64
                     -> ValueError, no launch
9. kernel_parity_big K5 (each stage) and K4 against their plain versions at
                     the big main path's shapes (1024 envs at 32x64x64); K5
                     at 8 envs beside a float64 stage and, forced, at
                     16x32x32; one big-grid env step of the kernel path
                     against the all-plain path and a float64 run
10. main_path_big    RBC3DVectorEnv(1024, state_shape=(32, 64, 64),
                     dt_solver=0.005): reset, 3 steps (25 substeps each); the
                     same checks, launch counters 225 (K5), 3 (K4), 0 (K3),
                     peak device memory
11. timing_big       K5 per stage with its share of the bytes bound, K4, the
                     factored Poisson solve, the split of one big-grid env step
12. kernel_parity_field K6 (each field) and K7 against their plain versions
                     at the per-field path's shapes (1024 envs at 16x32x32,
                     K6's march instance), at 16x32x30 (auto's field grid)
                     and forced on the big grid (K6's general instance); K6
                     beside a float64 run; one env step of the field path
                     against the all-plain path and against the K3 path
13. main_path_field  RBC3DVectorEnv(1024, fused="field"): reset, 3 steps; the
                     same checks, launch counters K6 468 (117 per field), K7
                     117, K4 117, K3 0, K5 0
14. timing_field     K6 per field, K7, K4, their plain versions, bounds and
                     shares of them, the dense solve, pHY', the RK update,
                     the split of one field-path env step
15. bank_oracles     from the committed Ra=1e4 train bank (20 episodes):
                     max|div| under the port's operator in float64, and the
                     fixed point (4 episodes, zero action, 20 env steps of
                     50 substeps) at Nu 4.000 +- 0.005 in float64 on the plain
                     path and +- 0.02 in float32 through K1 (20 launches)
16. policy_parity    the trained 2D policy (committed flax weights) on the
                     card in float32 against the CPU in float64, 256
                     normalised bank observations; TF32 off
17. rl_eval_2d       the JAX baseline evaluation of that policy: test bank,
                     64 envs, sequential, ic_noise 1e-3, 200 steps, trained
                     and zero action; second-half Nu suppression >= 25 %,
                     K1 400 launches
18. rl_train_2d      PPO at the sarl2d_ra10000 configuration (256 envs on the
                     train bank), 4 iterations through CheckpointCallback:
                     finite metrics, updates applied, params moved, K1 64
                     launches an iteration, every env truncated once (step
                     200) with a finite nonzero V(final_obs), the restored
                     full state equal to the live one; seconds an iteration and their split, and
                     one more update's kernels under torch.profiler
19. policy_parity_3d the trained 3D policy (sarl_ra2500) on the card in
                     float32 against the CPU in float64, 256 normalised
                     observations of the 3D test bank; TF32 off
20. rl_eval_3d       the JAX baseline evaluation of that policy at its
                     config (heater_duration 0.375: 38 substeps a step):
                     test bank, 64 envs, sequential, ic_noise 1e-3, 80 steps,
                     trained and zero action; suppression >= 0.5 %, K3
                     18,240 and K4 160 launches
21. rl_train_3d      PPO at the sarl3d_ra2500 configuration (256 envs on the
                     3D train bank) through run_sarl.make_trainer, 2
                     iterations (64 steps, past the 40-step episode) through
                     CheckpointCallback: the checks of phase 18, K3 3,648 and
                     K4 32 launches an iteration, 256 truncations
22. rl_generalist_2d the generalist twin at Ra 1e4 and 3e4, 256 envs, one
                     iteration a rung: records' Ra [10000, 30000], one model
                     and one optimizer across the trainers with its count at
                     the applied updates, K1 128 launches
23. burnin           both bank generators: 2D Ra=1e4, 20 episodes, 600 time
                     units (2,000 K1 launches of 10 substeps); 3D Ra=2500, 20
                     episodes, 200 free-fall units (1,600 windows: 62,400 K3,
                     1,600 K4); finite, distinct, divergence-free banks, each
                     written as .npz, read by its vector env and stepped

24. flowstats_2d     the 2D flow-statistics twin over the bank ladder (Ra 1e4
                     to 1e7, 120 steps, 4 envs, tail 60, from the train banks):
                     every point from its bank, finite, Ra=1e4 within 0.02
                     of its drawn states' fixed points, the others within
                     max(2 %, 4 std) of the JAX record; K1 840 launches
25. flowstats_3d     the 3D twin at Ra 500 and 2000 (32x64x64, 50 substeps a
                     step, 300 steps, one env, tail 100): path stage_xy (K5
                     at 8 blocks a launch), the first step within 5e-6 of the
                     plain path, K5 150 and K4 1 a step, Nu within max(3 %,
                     4 std) of the JAX record, max|div| < 5e-4; ms a step
26. probe_2d         the 2D probe twin at Ra=1e6 on the test bank (32
                     episodes, 100 steps, rows 0/1/2/4, gains 1 and 30):
                     zero-action Nu within 5 % of the JAX log's, row 1 at
                     gain 30 raising Nu by >= 10 %; K1 900 launches
27. probe_3d         the 3D probe twin at Ra=500 on the test bank (32
                     episodes, 80 steps of 38 substeps; zero action, law T
                     at row 1 with gains +3 and -3): zero-action Nu within 2 %
                     of the JAX log's, both raising Nu by >= 15 %; K3 27,360
                     and K4 240 launches
28. profiling        utils.profiling's trace and annotate around 20 steps of
                     phase 25's one-env env and 5 of phase 27's 32-env env
                     (device idle shares, the annotations in the trace),
                     StepTimer's p50 beside the host clock, the device memory
                     stats; profile3d at 1,024 envs and profile_rl in 2D at
                     256, beside timing_3d's and rl_train_2d's numbers
29. single_env_2d    the gym-free 2D core (envs.single2d) at the 2D gym ID's
                     defaults from the Ra=1e4 train bank: reset(seed=0) (the
                     bank index drawn), one episode at zero action to
                     truncation (200 steps, K1 200 launches at one block),
                     the first 3 steps within 4e-5 of the solver forced
                     plain, obs (3, 8, 48) finite, reward = -Nu(obs),
                     truncation on step 200 and not before, the last Nu of
                     the state within 0.02 of the first, a step from NaN
                     fields raising RuntimeError; ms a step
30. single_env_3d    the gym-free 3D core (envs.single3d) at the 3D gym ID's
                     defaults (Ra=500, 13 substeps) from episode 0 of the
                     Ra=500 test bank: 20 steps of seeded random actions (K3
                     780, K4 20 at one env), the first step within 5e-6 of
                     the plain path, obs (4, 16, 32, 32) finite, Nu in [1, 3],
                     max|div| < 5e-4; truncation at episode_length=3 on
                     step 6; ms a step
31. ablate_actuation_3d the ablation twin (scripts.ablate_actuation3d) at
                     Ra=2500, 38 substeps, 32 episodes of 80 steps on the
                     test bank, amplitudes 0, 0.4 and 1.0, random and
                     checkerboard (K3 54,720, K4 480): within 2 % (amplitude
                     0, the two rows equal) and 3 % of docs/RL_RESULTS.md,
                     the checkerboard non-decreasing in the amplitude
32. example_vectorized the run_vectorized twin's native_lockstep: 6 envs, one
                     warm-up and 20 timed zero-action steps (K1 21
                     launches), the rewards finite with -reward (Nu of the
                     observation) in the main path's range; env-steps/s
33. example_timing   the timing twin's time_native: 1024 envs at
                     heater_duration 0.99 (33 substeps), one warm-up and 10
                     timed steps (K1 11 launches), finite rewards; us an env
                     step
34. example_ppo_native the run_ppo_native twin: PPO on RBC3DVectorEnv(16),
                     10 iterations of 8 steps (K3 3,120 and K4 80 launches),
                     every metric finite, best rollout Nu in [1, 3], TF32
                     off; seconds an iteration and the update's share
35. launchers        the bank launchers through bash into a temporary
                     OUT_DIR (npz, Ra 1e4 in 2D and 2500 in 3D, 2 episodes,
                     a cut duration): each bank loads, is finite with
                     distinct episodes and max|div u| under the float32
                     gate; fill_missing_banks.sh then skips all six; and
                     train_sa.sbatch outside Slurm (16 envs, 8 steps, one
                     iteration) leaves config.yaml, metrics.jsonl and
                     models/final_model.npz
36. multi_rank       two gloo ranks sharing the card (NCCL refuses two ranks
                     on one device), each through parallel.shard_vector_env
                     and shard_ppo_trainer, against one process on the same
                     inputs: the 2D main path (1024 envs as 2 x 512, 3 steps,
                     K1 3 launches a rank), the training grid (1024 envs as
                     2 x 512, 2 steps) on K3's path (K3 and K4) and on the
                     field path (K6, K7 and K4), rewards and obs within 1e-5
                     relative; one 2D PPO iteration at the sarl2d_ra10000
                     configuration (256 envs as 2 x 128, K1 64 launches a
                     rank) of one epoch (8 updates, cuDNN deterministic):
                     params within 1e-5 of one process's; of the full 10
                     epochs (80 updates): the params' difference beside one
                     process's own repeat (float32 rounding grows over the
                     updates); both equal on the two ranks, one n_updates;
                     the weak-scaling harness (bench_multihost.sh, 512 envs
                     a rank, one and two ranks: the split on one card, not a
                     scaling figure); and launch_multihost.sh -> run_sarl
                     over two ranks (16 envs, one iteration of one epoch):
                     one metrics record, written by rank 0, the n_updates of
                     run_sarl in one process, the params beside its repeat
37. measurement      the measurement modules and their scripts: utils.parity
                     on the card, each gate on its main path's grid (K1 in
                     2D; K3 and K4, K6/K7 and K4 at 16x32x32, K5 and K4 at
                     32x64x64, each against the plain path within the JAX
                     helper's 5e-6, with its launches) and its
                     refusal of the CPU; utils.flopcount over the plain 2D
                     env step at 96x64 and 4 envs (elementwise FLOP per
                     point-stage, equal to the CPU's count; GEMM the solve's
                     closed form; no unknown op), over the 3D Poisson solves
                     (16x32x32 dense, 32x64x64 factored; their closed forms),
                     and its refusal of a K3-path env step, naming K3;
                     utils.roofline's shares of the main_path, main_path_3d
                     and main_path_big rates, each in (0, 100] %; and the
                     scripts at 1024 envs: bench3d on the stage and field
                     paths, ablate3d, probe_mxu_recon (its two
                     reconstructions within 1e-5 of the field's max |value|),
                     every time finite, the launches of each counted
38. lazy_options     the lazy loop's options at 1024 envs on 16x32x32: K3's
                     analysis instance (fused="stage_qp") at each stage
                     against its plain version (fields and g at K3's gates,
                     rhat against the plain version in float64 within twice
                     the float32 plain version's own error), and at stage 1
                     at 128 envs on nx = 64 (16x32x64); from one reset,
                     one env step each of fused="stage_qp" (within 5e-6 of
                     "stage", the instance 39 launches, K3 none), "stage_ew"
                     (bit for bit "stage", K3 39) and poisson_precision
                     "high" (within 5e-6 of "highest") and "default"
                     (finite), the divergence after each; q of the three
                     precisions against a float64 solve; both TF32 flags
                     off; the instance's ms a stage beside K3 plus the dense
                     analysis product, a stage_qp step beside a stage step,
                     the resident blocks an SM, registers and local memory
                     of the instance and of K3
39. poisson_precision_2d the 2D solver's "bf16x3" and "default" through K1's
                     split-product and one-pass TF32 instances at 1024 envs
                     on 96x64: each against its plain version at 6 substeps
                     ("bf16x3" at K1's gate against three TF32-split
                     products; "default" against the plain version in
                     float64, within twice the float32 plain version's own
                     error at "default" or K1's gate), beside float32 K1
                     and a float64 run; the runtime, cluster (128x64) and
                     off-chip (127x64) instances at "bf16x3" at 8 envs, the
                     one-pass cluster instance against float64 there; one env step of RBC2DVectorEnv
                     at each name (the instance 1 launch, float32 K1 none;
                     finite, Nu in range, max|div| under 1e-4, at "default"
                     under twice the plain path's own at "default", which
                     a one-pass TF32 solve leaves at ~2e-4); Solver2D.substep at
                     "bf16x3" within 5e-6 of "highest"; utils.parity at
                     "bf16x3"; the Ra=1e4 bank's fixed point through the
                     split instance (Nu 4.000 +- 0.02, 20 launches); both
                     TF32 flags off; each instance's ms beside float32 K1
                     (timed first and last), plain ms, bound and share
40. main_path_cluster RBC2DVectorEnv(num_envs=1024) on 128x64, the grid of
                     K1's cluster instance (two CTAs of 64 columns): reset,
                     3 steps with random actions; the 2D checks, the cluster
                     instance 3 launches and the other K1 instances none
41. fine_grids       the grids where the JAX package runs its kernels and the
                     port used to raise: K5's z split (a cluster of 2 CTAs a
                     block at nz = 112 and 128) at each stage against the
                     plain version in float64 beside the float32 plain
                     version's own error (SPLIT_VS_PLAIN) on 128x128x128 at
                     16 envs and 112x64x32 at 64;
                     RBC3DVectorEnv(16, state_shape=(128, 128, 128),
                     dt_solver=0.000625): reset, 3 steps, the 3D checks, the
                     split 225 launches, K4 3, single-CTA K5 none;
                     flowstats_ra.perform_experiment at Ra=2000, one env, 3
                     steps there; K1's off-chip instance with its slabs in
                     global scratch on 256x128 at 8 envs after 6 (K1_ATOL) and
                     50 (K1_MAIN_ATOL) substeps and at "bf16x3" and
                     "default" (phase 39's gates); RBC2DVectorEnv(1024,
                     state_shape=(128, 256)) and (64, (256, 512)) at stable
                     dt_solvers: reset, 3 steps, the 2D checks, the instance
                     3 launches and no other K1 instance; both instances'
                     occupancy and times beside their plain versions and
                     bounds

then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and last ``{"ok": true, "device": {...}}``.
Any failure is a traceback and a non-zero exit; without a CUDA device it
exits non-zero before printing a result.

The phase functions take the device and sizes as arguments, so the CPU
tests run them at a tiny size with the plain versions. The whole 3D env
steps that phases 5, 9 and 12 compare, and their float64 side-checks,
start from ``utils.parity.env_steps_3d``'s seeded start, the run that
phase 37 and a bench gate on.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from rbc_gym_tpu_torch.envs import single2d, single3d
from rbc_gym_tpu_torch.envs.vector2d import RBC2DVectorEnv
from rbc_gym_tpu_torch.envs.vector3d import RBC3DVectorEnv
from rbc_gym_tpu_torch.examples import run_ppo_native, run_vectorized
from rbc_gym_tpu_torch.examples import timing as example_timing_twin
from rbc_gym_tpu_torch.experiments import eval_baselines, run_sarl, run_sarl_2d
from rbc_gym_tpu_torch.experiments import run_sarl_2d_generalist as gen
from rbc_gym_tpu_torch.experiments.flowstats import flowstats_ra as fs3d
from rbc_gym_tpu_torch.experiments.flowstats import flowstats_ra_2d as fs2d
from rbc_gym_tpu_torch.models.nets import RBCActorCritic, RBCActorCritic2D
from rbc_gym_tpu_torch.models.params import load_params
from rbc_gym_tpu_torch.ops import _build
from rbc_gym_tpu_torch.ops import kernels2d as k2d
from rbc_gym_tpu_torch.ops import kernels3d as k3d
from rbc_gym_tpu_torch.ops import registry
from rbc_gym_tpu_torch.ops.limits import (
    env_step_2d_cluster_size,
    env_step_2d_on_chip,
    env_step_2d_slabs_on_chip,
    field_tendency_on_march,
    stage_xy_split_size,
    tendencies_2d_instance,
)
from rbc_gym_tpu_torch.ops.poisson import (
    FACTORED_POISSON_MIN_NXNZ,
    make_poisson_solver_3d,
    spectral_constants_2d,
)
from rbc_gym_tpu_torch.parallel import initialize_distributed, make_env_mesh, shard_vector_env
from rbc_gym_tpu_torch.parallel.launch import run_ranks
from rbc_gym_tpu_torch.rl import PPO, CheckpointCallback, NusseltCallback, restore_training_state
from rbc_gym_tpu_torch.rl.checkpoint import trainer_tensors
from rbc_gym_tpu_torch.scripts import ablate3d as substep_ablation
from rbc_gym_tpu_torch.scripts import ablate_actuation3d as ablate3d
from rbc_gym_tpu_torch.scripts import bench3d, probe_mxu_recon
from rbc_gym_tpu_torch.scripts import probe_control2d, probe_control3d, profile3d, profile_rl
from rbc_gym_tpu_torch.sim import burnin as bank_gen
from rbc_gym_tpu_torch.sim import solver2d as s2d
from rbc_gym_tpu_torch.sim import solver3d as s3d
from rbc_gym_tpu_torch.sim.grid import Grid2D, Grid3D
from rbc_gym_tpu_torch.sim.nusselt import nusselt_2d_physical
from rbc_gym_tpu_torch.sim.solver3d import Fields3D
from rbc_gym_tpu_torch.sim.solver2d import (
    DIVERGENCE_ATOL,
    Fields2D,
    SimParams2D,
    make_solver2d,
    max_divergence,
)
from rbc_gym_tpu_torch.utils import flopcount, parity, profiling, roofline
from rbc_gym_tpu_torch.utils.roofline import (
    FP32_FLOPS,
    bound,
    correct_3d_work,
    div_3d_work,
    env_step_work,
    field_tendency_3d_work,
    poisson_3d_flops,
    stage_rk_3d_rhat_work,
    stage_rk_3d_work,
    tendencies_own_work,
    tendencies_work,
)
from rbc_gym_tpu_torch.utils.checkpoints import (
    load_bank_2d,
    load_bank_3d,
    save_bank_2d,
    save_bank_3d,
)
from rbc_gym_tpu_torch.wrappers import functional as fn

# The big grid: 32x64x64 at dt_solver 0.005, 25 substeps per env step.
BIG_SHAPE = (32, 64, 64)
BIG_DT_SOLVER = 0.005

# K1 after 6 substeps: the JAX package's own device gate for the fused
# whole-step kernel against the XLA path (rbc_gym_tpu/utils/parity.py:20);
# the two differ only in float32 summation order. After the main path's
# 50 substeps the same gate scaled by the 50/6 more stages, rounded down.
K1_ATOL = 5e-6
K1_MAIN_ATOL = 4e-5
# K1's cluster instance's grid: 128x64 (nz, nx), whose on-chip state
# (296,448 bytes) does not fit a block, on two CTAs of 64 columns
CLUSTER_SHAPE = (64, 128)
# K1's one-pass TF32 instance (poisson_precision "default") rounds every
# operand of the solve to TF32 (2^-11 relative), far above K1_ATOL. It is
# held against its plain version run in float64 on the same inputs, within
# K1_TF32_VS_PLAIN times the error of the float32 plain version at
# "default" (its products one TF32 pass on the card too) against the same
# (phase 38's rule for rhat), or within K1_ATOL where that is larger: the
# float32 instance's own gate, which on small grids lies above both TF32
# errors. The split-product instance keeps K1_ATOL.
K1_TF32_VS_PLAIN = 2.0
# K2, one stage: the JAX test of the tendency kernel (tests/test_solver2d.py:208).
K2_ATOL = 1e-5
# Physical Nu at Ra=1e4 spans conduction (1) to developed 2D convection (~5).
NU_RANGE = (0.9, 6.0)
# K3, one stage on the same inputs: the updated fields and div within the
# JAX package's gate for its stage kernel against its XLA path
# (tests/test_pallas3d.py:56-70); the tendencies within its gate for a
# tendency kernel (tests/test_solver2d.py:208), as for K2. Both halves
# differ in float32 rounding only (flux form and FMA against the select
# form, a sequential against a library suffix sum).
K3_FIELD_ATOL = 5e-6
K3_G_ATOL = 1e-5
# K4 does the same three differences as its plain version; only FMA
# contraction may change the last bits of values of order 0.1.
K4_ATOL = 1e-6
# A whole 3D env step (13 substeps), kernel path against the all-plain
# path, u, v, w, b and p_nhs: the JAX package's gate for its stage-kernel
# path against the XLA path (tests/test_pallas3d.py:161-175).
ENV_STEP_3D_ATOL = 5e-6
# 3D Nu (the reference's definition, 1 + <T'w>/kappa) at Ra=2500, 1.5x the
# onset: 1 in conduction, under 2 for developed convection at this Ra; 3
# steps (1.5 time units) from the random IC leave it near 1. Below 0.8 or
# above 3 the solve has gone wrong.
NU_RANGE_3D = (0.8, 3.0)
# K6, one field's tendency: K3's tendency gate (the flux form against the
# plain version's, float32 rounding only). K7 does the plain version's
# three differences in its order; FMA contraction moves the last bits of
# terms of order 0.1-1.
K6_ATOL = 1e-5
K7_ATOL = 5e-6
# One env step of the per-field path against the K3 path from the same
# state: the same RK3 projection (each stage projected, or its correction
# carried to the next stage), which the JAX package holds against its XLA
# path at 5e-6 each (tests/test_pallas3d.py:30-43, :56-70).
FIELD_VS_STAGE_ATOL = 1e-5
# K3's analysis instance (fused="stage_qp") writes rhat = kron(Fx, Cz) div,
# which it sums in two factors where its plain version takes one dense
# GEMM: rhat is held against the plain version run in float64, at most
# RHAT_VS_PLAIN times the float32 plain version's own error there (K2's
# rule). Its fields and g keep K3's gates.
RHAT_VS_PLAIN = 2.0

# The 2D RL path. The committed copies of the Ra=1e4 banks and of the
# trained sarl2d_ra10000 policy (rbc_gym_tpu_torch/utils/convert.py).
REPO = Path(__file__).resolve().parent
ASSETS = REPO / "rbc_gym_tpu_torch" / "assets"
BANK_EPISODES = 20
# PARITY.md 1: the reference's float64 projected velocities have max|div|
# 6.4e-15 under the port's operator; 1e-12 is roundoff at a velocity-
# gradient scale of ~5 (tests/test_parity_reference.py:74). The repo's
# copies of the banks hold float32 values (each exactly representable),
# so for them the bound is float32 rounding: bank_div_atol.
BANK_DIV_ATOL = 1e-12
# PARITY.md 2: the reference-converged Ra=1e4 roll is the solver's fixed
# point, Nu 4.000 +- 0.005 over 30 time units in float64. Float32 rounding
# moves it by ~1e-3 (the K1 gate's 4e-5 on fields of order 1, over 20 env
# steps), so its band is 0.02.
FIXED_POINT_NU = 4.0
FIXED_POINT_ATOL = {torch.float64: 0.005, torch.float32: 0.02}
# The trained policy's mean and value in float32 against float64: a float32
# conv/dense stack of four layers, ~1e-6 relative rounding a layer.
POLICY_ATOL = 1e-5
POLICY_RTOL = 1e-5
# JAX evaluated the trained policy at 31.2 % suppression, CI [29.3, 33.0]
# (results/sarl2d_ra10000/baseline_eval.json); the port must reach 25 %.
MIN_SUPPRESSION_PCT = 25.0
# results/sarl2d_ra10000/config.yaml differs from run_sarl_2d's defaults
# only in its iteration count (the anneal horizon).
SARL2D_RA10000 = {"rl_nr_iterations": 500}
# The 3D RL path: results/sarl_ra2500/config.yaml (= experiments/configs/
# sarl3d_ra2500.yaml) over run_sarl's defaults: 256 envs, 32 steps a
# rollout, 4 minibatches of 2048, episodes of 40 env steps of 38 substeps.
SARL3D_RA2500 = {"rl_n_steps": 32, "rl_n_envs": 256, "rl_batch_size": 2048,
                 "rl_anneal_lr": True, "rl_nr_iterations": 300, "rbc_episode_length": 60,
                 "rl_log_std_init": -0.5,
                 "rbc_checkpoint": "data/checkpoints/train/3D_ckpt_ra2500.h5"}
# JAX evaluated the trained 3D policy (results/sarl_ra2500/baseline_eval.json:
# test bank, 64 episodes, 80 steps, sequential, ic_noise 1e-3) at second-half
# Nu 1.9330 against 1.9572 at zero action, 1.236 % suppression, CI [0.504,
# 1.947]; the port must reach the lower end of that CI.
JAX_EVAL_3D = {"trained_second_half_nu": 1.9330, "zero_second_half_nu": 1.9572,
               "suppression_vs_zero_pct": 1.236, "suppression_vs_zero_ci95": [0.504, 1.947]}
MIN_SUPPRESSION_3D_PCT = 0.5
# Flow statistics (phases 24-25): the JAX records' nu_mean and nu_std of
# experiments/flowstats/flowstats_ra_2d.json (120 steps, 4 envs, tail 60,
# from the train banks) and flowstats_ra.json (32x64x64, 300 steps, 1 env,
# tail 100). A point holds when its nu_mean is within the larger of
# FLOWSTATS_RTOL and FLOWSTATS_STDS JAX standard deviations of the JAX one;
# the Ra=1e4 point is the bank's fixed point, gated as in bank_oracles.
JAX_FLOWSTATS_2D = {
    "10000": (3.9997146646181743, 8.205443836150653e-06),
    "30000": (5.030286558469137, 0.31352541739495915),
    "100000": (6.7637302796045935, 0.38426452957222995),
    "300000": (8.796651593844096, 1.3290867091643541),
    "1000000": (13.322950665156046, 2.5087996767710523),
    "3000000": (24.272461064656575, 3.759635080684223),
    "10000000": (33.71948394775391, 3.1396454870124373),
}
JAX_FLOWSTATS_3D = {
    "500": (1.3588727295398713, 0.0007710421898760217),
    "2000": (1.7716144728660583, 0.024873890392957246),
}
FLOWSTATS_RTOL = {"2d": 0.02, "3d": 0.03}
FLOWSTATS_STDS = 4.0
# The probes (phases 26-27): results/probe2d_ra1000000.log (zero action,
# row 1 at gain 30) and results/probe3d_ra500.log (zero action, law T at
# row 1, gains +3 and -3), and the gates on them: the zero-action Nu
# within PROBE_ZERO_RTOL of JAX's, the controller raising Nu by at least
# PROBE_MIN_RISE (JAX: +27.3 % in 2D, +34.4 % and +36.8 % in 3D).
JAX_PROBE_2D = {"zero": 13.2262, "row1_gain30": 16.8423}
JAX_PROBE_3D = {"zero": 1.3772, "T_row1_gain+3": 1.8509, "T_row1_gain-3": 1.8835}
PROBE_ZERO_RTOL = {"2d": 0.05, "3d": 0.02}
PROBE_MIN_RISE = {"2d": 0.10, "3d": 0.15}

# The actuation ablation (phase 31): docs/RL_RESULTS.md:212-217, the JAX
# script's second-half Nu (held-out bank, 80 steps) under random and
# checkerboard forcing; the port's zero-amplitude row within
# ABLATION_ZERO_RTOL of it, every other within ABLATION_RTOL.
JAX_ABLATION = {"0": {"random": 1.957, "checker": 1.957},
                "0.2": {"random": 1.954, "checker": 1.987},
                "0.4": {"random": 1.974, "checker": 2.088},
                "1": {"random": 2.048, "checker": 2.567}}
ABLATION_ZERO_RTOL = 0.02
ABLATION_RTOL = 0.03

SOURCES = {
    "env_step_2d": "rbc_gym_tpu_torch/csrc/rbc2d.cu",
    "tendencies_2d": "rbc_gym_tpu_torch/csrc/rbc2d.cu",
    "stage_rk_3d": "rbc_gym_tpu_torch/csrc/rbc3d.cu",
    "correct_3d": "rbc_gym_tpu_torch/csrc/rbc3d.cu",
    "stage_rk_3d_xy": "rbc_gym_tpu_torch/csrc/rbc3d.cu",
    "field_tendency_3d": "rbc_gym_tpu_torch/csrc/rbc3d.cu",
    "div_3d": "rbc_gym_tpu_torch/csrc/rbc3d.cu",
    "stage_rk_3d_rhat": "rbc_gym_tpu_torch/csrc/rbc3d.cu",
    "env_step_2d_tf32x3": "rbc_gym_tpu_torch/csrc/rbc2d.cu",
    "env_step_2d_tf32": "rbc_gym_tpu_torch/csrc/rbc2d.cu",
    "env_step_2d_cluster": "rbc_gym_tpu_torch/csrc/rbc2d.cu",
    "stage_rk_3d_xy_split": "rbc_gym_tpu_torch/csrc/rbc3d.cu",
    "env_step_2d_global": "rbc_gym_tpu_torch/csrc/rbc2d.cu",
}
REPLACES = {
    "env_step_2d": "rbc_gym_tpu/ops/pallas2d.py:220",
    "tendencies_2d": "rbc_gym_tpu/ops/pallas2d.py:187",
    "stage_rk_3d": "rbc_gym_tpu/ops/pallas3d.py:597",
    "correct_3d": "rbc_gym_tpu/ops/pallas3d.py:894",
    "stage_rk_3d_xy": "rbc_gym_tpu/ops/pallas3d.py:1242",
    "field_tendency_3d": "rbc_gym_tpu/ops/pallas3d.py:441",
    "div_3d": "rbc_gym_tpu/ops/pallas3d.py:886",
    # the same Pallas body with emit_rhat (its in-kernel analysis, :853-882)
    "stage_rk_3d_rhat": "rbc_gym_tpu/ops/pallas3d.py:597",
    # the same Pallas body with bf16x3 (its split-product branch, :270-304)
    # and with its DEFAULT products (:432-436)
    "env_step_2d_tf32x3": "rbc_gym_tpu/ops/pallas2d.py:220",
    "env_step_2d_tf32": "rbc_gym_tpu/ops/pallas2d.py:220",
    # the same Pallas body on the grids K1's on-chip instance cannot hold
    "env_step_2d_cluster": "rbc_gym_tpu/ops/pallas2d.py:220",
    # the same Pallas bodies on the grids whose column single-CTA K5 cannot
    # hold, and whose solve slabs K1's off-chip instance cannot keep on the chip
    "stage_rk_3d_xy_split": "rbc_gym_tpu/ops/pallas3d.py:1242",
    "env_step_2d_global": "rbc_gym_tpu/ops/pallas2d.py:220",
}
# the gated parity error at the main path's shapes that each kernel reports
MAIN_SHAPE_CHECK = {"env_step_2d": "env_step_2d_main", "tendencies_2d": "tendencies_2d",
                    "stage_rk_3d": "stage_rk_3d", "correct_3d": "correct_3d",
                    "stage_rk_3d_xy": "stage_rk_3d_xy", "field_tendency_3d": "field_tendency_3d",
                    "div_3d": "div_3d", "stage_rk_3d_rhat": "stage_rk_3d_rhat",
                    "env_step_2d_tf32x3": "env_step_2d_tf32x3",
                    "env_step_2d_tf32": "env_step_2d_tf32",
                    "env_step_2d_cluster": "env_step_2d_cluster_main",
                    "stage_rk_3d_xy_split": "stage_rk_3d_xy_split",
                    "env_step_2d_global": "env_step_2d_global"}
WRAPPERS = registry.KERNEL_WRAPPERS


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def working_dtype(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cuda" else torch.float64


# ---------------------------------------------------------------------------
# Inputs and the two halves of each comparison
# ---------------------------------------------------------------------------


def make_case(device, num_envs: int, state_shape=(64, 96), heater_duration=0.18, seed=0,
              dtype=None, dt_solver=None):
    """Solver plus fields and bottom profile made by numpy from a seed."""
    device = torch.device(device)
    dtype = dtype or working_dtype(device)
    nz, nx = state_shape
    grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
    params = SimParams2D(heater_duration=heater_duration,
                         **({} if dt_solver is None else {"dt_solver": dt_solver}))
    solver = make_solver2d(grid, params, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    kick = params.random_kick
    u = kick * rng.standard_normal((num_envs, nx, nz))
    w = kick * rng.standard_normal((num_envs, nx, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    profile = params.min_b + (grid.lz - grid.z_centers()) * params.delta_b / 2.0
    b = np.clip(profile + kick * rng.standard_normal((num_envs, nx, nz)),
                params.min_b, params.min_b + params.delta_b)
    actions = rng.uniform(-1.0, 1.0, (num_envs, params.n_heaters))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    u, w, b = t(u), t(w), t(b)
    bottom = solver.heater_profile(t(actions)).contiguous()
    return solver, dict(u=u, w=w, b=b, bottom=bottom)


def k1_run(solver, case, kernel: bool, precision=None):
    fn = k2d.env_step_2d if kernel else k2d.env_step_2d_plain
    return fn(case["u"], case["w"], case["b"], case["bottom"], solver.spectral,
              solver.coeffs, solver.params.dt_solver, solver.params.substeps_per_env_step,
              precision)


def k1_float64(solver, case):
    """K1's plain version run in float64 on ``case`` (any dtype), with the
    solve's constants built in float64 (every product full precision)."""
    g = solver.grid
    spectral = spectral_constants_2d(g.nx, g.nz, g.dx, g.dz, torch.float64, case["u"].device)
    return k2d.env_step_2d_plain(*(case[k].double() for k in ("u", "w", "b", "bottom")),
                                 spectral, solver.coeffs, solver.params.dt_solver,
                                 solver.params.substeps_per_env_step)


def k1_tf32_errors(solver, case, got, plain=None, ref=None) -> dict:
    """Max |x - x64| over u, w, b, p_nhs of K1's output ``got`` (``kernel``)
    and of the float32 plain version at "default" (``plain_float32``; ``plain``
    if given, else run here), x64 the plain version run in float64 on the
    same inputs (``k1_float64``), and the one-pass instance's gate on
    ``kernel`` (``bound``, K1_TF32_VS_PLAIN); ``ref`` if given is x64."""
    ref = k1_float64(solver, case) if ref is None else ref
    plain = k1_run(solver, case, False, "default") if plain is None else plain
    kernel = max(abs_diffs(K1_OUT, ref, got).values())
    plain = max(abs_diffs(K1_OUT, ref, plain).values())
    return {"kernel": kernel, "plain_float32": plain,
            "bound": max(K1_TF32_VS_PLAIN * plain, K1_ATOL)}


def k2_run(solver, case, kernel: bool):
    fn = k2d.tendencies_2d if kernel else k2d.tendencies_2d_plain
    return fn(case["u"], case["w"], case["b"], case["bottom"], solver.coeffs)


def k2_errors(solver, case, got) -> dict:
    """K2's output ``got`` against its plain version run in float64 on the
    same inputs (``kernel``, the gate), beside the float32 plain version
    against the same (``plain_float32``) and K2 against the float32 plain
    version (``kernel_vs_plain_float32``). K2 sums pHY' in float64; the
    plain version sums it in the inputs' dtype, as the JAX package does,
    and -d pHY'/dx grows that sum's float32 rounding by 1/dx."""
    ref = k2_run(solver, {k: v.double() for k, v in case.items()}, False)
    plain = k2_run(solver, case, False)
    return {"kernel": abs_diffs(K2_OUT, ref, got),
            "plain_float32": abs_diffs(K2_OUT, ref, plain),
            "kernel_vs_plain_float32": abs_diffs(K2_OUT, got, plain)}


def abs_diffs(names, xs, ys) -> dict:
    """max |x - y| per output, compared in float64."""
    return {n: float((x.double() - y.double()).abs().max()) for n, x, y in zip(names, xs, ys)}


K1_OUT = ("u", "w", "b", "p_nhs")
K2_OUT = ("gu", "gw", "gb")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    start = time.perf_counter()
    lib, nvcc_s = _build.build()
    _build.load_library()
    return {"phase": "build", "library": lib.name, "nvcc_s": nvcc_s,
            "seconds": time.perf_counter() - start}


def kernel_parity(device, k1_envs=128, main_envs=1024, state_shape=(64, 96),
                  off_chip_shape=(64, 127), k2_runtime_shape=(64, 128),
                  k2_general_shape=(80, 96), cluster_shape=CLUSTER_SHAPE,
                  cluster_wide_shape=(64, 192)) -> dict:
    """Each kernel against its plain version from the same inputs: K1 after
    6 substeps (heater_duration 0.18) at ``k1_envs`` and after the main
    path's 50 at ``main_envs``, K2 on one stage at ``main_envs`` on
    ``state_shape`` and on a grid of each of its other instances (128x64:
    the runtime march; 96x80: the general instance), each against its plain
    version run in float64 (``k2_errors``). Also K1 and its plain version
    against a float64 plain run, after 6 and after 50 substeps at
    ``k1_envs``; K1's cluster instance on ``cluster_shape`` (128x64: the
    on-chip state does not fit a block, two CTAs of 64 columns do) after 6
    substeps at ``k1_envs`` and after 50 at ``main_envs``, and on
    ``cluster_wide_shape`` (192x64: two CTAs of 96 columns) after 6 at
    ``k1_envs``; and K1's off-chip
    instance after 6 substeps at ``k1_envs`` on ``off_chip_shape`` (127x64:
    no cluster splits an odd nx)."""
    start = time.perf_counter()
    solver, case = make_case(device, k1_envs, state_shape, heater_duration=0.18)
    k1_out = k1_run(solver, case, True)
    plain = k1_run(solver, case, False)
    k1 = abs_diffs(K1_OUT, k1_out, plain)
    ref = k1_run(*make_case(device, k1_envs, state_shape, 0.18, dtype=torch.float64), False)
    solver, case = make_case(device, k1_envs, state_shape, heater_duration=1.5, seed=3)
    ref50 = k1_run(*make_case(device, k1_envs, state_shape, 1.5, seed=3, dtype=torch.float64),
                   False)
    float64_50 = {"kernel": abs_diffs(K1_OUT, ref50, k1_run(solver, case, True)),
                  "plain_float32": abs_diffs(K1_OUT, ref50, k1_run(solver, case, False))}
    nz, nx = off_chip_shape
    if env_step_2d_on_chip(nx, nz) or env_step_2d_cluster_size(nx, nz):
        raise AssertionError(f"{off_chip_shape} does not run K1's off-chip instance")
    solver, case = make_case(device, k1_envs, off_chip_shape, heater_duration=0.18, seed=4)
    k1_off = abs_diffs(K1_OUT, k1_run(solver, case, True), k1_run(solver, case, False))
    nz, nx = cluster_shape
    if not env_step_2d_cluster_size(nx, nz):
        raise AssertionError(f"{cluster_shape} does not run K1's cluster instance")
    solver, case = make_case(device, k1_envs, cluster_shape, heater_duration=0.18, seed=8)
    k1_cluster = abs_diffs(K1_OUT, k1_run(solver, case, True), k1_run(solver, case, False))
    solver, case = make_case(device, main_envs, cluster_shape, heater_duration=1.5, seed=9)
    k1_cluster_main = abs_diffs(K1_OUT, k1_run(solver, case, True), k1_run(solver, case, False))
    del case
    nz, nx = cluster_wide_shape
    if not env_step_2d_cluster_size(nx, nz):
        raise AssertionError(f"{cluster_wide_shape} does not run K1's cluster instance")
    solver, case = make_case(device, k1_envs, cluster_wide_shape, heater_duration=0.18, seed=10)
    k1_cluster_wide = abs_diffs(K1_OUT, k1_run(solver, case, True), k1_run(solver, case, False))
    solver, case = make_case(device, main_envs, state_shape, heater_duration=1.5, seed=1)
    k1_main = abs_diffs(K1_OUT, k1_run(solver, case, True), k1_run(solver, case, False))
    k2_all = {"grid": k2_errors(solver, case, k2_run(solver, case, True))}
    k2_grids = {"grid": state_shape, "runtime_grid": k2_runtime_shape,
                "general_grid": k2_general_shape}
    k2_instances = {name: tendencies_2d_instance(shape[1], shape[0])
                    for name, shape in k2_grids.items()}
    for name, shape, seed in (("runtime_grid", k2_runtime_shape, 5),
                              ("general_grid", k2_general_shape, 6)):
        solver, case = make_case(device, main_envs, shape, heater_duration=0.18, seed=seed)
        k2_all[name] = k2_errors(solver, case, k2_run(solver, case, True))
    k2 = {name: e["kernel"] for name, e in k2_all.items()}
    errs = {"env_step_2d": max(k1.values()), "env_step_2d_main": max(k1_main.values()),
            "env_step_2d_off_chip": max(k1_off.values()),
            "env_step_2d_cluster": max(k1_cluster.values()),
            "env_step_2d_cluster_main": max(k1_cluster_main.values()),
            "env_step_2d_cluster_wide": max(k1_cluster_wide.values()),
            "tendencies_2d": max(k2["grid"].values()),
            "tendencies_2d_runtime": max(k2["runtime_grid"].values()),
            "tendencies_2d_general": max(k2["general_grid"].values())}
    atols = {"env_step_2d": K1_ATOL, "env_step_2d_main": K1_MAIN_ATOL,
             "env_step_2d_off_chip": K1_ATOL, "env_step_2d_cluster": K1_ATOL,
             "env_step_2d_cluster_main": K1_MAIN_ATOL, "env_step_2d_cluster_wide": K1_ATOL,
             "tendencies_2d": K2_ATOL,
             "tendencies_2d_runtime": K2_ATOL, "tendencies_2d_general": K2_ATOL}
    failed = {k: (errs[k], atols[k]) for k in errs if not errs[k] <= atols[k]}
    if failed:
        raise AssertionError(f"kernel parity failed (error, atol): {failed}")
    return {"phase": "kernel_parity", "max_abs_err": errs, "atol": atols,
            "env_step_2d_by_field": k1, "env_step_2d_main_by_field": k1_main,
            "env_step_2d_off_chip_by_field": k1_off, "off_chip_shape": list(off_chip_shape),
            "env_step_2d_cluster_by_field": k1_cluster,
            "env_step_2d_cluster_main_by_field": k1_cluster_main,
            "env_step_2d_cluster_wide_by_field": k1_cluster_wide,
            "cluster_shape": list(cluster_shape), "cluster_wide_shape": list(cluster_wide_shape),
            "cluster_ctas": env_step_2d_cluster_size(cluster_shape[1], cluster_shape[0]),
            "tendencies_2d_by_field": k2["grid"], "tendencies_2d_instances": k2_instances,
            "tendencies_2d_other_grids_by_field": {
                name: k2[name] for name in ("runtime_grid", "general_grid")},
            "tendencies_2d_float64_plain_vs": {
                name: k2_all["grid"][name] for name in ("kernel", "plain_float32")},
            "tendencies_2d_vs_plain_float32": {
                name: e["kernel_vs_plain_float32"] for name, e in k2_all.items()},
            "tendencies_2d_plain_float32_vs_float64": {
                name: e["plain_float32"] for name, e in k2_all.items()},
            "float64_plain_vs": {"kernel": abs_diffs(K1_OUT, ref, k1_out),
                                 "plain_float32": abs_diffs(K1_OUT, ref, plain)},
            "float64_plain_vs_50_substeps": float64_50,
            "seconds": time.perf_counter() - start}


def reset_counters() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    k3d.field_tendency_3d.launches_by_field = dict.fromkeys(k3d.FIELD_INPUTS, 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def counting_p_hy():
    """Count the calls of the PyTorch pHY' (``hydrostatic_pressure``, which
    the 2D solver and the plain tendencies reach) made inside; yields a
    one-item list holding the count."""
    real, calls = k2d.hydrostatic_pressure, [0]

    def counted(*args):
        calls[0] += 1
        return real(*args)

    k2d.hydrostatic_pressure = s2d.hydrostatic_pressure = counted
    try:
        yield calls
    finally:
        k2d.hydrostatic_pressure = s2d.hydrostatic_pressure = real


def main_path(device, num_envs=1024, state_shape=(64, 96), observation_shape=(8, 48),
              heater_duration=1.5, steps=3, seed=0) -> dict:
    """The user's path: reset, ``steps`` env steps, one single substep (on
    the card one PyTorch pHY' call: K2 computes its own)."""
    device = torch.device(device)
    env = RBC2DVectorEnv(num_envs, state_shape=state_shape,
                         observation_shape=observation_shape,
                         heater_duration=heater_duration,
                         dtype=working_dtype(device), device=device)
    rng = np.random.default_rng(seed)
    actions = [rng.uniform(-1.0, 1.0, (num_envs, env.params.n_heaters)) for _ in range(steps)]

    reset_counters()
    start = time.perf_counter()
    state, obs = env.reset(seed=seed)
    _sync(device)
    reset_s = time.perf_counter() - start
    start = time.perf_counter()
    for a in actions:
        state, ts = env.step(state, a)
    _sync(device)
    steps_s = time.perf_counter() - start
    bottom = env.solver.heater_profile(actions[-1])
    with counting_p_hy() as p_hy_calls:
        sub = env.solver.substep(state.fields, bottom)
    _sync(device)
    launches = {name: WRAPPERS[name].launches for name in ("env_step_2d", "tendencies_2d")}
    if device.type == "cuda" and p_hy_calls[0] != 1:
        raise AssertionError(f"the substep made {p_hy_calls[0]} PyTorch pHY' calls, not 1")

    nz_o, nx_o = observation_shape
    if tuple(ts.obs.shape) != (num_envs, 3, nz_o, nx_o):
        raise AssertionError(f"obs shape {tuple(ts.obs.shape)}")
    checks = check_2d(env, state, ts, extra=sub)
    if device.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"the main path missed a kernel: {launches}")
    return {"phase": "main_path", "num_envs": num_envs, "steps": steps,
            "reset_s": reset_s, "steps_s": steps_s,
            "env_steps_per_s": num_envs * steps / steps_s, **checks,
            "launches": launches, "substep_p_hy_calls": p_hy_calls[0]}


def main_path_cluster(device, num_envs=1024, state_shape=CLUSTER_SHAPE,
                      observation_shape=(8, 48), heater_duration=1.5, steps=3,
                      seed=0) -> dict:
    """The user's path on a grid of K1's cluster instance: reset and
    ``steps`` env steps of ``RBC2DVectorEnv`` on ``state_shape`` (on the
    card one cluster launch a step and no other K1 instance), with
    ``check_2d``'s checks; env-steps/s."""
    device = torch.device(device)
    env = RBC2DVectorEnv(num_envs, state_shape=state_shape,
                         observation_shape=observation_shape,
                         heater_duration=heater_duration,
                         dtype=working_dtype(device), device=device)
    rng = np.random.default_rng(seed)
    actions = [rng.uniform(-1.0, 1.0, (num_envs, env.params.n_heaters)) for _ in range(steps)]
    state, _ = env.reset(seed=seed)
    _sync(device)
    reset_counters()
    start = time.perf_counter()
    for a in actions:
        state, ts = env.step(state, a)
    _sync(device)
    steps_s = time.perf_counter() - start
    launches = {name: WRAPPERS[name].launches for name in K1_WRAPPERS + ("env_step_2d_cluster",)}
    expect_launches(device, launches, {**dict.fromkeys(K1_WRAPPERS, 0),
                                       "env_step_2d_cluster": steps})
    checks = check_2d(env, state, ts)
    nz, nx = state_shape
    return {"phase": "main_path_cluster", "num_envs": num_envs, "state_shape": list(state_shape),
            "cluster_ctas": env_step_2d_cluster_size(nx, nz), "steps": steps,
            "steps_s": steps_s, "env_steps_per_s": num_envs * steps / steps_s, **checks,
            "launches": launches}


def check_2d(env, state, ts, extra=None, div_atol=None) -> dict:
    """A 2D env step's checks: obs, reward and the fields (and ``extra``'s,
    a substep's) finite, reward = -Nu of the observation, the physical Nu
    of the state in ``NU_RANGE``, max |div| under the dtype's gate (or
    ``div_atol``)."""
    fields = [*state.fields._asdict().items()]
    if extra is not None:
        fields += [("substep." + k, v) for k, v in extra._asdict().items()]
    for name, x in [("obs", ts.obs), ("reward", ts.reward), *fields]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} is not finite")
    if not torch.equal(ts.reward, -ts.nusselt_obs):
        raise AssertionError("reward is not -Nu of the observation")
    g, p = env.grid, env.params
    f = state.fields
    w_c = 0.5 * (f.w[..., :-1] + f.w[..., 1:])
    nu_phys = nusselt_2d_physical(f.b, w_c, p.kappa, p.delta_b, g.lz, g.dz)
    nu_lo, nu_hi = float(nu_phys.min()), float(nu_phys.max())
    if not (NU_RANGE[0] <= nu_lo and nu_hi <= NU_RANGE[1]):
        raise AssertionError(f"Nu in [{nu_lo}, {nu_hi}], outside {NU_RANGE}")
    div_tol = DIVERGENCE_ATOL[env.dtype] if div_atol is None else div_atol
    div = max_divergence(f, g)
    if extra is not None:
        div = max(div, max_divergence(extra, g))
    if div >= div_tol:
        raise AssertionError(f"max |div| {div} >= {div_tol}")
    return {"nusselt_physical": [nu_lo, nu_hi], "max_abs_div": div, "div_atol": div_tol}


def _cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


kernel_time_split = profiling.kernel_time_split


def device_profile(fn) -> dict:
    """One call of ``fn`` (after one warm-up) under ``utils.profiling.trace``
    (CUDA activity, a synchronise on entry and exit): ``kernel_time_split``
    of its trace."""
    fn()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as traced:
            fn()
        return kernel_time_split(profiling.trace_events(traced.path))


def timing(device, num_envs=1024, state_shape=(64, 96), heater_duration=1.5,
           off_chip_shape=(64, 127), cluster_shape=CLUSTER_SHAPE) -> dict:
    """CUDA-event times at the main path's shapes, with the plain versions
    and the bounds, K1's cluster instance on ``cluster_shape`` and its
    off-chip instance on ``off_chip_shape``, and what the card gives each
    K1 instance (``kernels2d.env_step_2d_occupancy``: registers, local
    memory, shared bytes, blocks an SM, resident clusters); the
    PyTorch pHY' and one ``Solver2D.substep`` split into its 3 K2 launches,
    its one pHY' call, the RK updates and the projections (divergence,
    solve and correction), each part timed alone, and the substep's
    kernels by device time from ``torch.profiler``. Launches made here are
    not the main path's."""
    begin = time.perf_counter()
    out = {}
    for name, shape, run, reps in (
        ("env_step_2d", state_shape, k1_run, 3),
        ("tendencies_2d", state_shape, k2_run, 20),
        ("env_step_2d_cluster", cluster_shape, k1_run, 3),
        ("env_step_2d_off_chip", off_chip_shape, k1_run, 1),
    ):
        solver, case = make_case(device, num_envs, shape, heater_duration, seed=2)
        nz, nx = shape
        n_sub = solver.params.substeps_per_env_step
        work = (tendencies_own_work(num_envs, nx, nz) if run is k2_run
                else env_step_work(num_envs, nx, nz, n_sub))
        ms = _cuda_ms(lambda: run(solver, case, True), reps)
        plain_ms = _cuda_ms(lambda: run(solver, case, False), max(1, reps // 3))
        bound_ms, bound_by = bound(work)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                     "shape": list(shape), **work}
        del case
    occupancy = {}
    if device.type == "cuda":
        for name, shape, precision in (
                ("on_chip", state_shape, None), ("on_chip_tf32x3", state_shape, "high"),
                ("on_chip_tf32", state_shape, "default"), ("cluster", cluster_shape, None),
                ("cluster_tf32x3", cluster_shape, "high"),
                ("cluster_tf32", cluster_shape, "default"), ("off_chip", off_chip_shape, None)):
            occupancy[name] = {"shape": list(shape), "precision": precision,
                               **k2d.env_step_2d_occupancy(shape[1], shape[0], precision)}
    nz, nx = state_shape
    pallas_ms = bound(tendencies_work(num_envs, nx, nz))[0]
    out["tendencies_2d"].update(pallas_bound_ms=pallas_ms,
                                share_of_pallas_bound=pallas_ms / out["tendencies_2d"]["ms"])

    solver, case = make_case(device, num_envs, state_shape, heater_duration, seed=2)
    c, dt = solver.coeffs, solver.params.dt_solver
    uwb = (case["u"], case["w"], case["b"])
    g = k2_run(solver, case, True)
    parts = {
        "p_hy_ms": _cuda_ms(lambda: k2d.hydrostatic_pressure(case["b"], c.dz, c.min_b), 20),
        "rk_update_stage0_ms": _cuda_ms(lambda: k2d.rk3_update(uwb, g, None, 0, dt), 20),
        "rk_update_stage12_ms": _cuda_ms(lambda: k2d.rk3_update(uwb, g, g, 1, dt), 20),
        "project_ms": _cuda_ms(
            lambda: k2d.project_2d(case["u"], case["w"], solver.spectral, c,
                                   (k2d.RK3_GAMMA[0] + k2d.RK3_ZETA[0]) * dt), 10)}
    zeros = torch.zeros_like(case["u"])
    f = Fields2D(case["u"], case["w"], case["b"], zeros, zeros)
    substep_ms = _cuda_ms(lambda: solver.substep(f, case["bottom"]), 5)
    split = {"substep_ms": substep_ms,
             "tendencies_2d_ms": 3 * out["tendencies_2d"]["ms"],
             "p_hy_ms": parts["p_hy_ms"],
             "rk_update_ms": parts["rk_update_stage0_ms"] + 2 * parts["rk_update_stage12_ms"],
             "project_ms": 3 * parts["project_ms"]}
    split["rest_ms"] = substep_ms - sum(v for k, v in split.items() if k != "substep_ms")
    return {"phase": "timing", "num_envs": num_envs, "kernels": out, "occupancy": occupancy,
            "substep_parts": parts,
            "substep_split": split,
            "substep_device": device_profile(lambda: solver.substep(f, case["bottom"])),
            "seconds": time.perf_counter() - begin}


# ---------------------------------------------------------------------------
# 3D: the training grid through RBC3DVectorEnv
# ---------------------------------------------------------------------------


# The amplitude of the cases' noise on u, v, w and b: large enough that the
# advective fluxes, not the diffusion alone, set the kernels' outputs.
CASE_AMP = 0.05


def make_case_3d(device, num_envs: int, state_shape=(16, 32, 32), seed=0, dtype=None,
                 dt_solver=0.01, fused=None):
    """3D solver (path ``fused``) plus fields, bottom plate and the pending
    solve q of their divergence, made by numpy from a seed."""
    device = torch.device(device)
    dtype = dtype or working_dtype(device)
    nz, ny, nx = state_shape
    grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
    params = s3d.SimParams3D(dt_solver=dt_solver)
    solver = s3d.make_solver3d(grid, params, dtype=dtype, device=device, fused=fused)
    rng = np.random.default_rng(seed)
    amp = CASE_AMP
    u = amp * rng.standard_normal((num_envs, nx, ny, nz))
    v = amp * rng.standard_normal((num_envs, nx, ny, nz))
    w = amp * rng.standard_normal((num_envs, nx, ny, nz + 1))
    w[..., 0] = w[..., -1] = 0.0
    profile = params.min_b + (grid.lz - grid.z_centers()) * params.delta_b / 2.0
    b = np.clip(profile + amp * rng.standard_normal(u.shape), params.min_b,
                params.min_b + params.delta_b)
    actions = rng.uniform(-1.0, 1.0, (num_envs, params.n_heaters, params.n_heaters))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    u, v, w, b = t(u), t(v), t(w), t(b)
    bottom = solver.heater_profile(t(actions)).contiguous()
    q = solver.solve(k3d.div_3d_plain(u, v, w, solver.coeffs))
    return solver, dict(u=u, v=v, w=w, b=b, bottom=bottom, q=q)


def k3_run(solver, case, stage: int, g_prev, kernel: bool, wrapper=k3d.stage_rk_3d):
    """One stage of ``wrapper`` (K3 or K5) or of the plain version."""
    fn = wrapper if kernel else k3d.stage_rk_3d_plain
    return fn(case["u"], case["v"], case["w"], case["b"], case["q"], case["bottom"],
              solver.coeffs, 0.04, stage, g_prev)


def k4_run(solver, case, kernel: bool):
    fn = k3d.correct_3d if kernel else k3d.correct_3d_plain
    return fn(case["u"], case["v"], case["w"], case["q"], solver.coeffs)


def env_step_3d_run(solver, case, kernel: bool):
    """One env step's lazy loop from the case's fields -> (u, v, w, b,
    p_nhs), through the solver's path or the all-plain one."""
    stage_rk, correct = s3d.STAGE_PATHS[solver.path if kernel else "plain"]
    dts = [float(d) for d in solver.params.substep_dts()]
    u, v, w, b, q = s3d.lazy_substeps(case["u"], case["v"], case["w"], case["b"], case["bottom"],
                                      dts, solver.solve, solver.coeffs, stage_rk, correct)
    dt_last = (k3d.RK3_GAMMA[2] + k3d.RK3_ZETA[2]) * dts[-1]
    return u, v, w, b, k3d.from_solve_layout(q) / dt_last


def k6_run(solver, case, field: str, kernel: bool):
    fn = k3d.field_tendency_3d if kernel else k3d.field_tendency_3d_plain
    return fn(field, *(case[n] for n in k3d.FIELD_INPUTS[field]), c=solver.coeffs)


def k7_run(solver, case, kernel: bool):
    fn = k3d.div_3d if kernel else k3d.div_3d_plain
    return fn(case["u"], case["v"], case["w"], solver.coeffs)


K3_OUT = ("u", "v", "w", "b", "div")
G_OUT = ("gu", "gv", "gw", "gb")
ENV3_OUT = ("u", "v", "w", "b", "p_nhs")


def env_step_paths_3d(device, num_envs: int, state_shape, paths, seed: int,
                      dt_solver=0.01, dtype=torch.float32) -> list:
    """(u, v, w, b, p_nhs) after one env step of each path of ``paths`` (a
    ``fused`` value; None is the solver's own) from one seeded start at the
    cases' amplitude: ``utils.parity.env_steps_3d``, the bench gate's run."""
    fields = parity.env_steps_3d(paths, num_envs, state_shape=state_shape, dt_solver=dt_solver,
                                 heater_duration=s3d.SimParams3D().heater_duration,
                                 random_kick=CASE_AMP, device=device, seed=seed, dtype=dtype)
    return [[getattr(f, n) for n in ENV3_OUT] for f in fields]


def stage_parity(solver, case, wrapper, prefix=""):
    """Stage 0, 1, 2 of ``wrapper`` (K3 or K5) against the plain version,
    each stage fed the plain outputs of the one before -> (errors by stage
    and output, {check: (error, atol)})."""
    by_stage, g_prev, errs = {}, None, {}
    stage_case = dict(case)
    for stage in range(3):
        got = k3_run(solver, stage_case, stage, g_prev, True, wrapper)
        want = k3_run(solver, stage_case, stage, g_prev, False)
        fields = abs_diffs(K3_OUT, got[:5], want[:5])
        g = abs_diffs(G_OUT, got[5], want[5]) if stage < 2 else {}
        by_stage[f"stage{stage}"] = {**fields, **g}
        errs[f"{prefix}stage{stage}_fields"] = (max(fields.values()), K3_FIELD_ATOL)
        if g:
            errs[f"{prefix}stage{stage}_g"] = (max(g.values()), K3_G_ATOL)
        stage_case.update(zip("uvwb", want[:4]), q=solver.solve(want[4]))
        g_prev = want[5]
    return by_stage, errs


def stage0_float64(solver, case, wrapper) -> dict:
    """Stage 0 of ``wrapper`` (K3 or K5) and of the float32 plain version
    against a float64 plain run from the same inputs: each half's float32
    rounding."""
    case64 = {k: v.double() for k, v in case.items()}

    def outs(out):
        return (*out[:5], *out[5])

    ref = outs(k3_run(solver, case64, 0, None, False))
    return {"kernel": abs_diffs(K3_OUT + G_OUT, ref,
                                outs(k3_run(solver, case, 0, None, True, wrapper))),
            "plain_float32": abs_diffs(K3_OUT + G_OUT, ref,
                                       outs(k3_run(solver, case, 0, None, False)))}


def kernel_parity_3d(device, main_envs=1024, step_envs=32, state_shape=(16, 32, 32)) -> dict:
    """K3 stage 0, 1, 2 and K4 against their plain versions at the main
    path's shapes, each stage fed the plain outputs of the one before; K3's
    stage 0 beside a float64 run at ``step_envs``; one whole env step of
    the kernel path against the all-plain path at ``step_envs`` and at
    ``main_envs``, and both against a float64 plain run
    (``env_step_paths_3d``)."""
    start = time.perf_counter()
    solver, case = make_case_3d(device, main_envs, state_shape, seed=3)
    by_stage, errs = stage_parity(solver, case, k3d.stage_rk_3d)
    k4 = abs_diffs("uvw", k4_run(solver, case, True), k4_run(solver, case, False))
    errs["correct_3d"] = (max(k4.values()), K4_ATOL)
    del case
    rounding = stage0_float64(*make_case_3d(device, step_envs, state_shape, seed=10),
                              k3d.stage_rk_3d)
    steps = {}
    for n_env in sorted({step_envs, main_envs}):
        kern, plain = env_step_paths_3d(device, n_env, state_shape, (None, False), seed=4)
        steps[n_env] = {"kernel_vs_plain": abs_diffs(ENV3_OUT, kern, plain)}
        errs[f"env_step_{n_env}"] = (max(steps[n_env]["kernel_vs_plain"].values()),
                                     ENV_STEP_3D_ATOL)
        if n_env == step_envs:
            ref, = env_step_paths_3d(device, n_env, state_shape, (False,), seed=4,
                                     dtype=torch.float64)
            steps[n_env]["float64_plain_vs"] = {
                "kernel": abs_diffs(ENV3_OUT, ref, kern),
                "plain_float32": abs_diffs(ENV3_OUT, ref, plain)}
    failed = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if failed:
        raise AssertionError(f"3D kernel parity failed (error, atol): {failed}")
    max_err = {"stage_rk_3d": max(v[0] for k, v in errs.items() if k.startswith("stage")),
               "correct_3d": errs["correct_3d"][0]}
    return {"phase": "kernel_parity_3d", "num_envs": main_envs, "max_abs_err": max_err,
            "gated": {k: {"error": e, "atol": a} for k, (e, a) in errs.items()},
            "stage_rk_3d_by_stage": by_stage, "correct_3d_by_field": k4,
            "stage0_float64_plain_vs": rounding,
            "env_step": {str(k): v for k, v in steps.items()},
            "seconds": time.perf_counter() - start}


STAGE_WRAPPERS = ("stage_rk_3d", "stage_rk_3d_xy", "correct_3d")
FIELD_PATH_WRAPPERS = STAGE_WRAPPERS + ("field_tendency_3d", "div_3d")


def drive_3d(env, steps: int, seed: int, counted=STAGE_WRAPPERS):
    """The user's 3D path from zeroed counters: reset, ``steps`` env steps
    with random (E, S, S) actions -> (state, obs, last timestep, record
    with the launches of the wrappers ``counted``)."""
    device, num_envs, s = env.device, env.num_envs, env.params.n_heaters
    rng = np.random.default_rng(seed)
    actions = [rng.uniform(-1.0, 1.0, (num_envs, s, s)) for _ in range(steps)]
    reset_counters()
    start = time.perf_counter()
    state, obs = env.reset(seed=seed)
    _sync(device)
    reset_s = time.perf_counter() - start
    start = time.perf_counter()
    for a in actions:
        state, ts = env.step(state, a)
    _sync(device)
    steps_s = time.perf_counter() - start
    launches = {name: WRAPPERS[name].launches for name in counted}
    return state, obs, ts, actions, {
        "num_envs": num_envs, "steps": steps, "path": env.solver.path, "reset_s": reset_s,
        "steps_s": steps_s, "env_steps_per_s": num_envs * steps / steps_s,
        "launches": launches}


def check_3d(env, state, obs, ts, extra=None) -> dict:
    """Shapes, finiteness, reward, Nu and divergence of a 3D run (and of
    ``extra``, more fields on the same grid)."""
    nz, ny, nx = env.grid.nz, env.grid.ny, env.grid.nx
    for o in (obs, ts.obs):
        if tuple(o.shape) != (env.num_envs, 4, nz, ny, nx):
            raise AssertionError(f"obs shape {tuple(o.shape)}")
    more = () if extra is None else tuple(("substep." + k, v) for k, v in extra._asdict().items())
    for name, x in [("obs", ts.obs), ("reward", ts.reward), *state.fields._asdict().items(),
                    *more]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} is not finite")
    if not torch.equal(ts.reward, -ts.nusselt):
        raise AssertionError("reward is not -Nu")
    nu_lo, nu_hi = float(ts.nusselt.min()), float(ts.nusselt.max())
    if not (NU_RANGE_3D[0] <= nu_lo and nu_hi <= NU_RANGE_3D[1]):
        raise AssertionError(f"Nu in [{nu_lo}, {nu_hi}], outside {NU_RANGE_3D}")
    div_tol = s3d.DIVERGENCE_ATOL[env.dtype]
    div = s3d.max_divergence_3d(state.fields, env.grid)
    if extra is not None:
        div = max(div, s3d.max_divergence_3d(extra, env.grid))
    if div >= div_tol:
        raise AssertionError(f"max |div| {div} >= {div_tol}")
    return {"nusselt": [nu_lo, nu_hi], "max_abs_div": div, "div_atol": div_tol}


def expect_launches(device, got: dict, want: dict) -> None:
    if device.type == "cuda" and got != want:
        raise AssertionError(f"launches {got}, expected {want}")


def main_path_3d(device, num_envs=1024, state_shape=(16, 32, 32), heater_duration=0.125,
                 steps=3, seed=0) -> dict:
    """The user's 3D path: reset, ``steps`` env steps, one single substep."""
    device = torch.device(device)
    env = RBC3DVectorEnv(num_envs, state_shape=state_shape, heater_duration=heater_duration,
                         dtype=working_dtype(device), device=device)
    state, obs, ts, actions, rec = drive_3d(env, steps, seed)
    sub = env.solver.substep(state.fields, env.solver.heater_profile(actions[-1]),
                             float(env.params.substep_dts()[0]))
    _sync(device)
    checks = check_3d(env, state, obs, ts, sub)
    n_stages = steps * 3 * len(env.params.substep_dts())
    expect_launches(device, rec["launches"],
                    {"stage_rk_3d": n_stages, "stage_rk_3d_xy": 0, "correct_3d": steps})
    launches = {k: rec["launches"][k] for k in ("stage_rk_3d", "correct_3d")}
    return {"phase": "main_path_3d", **rec, **checks, "launches": launches}


def main_path_big(device, num_envs=1024, state_shape=BIG_SHAPE, dt_solver=BIG_DT_SOLVER,
                  heater_duration=0.125, steps=3, seed=0) -> dict:
    """The big grid through the user's path: reset and ``steps`` env steps
    of ``RBC3DVectorEnv(num_envs, state_shape, dt_solver)``; the peak of
    device memory over them."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    env = RBC3DVectorEnv(num_envs, state_shape=state_shape, dt_solver=dt_solver,
                         heater_duration=heater_duration, dtype=working_dtype(device),
                         device=device)
    state, obs, ts, _, rec = drive_3d(env, steps, seed)
    checks = check_3d(env, state, obs, ts)
    n_stages = steps * 3 * len(env.params.substep_dts())
    expect_launches(device, rec["launches"],
                    {"stage_rk_3d": 0, "stage_rk_3d_xy": n_stages, "correct_3d": steps})
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"phase": "main_path_big", "state_shape": list(state_shape),
            "substeps_per_step": len(env.params.substep_dts()), **rec, **checks,
            "peak_memory_bytes": peak}


def timing_3d(device, num_envs=1024, state_shape=(16, 32, 32)) -> dict:
    """CUDA-event times at the 3D main path's shapes: K3 per stage with its
    share of the bound, K5 forced on the same inputs (K3's yardstick), K4,
    their plain versions and bounds, both Poisson forms, and one env step
    split into K3, solves, K4 and the rest. Launches here are not the main
    path's."""
    begin = time.perf_counter()
    nz, ny, nx = state_shape
    solver, case = make_case_3d(device, num_envs, state_shape, seed=5)
    g_prev = k3_run(solver, case, 0, None, False)[5]
    out = {}
    for stage in range(3):
        gp = g_prev if stage else None
        ms = _cuda_ms(lambda: k3_run(solver, case, stage, gp, True), 20)
        plain_ms = _cuda_ms(lambda: k3_run(solver, case, stage, gp, False), 3)
        xy_ms = _cuda_ms(lambda: k3_run(solver, case, stage, gp, True, k3d.stage_rk_3d_xy), 20)
        work = stage_rk_3d_work(num_envs, nx, ny, nz, stage)
        bound_ms, bound_by = bound(work)
        out[f"stage_rk_3d.stage{stage}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                            "bound_by": bound_by,
                                            "share_of_bound": bound_ms / ms, **work}
        out[f"stage_rk_3d_xy_forced.stage{stage}"] = {"ms": xy_ms,
                                                      "share_of_bound": bound_ms / xy_ms}
    work = correct_3d_work(num_envs, nx, ny, nz)
    bound_ms, bound_by = bound(work)
    out["correct_3d"] = {"ms": _cuda_ms(lambda: k4_run(solver, case, True), 20),
                         "plain_ms": _cuda_ms(lambda: k4_run(solver, case, False), 3),
                         "bound_ms": bound_ms, "bound_by": bound_by, **work}
    # K3 per env step: 13 substeps of the three variants; its record is
    # the mean launch, its bound the mean bound
    stages = [out[f"stage_rk_3d.stage{m}"] for m in range(3)]
    mean = {k: sum(st[k] for st in stages) / 3 for k in ("ms", "plain_ms", "bound_ms")}
    out["stage_rk_3d"] = {**mean, "bound_by": stages[1]["bound_by"]}

    rhs = case["q"]
    solves = {}
    for factored in (False, True):
        solve = make_poisson_solver_3d(nx, ny, nz, solver.grid.dx, solver.grid.dy,
                                       solver.grid.dz, rhs.dtype, rhs.device, factored=factored)
        flops = poisson_3d_flops(num_envs, nx, ny, nz, factored)
        solves["factored" if factored else "dense"] = {
            "ms": _cuda_ms(lambda: solve(rhs), 10), "flops": flops,
            "bound_ms": 1e3 * flops / FP32_FLOPS}
    zeros = torch.zeros_like(case["u"])
    f = s3d.Fields3D(case["u"], case["v"], case["w"], case["b"], zeros, zeros)
    actions = torch.zeros((num_envs, 8, 8), dtype=rhs.dtype, device=rhs.device)
    step_ms = _cuda_ms(lambda: solver.env_step(f, actions), 3)
    n_sub = len(solver.params.substep_dts())
    default = "factored" if nx * nz >= FACTORED_POISSON_MIN_NXNZ else "dense"
    split = {"env_step_ms": step_ms,
             "stage_rk_3d_ms": n_sub * sum(st["ms"] for st in stages),
             "poisson_ms": 3 * n_sub * solves[default]["ms"],
             "correct_3d_ms": out["correct_3d"]["ms"]}
    split["rest_ms"] = step_ms - sum(v for k, v in split.items() if k != "env_step_ms")
    return {"phase": "timing_3d", "num_envs": num_envs, "kernels": out, "poisson": solves,
            "env_step_split": split, "seconds": time.perf_counter() - begin}


# ---------------------------------------------------------------------------
# 3D: the 32x64x64 big grid, K5 and the kernel-selection rule
# ---------------------------------------------------------------------------


ODD_NX_SHAPE = (16, 32, 30)  # nx = 30: K3's slab fits, nx % 4 != 0


def selection(device) -> dict:
    """The rule of ``Solver3D.path`` / ``Solver2D.path`` on this device:
    auto picks K3 on the training grid, K5 on the big grid and the field
    path at nx = 30 (CUDA, float32), where one env step launches K6 and
    K7; the plain path for float64 (no kernel launch in a step);
    ``fused=True`` is the field path; forcing K3 on the big grid, or the
    field path in float64, raises before any launch. On the CPU auto is
    the plain path everywhere."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    f32, f64 = torch.float32, torch.float64
    paths = {}
    for name, shape in (("training_grid", (16, 32, 32)), ("big_grid", BIG_SHAPE),
                        ("odd_nx", ODD_NX_SHAPE)):
        env = RBC3DVectorEnv(2, state_shape=shape, dtype=f32, device=device)
        paths[name] = env.solver.path
    want = {"training_grid": "stage" if cuda else "plain",
            "big_grid": "stage_xy" if cuda else "plain",
            "odd_nx": "field" if cuda else "plain"}
    fused_true = RBC3DVectorEnv(2, fused=True, dtype=f32, device=device).solver.path
    if fused_true != "field":
        raise AssertionError(f"fused=True took the {fused_true} path, not the field path")
    rng = np.random.default_rng(0)
    reset_counters()
    env = RBC3DVectorEnv(2, state_shape=(8, 16, 16), heater_duration=0.0125, dtype=f64,
                         device=device)
    state, _ = env.reset(seed=0)
    state, ts = env.step(state, rng.uniform(-1.0, 1.0, (2, 8, 8)))
    _sync(device)
    paths["float64_3d"], want["float64_3d"] = env.solver.path, "plain"
    env2 = RBC2DVectorEnv(2, heater_duration=0.06, dtype=f64, device=device)
    state2, _ = env2.reset(seed=0)
    state2, ts2 = env2.step(state2, rng.uniform(-1.0, 1.0, (2, env2.params.n_heaters)))
    _sync(device)
    paths["float64_2d"], want["float64_2d"] = env2.solver.path, "plain"
    if not all(bool(torch.isfinite(t).all()) for t in (*state.fields, *state2.fields)):
        raise AssertionError("a float64 plain step is not finite")
    try:
        RBC3DVectorEnv(2, state_shape=BIG_SHAPE, fused="stage", dtype=torch.float32,
                       device=device)
    except ValueError as err:
        forced = str(err)
    else:
        raise AssertionError("forcing K3 on the big grid did not raise")
    if "ny * nz <= 1024" not in forced:
        raise AssertionError(f"the refusal does not name K3's thread limit: {forced}")
    try:
        RBC3DVectorEnv(2, fused="field", dtype=f64, device=device)
    except ValueError as err:
        forced_field = str(err)
    else:
        raise AssertionError("forcing the field path in float64 did not raise")
    if "float32" not in forced_field:
        raise AssertionError(f"the refusal does not name the dtype: {forced_field}")
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    if paths != want:
        raise AssertionError(f"paths {paths}, expected {want}")
    if any(launches.values()):
        raise AssertionError(f"a plain or refused path launched a kernel: {launches}")
    # one env step where auto took the field path (2 substeps)
    env = RBC3DVectorEnv(2, state_shape=ODD_NX_SHAPE, heater_duration=0.0125, dtype=f32,
                         device=device)
    state, _ = env.reset(seed=0)
    state, _ = env.step(state, rng.uniform(-1.0, 1.0, (2, 8, 8)))
    _sync(device)
    if not all(bool(torch.isfinite(t).all()) for t in state.fields):
        raise AssertionError("the odd-nx step is not finite")
    odd = {name: WRAPPERS[name].launches - launches[name] for name in FIELD_PATH_WRAPPERS}
    n_stages = 3 * len(env.params.substep_dts())
    expect_launches(device, odd, {"stage_rk_3d": 0, "stage_rk_3d_xy": 0, "correct_3d": n_stages,
                                  "field_tendency_3d": 4 * n_stages, "div_3d": n_stages})
    return {"phase": "selection", "paths": paths, "fused_true": fused_true,
            "forced_stage_big_grid": forced, "forced_field_float64": forced_field,
            "launches": launches, "odd_nx_step_launches": odd}


def kernel_parity_big(device, main_envs=1024, big_envs=8, small_envs=256, step_envs=4,
                      state_shape=BIG_SHAPE, small_shape=(16, 32, 32)) -> dict:
    """K5 stage 0, 1, 2 and K4 against their plain versions at the big main
    path's shapes (``main_envs``); K5 again at ``big_envs`` beside a float64
    run of stage 0, and, forced, at the training grid, where ny = 32 makes
    four y blocks (``small_envs``); one whole big-grid env step (25
    substeps) of the kernel path against the all-plain path and both
    against a float64 plain run (``step_envs``; ``env_step_paths_3d``)."""
    start = time.perf_counter()
    device = torch.device(device)
    solver, case = make_case_3d(device, main_envs, state_shape, seed=6, dt_solver=BIG_DT_SOLVER)
    by_stage, errs = stage_parity(solver, case, k3d.stage_rk_3d_xy)
    k4 = abs_diffs("uvw", k4_run(solver, case, True), k4_run(solver, case, False))
    errs["correct_3d"] = (max(k4.values()), K4_ATOL)
    max_err = {"stage_rk_3d_xy": max(e for k, (e, _) in errs.items() if k.startswith("stage")),
               "correct_3d": errs["correct_3d"][0]}
    del case
    solver, case = make_case_3d(device, big_envs, state_shape, seed=10, dt_solver=BIG_DT_SOLVER)
    by_stage_few, errs_few = stage_parity(solver, case, k3d.stage_rk_3d_xy, "few_envs_")
    errs.update(errs_few)
    # stage 0 in float64 from the same inputs: the float32 rounding of both
    # halves, which grows with 1/dx^2 and 1/dz^2 on this finer grid
    rounding = stage0_float64(solver, case, k3d.stage_rk_3d_xy)
    solver, case = make_case_3d(device, small_envs, small_shape, seed=7)
    by_stage_small, errs_small = stage_parity(solver, case, k3d.stage_rk_3d_xy, "small_")
    errs.update(errs_small)
    kern, plain = env_step_paths_3d(device, step_envs, state_shape, (None, False), seed=8,
                                    dt_solver=BIG_DT_SOLVER)
    step = {"path": s3d.select_stage_path(torch.float32, *state_shape[::-1], device.type),
            "kernel_vs_plain": abs_diffs(ENV3_OUT, kern, plain)}
    errs["env_step"] = (max(step["kernel_vs_plain"].values()), ENV_STEP_3D_ATOL)
    ref, = env_step_paths_3d(device, step_envs, state_shape, (False,), seed=8,
                             dt_solver=BIG_DT_SOLVER, dtype=torch.float64)
    step["float64_plain_vs"] = {"kernel": abs_diffs(ENV3_OUT, ref, kern),
                                "plain_float32": abs_diffs(ENV3_OUT, ref, plain)}
    failed = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if failed:
        raise AssertionError(f"big-grid kernel parity failed (error, atol): {failed}")
    return {"phase": "kernel_parity_big", "num_envs": main_envs, "max_abs_err": max_err,
            "gated": {k: {"error": e, "atol": a} for k, (e, a) in errs.items()},
            "stage_rk_3d_xy_by_stage": by_stage, "correct_3d_by_field": k4,
            "stage_rk_3d_xy_few_envs_by_stage": by_stage_few,
            "stage0_float64_plain_vs": rounding,
            "stage_rk_3d_xy_small_grid_by_stage": by_stage_small,
            "env_step": step, "seconds": time.perf_counter() - start}


def timing_big(device, num_envs=1024, state_shape=BIG_SHAPE, plain_envs=1024) -> dict:
    """CUDA-event times at the big main path's shapes: K5 per stage, its
    share of its bound and its plain version (at ``plain_envs``), K4, one
    factored Poisson solve, and one env step split into K5, solves, K4 and
    the rest. Launches here are not the main path's."""
    begin = time.perf_counter()
    nz, ny, nx = state_shape
    solver, case = make_case_3d(device, num_envs, state_shape, seed=9, dt_solver=BIG_DT_SOLVER)
    if plain_envs == num_envs:
        p_case = case
    else:
        p_case = {k: v[:plain_envs].contiguous() for k, v in case.items()}
    g_prev = k3_run(solver, case, 0, None, True, k3d.stage_rk_3d_xy)[5]
    p_g_prev = tuple(g[:plain_envs].contiguous() for g in g_prev)
    out = {}
    for stage in range(3):
        gp, pgp = (g_prev, p_g_prev) if stage else (None, None)
        ms = _cuda_ms(lambda: k3_run(solver, case, stage, gp, True, k3d.stage_rk_3d_xy), 5)
        plain_ms = _cuda_ms(lambda: k3_run(solver, p_case, stage, pgp, False), 2)
        work = stage_rk_3d_work(num_envs, nx, ny, nz, stage)
        bound_ms, bound_by = bound(work)
        out[f"stage_rk_3d_xy.stage{stage}"] = {
            "ms": ms, "plain_ms": plain_ms, "plain_envs": plain_envs, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms, **work}
    del g_prev, p_g_prev
    work = correct_3d_work(num_envs, nx, ny, nz)
    bound_ms, bound_by = bound(work)
    out["correct_3d"] = {"ms": _cuda_ms(lambda: k4_run(solver, case, True), 5),
                         "plain_ms": _cuda_ms(lambda: k4_run(solver, case, False), 2),
                         "bound_ms": bound_ms, "bound_by": bound_by, **work}
    stages = [out[f"stage_rk_3d_xy.stage{m}"] for m in range(3)]
    mean = {k: sum(st[k] for st in stages) / 3 for k in ("ms", "plain_ms", "bound_ms")}
    out["stage_rk_3d_xy"] = {**mean, "bound_by": stages[1]["bound_by"]}
    rhs = case["q"]
    flops = poisson_3d_flops(num_envs, nx, ny, nz, factored=True)
    solve = {"ms": _cuda_ms(lambda: solver.solve(rhs), 5), "flops": flops,
             "bound_ms": 1e3 * flops / FP32_FLOPS}
    zeros = torch.zeros_like(case["u"])
    f = s3d.Fields3D(case["u"], case["v"], case["w"], case["b"], zeros, zeros)
    actions = torch.zeros((num_envs, 8, 8), dtype=rhs.dtype, device=rhs.device)
    step_ms = _cuda_ms(lambda: solver.env_step(f, actions), 2)
    n_sub = len(solver.params.substep_dts())
    split = {"env_step_ms": step_ms,
             "stage_rk_3d_xy_ms": n_sub * sum(st["ms"] for st in stages),
             "poisson_ms": 3 * n_sub * solve["ms"],
             "correct_3d_ms": out["correct_3d"]["ms"]}
    split["rest_ms"] = step_ms - sum(v for k, v in split.items() if k != "env_step_ms")
    return {"phase": "timing_big", "num_envs": num_envs, "path": solver.path, "kernels": out,
            "poisson_factored": solve, "env_step_split": split,
            "seconds": time.perf_counter() - begin}


# ---------------------------------------------------------------------------
# 3D: the per-field path (fused="field") on the training grid, K6 and K7
# ---------------------------------------------------------------------------


def k6_instance(state_shape) -> str:
    """The K6 instance its launcher runs on a grid (nz, ny, nx)."""
    nz, ny, nx = state_shape
    return "march" if field_tendency_on_march(nx, ny, nz) else "general"


def kernel_parity_field(device, main_envs=1024, step_envs=32, big_envs=128,
                        state_shape=(16, 32, 32), big_shape=BIG_SHAPE,
                        odd_shape=ODD_NX_SHAPE) -> dict:
    """K6 for each field and K7 against their plain versions at the field
    path's shapes (``main_envs``), at ``odd_shape`` (nx % 4 != 0, where auto
    takes the field path; ``main_envs``) and, forced, on the big grid
    (``big_envs``); K6 and its float32 plain version against a float64
    plain run at ``step_envs``; one env step of the field path against the
    all-plain path, and against the solver's own path (K3 on the card)
    from the same state, at ``step_envs`` and
    ``main_envs`` (``env_step_paths_3d``)."""
    start = time.perf_counter()
    device = torch.device(device)
    errs, by_field = {}, {}
    grids = (("", main_envs, state_shape, 11, 0.01), ("odd_", main_envs, odd_shape, 15, 0.01),
             ("big_", big_envs, big_shape, 12, BIG_DT_SOLVER))
    instances = {prefix + "grid": k6_instance(shape) for prefix, _, shape, _, _ in grids}
    for prefix, n_env, shape, seed, dt_solver in grids:
        solver, case = make_case_3d(device, n_env, shape, seed=seed, dt_solver=dt_solver)
        for field in "uvwb":
            got, want = k6_run(solver, case, field, True), k6_run(solver, case, field, False)
            by_field[f"{prefix}g{field}"] = abs_diffs(["g"], [got], [want])["g"]
            errs[f"{prefix}g{field}"] = (by_field[f"{prefix}g{field}"], K6_ATOL)
        errs[f"{prefix}div"] = (abs_diffs(["div"], [k7_run(solver, case, True)],
                                          [k7_run(solver, case, False)])["div"], K7_ATOL)
        del case
    # each field in float64 from the same inputs: both halves' float32 rounding
    solver, case = make_case_3d(device, step_envs, state_shape, seed=16)
    case64 = {k: v.double() for k, v in case.items()}
    float64 = {}
    for field in "uvwb":
        ref = [k6_run(solver, case64, field, False)]
        float64[f"g{field}"] = {
            "kernel": abs_diffs(["g"], ref, [k6_run(solver, case, field, True)])["g"],
            "plain_float32": abs_diffs(["g"], ref, [k6_run(solver, case, field, False)])["g"]}
    steps = {}
    for n_env in sorted({step_envs, main_envs}):
        kern, plain, stage_path = env_step_paths_3d(device, n_env, state_shape,
                                                    ("field", False, None), seed=13)
        steps[n_env] = {
            "stage_path": s3d.select_stage_path(torch.float32, *state_shape[::-1], device.type),
            "kernel_vs_plain": abs_diffs(ENV3_OUT, kern, plain),
            "field_vs_stage_path": abs_diffs(ENV3_OUT, kern, stage_path)}
        errs[f"env_step_{n_env}"] = (max(steps[n_env]["kernel_vs_plain"].values()),
                                     ENV_STEP_3D_ATOL)
        errs[f"field_vs_stage_path_{n_env}"] = (
            max(steps[n_env]["field_vs_stage_path"].values()), FIELD_VS_STAGE_ATOL)
    failed = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if failed:
        raise AssertionError(f"field-path kernel parity failed (error, atol): {failed}")
    max_err = {"field_tendency_3d": max(errs[f"g{f}"][0] for f in "uvwb"),
               "div_3d": errs["div"][0]}
    return {"phase": "kernel_parity_field", "num_envs": main_envs, "big_envs": big_envs,
            "k6_instances": instances, "max_abs_err": max_err,
            "gated": {k: {"error": e, "atol": a} for k, (e, a) in errs.items()},
            "field_tendency_3d_float64_plain_vs": float64,
            "env_step": {str(k): v for k, v in steps.items()},
            "seconds": time.perf_counter() - start}


def main_path_field(device, num_envs=1024, state_shape=(16, 32, 32), heater_duration=0.125,
                    steps=3, seed=0) -> dict:
    """The per-field path through the user's entry point:
    ``RBC3DVectorEnv(num_envs, fused="field")``, reset and ``steps`` env
    steps. The path is forced, so it runs in float32 on any device."""
    device = torch.device(device)
    env = RBC3DVectorEnv(num_envs, state_shape=state_shape, heater_duration=heater_duration,
                         fused="field", dtype=torch.float32, device=device)
    state, obs, ts, _, rec = drive_3d(env, steps, seed, FIELD_PATH_WRAPPERS)
    checks = check_3d(env, state, obs, ts)
    n_stages = steps * 3 * len(env.params.substep_dts())
    by_field = dict(k3d.field_tendency_3d.launches_by_field)
    expect_launches(device, {**rec["launches"], **by_field},
                    {"stage_rk_3d": 0, "stage_rk_3d_xy": 0, "correct_3d": n_stages,
                     "field_tendency_3d": 4 * n_stages, "div_3d": n_stages,
                     **dict.fromkeys(k3d.FIELD_INPUTS, n_stages)})
    return {"phase": "main_path_field", **rec, **checks,
            "field_tendency_3d_launches_by_field": by_field}


def timing_field(device, num_envs=1024, state_shape=(16, 32, 32)) -> dict:
    """CUDA-event times at the field path's shapes: K6 per field, K7, K4,
    their plain versions, bounds and shares of them, the dense solve, pHY',
    the RK update of one stage, and one field-path env step split into
    them (pHY' once a step, after the loop; K6 computes it inside).
    Launches here are not the main path's."""
    begin = time.perf_counter()
    nz, ny, nx = state_shape
    solver, case = make_case_3d(device, num_envs, state_shape, seed=14, fused="field")
    out = {}
    for field in "uvwb":
        work = field_tendency_3d_work(num_envs, nx, ny, nz, field)
        bound_ms, bound_by = bound(work)
        ms = _cuda_ms(lambda: k6_run(solver, case, field, True), 20)
        out[f"field_tendency_3d.{field}"] = {
            "ms": ms, "plain_ms": _cuda_ms(lambda: k6_run(solver, case, field, False), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            **work}
    # K6 per stage: one launch per field; its record is the mean launch
    fields = [out[f"field_tendency_3d.{f}"] for f in "uvwb"]
    out["field_tendency_3d"] = {
        **{k: sum(r[k] for r in fields) / 4 for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": fields[0]["bound_by"]}
    for name, run, work in (("div_3d", k7_run, div_3d_work(num_envs, nx, ny, nz)),
                            ("correct_3d", k4_run, correct_3d_work(num_envs, nx, ny, nz))):
        bound_ms, bound_by = bound(work)
        ms = _cuda_ms(lambda: run(solver, case, True), 20)
        out[name] = {"ms": ms, "plain_ms": _cuda_ms(lambda: run(solver, case, False), 3),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "share_of_bound": bound_ms / ms, **work}
    c = solver.coeffs
    g = [k6_run(solver, case, f, True) for f in "uvwb"]
    f4 = [case[n] for n in "uvwb"]
    dt = float(solver.params.substep_dts()[0])
    gamma, zeta = k3d.RK3_GAMMA[1], k3d.RK3_ZETA[1]
    parts = {
        "poisson_dense_ms": _cuda_ms(lambda: solver.solve(case["q"]), 10),
        "p_hy_ms": _cuda_ms(lambda: k3d.hydrostatic_pressure(case["b"], c.dz, c.min_b), 20),
        "rk_update_stage0_ms": _cuda_ms(
            lambda: [f + dt * gamma * gf for f, gf in zip(f4, g)], 20),
        "rk_update_stage12_ms": _cuda_ms(
            lambda: [f + dt * (gamma * gf + zeta * gp) for f, gf, gp in zip(f4, g, g)], 20)}
    zeros = torch.zeros_like(case["u"])
    f = s3d.Fields3D(case["u"], case["v"], case["w"], case["b"], zeros, zeros)
    actions = torch.zeros((num_envs, 8, 8), dtype=zeros.dtype, device=zeros.device)
    step_ms = _cuda_ms(lambda: solver.env_step(f, actions), 3)
    n_sub = len(solver.params.substep_dts())
    n_stages = 3 * n_sub
    split = {"env_step_ms": step_ms,
             "field_tendency_3d_ms": n_stages * sum(r["ms"] for r in fields),
             "div_3d_ms": n_stages * out["div_3d"]["ms"],
             "poisson_ms": n_stages * parts["poisson_dense_ms"],
             "correct_3d_ms": n_stages * out["correct_3d"]["ms"],
             "rk_update_ms": n_sub * (parts["rk_update_stage0_ms"]
                                      + 2 * parts["rk_update_stage12_ms"]),
             "p_hy_ms": parts["p_hy_ms"]}
    split["rest_ms"] = step_ms - sum(v for k, v in split.items() if k != "env_step_ms")
    return {"phase": "timing_field", "num_envs": num_envs, "path": solver.path,
            "k6_instance": k6_instance(state_shape), "kernels": out,
            "parts": parts, "env_step_split": split, "seconds": time.perf_counter() - begin}


# ---------------------------------------------------------------------------
# The 2D RL path: checkpoint banks, the trained policy, evaluation and PPO
# ---------------------------------------------------------------------------


def _timed(func, device, acc: list):
    """``func`` with its synchronised host seconds added to ``acc[0]``."""

    def run(*args, **kwargs):
        _sync(device)
        start = time.perf_counter()
        out = func(*args, **kwargs)
        _sync(device)
        acc[0] += time.perf_counter() - start
        return out

    return run


def bank_div_atol(data) -> float:
    """The max|div| a bank's rounding allows: ``BANK_DIV_ATOL`` for float64
    data, else (every value exactly a float32) two float32 ulps of the
    largest |u| over dx plus two of the largest |w| over dz."""
    if not all(np.array_equal(a, a.astype(np.float32)) for a in (data.u, data.w)):
        return BANK_DIV_ATOL
    dx, dz = 2 * np.pi / data.u.shape[1], 2.0 / data.u.shape[2]
    ulp = float(np.finfo(np.float32).eps)
    return 2 * ulp * (float(np.abs(data.u).max()) / dx + float(np.abs(data.w).max()) / dz)


def fixed_point_env(n_fixed: int, bank, dtype, device, **kwargs) -> RBC2DVectorEnv:
    """The first ``n_fixed`` episodes of ``bank`` in order, never reset."""
    return RBC2DVectorEnv(n_fixed, checkpoint=str(bank), bank_sampling="sequential",
                          auto_reset=False, dtype=dtype, device=device, **kwargs)


def fixed_point(env, steps: int) -> tuple:
    """``steps`` zero-action env steps of ``env`` from its reset -> (the
    band [min, max] of Nu of the states, its largest distance from
    ``FIXED_POINT_NU``)."""
    zero = torch.zeros((env.num_envs, env.params.n_heaters), dtype=env.dtype, device=env.device)
    state, _ = env.reset(seed=0)
    nus = []
    for _ in range(steps):
        state, ts = env.step(state, zero)
        nus.append(ts.nusselt_state)
    nus = torch.stack(nus)
    return [float(nus.min()), float(nus.max())], float((nus - FIXED_POINT_NU).abs().max())


def bank_oracles(device, bank=ASSETS / "ckpt_ra10000_train.npz", episodes=BANK_EPISODES,
                 n_fixed=4, steps=20) -> dict:
    """PARITY.md 1-2 on the port: max|div| of every bank episode under the
    port's operator in float64, and the Ra=1e4 fixed point (zero action,
    dt 0.03, ``steps`` env steps of 50 substeps from the first ``n_fixed``
    episodes): float64 on the plain path, float32 on the main path (K1 on
    the card, its launches counted)."""
    begin = time.perf_counter()
    device = torch.device(device)
    data = load_bank_2d(bank)
    if data.num_episodes != episodes:
        raise AssertionError(f"{bank} holds {data.num_episodes} episodes, not {episodes}")
    grid = Grid2D(nx=data.b.shape[1], nz=data.b.shape[2], lx=2 * np.pi, lz=2.0)
    f = Fields2D(*(torch.as_tensor(getattr(data, n), dtype=torch.float64, device=device)
                   for n in ("u", "w", "b")), None, None)
    div, div_atol = max_divergence(f, grid), bank_div_atol(data)
    if not div < div_atol:
        raise AssertionError(f"bank max |div| {div} >= {div_atol}")

    out = {"phase": "bank_oracles", "bank": str(bank.relative_to(REPO)),
           "episodes": data.num_episodes, "max_abs_div": div, "div_atol": div_atol}
    for dtype, atol in ((torch.float64, FIXED_POINT_ATOL[torch.float64]),
                        (torch.float32, FIXED_POINT_ATOL[torch.float32])):
        env = fixed_point_env(n_fixed, bank, dtype, device)
        reset_counters()
        band, err = fixed_point(env, steps)
        launches = k2d.env_step_2d.launches
        name = str(dtype).replace("torch.", "")
        if not err <= atol:
            raise AssertionError(f"{name} fixed point: Nu in {band}, off {FIXED_POINT_NU} "
                                 f"by {err} > {atol}")
        if device.type == "cuda" and dtype == torch.float32 and launches != steps:
            raise AssertionError(f"float32 fixed point launched K1 {launches} times, not {steps}")
        out[f"fixed_point_{name}"] = {"path": env.solver.path, "nusselt_band": band,
                                      "max_abs_err": err, "atol": atol, "env_steps": steps,
                                      "env_step_2d_launches": launches}
    out["seconds"] = time.perf_counter() - begin
    return out


def _policy_vs_float64(make_net, params, obs: torch.Tensor) -> dict:
    """A trained net on ``obs``'s device in float32 against the same net on
    the CPU in float64: max errors of mean and value (gated at
    ``POLICY_ATOL + POLICY_RTOL * |x|``) and the float64 values' range."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the port's float32 products must run in float32")
    outs = {}
    for name, dev, dtype, x in (("card", obs.device, torch.float32, obs.float()),
                                ("cpu_float64", torch.device("cpu"), torch.float64,
                                 obs.cpu().double())):
        net = load_params(params, make_net()).to(device=dev, dtype=dtype).eval()
        with torch.no_grad():
            mean, _, value = net(x)
        outs[name] = (mean.cpu().double(), value.cpu().double())
    errs = {}
    for i, name in enumerate(("mean", "value")):
        got, want = outs["card"][i], outs["cpu_float64"][i]
        errs[name] = float((got - want).abs().max())
        excess = float(((got - want).abs() - POLICY_ATOL - POLICY_RTOL * want.abs()).max())
        if excess > 0.0:
            raise AssertionError(f"policy {name} off its float64 run by {errs[name]} "
                                 f"(atol {POLICY_ATOL} + rtol {POLICY_RTOL})")
    return {"n_obs": int(obs.shape[0]), "max_abs_err": errs, "atol": POLICY_ATOL,
            "rtol": POLICY_RTOL,
            "value_range": [float(outs["cpu_float64"][1].min()),
                            float(outs["cpu_float64"][1].max())],
            "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}


def policy_parity(device, params=ASSETS / "sarl2d_ra10000_best_model.npz",
                  bank=ASSETS / "ckpt_ra10000_train.npz", n_obs=256) -> dict:
    """The trained 2D policy on ``device`` in float32 against the same net
    on the CPU in float64, on ``n_obs`` normalised observations of bank
    states (kicked by 1e-3 so that no two are equal)."""
    config = run_sarl_2d.DEFAULT_CONFIG
    env = RBC2DVectorEnv(n_obs, checkpoint=str(bank), ic_noise=1e-3, device=torch.device(device))
    _, obs = env.reset(seed=7)
    obs = fn.normalize_observation(obs, fn.make_obs_norm_2d(config["rbc_heater_limit"]))
    return {"phase": "policy_parity", **_policy_vs_float64(
        lambda: RBCActorCritic2D(log_std_init=config["rl_log_std_init"]), params, obs)}


def policy_parity_3d(device, params=ASSETS / "sarl_ra2500_best_model.npz",
                     bank=ASSETS / "3D_ckpt_ra2500_test.npz", n_obs=256) -> dict:
    """``policy_parity`` for the trained 3D policy (sarl_ra2500) on ``n_obs``
    normalised observations of the 3D test bank's states, kicked by 1e-3."""
    config = {**run_sarl.DEFAULT_CONFIG, **SARL3D_RA2500}
    env = RBC3DVectorEnv(n_obs, checkpoint=str(bank), ic_noise=1e-3, device=torch.device(device))
    _, obs = env.reset(seed=7)
    norm = fn.make_obs_norm_3d(ra=config["rbc_rayleigh_number"],
                               heater_limit=config["rbc_heater_limit"])
    obs = fn.normalize_observation(obs, norm, channel_axis=-4)
    return {"phase": "policy_parity_3d", **_policy_vs_float64(
        lambda: RBCActorCritic(log_std_init=config["rl_log_std_init"]), params, obs)}


def _trained_vs_zero(config, bank, params, episodes, steps, ic_noise, seed, min_suppression,
                     device, counted) -> dict:
    """The JAX package's baseline evaluation through the port's
    ``eval_baselines``: the bank sequentially, ``episodes`` envs, ``steps``
    env steps, the trained policy and zero action from the same initial
    states; second-half Nu and the suppression against zero, its CI
    clustered by bank state (the script's) and iid over episodes, the
    largest spread of zero-action Nu among episodes sharing a state, and
    the launches of the wrappers ``counted`` over both rollouts."""
    env, policies, nusselt_of, _ = eval_baselines.make_eval(config, str(bank), episodes,
                                                            ic_noise, str(params), device)
    _sync(device)
    start = time.perf_counter()
    state0, obs0 = env.reset(seed=seed)  # a gather from the bank on the device, and the kick
    _sync(device)
    reset_s = time.perf_counter() - start
    reset_counters()
    per_episode, out, seconds = {}, {}, 0.0
    for name in ("trained", "zero"):
        _sync(device)
        start = time.perf_counter()
        nus = eval_baselines.rollout(env, state0, obs0, policies[name], steps, nusselt_of,
                                     seed + 1)
        seconds += time.perf_counter() - start
        if not np.isfinite(nus).all():
            raise AssertionError(f"{name}: Nu is not finite")
        per_episode[name] = nus[nus.shape[0] // 2:].mean(axis=0)
        out[name] = {"nusselt_mean": float(nus.mean()),
                     "nusselt_mean_second_half": float(per_episode[name].mean())}
    launches = {name: WRAPPERS[name].launches for name in counted}
    clusters = np.arange(episodes) % env._bank.size
    supp = eval_baselines.suppression(per_episode, "trained", clusters)
    supp_iid = eval_baselines.suppression(per_episode, "trained", None)
    zero_ep = per_episode["zero"]
    spread = max(float(np.ptp(zero_ep[clusters == c])) for c in np.unique(clusters))
    if min_suppression is not None and not supp["pct"] >= min_suppression:
        raise AssertionError(f"trained policy suppresses Nu by {supp['pct']} % of zero action, "
                             f"under {min_suppression} %")
    return {"episodes": episodes, "steps": steps, "bank": str(bank.relative_to(REPO)),
            "path": env.solver.path, **out,
            "suppression_vs_zero_pct": supp["pct"], "suppression_vs_zero_ci95": supp["ci95"],
            "suppression_vs_zero_ci95_iid": supp_iid["ci95"],
            "zero_second_half_std_across_episodes": float(zero_ep.std()),
            "zero_second_half_max_spread_within_state": spread,
            "min_suppression_pct": min_suppression, "reset_s": reset_s, "seconds": seconds,
            "env_steps_per_s": 2 * steps * episodes / seconds, "launches": launches}


def rl_eval_2d(device, episodes=64, steps=200, bank=ASSETS / "ckpt_ra10000_test.npz",
               params=ASSETS / "sarl2d_ra10000_best_model.npz", ic_noise=1e-3, seed=123,
               min_suppression=MIN_SUPPRESSION_PCT) -> dict:
    """The JAX record results/sarl2d_ra10000/baseline_eval.json's protocol
    on the port (``_trained_vs_zero``); K1 once an env step."""
    device = torch.device(device)
    config = {**run_sarl_2d.DEFAULT_CONFIG, **SARL2D_RA10000}
    out = _trained_vs_zero(config, bank, params, episodes, steps, ic_noise, seed,
                           min_suppression, device, ("env_step_2d",))
    expect_launches(device, out["launches"], {"env_step_2d": 2 * steps})
    return {"phase": "rl_eval_2d", **out}


def rl_eval_3d(device, episodes=64, steps=80, bank=ASSETS / "3D_ckpt_ra2500_test.npz",
               params=ASSETS / "sarl_ra2500_best_model.npz", ic_noise=1e-3, seed=123,
               min_suppression=MIN_SUPPRESSION_3D_PCT, config_overrides=None) -> dict:
    """The JAX record results/sarl_ra2500/baseline_eval.json's protocol on
    the port (``_trained_vs_zero``) at the sarl_ra2500 config: K3 three
    times a substep, K4 once an env step; the JAX record's numbers beside."""
    device = torch.device(device)
    config = {**run_sarl.DEFAULT_CONFIG, **SARL3D_RA2500, **(config_overrides or {})}
    out = _trained_vs_zero(config, bank, params, episodes, steps, ic_noise, seed,
                           min_suppression, device, ("stage_rk_3d", "correct_3d"))
    n_sub = len(s3d.SimParams3D(heater_duration=config["rbc_heater_duration"],
                                dt_solver=config["rbc_dt_solver"]).substep_dts())
    expect_launches(device, out["launches"],
                    {"stage_rk_3d": 2 * steps * n_sub * 3, "correct_3d": 2 * steps})
    return {"phase": "rl_eval_3d", **out, "substeps_per_step": n_sub, "jax_record": JAX_EVAL_3D}


def _train_and_restore(make_trainer, config, device, iterations, counted) -> dict:
    """``iterations`` PPO iterations of ``make_trainer(config, device)``'s
    trainer through ``CheckpointCallback`` into a temporary directory, the
    launches of the wrappers ``counted`` over them, and the full state
    restored into a fresh trainer held equal to the live one. The run
    outlasts an episode, so every env truncates, takes V(final_obs) and
    restarts from a random bank state inside ``step``."""
    trainer, _, _ = make_trainer(config, device)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    env_s, rollout_s, update_s = [0.0], [0.0], [0.0]
    trainer.env.step = _timed(trainer.env.step, device, env_s)
    timed_rollout = _timed(trainer._rollout, device, rollout_s)
    boundary_values = []

    def rollout():
        traj, last_value = timed_rollout()
        boundary_values.append(traj.boundary_value[traj.truncated])
        return traj, last_value

    trainer._rollout = rollout
    trainer._update = _timed(trainer._update, device, update_s)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointCallback(tmp, save_freq=1)
        callbacks = (NusseltCallback(), lambda m, t: records.append(dict(m)), ckpt)
        ckpt.sibling_callbacks = callbacks
        reset_counters()
        _sync(device)
        start = time.perf_counter()
        trainer.learn(iterations, callbacks=callbacks)
        _sync(device)
        seconds = time.perf_counter() - start
        launches = {name: WRAPPERS[name].launches for name in counted}
        fresh, _, _ = make_trainer(config, device)
        nusselt = NusseltCallback()
        resumed_at = restore_training_state(ckpt.full_path, fresh, callbacks=(nusselt,))
    boundary = torch.cat(boundary_values)
    n_env = config["rl_n_envs"]
    truncations = n_env * (iterations * config["rl_n_steps"] // trainer.env.episode_steps)
    if truncations == 0 or boundary.numel() != truncations:
        raise AssertionError(f"{boundary.numel()} truncations, not {truncations} (and not 0)")
    if not (torch.isfinite(boundary).all() and (boundary != 0).all()):
        raise AssertionError("V(final_obs) at a truncation is not finite and nonzero")
    check_records(records)
    if all(torch.equal(a, b) for a, b in zip(before, trainer.model.parameters())):
        raise AssertionError("training left the params unchanged")
    live, restored = trainer_tensors(trainer), trainer_tensors(fresh)
    differ = [k for k in live if not torch.equal(live[k], restored[k])]
    if (differ or resumed_at != iterations or fresh.optimizer.count != trainer.optimizer.count
            or nusselt.history != callbacks[0].history):
        raise AssertionError(f"restored state differs: {differ}, resumes at {resumed_at}")
    split = {"env_steps": env_s[0] / iterations,
             "policy_forward": (rollout_s[0] - env_s[0]) / iterations,
             "update": update_s[0] / iterations,
             "gae_and_rest": (seconds - rollout_s[0] - update_s[0]) / iterations}
    adam_count = trainer.optimizer.count
    # the update's kernels by device time and its idle share, from one more
    # rollout (outside the counted run)
    update_device = "not measured (no card)"
    if device.type == "cuda":
        traj, last_value = PPO._rollout(trainer)
        advantages, returns = trainer._gae(traj, last_value)
        update_device = device_profile(lambda: PPO._update(trainer, traj, advantages, returns))
    return {"num_envs": n_env, "n_steps": config["rl_n_steps"], "iterations": iterations,
            "path": trainer.env.solver.path, "s_per_iteration": seconds / iterations,
            "split_s_per_iteration": split, "update_device": update_device,
            "env_steps_per_s": n_env * config["rl_n_steps"] * iterations / seconds,
            "n_updates": [r["n_updates"] for r in records],
            "approx_kl": [r["approx_kl"] for r in records],
            "rollout_nusselt_mean": [r["rollout/nusselt_mean"] for r in records],
            "truncations": truncations,
            "boundary_value_range": [float(boundary.min()), float(boundary.max())],
            "adam_count": adam_count, "restored_tensors": len(live), "launches": launches}


def check_records(records: list) -> None:
    """Every metric of every iteration finite, and an update applied."""
    for rec in records:
        bad = [k for k, v in rec.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"iteration {rec['iteration']}: {bad} not finite")
        if not rec["n_updates"] >= 1:
            raise AssertionError(f"iteration {rec['iteration']} applied no update")


def rl_train_2d(device, iterations=4, config_overrides=None) -> dict:
    """``PPO`` at the sarl2d_ra10000 configuration through the port's
    ``run_sarl_2d.make_trainer`` on the train bank (``_train_and_restore``);
    K1 once an env step."""
    device = torch.device(device)
    config = {**run_sarl_2d.DEFAULT_CONFIG, **SARL2D_RA10000,
              "rbc_checkpoint": str(ASSETS / "ckpt_ra10000_train.npz"),
              **(config_overrides or {})}
    out = _train_and_restore(run_sarl_2d.make_trainer, config, device, iterations,
                             ("env_step_2d",))
    expect_launches(device, out["launches"],
                    {"env_step_2d": iterations * config["rl_n_steps"]})
    return {"phase": "rl_train_2d", **out}


def rl_train_3d(device, iterations=2, config_overrides=None) -> dict:
    """``PPO`` at the sarl3d_ra2500 configuration through the port's
    ``run_sarl.make_trainer`` on the 3D train bank (``_train_and_restore``):
    K3 three times a substep, K4 once an env step."""
    device = torch.device(device)
    config = {**run_sarl.DEFAULT_CONFIG, **SARL3D_RA2500,
              "rbc_checkpoint": str(ASSETS / "3D_ckpt_ra2500_train.npz"),
              **(config_overrides or {})}
    out = _train_and_restore(run_sarl.make_trainer, config, device, iterations,
                             ("stage_rk_3d", "correct_3d"))
    steps = iterations * config["rl_n_steps"]
    n_sub = len(s3d.SimParams3D(heater_duration=config["rbc_heater_duration"],
                                dt_solver=config["rbc_dt_solver"]).substep_dts())
    expect_launches(device, out["launches"],
                    {"stage_rk_3d": steps * n_sub * 3, "correct_3d": steps})
    return {"phase": "rl_train_3d", **out, "substeps_per_step": n_sub}


def rl_generalist_2d(device, ras=(10_000, 30_000), iterations=2, num_envs=256,
                     config_overrides=None) -> dict:
    """The generalist twin at ``ras`` on the committed train banks, one
    iteration a rung: the records' rungs in round-robin order, one model and
    one optimizer across the trainers, its count at the applied updates,
    finite metrics, K1 once an env step; the per-rung result dirs."""
    device = torch.device(device)
    args = gen.parse_args(["--ras", *map(str, ras), "--iterations", str(iterations),
                           "--num_envs", str(num_envs)])
    cfg = {**gen.make_config(args), **(config_overrides or {})}
    pattern = str(ASSETS / "ckpt_ra{ra}_train.npz")
    trainers = gen.make_trainers(cfg, device, pattern)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        _sync(device)
        start = time.perf_counter()
        records = gen.train(trainers, cfg, os.path.join(tmp, "metrics.jsonl"))
        _sync(device)
        seconds = time.perf_counter() - start
        launches = {"env_step_2d": k2d.env_step_2d.launches}
        gen.write_rungs(trainers[0].model, cfg, tmp, pattern)
        rungs = sorted(p.parents[1].name for p in Path(tmp).glob("ra*/models/best_model.npz"))
    expect_launches(device, launches, {"env_step_2d": iterations * cfg["rl_n_steps"]})
    rec_ras = [r["ra"] for r in records]
    if rec_ras != [ras[i % len(ras)] for i in range(iterations)]:
        raise AssertionError(f"records' Ra {rec_ras}")
    check_records(records)
    shared = (all(t.model is trainers[0].model for t in trainers)
              and all(t.optimizer is trainers[0].optimizer for t in trainers))
    applied = sum(r["n_updates"] for r in records)
    if not shared or trainers[0].optimizer.count != applied:
        raise AssertionError(f"shared {shared}, Adam count {trainers[0].optimizer.count} "
                             f"for {applied} applied updates")
    return {"phase": "rl_generalist_2d", "ras": rec_ras, "num_envs": cfg["rl_n_envs"],
            "n_steps": cfg["rl_n_steps"], "iterations": iterations,
            "s_per_iteration": seconds / iterations, "n_updates": [r["n_updates"] for r in records],
            "adam_count": trainers[0].optimizer.count, "shared_model_and_optimizer": shared,
            "rollout_nusselt_mean": [r["rollout/nusselt_mean"] for r in records],
            "rung_dirs": rungs, "launches": launches}


def _bank_checks(bank, div: float, div_atol: float) -> dict:
    """A generated bank: finite, its episodes pairwise distinct, max|div u|
    under ``div_atol``."""
    names = [n for n in ("b", "u", "v", "w") if hasattr(bank, n)]
    if not all(np.isfinite(getattr(bank, n)).all() for n in names):
        raise AssertionError("bank is not finite")
    n = bank.num_episodes
    gaps = [float(np.abs(bank.b[i] - bank.b[j]).max()) for i in range(n) for j in range(i + 1, n)]
    if min(gaps, default=1.0) == 0.0:
        raise AssertionError("two episodes of the bank are equal")
    if not div < div_atol:
        raise AssertionError(f"bank max |div| {div} >= {div_atol}")
    return {"episodes": n, "min_episode_gap_b": min(gaps, default=None), "max_abs_div": div,
            "div_atol": div_atol}


def _zero_action_nu(env, steps: int) -> float:
    """Mean Nu over the envs after ``steps`` zero-action env steps."""
    three_d = isinstance(env, RBC3DVectorEnv)
    zero = torch.zeros((env.num_envs,) + (env.params.n_heaters,) * (2 if three_d else 1),
                       dtype=env.dtype, device=env.device)
    state, _ = env.reset(seed=0)
    for _ in range(steps):
        state, ts = env.step(state, zero)
    return float((ts.nusselt if three_d else ts.nusselt_state).mean())


def burnin(device, n_episodes=20, seed=42, duration_2d=600.0, duration_3d=200.0,
           nu_steps=5, nu_heater_duration_3d=run_sarl.DEFAULT_CONFIG["rbc_heater_duration"]
           ) -> dict:
    """Both bank generators (``sim.burnin``) on ``device`` at the
    reference's durations: 2D at Ra=1e4 (windows of 10 substeps, K1 once a
    window), 3D at Ra=2500 (windows of 13 substeps: K3 three times a
    substep, K4 once a window). Each bank finite, its episodes pairwise
    distinct, max|div u| under the float32 gate, written as ``.npz``, read
    by its vector env and stepped ``nu_steps`` times at zero action beside
    the committed bank of the same split (the 3D env at the sarl_ra2500
    config's 38-substep step)."""
    device = torch.device(device)
    out = {"phase": "burnin", "n_episodes": n_episodes, "seed": seed}
    with tempfile.TemporaryDirectory() as tmp:
        for dim in ("2d", "3d"):
            three_d = dim == "3d"
            reset_counters()
            _sync(device)
            start = time.perf_counter()
            if three_d:
                bank = bank_gen.generate_bank_3d(2500, n_episodes, seed, duration=duration_3d,
                                                 device=device)
            else:
                bank = bank_gen.generate_bank_2d(1e4, n_episodes, seed, duration=duration_2d,
                                                 device=device)
            _sync(device)
            seconds = time.perf_counter() - start
            # the generators' default windows: 0.3 time units of 10 substeps
            # in 2D, 0.125 free-fall units of 13 in 3D
            if three_d:
                windows = int(round(duration_3d / 0.125))
                n_sub = len(s3d.SimParams3D(heater_duration=0.125).substep_dts())
                counted = {"stage_rk_3d": windows * n_sub * 3, "correct_3d": windows}
                grid = Grid3D(nx=32, ny=32, nz=16, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
                fields = s3d.Fields3D(*(torch.as_tensor(getattr(bank, n), dtype=torch.float64)
                                        for n in ("u", "v", "w", "b")), None, None)
                div, div_atol = (s3d.max_divergence_3d(fields, grid),
                                 s3d.DIVERGENCE_ATOL[torch.float32])
            else:
                windows = int(round(duration_2d / 0.3))
                counted = {"env_step_2d": windows}
                grid = Grid2D(nx=96, nz=64, lx=2 * np.pi, lz=2.0)
                fields = Fields2D(*(torch.as_tensor(getattr(bank, n), dtype=torch.float64)
                                    for n in ("u", "w", "b")), None, None)
                div, div_atol = max_divergence(fields, grid), DIVERGENCE_ATOL[torch.float32]
            launches = {name: WRAPPERS[name].launches for name in counted}
            expect_launches(device, launches, counted)
            checks = _bank_checks(bank, div, div_atol)
            path = Path(tmp) / ("3D_ckpt_ra2500.npz" if three_d else "ckpt_ra10000.npz")
            (save_bank_3d if three_d else save_bank_2d)(str(path), bank)
            committed = ASSETS / ("3D_ckpt_ra2500_train.npz" if three_d
                                  else "ckpt_ra10000_train.npz")
            nus = {}
            for name, src in (("generated", path), ("committed", committed)):
                if three_d:
                    env = RBC3DVectorEnv(n_episodes, checkpoint=str(src),
                                         heater_duration=nu_heater_duration_3d,
                                         bank_sampling="sequential", auto_reset=False,
                                         device=device)
                else:
                    env = RBC2DVectorEnv(n_episodes, checkpoint=str(src),
                                         bank_sampling="sequential", auto_reset=False,
                                         device=device)
                nus[name] = _zero_action_nu(env, nu_steps)
            if not all(np.isfinite(v) for v in nus.values()):
                raise AssertionError(f"{dim}: Nu after {nu_steps} steps {nus}")
            out[dim] = {"windows": windows, "seconds": seconds, "launches": launches, **checks,
                        f"zero_action_nu_after_{nu_steps}_steps": nus,
                        "committed_reference_nu": 1.957 if three_d else 4.0}
    out["durations"] = {"2d": duration_2d, "3d": duration_3d}
    return out


# ---------------------------------------------------------------------------
# Flow statistics, the control probes and the profiling hooks
# ---------------------------------------------------------------------------


def _near_jax(nu: float, jax_point: tuple, rtol: float) -> tuple:
    """(holds, tolerance): ``nu`` within the larger of ``rtol`` of the JAX
    mean and ``FLOWSTATS_STDS`` of its standard deviations."""
    mean, std = jax_point
    tol = max(rtol * mean, FLOWSTATS_STDS * std)
    return abs(nu - mean) <= tol, tol


def _finite_record(rec: dict, keys) -> None:
    for k in keys:
        if not np.isfinite(rec[k]).all():
            raise AssertionError(f"Ra={rec['ra']}: {k} is not finite")


def flowstats_2d(device, ras=tuple(fs2d.RA_SWEEP), steps=120, tail=60, num_envs=4, seed=0,
                 check_jax=True) -> dict:
    """The 2D flow-statistics twin over the bank ladder at the JAX protocol
    (``fs2d.perform_experiment`` from the train banks in ``assets/``, K1
    once an env step): every point from its bank and finite; with
    ``check_jax`` the Ra=1e4 point at its bank states' fixed points and
    every other within max(2 %, 4 std) of the JAX record; each point
    beside the JAX one and its seconds.

    The Ra=1e4 train bank holds two steady rolls: 16 states at Nu 4.000
    and 4 (episodes 5, 6, 7 and 17) at Nu 3.1806, in both packages. Each
    run draws 4 states at random, so its mean is a mix of the two: the
    JAX run drew four at Nu 4 (3.9997), this one draws episodes 1, 17, 18
    and 9 (seed 0). The gate is the float32 K1 gate of ``bank_oracles``,
    0.02, on the drift from the drawn states' own fixed points: the tail's
    mean Nu against the first step's, which for converged states is the
    mean of their fixed points."""
    device = torch.device(device)
    reset_counters()
    points, seconds, failed = {}, {}, {}
    for ra in ras:
        _sync(device)
        start = time.perf_counter()
        rec = fs2d.perform_experiment(ra, steps, num_envs, seed, None, device)
        _sync(device)
        seconds[str(ra)] = time.perf_counter() - start
        _finite_record(rec, ("nusselt", "max_u", "max_w"))
        if not rec["from_bank"]:
            raise AssertionError(f"Ra={ra}: no bank in assets/, the run took random ICs")
        pt = fs2d.point(rec, tail)
        jax_mean, jax_std = JAX_FLOWSTATS_2D[str(ra)]
        if ra == 10_000:
            tol = FIXED_POINT_ATOL[torch.float32]
            pt["fixed_point_first_step"] = rec["nusselt"][0]
            holds = abs(pt["nu_mean"] - rec["nusselt"][0]) <= tol
        else:
            holds, tol = _near_jax(pt["nu_mean"], (jax_mean, jax_std), FLOWSTATS_RTOL["2d"])
        if check_jax and not holds:
            failed[str(ra)] = (pt["nu_mean"], jax_mean, tol)
        points[str(ra)] = {**pt, "jax_nu_mean": jax_mean, "jax_nu_std": jax_std, "tol": tol}
    launches = {"env_step_2d": k2d.env_step_2d.launches}
    expect_launches(device, launches, {"env_step_2d": len(ras) * steps})
    if failed:
        raise AssertionError(f"2D flow statistics off the JAX record (port, JAX, tol): {failed}")
    return {"phase": "flowstats_2d", "protocol": fs2d.protocol(steps, tail, num_envs),
            "points": points, "seconds_per_ra": seconds, "launches": launches}


def flowstats_3d(device, ras=(500, 2000), steps=300, tail=100, num_envs=1,
                 state_shape=BIG_SHAPE, dt_solver=BIG_DT_SOLVER, heater_duration=0.25, seed=0,
                 check_jax=True) -> dict:
    """The 3D flow-statistics twin at the JAX protocol (32x64x64, 50
    substeps a step, one env; ``fs3d.run_stats``), K5 at one env: the
    solver's path K5's, the first env step of the kernel path within 5e-6
    of the all-plain path from the same reset, K5 three times a substep and
    K4 once a step, Nu and the maxima finite, max|div u| under the float32
    gate at the end, and with ``check_jax`` the Nu mean of the last
    ``tail`` steps within max(3 %, 4 std) of the JAX record; ms an env step."""
    device = torch.device(device)
    out = {"phase": "flowstats_3d", "num_envs": num_envs, "steps": steps, "points": {}}
    failed = {}
    for ra in ras:
        env = fs3d.make_env(ra, state_shape, dt_solver, heater_duration, num_envs, device,
                            working_dtype(device))
        want_path = "stage_xy" if device.type == "cuda" else "plain"
        if env.solver.path != want_path:
            raise AssertionError(f"the sweep's env takes path {env.solver.path}, not {want_path}")
        state, _ = env.reset(seed=seed)
        f = state.fields
        zero = torch.zeros((num_envs,) + (env.params.n_heaters,) * 2, dtype=env.dtype,
                           device=device)
        case = {"u": f.u, "v": f.v, "w": f.w, "b": f.b,
                "bottom": env.solver.heater_profile(zero).contiguous()}
        step_err = abs_diffs(ENV3_OUT, env_step_3d_run(env.solver, case, True),
                             env_step_3d_run(env.solver, case, False))
        if not max(step_err.values()) <= ENV_STEP_3D_ATOL:
            raise AssertionError(f"Ra={ra}: first env step off the plain path: {step_err}")
        n_sub = len(env.params.substep_dts())
        reset_counters()
        _sync(device)
        start = time.perf_counter()
        state, stats = fs3d.run_stats(env, state, steps)
        _sync(device)
        seconds = time.perf_counter() - start
        launches = {name: WRAPPERS[name].launches
                    for name in ("stage_rk_3d", "stage_rk_3d_xy", "correct_3d")}
        expect_launches(device, launches, {"stage_rk_3d": 0, "stage_rk_3d_xy": 3 * n_sub * steps,
                                           "correct_3d": steps})
        rec = {"ra": ra, **stats}
        _finite_record(rec, ("nusselt", "max_u", "max_v", "max_w"))
        div = s3d.max_divergence_3d(state.fields, env.grid)
        if not div < s3d.DIVERGENCE_ATOL[env.dtype]:
            raise AssertionError(f"Ra={ra}: max |div| {div} at the end")
        nu_mean = float(np.mean(stats["nusselt"][-tail:]))
        jax_point = JAX_FLOWSTATS_3D.get(str(ra))
        holds, tol = (True, None) if jax_point is None else _near_jax(
            nu_mean, jax_point, FLOWSTATS_RTOL["3d"])
        if check_jax and not holds:
            failed[str(ra)] = (nu_mean, jax_point[0], tol)
        out["points"][str(ra)] = {
            "path": env.solver.path, "substeps_per_step": n_sub,
            "first_step_vs_plain": step_err, "nu_mean": nu_mean,
            "nu_std": float(np.std(stats["nusselt"][-tail:])),
            "max_w": float(max(stats["max_w"])), "jax": jax_point, "tol": tol,
            "max_abs_div": div, "seconds": seconds, "ms_per_env_step": 1e3 * seconds / steps,
            "launches": launches}
    if failed:
        raise AssertionError(f"3D flow statistics off the JAX record (port, JAX, tol): {failed}")
    return out


def _probe_checks(name, zero, raised: dict, jax_zero, dim, check_jax, failed) -> dict:
    """The relative rise of each controlled Nu over zero action, and the
    probe gates (zero action near JAX's, every rise at least the floor)."""
    rises = {k: (nu - zero) / zero for k, nu in raised.items()}
    if check_jax:
        if not abs(zero - jax_zero) <= PROBE_ZERO_RTOL[dim] * jax_zero:
            failed[f"{name} zero"] = (zero, jax_zero)
        low = {k: r for k, r in rises.items() if not r >= PROBE_MIN_RISE[dim]}
        if low:
            failed[f"{name} rise"] = low
    return rises


def probe_2d(device, ra=1e6, episodes=32, n_steps=100, rows=probe_control2d.ROWS,
             gains=(1.0, 30.0), seed=7, bank=ASSETS / "ckpt_ra1000000_test.npz",
             check_jax=True) -> dict:
    """The 2D probe twin (``probe_control2d.probe``) at Ra=1e6 on the test
    bank: zero action, then the law at each row and gain (K1 once an env
    step); zero-action Nu within 5 % of the JAX log's, row 1 at the
    largest gain raising Nu by at least 10 %."""
    device = torch.device(device)
    env = probe_control2d.make_env(episodes, ra, str(bank), device)
    state0, obs0 = env.reset(seed=seed)
    lines = []
    reset_counters()
    _sync(device)
    start = time.perf_counter()
    nus = probe_control2d.probe(env, state0, obs0, n_steps,
                                [(r, g) for r in rows for g in gains], log=lines.append)
    seconds = time.perf_counter() - start
    launches = {"env_step_2d": k2d.env_step_2d.launches}
    expect_launches(device, launches, {"env_step_2d": (1 + len(rows) * len(gains)) * n_steps})
    if not all(np.isfinite(v) for v in nus.values()):
        raise AssertionError(f"probe Nu not finite: {nus}")
    failed = {}
    rises = _probe_checks("2d", nus["zero"], {"row1_gain30": nus[(1, max(gains))]},
                          JAX_PROBE_2D["zero"], "2d", check_jax, failed)
    if failed:
        raise AssertionError(f"2D probe off its gates: {failed}")
    return {"phase": "probe_2d", "ra": ra, "episodes": episodes, "n_steps": n_steps,
            "bank": str(Path(bank).relative_to(REPO)), "lines": lines, "rises": rises,
            "jax": JAX_PROBE_2D, "seconds": seconds, "launches": launches}


def probe_3d(device, ra=500, episodes=32, n_steps=80, heater_duration=0.375, row=1,
             gains=(3.0, -3.0), seed=7, bank=ASSETS / "3D_ckpt_ra500_test.npz",
             check_jax=True) -> dict:
    """The 3D probe twin (``probe_control3d.probe``) at Ra=500 on the test
    bank, 38 substeps a step: zero action, then law T at ``row`` with each
    gain (K3 three times a substep, K4 once a step); zero-action Nu within
    2 % of the JAX log's, both signs raising Nu by at least 15 %."""
    device = torch.device(device)
    env = probe_control3d.make_env(episodes, ra, heater_duration, str(bank), device=device)
    state0, obs0 = env.reset(seed=seed)
    lines = []
    reset_counters()
    _sync(device)
    start = time.perf_counter()
    header = f"Ra={ra:g} duration={heater_duration} burnin=0"
    nus = probe_control3d.probe(env, state0, obs0, n_steps, [("T", row, g) for g in gains],
                                header, log=lines.append)
    seconds = time.perf_counter() - start
    n_sub = len(env.params.substep_dts())
    rollouts = 1 + len(gains)
    launches = {name: WRAPPERS[name].launches for name in ("stage_rk_3d", "correct_3d")}
    expect_launches(device, launches, {"stage_rk_3d": rollouts * n_steps * n_sub * 3,
                                       "correct_3d": rollouts * n_steps})
    if not all(np.isfinite(v) for v in nus.values()):
        raise AssertionError(f"probe Nu not finite: {nus}")
    failed = {}
    rises = _probe_checks("3d", nus["zero"],
                          {f"T_row{row}_gain{g:+g}": nus[("T", row, g)] for g in gains},
                          JAX_PROBE_3D["zero"], "3d", check_jax, failed)
    if failed:
        raise AssertionError(f"3D probe off its gates: {failed}")
    return {"phase": "probe_3d", "ra": ra, "episodes": episodes, "n_steps": n_steps,
            "substeps_per_step": n_sub, "bank": str(Path(bank).relative_to(REPO)),
            "lines": lines, "rises": rises, "jax": JAX_PROBE_3D, "seconds": seconds,
            "launches": launches}


def _traced_steps(env, state, obs, action_fn, steps: int, name: str, logdir: str) -> dict:
    """``steps`` env steps under ``utils.profiling.trace``, each inside
    ``annotate(name)`` and a ``StepTimer`` that waits on the step's Nu (as
    the flow-statistics loop reads its statistics every step): the device
    split and idle share of the trace, whether the annotation is in it,
    StepTimer's summary and the host clock's ms a step."""
    state, ts = env.step(state, action_fn(obs))  # warm-up, outside the trace
    obs = ts.obs
    timer = profiling.StepTimer(skip_first=0)
    with profiling.trace(logdir) as traced:
        start = time.perf_counter()
        for _ in range(steps):
            with profiling.annotate(name), timer:
                state, ts = env.step(state, action_fn(obs))
                timer.sink(ts.nusselt)
            obs = ts.obs
        host_s = time.perf_counter() - start
    events = profiling.trace_events(traced.path)
    annotated = sum(1 for e in events if e.get("name") == name
                    and e.get("cat") == "user_annotation")
    if annotated != steps:
        raise AssertionError(f"the trace holds {annotated} '{name}' annotations, not {steps}")
    return {"num_envs": env.num_envs, "steps": steps, "annotations_in_trace": annotated,
            "host_ms_per_step": 1e3 * host_s / steps, "step_timer": timer.summary(),
            "device": kernel_time_split(events)}


def profiling_hooks(device, big_steps=20, probe_steps=5, profile3d_envs=1024,
                    profile3d_reps=5, rl_envs=256, rl_k=1, big_shape=BIG_SHAPE,
                    big_heater_duration=0.25, probe_episodes=32, probe_heater_duration=0.375,
                    rl_n_steps=64) -> dict:
    """``utils.profiling`` on the card: ``trace`` and ``annotate`` around
    ``big_steps`` steps of phase 25's one-env big-grid env and
    ``probe_steps`` of phase 27's 32-env env under law T, each one's device
    idle share (as ``device_profile``) and its annotations in the written
    trace, StepTimer's p50 beside the host clock, ``device_memory_stats()``;
    then ``profile3d`` at ``profile3d_envs`` and ``profile_rl`` in 2D at
    ``rl_envs`` (no gate on the times)."""
    device = torch.device(device)
    begin = time.perf_counter()
    out = {"phase": "profiling"}
    with tempfile.TemporaryDirectory() as d:
        env = fs3d.make_env(500, big_shape, BIG_DT_SOLVER, big_heater_duration, 1, device,
                            working_dtype(device))
        zero = torch.zeros((1, 8, 8), dtype=env.dtype, device=device)
        out["flowstats_3d_one_env"] = _traced_steps(
            env, *env.reset(seed=0), lambda obs: zero, big_steps, "flowstats_3d_step", d)
        env = probe_control3d.make_env(probe_episodes, 500, probe_heater_duration,
                                       str(ASSETS / "3D_ckpt_ra500_test.npz"), device=device)
        out["probe_3d_32_envs"] = _traced_steps(
            env, *env.reset(seed=7), lambda obs: probe_control3d.law_T(obs, 3.0, 1, 8),
            probe_steps, "probe_3d_step", d)
    del env, zero
    out["device_memory_stats"] = profiling.device_memory_stats()
    lines = []
    out["profile3d"] = profile3d.profile(profile3d_envs, profile3d_reps, device, log=lines.append)
    out["profile_rl_2d"] = profile_rl.profile_row(2, rl_envs, rl_n_steps, 10, rl_k, device)
    out["profile3d_lines"] = lines
    out["seconds"] = time.perf_counter() - begin
    return out


def profiling_beside(times_3d: dict, train_2d: dict) -> dict:
    """The numbers of earlier phases that time what ``profile3d`` and
    ``profile_rl`` time: timing_3d's K3 per stage, dense solve and env step,
    and rl_train_2d's seconds an iteration with its split."""
    kernels = times_3d["kernels"]
    return {"timing_3d": {**{f"stage_rk_3d.stage{m}_ms": kernels[f"stage_rk_3d.stage{m}"]["ms"]
                             for m in range(3)},
                          "poisson_dense_ms": times_3d["poisson"]["dense"]["ms"],
                          "env_step_ms": times_3d["env_step_split"]["env_step_ms"]},
            "rl_train_2d": {"s_per_iteration": train_2d["s_per_iteration"],
                            "split_s_per_iteration": train_2d["split_s_per_iteration"]}}


def single_env_2d(device, state_shape=(64, 96), observation_shape=(8, 48), heater_duration=1.5,
                  episode_length=300, bank=ASSETS / "ckpt_ra10000_train.npz", parity_steps=3,
                  seed=0) -> dict:
    """The gym-free 2D core (``envs.single2d.RBC2DEnvCore``) at the 2D gym
    ID's defaults, from the Ra=1e4 train bank: ``reset(seed)`` (the bank
    index it draws, as ``np.random.default_rng(seed)`` draws it), one whole
    episode at zero action, K1 once a step at one block; the first
    ``parity_steps`` steps' fields within K1's gate of the same solver forced
    plain, obs shape and finiteness, reward = -Nu of the observation,
    truncation on the last step and not before, the last step's Nu of the
    state within the float32 fixed-point gate of the first step's (the bank
    holds steady rolls), a step from NaN fields raising RuntimeError; ms a
    step."""
    device = torch.device(device)
    dtype = working_dtype(device)
    core = single2d.RBC2DEnvCore(state_shape=state_shape, observation_shape=observation_shape,
                                 heater_duration=heater_duration, episode_length=episode_length,
                                 checkpoint=str(bank), dtype=dtype, device=device)
    obs, info = core.reset(seed=seed)
    bank_index = int(np.random.default_rng(seed).integers(core._bank.num_episodes))
    zero = np.zeros(core.heater_segments, np.float32)
    fields0, stepped, records = core._fields, [], []
    reset_counters()
    _sync(device)
    start = time.perf_counter()
    while True:
        obs, reward, terminated, truncated, info = core.step(zero)
        records.append((obs, reward, terminated, truncated, info))
        if len(stepped) < parity_steps:
            stepped.append(core._fields)
        if truncated or len(records) > core.episode_steps:
            break
    _sync(device)
    seconds = time.perf_counter() - start
    launches = {"env_step_2d": k2d.env_step_2d.launches}
    steps = len(records)
    expect_launches(device, launches, {"env_step_2d": steps})

    plain = make_solver2d(core._grid, core._params, dtype=dtype, device=device, fused=False)
    f, errors = fields0, []
    for got in stepped:
        f = plain.env_step(f, zero)
        errors.append(abs_diffs(K1_OUT, [getattr(got, n) for n in K1_OUT],
                                [getattr(f, n) for n in K1_OUT]))
    worst = max(max(e.values()) for e in errors)
    if not worst <= K1_MAIN_ATOL:
        raise AssertionError(f"the single env's steps off the plain solver: {errors}")
    nz_o, nx_o = observation_shape
    for obs, reward, terminated, truncated, info in records:
        if obs.shape != (3, nz_o, nx_o) or not np.isfinite(obs).all():
            raise AssertionError(f"obs of shape {obs.shape}, finite {np.isfinite(obs).all()}")
        if reward != -info["nusselt_obs"] or terminated:
            raise AssertionError(f"reward {reward} against Nu {info['nusselt_obs']}")
    truncated_at = [i + 1 for i, r in enumerate(records) if r[3]]
    if truncated_at != [core.episode_steps]:
        raise AssertionError(f"truncated at steps {truncated_at}, not {core.episode_steps}")
    nu_first, nu_last = records[0][4]["nusselt_state"], records[-1][4]["nusselt_state"]
    tol = FIXED_POINT_ATOL[torch.float32]
    if not abs(nu_last - nu_first) <= tol:
        raise AssertionError(f"Nu of the state moved from {nu_first} to {nu_last} (gate {tol})")
    b = core._fields.b.clone()
    b.view(-1)[0] = float("nan")
    core._fields = core._fields._replace(b=b)
    try:
        core.step(zero)
        raise AssertionError("a step from NaN fields did not raise RuntimeError")
    except RuntimeError as e:
        nan_error = str(e)
    return {"phase": "single_env_2d", "path": core._solver.path, "bank_index": bank_index,
            "bank": str(Path(bank).relative_to(REPO)), "steps": steps,
            "episode_steps": core.episode_steps, "truncated_at": truncated_at,
            "first_steps_vs_plain": errors, "atol": K1_MAIN_ATOL,
            "nusselt_state_first_last": [nu_first, nu_last], "fixed_point_atol": tol,
            "nusselt_obs_last": records[-1][4]["nusselt_obs"], "nan_raises": nan_error,
            "seconds": seconds, "ms_per_step": 1e3 * seconds / steps, "launches": launches}


def single_env_3d(device, ra=500, state_shape=(16, 32, 32), heater_duration=0.125, steps=20,
                  bank=ASSETS / "3D_ckpt_ra500_test.npz", checkpoint_idx=0,
                  truncation_length=3, seed=0) -> dict:
    """The gym-free 3D core (``envs.single3d.RBC3DEnvCore``) at the 3D gym
    ID's defaults from episode ``checkpoint_idx`` of the Ra=500 test bank:
    ``steps`` steps of random actions from a seeded generator, K3 three
    times a substep and K4 once a step at one env; the first step within
    the 3D env-step gate of the plain path, obs shape and finiteness, Nu in
    [1, 3], max|div u| under the float32 gate; a second core with
    ``episode_length=truncation_length`` truncating on its last step and
    not before; ms a step."""
    device = torch.device(device)
    dtype = working_dtype(device)
    config = dict(rayleigh_number=ra, state_shape=state_shape, heater_duration=heater_duration,
                  checkpoint=str(bank), checkpoint_idx=checkpoint_idx, dtype=dtype,
                  device=device)
    core = single3d.RBC3DEnvCore(**config)
    core.reset(seed=seed)
    s = core.heater_segments
    actions = np.random.default_rng(seed).uniform(-1.0, 1.0, (steps, s, s)).astype(np.float32)
    fields0, records = core._fields, []
    reset_counters()
    _sync(device)
    start = time.perf_counter()
    for a in actions:
        records.append(core.step(a))
        if len(records) == 1:
            first = core._fields
    _sync(device)
    seconds = time.perf_counter() - start
    n_sub = len(core._params.substep_dts())
    launches = {name: WRAPPERS[name].launches for name in STAGE_WRAPPERS}
    expect_launches(device, launches, {"stage_rk_3d": 3 * n_sub * steps, "stage_rk_3d_xy": 0,
                                       "correct_3d": steps})

    plain = s3d.make_solver3d(core._grid, core._params, dtype=dtype, device=device, fused=False)
    want = plain.env_step(fields0, actions[0])
    step_err = abs_diffs(ENV3_OUT, [getattr(first, n) for n in ENV3_OUT],
                         [getattr(want, n) for n in ENV3_OUT])
    if not max(step_err.values()) <= ENV_STEP_3D_ATOL:
        raise AssertionError(f"the single env's first step off the plain path: {step_err}")
    nz, ny, nx = state_shape
    nus = [info["nusselt"] for _, _, _, _, info in records]
    for obs, reward, terminated, truncated, info in records:
        if obs.shape != (4, nz, ny, nx) or not np.isfinite(obs).all():
            raise AssertionError(f"obs of shape {obs.shape}, finite {np.isfinite(obs).all()}")
        if reward != -info["nusselt"] or terminated or truncated:
            raise AssertionError(f"step {info['step']}: reward {reward}, Nu {info['nusselt']}, "
                                 f"terminated {terminated}, truncated {truncated}")
    if not (1.0 <= min(nus) and max(nus) <= 3.0):
        raise AssertionError(f"Nu in [{min(nus)}, {max(nus)}], outside [1, 3]")
    div = s3d.max_divergence_3d(Fields3D(*(q[None] for q in core._fields)), core._grid)
    if not div < s3d.DIVERGENCE_ATOL[dtype]:
        raise AssertionError(f"max |div| {div}")

    short = single3d.RBC3DEnvCore(**config, episode_length=truncation_length)
    short.reset(seed=seed)
    truncated_at = [i + 1 for i in range(short.episode_steps + 1)
                    if short.step(np.zeros((s, s), np.float32))[3]]
    if truncated_at[:1] != [short.episode_steps]:
        raise AssertionError(f"truncated at steps {truncated_at}, not {short.episode_steps}")
    return {"phase": "single_env_3d", "path": core._solver.path, "steps": steps,
            "substeps_per_step": n_sub, "first_step_vs_plain": step_err,
            "atol": ENV_STEP_3D_ATOL, "nusselt": [min(nus), max(nus)], "max_abs_div": div,
            "truncation": {"episode_length": truncation_length,
                           "episode_steps": short.episode_steps, "truncated_at": truncated_at},
            "seconds": seconds, "ms_per_step": 1e3 * seconds / steps, "launches": launches}


def ablation_gates(rows: dict) -> dict:
    """The ablation's rows (amplitude -> {"random": Nu, "checker": Nu}, in
    increasing amplitude) against the JAX record: what is off its gate."""
    failed = {}
    for amp, row in rows.items():
        jax_row = JAX_ABLATION[amp]
        rtol = ABLATION_ZERO_RTOL if float(amp) == 0.0 else ABLATION_RTOL
        off = {m: (row[m], jax_row[m]) for m in row
               if not abs(row[m] - jax_row[m]) <= rtol * jax_row[m]}
        if off:
            failed[amp] = off
    if "0" in rows and rows["0"]["random"] != rows["0"]["checker"]:
        failed["0 random == checker"] = rows["0"]
    checker = [row["checker"] for row in rows.values()]
    if any(b < a for a, b in zip(checker, checker[1:])):
        failed["checker non-decreasing"] = checker
    return failed


def ablate_actuation_3d(device, episodes=32, n_steps=80, ra=2500, heater_duration=0.375,
                        amplitudes=(0.0, 0.4, 1.0), bank=ASSETS / "3D_ckpt_ra2500_test.npz",
                        seed=7, check_jax=True) -> dict:
    """The ablation twin (``scripts.ablate_actuation3d.ablate``) on the
    Ra=2500 test bank, 38 substeps a step, random and checkerboard forcing
    at each amplitude (K3 three times a substep, K4 once a step); with
    ``check_jax`` held to the JAX record: at amplitude 0 the two rows equal
    and within 2 % of it, every other row within 3 %, the checkerboard
    rows non-decreasing in the amplitude; seconds."""
    device = torch.device(device)
    env = ablate3d.make_env(episodes, ra, heater_duration, str(bank), device)
    state0, _ = env.reset(seed=seed)
    lines = []
    reset_counters()
    _sync(device)
    start = time.perf_counter()
    table = ablate3d.ablate(env, state0, amplitudes, n_steps, seed, log=lines.append)
    _sync(device)
    seconds = time.perf_counter() - start
    n_sub = len(env.params.substep_dts())
    rollouts = 2 * len(amplitudes)
    launches = {name: WRAPPERS[name].launches for name in ("stage_rk_3d", "correct_3d")}
    expect_launches(device, launches, {"stage_rk_3d": rollouts * n_steps * n_sub * 3,
                                       "correct_3d": rollouts * n_steps})
    rows = {f"{amp:g}": {"random": nr, "checker": nc}
            for amp, nr, nc in zip(amplitudes, table["random"], table["checker"])}
    if not all(np.isfinite(v) for row in rows.values() for v in row.values()):
        raise AssertionError(f"ablation Nu not finite: {rows}")
    failed = ablation_gates(rows) if check_jax else {}
    if failed:
        raise AssertionError(f"ablation off the JAX record (port, JAX): {failed}")
    return {"phase": "ablate_actuation_3d", "ra": ra, "episodes": episodes, "n_steps": n_steps,
            "substeps_per_step": n_sub, "bank": str(Path(bank).relative_to(REPO)),
            "lines": lines, "rows": rows, "jax": JAX_ABLATION, "seconds": seconds,
            "ms_per_step": 1e3 * seconds / (rollouts * n_steps), "launches": launches}


# ---------------------------------------------------------------------------
# The example twins and the launchers
# ---------------------------------------------------------------------------


def example_vectorized(device, num_envs=6, steps=20, nu_range=NU_RANGE, **env_kwargs) -> dict:
    """``examples.run_vectorized.native_lockstep``: one warm-up and
    ``steps`` timed zero-action steps, K1 once a step; the rewards finite,
    -reward (Nu of the observation) in ``nu_range``; its printed lines and
    env-steps/s."""
    device = torch.device(device)
    reset_counters()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rewards, rate = run_vectorized.native_lockstep(num_envs, steps, device=device,
                                                       **env_kwargs)
    launches = {"env_step_2d": k2d.env_step_2d.launches}
    expect_launches(device, launches, {"env_step_2d": steps + 1})
    nu = -rewards
    if not (np.isfinite(rewards).all() and nu_range[0] <= nu.min() and nu.max() <= nu_range[1]):
        raise AssertionError(f"rewards {rewards}: -reward outside {nu_range}")
    return {"phase": "example_vectorized", "num_envs": num_envs, "steps": steps,
            "env_steps_per_s": rate, "nusselt_obs": [float(nu.min()), float(nu.max())],
            "lines": printed.getvalue().splitlines(), "launches": launches}


def example_timing(device, num_envs=1024, steps=10, **env_kwargs) -> dict:
    """``examples.timing.time_native``: one warm-up and ``steps`` timed
    zero-action steps at the twin's heater_duration, K1 once a step;
    finite rewards; us an env step and the substeps an env step."""
    device = torch.device(device)
    reset_counters()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = example_timing_twin.time_native(num_envs, steps, device=device, **env_kwargs)
    launches = {"env_step_2d": k2d.env_step_2d.launches}
    expect_launches(device, launches, {"env_step_2d": steps + 1})
    if not np.isfinite(out["rewards"]).all():
        raise AssertionError(f"rewards not finite: {out['rewards']}")
    return {"phase": "example_timing", "num_envs": num_envs, "steps": steps,
            "heater_duration": out["heater_duration"], "substeps_per_step": out["substeps"],
            "us_per_env_step": out["us_per_env_step"], "x_reference": out["x_reference"],
            "lines": printed.getvalue().splitlines(), "launches": launches}


def example_ppo_native(device, iterations=10, **kwargs) -> dict:
    """The ``examples.run_ppo_native`` twin: ``iterations`` PPO iterations
    on the 3D env, K3 three times a substep and K4 once an env step; every
    metric of every iteration finite with an update applied, the best
    rollout Nu finite and in [1, 3], TF32 off; seconds an iteration (the
    first apart) and the update's share of them."""
    device = torch.device(device)
    update_s, ends, records = [0.0], [], []

    def record(metrics, trainer):
        _sync(device)
        ends.append(time.perf_counter())
        records.append(dict(metrics))

    reset_counters()
    with mock.patch.object(PPO, "_update", _timed(PPO._update, device, update_s)), \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        _sync(device)
        start = time.perf_counter()
        trainer, nusselt = run_ppo_native.main(iterations=iterations, device=device,
                                               callbacks=(record,), **kwargs)
    launches = {name: WRAPPERS[name].launches for name in ("stage_rk_3d", "correct_3d")}
    steps = iterations * trainer.config.n_steps
    n_sub = len(trainer.env.params.substep_dts())
    expect_launches(device, launches, {"stage_rk_3d": steps * n_sub * 3, "correct_3d": steps})
    check_records(records)
    best = float(nusselt.best_nusselt)
    if not (np.isfinite(best) and 1.0 <= best <= 3.0):
        raise AssertionError(f"best rollout Nu {best} outside [1, 3]")
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    if any(tf32.values()):
        raise AssertionError(f"TF32 on: {tf32}")
    iteration_s = np.diff([start, *ends])
    return {"phase": "example_ppo_native", "num_envs": trainer.env.num_envs,
            "n_steps": trainer.config.n_steps, "iterations": iterations,
            "substeps_per_step": n_sub, "path": trainer.env.solver.path,
            "first_iteration_s": float(iteration_s[0]),
            "s_per_iteration": float(iteration_s.mean()),
            "s_per_later_iteration": float(iteration_s[1:].mean()) if iterations > 1 else None,
            "update_share": update_s[0] / float(iteration_s.sum()),
            "best_nusselt": best, "n_updates": [r["n_updates"] for r in records],
            "loss": [r["loss"] for r in records], "tf32": tf32,
            "last_line": printed.getvalue().splitlines()[-1], "launches": launches}


LAUNCHER_DIR = REPO / "rbc_gym_tpu_torch" / "scripts"
SPLITS = ("train", "test", "val")


def _launch(script: str, env: dict, *args, timeout: float = 600.0) -> str:
    """``bash`` runs the launcher twin ``script`` with ``env`` over this
    process's environment, in a session of its own; a non-zero exit raises
    with its output, and so does the time limit, after killing the session
    (every process the script started). Its standard output."""
    proc = subprocess.Popen(["bash", str(LAUNCHER_DIR / script), *args],
                            env={**os.environ, **env}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        raise RuntimeError(f"{script} outlasted {timeout} s:\n{stdout}\n{stderr}")
    if proc.returncode != 0:
        raise RuntimeError(f"{script} exited {proc.returncode}:\n{stdout}\n{stderr}")
    return stdout


def launchers(device, ra_2d=10_000, ra_3d=2500, duration_2d=3.0, duration_3d=1.0,
              random_inits=2, args_2d=(), args_3d=(), sbatch=None) -> dict:
    """The bank launchers into a temporary OUT_DIR (``FORMAT=npz``, one Ra
    each, ``random_inits`` episodes, the durations cut; ``args_2d`` and
    ``args_3d`` go to every call): every bank loads through
    ``utils.checkpoints``, is finite with distinct episodes and max|div u|
    under the float32 gate (``DIVERGENCE_ATOL``, the burn-in phase's: a
    float32 burn-in projects in float32, so the rounding bound
    ``bank_div_atol`` of a float64 field stored as float32 does not apply,
    and is reported beside it in 2D); ``fill_missing_banks.sh`` over that
    directory skips all six and generates nothing. Then ``train_sa.sbatch``
    outside Slurm (``sbatch``: its environment, default 16 envs, 8 steps,
    one iteration) leaves config.yaml, one finite metrics record and
    models/final_model.npz."""
    device = torch.device(device)
    common = {"DEVICE": device.type, "PYTHON": sys.executable}
    out = {"phase": "launchers", "ra_2d": ra_2d, "ra_3d": ra_3d, "random_inits": random_inits,
           "durations": {"2d": duration_2d, "3d": duration_3d}}
    with tempfile.TemporaryDirectory() as tmp:
        banks = Path(tmp) / "banks"
        env = {**common, "OUT_DIR": str(banks), "FORMAT": "npz"}
        inits = ("--random_inits", str(random_inits))
        for dim, script, ra, duration, args in (
                ("2d", "create_checkpoints_2D.sh", ra_2d, duration_2d, args_2d),
                ("3d", "create_checkpoints_3D.sh", ra_3d, duration_3d, args_3d)):
            start = time.perf_counter()
            printed = _launch(script, {**env, "RAS": str(ra), "DURATION": str(duration)},
                              *inits, *args)
            out[dim] = {"seconds": time.perf_counter() - start, "lines": printed.splitlines()}
            for split in SPLITS:
                if dim == "2d":
                    bank = load_bank_2d(banks / split / f"ckpt_ra{ra}.npz")
                    _, nx, nz = bank.b.shape
                    grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
                    fields = Fields2D(*(torch.as_tensor(getattr(bank, n))
                                        for n in ("u", "w", "b")), None, None)
                    div, atol = max_divergence(fields, grid), DIVERGENCE_ATOL[torch.float32]
                    extra = {"bank_div_atol": bank_div_atol(bank)}
                else:
                    bank = load_bank_3d(banks / split / f"3D_ckpt_ra{ra}.npz")
                    _, nx, ny, nz = bank.b.shape
                    grid = Grid3D(nx=nx, ny=ny, nz=nz, lx=4 * np.pi, ly=4 * np.pi, lz=2.0)
                    fields = s3d.Fields3D(*(torch.as_tensor(getattr(bank, n))
                                            for n in ("u", "v", "w", "b")), None, None)
                    div, atol = s3d.max_divergence_3d(fields, grid), s3d.DIVERGENCE_ATOL[
                        torch.float32]
                    extra = {}
                if bank.num_episodes != random_inits:
                    raise AssertionError(f"{dim} {split}: {bank.num_episodes} episodes")
                out[dim][split] = {**_bank_checks(bank, div, atol), **extra}
        printed = _launch("fill_missing_banks.sh",
                          {**env, "RAS_2D": str(ra_2d), "RAS_3D": str(ra_3d)}, *inits)
        want = ([f"skip {banks}/{split}/3D_ckpt_ra{ra_3d}.npz" for split in SPLITS]
                + [f"skip {banks}/{split}/ckpt_ra{ra_2d}.npz" for split in SPLITS]
                + ["all banks present"])
        if printed.splitlines() != want:
            raise AssertionError(f"fill_missing_banks.sh printed {printed.splitlines()}")
        out["fill_missing_banks"] = printed.splitlines()

        run = Path(tmp) / "sarl"
        sb_env = {"NUM_ENVS": "16", "N_STEPS": "8", "ITERATIONS": "1", **(sbatch or {})}
        start = time.perf_counter()
        printed = _launch("train_sa.sbatch", {**common, **sb_env, "OUTPUT_DIR": str(run)})
        seconds = time.perf_counter() - start
        missing = [n for n in ("config.yaml", "metrics.jsonl", "models/final_model.npz")
                   if not (run / n).is_file()]
        if missing:
            raise AssertionError(f"train_sa.sbatch left no {missing} in {run}")
        metrics = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        if len(metrics) != int(sb_env["ITERATIONS"]):
            raise AssertionError(f"{len(metrics)} metrics records")
        check_records(metrics)
        out["train_sa"] = {**sb_env, "seconds": seconds, "first_line": printed.splitlines()[0],
                           "outputs": sorted(str(p.relative_to(run)) for p in run.rglob("*")
                                             if p.is_file())}
    return out


# ---------------------------------------------------------------------------
# Multi-rank: the env-axis split over two ranks sharing the card (phase 36)
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one device; gloo takes CUDA tensors for the
# all-reduce and broadcast that the split needs, and the tensors stay on
# the card.
MULTI_RANK_BACKEND = "gloo"
# the ranks against one process: rewards and obs as max|two - one| /
# max|one|, the params after one PPO iteration of one epoch absolutely
MULTI_RANK_RTOL = 1e-5
MULTI_RANK_PARAMS_ATOL = 1e-5
# the card run: the main path, the training grid (K3's path and the field
# path, K6 and K7) and the 2D PPO configuration of rl_train_2d
MULTI_RANK_SPEC = {
    "seed": 0,
    "env_2d": {"num_envs": 1024, "steps": 3, "state_shape": [64, 96],
               "observation_shape": [8, 48], "heater_duration": 1.5},
    "env_3d": {"num_envs": 1024, "steps": 2, "state_shape": [16, 32, 32],
               "heater_duration": 0.125},
    "ppo_2d": {"rl_n_envs": 256},
}
# One PPO iteration each. "one_epoch" (8 updates of 2048 at the card's
# config) is gated at MULTI_RANK_PARAMS_ATOL, with cuDNN's deterministic
# algorithms so that one process repeats itself exactly; "full" (the
# configuration's 10 epochs, 80 updates) runs as users run it and is
# recorded beside one process's own repeat: the float32 update amplifies
# rounding, so after 80 updates one process differs from itself by ~6e-4
# under cuDNN's default algorithms (PERF.md §6).
MULTI_RANK_PPO_RUNS = {"one_epoch": ({"rl_n_epochs": 1}, True), "full": ({}, False)}


def _multi_rank_envs(spec: dict, device: torch.device) -> list:
    """(name, env class, kwargs, wrappers counted) of the env parts."""
    dtype = working_dtype(device)
    e2, e3 = spec["env_2d"], spec["env_3d"]
    kw_3d = dict(state_shape=tuple(e3["state_shape"]), heater_duration=e3["heater_duration"])
    return [
        ("env_2d", RBC2DVectorEnv, dict(state_shape=tuple(e2["state_shape"]),
                                        observation_shape=tuple(e2["observation_shape"]),
                                        heater_duration=e2["heater_duration"], dtype=dtype),
         ("env_step_2d",)),
        ("env_3d", RBC3DVectorEnv, dict(kw_3d, dtype=dtype), STAGE_WRAPPERS),
        # forced, so float32 on any device
        ("env_3d_field", RBC3DVectorEnv, dict(kw_3d, fused="field", dtype=torch.float32),
         FIELD_PATH_WRAPPERS),
    ]


def _multi_rank_env_parts(spec: dict, device: torch.device, mesh=None):
    """The env parts of ``spec`` in one process or as this rank of
    ``mesh``: (arrays, record). Each steps the whole fleet's seeded random
    actions (a rank its rows) from reset(seed); the rewards of every step
    and the last obs are gathered to rank 0 (None on the other ranks)."""
    arrays, record = {}, {}
    for name, cls, kw, counted in _multi_rank_envs(spec, device):
        part = spec[name.replace("_field", "")]
        n, lo = part["num_envs"], 0
        if mesh is None:
            env = cls(n, device=device, **kw)
        else:
            env = shard_vector_env(cls, n, mesh, **kw)
            lo = env.env_offset
        rng = np.random.default_rng(spec["seed"])
        shape = (n,) + ((env.params.n_heaters,) if cls is RBC2DVectorEnv
                        else (env.params.n_heaters,) * 2)
        reset_counters()
        start = time.perf_counter()
        state, obs = env.reset(seed=spec["seed"])
        rewards = []
        for _ in range(part["steps"]):
            state, ts = env.step(state, rng.uniform(-1.0, 1.0, shape)[lo:lo + env.num_envs])
            rewards.append(ts.reward)
        _sync(device)
        record[name] = {"num_envs": env.num_envs, "path": env.solver.path,
                        "seconds": time.perf_counter() - start,
                        "launches": {k: WRAPPERS[k].launches for k in counted}}
        for key, x in (("rewards", torch.stack(rewards, 1)), ("obs", ts.obs)):
            arrays[f"{name}/{key}"] = x.cpu() if mesh is None else mesh.gather_rows(x)
    return arrays, record


def _multi_rank_ppo(spec: dict, device: torch.device, run: str, mesh=None):
    """One PPO iteration of ``MULTI_RANK_PPO_RUNS[run]`` at the
    sarl2d_ra10000 configuration on the train bank, in one process or as
    this rank of ``mesh``: (params, record)."""
    overrides, deterministic = MULTI_RANK_PPO_RUNS[run]
    config = {**run_sarl_2d.DEFAULT_CONFIG, **SARL2D_RA10000,
              "rbc_checkpoint": str(ASSETS / "ckpt_ra10000_train.npz"),
              **spec["ppo_2d"], **overrides}
    trainer, _, _ = run_sarl_2d.make_trainer(config, device, mesh)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        reset_counters()
        _sync(device)
        start = time.perf_counter()
        metrics = trainer.learn(1)
        _sync(device)
    finally:
        torch.backends.cudnn.deterministic = was
    params = {k: p.detach().cpu().numpy() for k, p in trainer.model.named_parameters()}
    return params, {"num_envs": trainer.env.num_envs, "n_steps": config["rl_n_steps"],
                    "seconds": time.perf_counter() - start, "metrics": metrics,
                    "launches": {"env_step_2d": k2d.env_step_2d.launches}}


def rank_worker(tmp: str) -> int:
    """One rank of ``multi_rank_ranks`` (``chip_smoke.py --rank-worker
    DIR``): joins the ranks (torchrun's variables) on ``DIR/spec.json``'s
    device with gloo, runs the env parts and the PPO runs as its rank and
    writes ``DIR/rank<r>.npz`` and ``DIR/rank<r>.json``."""
    import torch.distributed as dist

    spec = json.loads((Path(tmp) / "spec.json").read_text())
    if not initialize_distributed(backend=MULTI_RANK_BACKEND, device=spec["device"],
                                  timeout=spec["timeout"]):
        raise RuntimeError("--rank-worker outside a multi-rank launch")
    mesh = make_env_mesh(device=spec["device"])
    arrays, record = _multi_rank_env_parts(spec, mesh.device, mesh)
    arrays = {k: v.numpy() for k, v in arrays.items() if v is not None}
    for run in MULTI_RANK_PPO_RUNS:
        params, record[run] = _multi_rank_ppo(spec, mesh.device, run, mesh)
        arrays.update({f"{run}/params/{k}": v for k, v in params.items()})
    record.update(rank=mesh.rank, world_size=mesh.size, backend=dist.get_backend(),
                  device=str(mesh.device))
    np.savez(Path(tmp) / f"rank{mesh.rank}.npz", **arrays)
    (Path(tmp) / f"rank{mesh.rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()
    return 0


def _max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), np.finfo(np.float64).tiny))


def _max_abs(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def multi_rank_ranks(device, spec=None, timeout: float = 600.0) -> dict:
    """``spec``'s parts in one process, then as two gloo ranks on the same
    device (``parallel.launch.run_ranks`` of ``chip_smoke.py
    --rank-worker``): the ranks' rewards and obs within ``MULTI_RANK_RTOL``
    of one process's; after each PPO run their params equal to each other
    and one ``n_updates`` on both ranks and in one process, and after the
    one-epoch run the params within ``MULTI_RANK_PARAMS_ATOL`` of one
    process's (the full run's difference is recorded beside one process's
    own repeat); on the card each rank's launches (K1 once a 2D env step,
    K3 and K4 on the training grid, K6, K7 and K4 on its field path)."""
    device = torch.device(device)
    spec = {**MULTI_RANK_SPEC, **(spec or {}), "device": str(device), "timeout": timeout}
    start = time.perf_counter()
    one, one_record = _multi_rank_env_parts(spec, device)
    one = {k: v.numpy() for k, v in one.items()}
    one_params = {}
    for run in MULTI_RANK_PPO_RUNS:
        one_params[run], one_record[run] = _multi_rank_ppo(spec, device, run)
    repeat, _ = _multi_rank_ppo(spec, device, "full")
    one_s = time.perf_counter() - start
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the card's memory for the ranks
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "spec.json").write_text(json.dumps(spec))
        start = time.perf_counter()
        run_ranks([sys.executable, str(REPO / "chip_smoke.py"), "--rank-worker", tmp], 2,
                  env={"OMP_NUM_THREADS": "1"}, timeout=timeout)
        ranks_s = time.perf_counter() - start
        arrays = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in (0, 1)]
        records = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in (0, 1)]
    out = {"phase": "multi_rank", "backend": records[0]["backend"],
           "devices": [r["device"] for r in records], "one_process_s": one_s,
           "ranks_s": ranks_s, "max_rel_diff": {}, "launches_per_rank": {}}
    failed = [r["backend"] for r in records if r["backend"] != MULTI_RANK_BACKEND]
    for name, _, _, counted in _multi_rank_envs(spec, device):
        for key in ("rewards", "obs"):
            k = f"{name}/{key}"
            out["max_rel_diff"][k] = diff = _max_rel(arrays[0][k], one[k])
            if not diff <= MULTI_RANK_RTOL:
                failed.append(f"{k}: {diff}")
        out["launches_per_rank"][name] = [r[name]["launches"] for r in records]
        out[name] = {"num_envs_per_rank": records[0][name]["num_envs"],
                     "path": records[0][name]["path"],
                     "rank_seconds": [r[name]["seconds"] for r in records],
                     "one_process_seconds": one_record[name]["seconds"]}
    for run in MULTI_RANK_PPO_RUNS:
        ranks = [{k[len(run) + 8:]: v for k, v in a.items() if k.startswith(f"{run}/params/")}
                 for a in arrays]
        n_updates = [r[run]["metrics"]["n_updates"] for r in records]
        rec = out[run] = {
            "num_envs_per_rank": records[0][run]["num_envs"],
            "cudnn_deterministic": MULTI_RANK_PPO_RUNS[run][1],
            "params_max_abs_diff": _max_abs(ranks[0], one_params[run]),
            "params_ranks_max_abs_diff": _max_abs(ranks[0], ranks[1]),
            "n_updates": {"ranks": n_updates,
                          "one_process": one_record[run]["metrics"]["n_updates"]},
            "metrics_max_abs_diff": max(abs(records[0][run]["metrics"][k] - v)
                                        for k, v in one_record[run]["metrics"].items()),
            "rank_seconds": [r[run]["seconds"] for r in records],
            "one_process_seconds": one_record[run]["seconds"]}
        if run == "full":
            rec["one_process_repeat_params_max_abs_diff"] = _max_abs(repeat, one_params[run])
        elif not rec["params_max_abs_diff"] <= MULTI_RANK_PARAMS_ATOL:
            failed.append(f"{run} params: {rec['params_max_abs_diff']} from one process")
        if rec["params_ranks_max_abs_diff"] != 0.0 or len({*n_updates, rec["n_updates"][
                "one_process"]}) != 1:
            failed.append(f"{run}: ranks differ by {rec['params_ranks_max_abs_diff']}, "
                          f"n_updates {rec['n_updates']}")
        out["launches_per_rank"][run] = [r[run]["launches"] for r in records]
    if device.type == "cuda":
        e2, e3 = spec["env_2d"], spec["env_3d"]
        n_stages = e3["steps"] * 3 * len(s3d.SimParams3D(
            heater_duration=e3["heater_duration"]).substep_dts())
        k1_ppo = {"env_step_2d": one_record["full"]["n_steps"]}
        want = {"env_2d": {"env_step_2d": e2["steps"]},
                "env_3d": {"stage_rk_3d": n_stages, "stage_rk_3d_xy": 0,
                           "correct_3d": e3["steps"]},
                "env_3d_field": {"stage_rk_3d": 0, "stage_rk_3d_xy": 0, "correct_3d": n_stages,
                                 "field_tendency_3d": 4 * n_stages, "div_3d": n_stages},
                "one_epoch": k1_ppo, "full": k1_ppo}
        for name, counts in want.items():
            if out["launches_per_rank"][name] != [counts, counts]:
                failed.append(f"{name} launches {out['launches_per_rank'][name]}, "
                              f"expected {counts} on each rank")
    if failed:
        raise AssertionError(f"multi_rank: {failed}; {out}")
    return out


def multi_rank_bench(device, envs_per_rank=512, steps=5, args=()) -> dict:
    """The weak-scaling harness (``bench_multihost.sh``) at ``envs_per_rank``
    envs a rank, one rank and two gloo ranks on ``device``: its three
    records, the efficiency its own arithmetic. Two ranks sharing one card
    measure the split, not scaling."""
    device = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        printed = _launch("bench_multihost.sh", {"BENCH_MULTIHOST_OUT": tmp,
                                                 "PYTHON": sys.executable},
                          str(envs_per_rank), str(steps), "--device", device.type,
                          "--backend", MULTI_RANK_BACKEND, *args)
    one, two, eff = [json.loads(x) for x in printed.splitlines() if x.startswith("{")]
    if (one["processes"], two["processes"], two["num_envs"]) != (1, 2, 2 * envs_per_rank):
        raise AssertionError(f"bench records {one}, {two}")
    if abs(eff["value"] - two["value"] / (2 * one["value"])) > 1e-9 * eff["value"]:
        raise AssertionError(f"efficiency {eff}")
    return {"one_rank": one, "two_ranks": two, "efficiency": eff,
            "note": "two ranks sharing one card: the split, not a scaling figure"}


def multi_rank_launcher(device, num_envs=16, iterations=1, config=None) -> dict:
    """``launch_multihost.sh`` with NPROC=2, BACKEND=gloo: ``run_sarl`` over
    two ranks for ``iterations`` iterations at its defaults under
    ``config`` (default: one epoch an iteration, within float32 rounding of
    one process, see ``MULTI_RANK_PPO_RUNS``). Rank 0 alone writes: one
    metrics record an iteration, each counting the whole fleet's steps, the
    frozen config, the models and the full state in the one-process layout.
    The same ``n_updates`` as ``run_sarl`` run here in one process; the
    final params' difference from it is recorded beside that of a second
    one-process run (cuDNN's default algorithms are not deterministic)."""
    import yaml

    device = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "in.yaml"
        cfg.write_text(yaml.safe_dump(config or {"rl_n_epochs": 1}))
        flags = ["--config", str(cfg), "--num_envs", str(num_envs), "--iterations",
                 str(iterations), "--device", device.type]
        run, one = Path(tmp) / "sarl", Path(tmp) / "one"
        start = time.perf_counter()
        _launch("launch_multihost.sh", {"NPROC": "2", "BACKEND": MULTI_RANK_BACKEND,
                                        "PYTHON": sys.executable},
                "--output_dir", str(run), *flags)
        seconds = time.perf_counter() - start
        start = time.perf_counter()
        run_sarl.main(["--output_dir", str(one), *flags])
        one_s = time.perf_counter() - start
        run_sarl.main(["--output_dir", str(Path(tmp) / "again"), *flags])
        final = [dict(np.load(d / "models" / "final_model.npz"))
                 for d in (run, one, Path(tmp) / "again")]
        params_diff, repeat_diff = _max_abs(final[0], final[1]), _max_abs(final[2], final[1])
        one_metrics = [json.loads(x) for x in (one / "metrics.jsonl").read_text().splitlines()]
        config = yaml.safe_load((run / "config.yaml").read_text())
        metrics = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        check_records(metrics)
        steps = [m["global_step"] for m in metrics]
        want = [config["rl_n_steps"] * num_envs * (i + 1) for i in range(iterations)]
        if [m["iteration"] for m in metrics] != list(range(iterations)) or steps != want:
            raise AssertionError(f"metrics records {metrics}: not one an iteration over the "
                                 f"fleet of {num_envs}")
        n_updates = [[m["n_updates"] for m in ms] for ms in (metrics, one_metrics)]
        if n_updates[0] != n_updates[1]:
            raise AssertionError(f"two ranks against one process: n_updates {n_updates}")
        with np.load(run / "models" / "checkpoints" / "latest_full.npz") as z:
            if z["env/key"].shape != (num_envs,):
                raise AssertionError(f"latest_full.npz holds {z['env/key'].shape} env keys")
        outputs = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
        missing = {"config.yaml", "metrics.jsonl", "models/final_model.npz",
                   "models/best_model.npz"} - set(outputs)
        if missing:
            raise AssertionError(f"launch_multihost.sh left no {sorted(missing)}")
    return {"num_envs": num_envs, "iterations": iterations, "seconds": seconds,
            "one_process_seconds": one_s, "global_steps": steps, "outputs": outputs,
            "params_max_abs_diff": params_diff,
            "one_process_repeat_params_max_abs_diff": repeat_diff, "n_updates": n_updates[0]}


def multi_rank(device) -> dict:
    """Phase 36: ``multi_rank_ranks``, ``multi_rank_bench`` and
    ``multi_rank_launcher`` at their card sizes."""
    start = time.perf_counter()
    out = multi_rank_ranks(device)
    out["bench"] = multi_rank_bench(device)
    out["launcher"] = multi_rank_launcher(device)
    out["seconds"] = time.perf_counter() - start
    return out


# ---------------------------------------------------------------------------
# 37: the measurement modules and their scripts
# ---------------------------------------------------------------------------

# Each kernel path's gate in utils.parity's run, on the grid and dt_solver
# of the main path that times it (one env step of 6 substeps in 2D; in 3D
# heater_duration 0.03: 3 substeps at dt 0.01, 6 on the big grid at 0.005):
# its (state_shape, dt_solver), RK stages, and the launches of its
# wrappers per stage and per env step.
PARITY_PATHS = {
    "2d": (None, 0, {}, {"env_step_2d": 1}),
    "stage": (((16, 32, 32), 0.01), 9, {"stage_rk_3d": 1}, {"correct_3d": 1}),
    "stage_xy": ((BIG_SHAPE, BIG_DT_SOLVER), 18, {"stage_rk_3d_xy": 1}, {"correct_3d": 1}),
    "field": (((16, 32, 32), 0.01), 9,
              {"field_tendency_3d": 4, "div_3d": 1, "correct_3d": 1}, {}),
}
# the kernels each script runs on the card
SCRIPT_KERNELS = {
    "bench3d_stage": {"stage_rk_3d", "correct_3d"},
    "bench3d_field": {"field_tendency_3d", "div_3d", "correct_3d"},
    "ablate3d": {"stage_rk_3d", "div_3d", "correct_3d"},
    "probe_mxu_recon": set(),
}
# the probe's two reconstructions agree to float32 rounding of five taps
PROBE_RTOL = 1e-5
ROOFLINE_SHARES = ("fp32_utilization_pct", "gemm_utilization_pct", "hbm_min_utilization_pct")


def _expect_kernels(device, name: str, got: dict, kernels: set) -> None:
    """On the card: every kernel of ``kernels`` launched, no other."""
    if device.type == "cuda" and {k for k, n in got.items() if n} != kernels:
        raise AssertionError(f"{name} launched {got}, expected exactly {sorted(kernels)}")


def measurement_parity(device, num_envs=128) -> dict:
    """``utils.parity`` on the card, as a bench gates a path before it
    times it: K1 (2D), K3 and K6/K7 on the training grid and K5 on the big
    grid against the plain path, each within the JAX helper's gate, with
    the launches each run made."""
    out = {"atol": parity.ATOL_DEFAULT, "max_abs_err": {}, "launches": {}}
    for path, (grid, stages, per_stage, per_step) in PARITY_PATHS.items():
        reset_counters()
        if path == "2d":
            err = parity.fused_parity_2d(num_envs=num_envs, device=device)
        else:
            err = parity.fused_parity_3d(num_envs=num_envs, state_shape=grid[0],
                                         dt_solver=grid[1], fused=path, device=device)
        got = registry.kernel_launches()
        want = dict.fromkeys(WRAPPERS, 0)
        for name, n in per_stage.items():
            want[name] += n * stages
        for name, n in per_step.items():
            want[name] += n
        expect_launches(device, got, want)
        out["max_abs_err"][path] = err
        out["launches"][path] = {k: n for k, n in got.items() if n}
    return out


def measurement_flops(device, state_shape_2d=(64, 96), num_envs=4, heater_duration_2d=1.5,
                      poisson_shapes=((16, 32, 32), BIG_SHAPE), refused_envs=4) -> dict:
    """``utils.flopcount`` on the card: the plain 2D env step (elementwise
    per point-stage, equal to the CPU's count of the same step; GEMM per
    point-stage the solve's closed form; no unknown op), the 3D Poisson
    solves of the kernel paths against their closed forms (dense and
    factored), and one K3-path env step, which the count must refuse."""
    out = {}
    nz, nx = state_shape_2d
    grid = Grid2D(nx=nx, nz=nz, lx=2 * np.pi, lz=2.0)
    params = SimParams2D(heater_duration=heater_duration_2d)
    counts = {}
    for dev in (device, torch.device("cpu")):
        solver = make_solver2d(grid, params, dtype=torch.float32, device=dev, fused=False)
        f = solver.init_random(torch.Generator(device=dev).manual_seed(0), (num_envs,))
        a = torch.zeros((num_envs, params.n_heaters), dtype=torch.float32, device=dev)
        counts[dev.type] = flopcount.count_fn_flops(solver.env_step, f, a)
    c = counts[device.type]
    per = nx * nz * num_envs * 3 * params.substeps_per_env_step
    out["plain_2d"] = {"state_shape": list(state_shape_2d), "num_envs": num_envs,
                       "elementwise_per_point_stage": c["elementwise"] / per,
                       "gemm_per_point_stage": c["gemm"] / per,
                       "unknown_ops": sorted(c["unknown_ops"])}
    if c["unknown_ops"]:
        raise AssertionError(f"unknown ops in the plain 2D step: {sorted(c['unknown_ops'])}")
    if c["gemm"] / per != roofline.poisson_gemm_flops_per_point_2d(nx, nz):
        raise AssertionError(f"2D GEMM per point-stage {c['gemm'] / per}")
    if (c["elementwise"], c["gemm"]) != (counts["cpu"]["elementwise"], counts["cpu"]["gemm"]):
        raise AssertionError(f"the card's count {c} is not the CPU's {counts['cpu']}")
    out["poisson_3d"] = {}
    for shape in poisson_shapes:
        got = roofline.torch_poisson_flops_per_point("3d", shape, device)
        want = roofline.poisson_gemm_flops_per_point_3d(shape[2], shape[1], shape[0])
        out["poisson_3d"]["x".join(map(str, shape))] = {"gemm_per_point": got, "closed_form": want}
        if got != want:
            raise AssertionError(f"3D solve at {shape}: {got} GEMM FLOP a point, not {want}")
    solver = s3d.make_solver3d(Grid3D(nx=32, ny=32, nz=16, lx=4 * np.pi, ly=4 * np.pi, lz=2.0),
                               s3d.SimParams3D(), dtype=torch.float32, device=device,
                               fused="stage")
    f = solver.init_random(torch.Generator(device=device).manual_seed(0), (refused_envs,))
    a = torch.zeros((refused_envs, 8, 8), dtype=torch.float32, device=device)
    try:
        flopcount.count_fn_flops(solver.env_step, f, a)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    if device.type == "cuda" and (refusal is None or "stage_rk_3d" not in refusal):
        raise AssertionError(f"counting a K3-path step was not refused by name: {refusal}")
    out["k3_path_refused"] = refusal
    return out


def measurement_roofline(rates: dict) -> dict:
    """``roofline_metrics`` of each main path's rate: every share finite
    and in (0, 100] %."""
    costs = {"main_path": roofline.cost_2d(), "main_path_3d": roofline.cost_3d(),
             "main_path_big": roofline.cost_3d(state_shape=BIG_SHAPE, dt_solver=BIG_DT_SOLVER)}
    out = {}
    for name, cost in costs.items():
        m = roofline.roofline_metrics(cost, rates[name])
        shares = [m[k] for k in ROOFLINE_SHARES]
        if not all(np.isfinite(x) and 0.0 < x <= 100.0 for x in shares):
            raise AssertionError(f"{name}: shares {shares} outside (0, 100] %")
        out[name] = {"env_steps_per_s": rates[name], **m}
    return out


def measurement_scripts(device, num_envs=1024, bench_steps=10, n_units=substep_ablation.N_UNITS,
                        n_iter=probe_mxu_recon.N_ITER) -> dict:
    """The scripts at ``num_envs``: ``bench3d.run`` on the stage and field
    paths, ``ablate3d`` and ``probe_mxu_recon`` (its two reconstructions
    within ``PROBE_RTOL`` of the field's max |value|); every time finite,
    the launches of each counted."""
    out = {"lines": [], "launches": {}}
    log = out["lines"].append
    runs = {
        "bench3d_stage": lambda: bench3d.run("stage", num_envs, bench_steps, device, log),
        "bench3d_field": lambda: bench3d.run("field", num_envs, bench_steps, device, log),
        "ablate3d": lambda: substep_ablation.ablate(num_envs, device, n_units, log),
        "probe_mxu_recon": lambda: probe_mxu_recon.probe(num_envs, device, n_iter, log=log),
    }
    for name, run in runs.items():
        reset_counters()
        out[name] = run()
        _sync(device)
        got = registry.kernel_launches()
        _expect_kernels(device, name, got, SCRIPT_KERNELS[name])
        out["launches"][name] = {k: n for k, n in got.items() if n}
    times = [out["bench3d_stage"], out["bench3d_field"],
             *out["ablate3d"]["ms_per_unit"].values(), *out["probe_mxu_recon"]["ms"].values()]
    if not all(np.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"a script's time is not finite: {times}")
    probe = out["probe_mxu_recon"]
    if max(probe["max_abs_err"].values()) > PROBE_RTOL * probe["max_abs_q"]:
        raise AssertionError(f"the GEMM reconstruction is off: {probe['max_abs_err']}")
    return out


def measurement(device, rates: dict, flop_sizes=None, script_sizes=None) -> dict:
    """Phase 37: ``measurement_parity`` (on the card), the parity checks'
    refusal of the CPU, ``measurement_flops``, ``measurement_roofline`` of
    ``rates`` (env-steps/s of main_path, main_path_3d, main_path_big) and
    ``measurement_scripts``; ``flop_sizes`` and ``script_sizes`` go to
    their parts (the CPU tests' tiny sizes)."""
    start = time.perf_counter()
    out = {"phase": "measurement"}
    if device.type == "cuda":
        out["parity"] = measurement_parity(device)
    out["cpu_refused"] = {}
    for check in (parity.fused_parity_2d, parity.fused_parity_3d):
        try:
            check(num_envs=1, device="cpu")
        except ValueError as e:
            out["cpu_refused"][check.__name__] = str(e)
        if check.__name__ not in out["cpu_refused"].get(check.__name__, ""):
            raise AssertionError(f"{check.__name__} did not refuse the CPU by name")
    out["flops"] = measurement_flops(device, **(flop_sizes or {}))
    out["roofline"] = measurement_roofline(rates)
    out["scripts"] = measurement_scripts(device, **(script_sizes or {}))
    out["seconds"] = time.perf_counter() - start
    return out


# ---------------------------------------------------------------------------
# 3D: the lazy loop's options, fused="stage_qp" and "stage_ew", poisson_precision
# ---------------------------------------------------------------------------


def stage_inputs(case) -> tuple:
    return tuple(case[n] for n in ("u", "v", "w", "b", "q", "bottom"))


def rhat_errors(c, inputs, dt: float, stage: int, g_prev, rhat) -> dict:
    """Max |rhat - rhat64| of ``rhat`` (K3's analysis instance) and of the
    float32 plain version, rhat64 the plain version run in float64 on the
    same inputs (u, v, w, b, q, bottom)."""
    gp64 = None if g_prev is None else tuple(t.double() for t in g_prev)
    ref = k3d.stage_rk_3d_rhat_plain(*(t.double() for t in inputs), c, dt, stage, gp64)[4]
    plain = k3d.stage_rk_3d_rhat_plain(*inputs, c, dt, stage, g_prev)[4]
    return {"kernel": float((rhat.double() - ref).abs().max()),
            "plain_float32": float((plain.double() - ref).abs().max()),
            "max_abs_rhat": float(ref.abs().max())}


def k3_analysis_parity(solver, case, dt=0.04, stages=(0, 1, 2), prefix="") -> tuple:
    """``stages`` of K3's analysis instance against its plain version, each
    stage fed the plain outputs of the one before: u*, v*, w*, b' and g at
    K3's gates, rhat within ``RHAT_VS_PLAIN`` times the float32 plain
    version's own error against the float64 one -> (errors by stage, {check
    (``prefix`` first): (error, bound)})."""
    by_stage, errs, g_prev = {}, {}, None
    stage_case = dict(case)
    for stage in range(max(stages) + 1):
        inputs = stage_inputs(stage_case)
        if stage not in stages:
            plain = k3d.stage_rk_3d_plain(*inputs, solver.coeffs, dt, stage, g_prev)
            stage_case.update(zip("uvwb", plain[:4]), q=solver.solve(plain[4]))
            g_prev = plain[5]
            continue
        got = k3d.stage_rk_3d_rhat(*inputs, solver.coeffs, dt, stage, g_prev)
        want = k3d.stage_rk_3d_rhat_plain(*inputs, solver.coeffs, dt, stage, g_prev)
        fields = abs_diffs("uvwb", got[:4], want[:4])
        g = abs_diffs(G_OUT, got[5], want[5]) if stage < 2 else {}
        rhat = rhat_errors(solver.coeffs, inputs, dt, stage, g_prev, got[4])
        by_stage[f"stage{stage}"] = {**fields, **g, "rhat_vs_plain_float32": float(
            (got[4] - want[4]).abs().max()), "rhat_float64_plain_vs": rhat}
        errs[f"{prefix}stage{stage}_fields"] = (max(fields.values()), K3_FIELD_ATOL)
        if g:
            errs[f"{prefix}stage{stage}_g"] = (max(g.values()), K3_G_ATOL)
        errs[f"{prefix}stage{stage}_rhat"] = (rhat["kernel"],
                                              RHAT_VS_PLAIN * rhat["plain_float32"])
        plain = k3d.stage_rk_3d_plain(*inputs, solver.coeffs, dt, stage, g_prev)
        stage_case.update(zip("uvwb", plain[:4]), q=solver.solve(plain[4]))
        g_prev = plain[5]
    return by_stage, errs


def lazy_options(device, num_envs=1024, state_shape=(16, 32, 32), heater_duration=0.125,
                 seed=0, reps=20, wide_shape=(16, 32, 64), wide_envs=128) -> dict:
    """Phase 38: the lazy loop's options on the training grid at
    ``num_envs``, float32. K3's analysis instance against its plain version at each
    stage (``k3_analysis_parity``), and at stage 1 on ``wide_shape`` at
    ``wide_envs`` (nx = 64, which its first design refused); one env step of
    ``RBC3DVectorEnv(fused="stage_qp")``, ``"stage_ew"`` and
    ``poisson_precision="high"`` and ``"default"`` from the state of
    ``fused="stage"``'s reset, each with its launches counted from zero:
    stage_qp within ``ENV_STEP_3D_ATOL`` of stage (the new instance 39
    launches, K3 none), stage_ew bit for bit stage's, "high" within
    ``ENV_STEP_3D_ATOL`` of "highest" (the default), each with
    ``check_3d``'s checks, "default" finite with its divergence shown; q of
    the three precisions against a float64 solve of a divergence; both
    TF32 flags off afterwards; and CUDA-event times of
    the instance against K3 plus the dense analysis product, and of a
    stage_qp step against a stage step, with both kernels' resident blocks
    an SM, registers and local memory (``k3d.march_occupancy``)."""
    begin = time.perf_counter()
    device = torch.device(device)
    dtype = torch.float32  # the paths are forced, so they run in float32 on any device
    nz, ny, nx = state_shape
    solver, case = make_case_3d(device, num_envs, state_shape, seed=11, dtype=dtype,
                                fused="stage_qp")
    by_stage, errs = k3_analysis_parity(solver, case)
    wide_solver, wide_case = make_case_3d(device, wide_envs, wide_shape, seed=12, dtype=dtype,
                                          fused="stage_qp")
    wide, wide_errs = k3_analysis_parity(wide_solver, wide_case, stages=(1,),
                                         prefix=f"nx{wide_shape[2]}_")
    errs.update(wide_errs)
    del wide_solver, wide_case

    kw = dict(state_shape=state_shape, heater_duration=heater_duration, dtype=dtype,
              device=device)
    envs = {"stage": RBC3DVectorEnv(num_envs, fused="stage", **kw),
            "stage_qp": RBC3DVectorEnv(num_envs, fused="stage_qp", **kw),
            "stage_ew": RBC3DVectorEnv(num_envs, fused="stage_ew", **kw),
            "high": RBC3DVectorEnv(num_envs, fused="stage", poisson_precision="high", **kw),
            "default": RBC3DVectorEnv(num_envs, fused="stage", poisson_precision="default",
                                      **kw)}
    rng = np.random.default_rng(seed)
    action = rng.uniform(-1.0, 1.0, (num_envs, 8, 8))
    state, obs = envs["stage"].reset(seed=seed)
    n_stages = 3 * len(envs["stage"].params.substep_dts())
    steps, launches, checks = {}, {}, {}
    for name, env in envs.items():
        reset_counters()
        nxt, ts = env.step(state, action)
        _sync(device)
        launches[name] = {k: WRAPPERS[k].launches for k in ("stage_rk_3d", "stage_rk_3d_rhat",
                                                             "correct_3d")}
        steps[name] = nxt
        if name == "default":  # one TF32 product a transform: finite, its divergence shown
            if not all(bool(torch.isfinite(t).all()) for t in (*nxt.fields, ts.obs, ts.reward)):
                raise AssertionError("the poisson_precision='default' step is not finite")
            checks[name] = {"max_abs_div": s3d.max_divergence_3d(nxt.fields, env.grid)}
        else:
            checks[name] = check_3d(env, nxt, obs, ts)
    k3 = {"stage_rk_3d": n_stages, "stage_rk_3d_rhat": 0, "correct_3d": 1}
    for name in ("stage", "stage_ew", "high", "default"):
        expect_launches(device, launches[name], k3)
    expect_launches(device, launches["stage_qp"],
                    {"stage_rk_3d": 0, "stage_rk_3d_rhat": n_stages, "correct_3d": 1})

    def step_diff(a, b):
        return abs_diffs(ENV3_OUT, [getattr(steps[a].fields, n) for n in ENV3_OUT],
                         [getattr(steps[b].fields, n) for n in ENV3_OUT])

    diffs = {"stage_qp_vs_stage": step_diff("stage_qp", "stage"),
             "high_vs_highest": step_diff("high", "stage"),
             "default_vs_highest": step_diff("default", "stage")}
    errs["stage_qp_env_step"] = (max(diffs["stage_qp_vs_stage"].values()), ENV_STEP_3D_ATOL)
    errs["high_env_step"] = (max(diffs["high_vs_highest"].values()), ENV_STEP_3D_ATOL)
    stage_ew_equal = all(torch.equal(a, b) for a, b in zip(steps["stage_ew"].fields,
                                                            steps["stage"].fields))
    if not stage_ew_equal:
        raise AssertionError("the stage_ew step is not the stage step bit for bit")

    rhs = k3d.div_3d_plain(case["u"], case["v"], case["w"], solver.coeffs)
    g = solver.grid
    q64 = make_poisson_solver_3d(nx, ny, nz, g.dx, g.dy, g.dz, torch.float64, device)(rhs.double())
    q_errors = {}
    for prec in ("highest", "high", "default"):
        q = make_poisson_solver_3d(nx, ny, nz, g.dx, g.dy, g.dz, dtype, device,
                                   precision=prec)(rhs)
        q_errors[prec] = float((q.double() - q64).abs().max())
    q_errors["max_abs_q"] = float(q64.abs().max())
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    if any(tf32.values()):
        raise AssertionError(f"a TF32 flag is on after the precisions: {tf32}")
    failed = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if failed:
        raise AssertionError(f"lazy-loop option checks failed (error, bound): {failed}")

    times = {}
    if device.type == "cuda":
        analysis = k3d._analysis(nx, nz, dtype, device)
        g_prev = k3d.stage_rk_3d_plain(*stage_inputs(case), solver.coeffs, 0.04, 0)[5]
        div = k3d.stage_rk_3d(*stage_inputs(case), solver.coeffs, 0.04, 0)[4]
        for stage in range(3):
            gp = g_prev if stage else None

            def run(wrapper, gp=gp, stage=stage):
                return wrapper(*stage_inputs(case), solver.coeffs, 0.04, stage, gp)

            work = stage_rk_3d_rhat_work(num_envs, nx, ny, nz, stage)
            bound_ms, bound_by = bound(work)
            rec = {"ms": _cuda_ms(lambda: run(k3d.stage_rk_3d_rhat), reps),
                   "plain_ms": _cuda_ms(lambda: run(k3d.stage_rk_3d_rhat_plain), 3),
                   "k3_ms": _cuda_ms(lambda: run(k3d.stage_rk_3d), reps),
                   "analysis_ms": _cuda_ms(lambda: analysis(div), reps),
                   "bound_ms": bound_ms, "bound_by": bound_by, **work}
            rec["k3_plus_analysis_ms"] = rec["k3_ms"] + rec["analysis_ms"]
            rec["share_of_bound"] = bound_ms / rec["ms"]
            times[f"stage_rk_3d_rhat.stage{stage}"] = rec
        per_stage = [times[f"stage_rk_3d_rhat.stage{m}"] for m in range(3)]
        times["stage_rk_3d_rhat"] = {
            **{k: sum(r[k] for r in per_stage) / 3 for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": per_stage[1]["bound_by"]}
        f = steps["stage"].fields
        a = torch.zeros((num_envs, 8, 8), dtype=dtype, device=device)
        for name in ("stage", "stage_qp"):
            times[f"env_step_{name}_ms"] = _cuda_ms(lambda: envs[name].solver.env_step(f, a), 3)
        times["occupancy"] = {name: k3d.march_occupancy(nx, ny, nz, rhat=rhat)
                              for name, rhat in (("stage_rk_3d_rhat", True),
                                                 ("stage_rk_3d", False))}
    return {"phase": "lazy_options", "num_envs": num_envs,
            "gated": {k: {"error": e, "bound": b} for k, (e, b) in errs.items()},
            "max_abs_err": {"stage_rk_3d_rhat": max(
                max(v for k, v in st.items() if isinstance(v, float)) for st in by_stage.values())},
            "stage_rk_3d_rhat_by_stage": by_stage,
            "stage_rk_3d_rhat_wide": {"shape": list(wide_shape), "num_envs": wide_envs, **wide},
            "env_step_diffs": diffs,
            "stage_ew_equal": stage_ew_equal, "launches": launches, "checks": checks,
            "q_vs_float64": q_errors, "tf32_flags": tf32, "times": times,
            "seconds": time.perf_counter() - begin}


# ---------------------------------------------------------------------------
# 2D: poisson_precision "bf16x3" and "default", K1's TF32 instances
# ---------------------------------------------------------------------------

# K1's instances by the JAX 2D solver's names: the wrapper that counts each,
# and the precision of its solve's products (``ops.kernels2d.K1_PASSES``).
K1_INSTANCES_2D = {"highest": ("env_step_2d", None),
                   "bf16x3": ("env_step_2d_tf32x3", "high"),
                   "default": ("env_step_2d_tf32", "default")}
K1_WRAPPERS = tuple(name for name, _ in K1_INSTANCES_2D.values())


def poisson_precision_2d(device, num_envs=1024, state_shape=(64, 96), observation_shape=(8, 48),
                         few_envs=8,
                         other_shapes=(("runtime", (32, 128)), ("runtime_plain", (40, 128)),
                                       ("cluster", CLUSTER_SHAPE), ("off_chip", (64, 127))),
                         parity_envs=128, n_fixed=4, fixed_steps=20, reps=3) -> dict:
    """Phase 39: the 2D ``poisson_precision`` "bf16x3" and "default", float32.
    From one case of ``num_envs`` on ``state_shape`` (6 substeps), K1's
    split-product instance against its plain version at "high" (K1_ATOL)
    and its one-pass instance against the plain version run in float64
    (``k1_tf32_errors``), both beside float32 K1 and its plain version
    against the same float64 run; the split-product runtime (nz a multiple
    of 32 and not), cluster and off-chip instances on ``other_shapes`` at
    ``few_envs``, and the one-pass cluster instance there too (its gate
    against float64, as above); one env step of ``RBC2DVectorEnv(num_envs,
    poisson_precision=...)`` at each name from one reset, with
    ``check_2d``'s checks (at "default" the divergence within
    K1_TF32_VS_PLAIN times the plain path's own at "default" from the same
    state) and the instance's launch counted (float32 K1's not);
    ``Solver2D.substep`` at "bf16x3" within K1_ATOL of "highest";
    ``utils.parity.fused_parity_2d(poisson_precision="bf16x3")`` (on the
    card; its refusal of the CPU elsewhere); the Ra=1e4 bank's fixed point
    through the split instance (``fixed_point``, ``n_fixed`` episodes,
    ``fixed_steps`` steps); both TF32 flags off afterwards; and, on the
    card, each instance's ``env_step_2d_occupancy`` on ``state_shape`` (at
    96x64 the TF32 instances run their solve on wgmma) and CUDA-event times
    of each at the main path's 50 substeps beside float32 K1 (timed first
    and last), with the plain versions and the bounds."""
    begin = time.perf_counter()
    device = torch.device(device)
    dtype = torch.float32  # the precisions act in float32 only
    gated = {}
    solver, case = make_case(device, num_envs, state_shape, heater_duration=0.18, seed=21,
                             dtype=dtype)
    ref = k1_float64(solver, case)
    runs = {name: (k1_run(solver, case, True, prec), k1_run(solver, case, False, prec))
            for name, (_, prec) in K1_INSTANCES_2D.items()}
    vs_plain = {name: abs_diffs(K1_OUT, got, plain) for name, (got, plain) in runs.items()}
    vs_float64 = {name: {"kernel": max(abs_diffs(K1_OUT, ref, got).values()),
                         "plain_float32": max(abs_diffs(K1_OUT, ref, plain).values())}
                  for name, (got, plain) in runs.items()}
    gated["bf16x3"] = (max(vs_plain["bf16x3"].values()), K1_ATOL)
    one_pass = k1_tf32_errors(solver, case, *runs["default"], ref=ref)
    gated["default"] = (one_pass["kernel"], one_pass["bound"])

    others = {}
    for name, shape in other_shapes:
        nz, nx = shape
        on_chip, cluster = env_step_2d_on_chip(nx, nz), env_step_2d_cluster_size(nx, nz) > 0
        instance = "cluster" if cluster else ("off_chip" if not on_chip else name)
        if instance != name:
            raise AssertionError(f"{shape} does not run K1's {name} instance")
        s, c = make_case(device, few_envs, shape, heater_duration=0.18, seed=22, dtype=dtype)
        err = abs_diffs(K1_OUT, k1_run(s, c, True, "high"), k1_run(s, c, False, "high"))
        others[name] = {"shape": list(shape), "swizzled": on_chip and nz % 32 == 0, **err}
        gated[f"bf16x3_{name}"] = (max(err.values()), K1_ATOL)
        if cluster:  # the one-pass cluster instance, against float64
            one = k1_tf32_errors(s, c, k1_run(s, c, True, "default"))
            others[name]["default_vs_float64"] = one
            gated[f"default_{name}"] = (one["kernel"], one["bound"])

    kw = dict(state_shape=state_shape, observation_shape=observation_shape, dtype=dtype,
              device=device)
    envs = {name: RBC2DVectorEnv(num_envs, poisson_precision=name, **kw)
            for name in K1_INSTANCES_2D}
    rng = np.random.default_rng(0)
    action = rng.uniform(-1.0, 1.0, (num_envs, envs["highest"].params.n_heaters))
    state, _ = envs["highest"].reset(seed=0)
    launches, checks, failures = {}, {}, {}
    for name in ("bf16x3", "default"):
        reset_counters()
        nxt, ts = envs[name].step(state, action)
        _sync(device)
        launches[name] = {k: WRAPPERS[k].launches for k in K1_WRAPPERS}
        div_atol = DIVERGENCE_ATOL[dtype]
        if name == "default":
            # one TF32 pass a product leaves the solve's residual, and so
            # the projected divergence, at TF32's rounding: the plain
            # path's own at "default" from the same state, K1_TF32_VS_PLAIN
            # times (or the float32 gate where that is larger)
            plain = make_solver2d(envs[name].grid, envs[name].params, dtype, device,
                                  fused=False, poisson_precision=name)
            plain_div = max_divergence(plain.env_step(state.fields, action), plain.grid)
            div_atol = max(div_atol, K1_TF32_VS_PLAIN * plain_div)
        try:
            checks[name] = check_2d(envs[name], nxt, ts, div_atol=div_atol)
        except AssertionError as e:
            failures[f"{name}_env_step"] = str(e)
        if name == "default":
            checks.setdefault(name, {})["plain_max_abs_div"] = plain_div
        expect_launches(device, launches[name],
                        {k: int(k == K1_INSTANCES_2D[name][0]) for k in K1_WRAPPERS})
    bottom = envs["highest"].solver.heater_profile(action)
    subs = {name: envs[name].solver.substep(state.fields, bottom) for name in ("highest", "bf16x3")}
    substep_diff = abs_diffs(K1_OUT, [getattr(subs["bf16x3"], n) for n in ("u", "w", "b", "p_nhs")],
                             [getattr(subs["highest"], n) for n in ("u", "w", "b", "p_nhs")])
    gated["substep_bf16x3"] = (max(substep_diff.values()), K1_ATOL)

    if device.type == "cuda":
        err = parity.fused_parity_2d(num_envs=parity_envs, device=device,
                                     poisson_precision="bf16x3", check=False)
        gated["fused_parity_2d_bf16x3"] = (err, parity.ATOL_DEFAULT)
    else:
        try:
            parity.fused_parity_2d(num_envs=1, device=device, poisson_precision="bf16x3")
            raise AssertionError("fused_parity_2d ran on the CPU")
        except ValueError:
            pass

    env = fixed_point_env(n_fixed, ASSETS / "ckpt_ra10000_train.npz", dtype, device,
                          poisson_precision="bf16x3")
    reset_counters()
    band, err = fixed_point(env, fixed_steps)
    fixed = {"path": env.solver.path, "nusselt_band": band, "env_steps": fixed_steps,
             "launches": {k: WRAPPERS[k].launches for k in K1_WRAPPERS}}
    expect_launches(device, fixed["launches"], {"env_step_2d": 0, "env_step_2d_tf32x3":
                                                fixed_steps, "env_step_2d_tf32": 0})
    gated["fixed_point_bf16x3"] = (err, FIXED_POINT_ATOL[torch.float32])

    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    if any(tf32.values()):
        raise AssertionError(f"a TF32 flag is on after the 2D precisions: {tf32}")
    failed = {**failures, **{k: v for k, v in gated.items() if not v[0] <= v[1]}}
    if failed:
        raise AssertionError(f"2D poisson_precision checks failed (error, bound): {failed}; "
                             f"by field against plain: {vs_plain}; against float64: "
                             f"{vs_float64}")

    times, occupancy = {}, {}
    if device.type == "cuda":
        nz, nx = state_shape
        # what the card gives the instances: registers, local and shared bytes
        occupancy = {wrapper: k2d.env_step_2d_occupancy(nx, nz, prec)
                     for wrapper, prec in K1_INSTANCES_2D.values()}
        solver, case = make_case(device, num_envs, state_shape, heater_duration=1.5, seed=2,
                                 dtype=dtype)
        n_sub = solver.params.substeps_per_env_step
        order = ("highest", "bf16x3", "default", "highest")
        for i, name in enumerate(order):
            wrapper, prec = K1_INSTANCES_2D[name]
            ms = _cuda_ms(lambda: k1_run(solver, case, True, prec), reps)
            if i == len(order) - 1:
                times[wrapper]["ms_again"] = ms
                continue
            work = env_step_work(num_envs, nx, nz, n_sub, prec)
            bound_ms, bound_by = bound(work)
            times[wrapper] = {"ms": ms, "plain_ms": _cuda_ms(
                lambda: k1_run(solver, case, False, prec), 1), "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / ms, **work}
    return {"phase": "poisson_precision_2d", "num_envs": num_envs,
            "gated": {k: {"error": e, "bound": b} for k, (e, b) in gated.items()},
            "max_abs_err": {K1_INSTANCES_2D[n][0]: max(vs_plain[n].values())
                            for n in ("bf16x3", "default")},
            "vs_plain_by_field": vs_plain, "vs_float64": vs_float64, "other_instances": others,
            "launches": launches, "checks": checks, "substep_bf16x3_vs_highest": substep_diff,
            "fixed_point_bf16x3": fixed, "tf32_flags": tf32, "times": times,
            "occupancy": occupancy, "seconds": time.perf_counter() - begin}


# ---------------------------------------------------------------------------
# Phase 41: the fine grids, K5's z split and K1's off-chip slabs off the chip
# ---------------------------------------------------------------------------

# 3D: 128x128x128 (nz x ny x nx), whose columns single-CTA K5 cannot hold,
# and 112x64x32. At 128 levels the explicit diffusion's largest rate,
# kappa (4/dx^2 + 4/dy^2 + 4/dz^2), is ~411 at Ra=2500 (~460 at the
# flow-statistics' Ra=2000) and RK3 is stable to 2.51 on the negative
# real axis, so the solver's step must stay under 0.0061 (0.0055). The 3D
# solver's step is dt_solver free-fall times of 4 (dt_solver 0.0025 blew
# up within a substep on the plain path at 128 levels): 0.000625 is a
# step of 0.0025, the rate's product 1.03 (1.15); 25 substeps a heater
# step of 0.015625.
FINE_SHAPE_3D = (128, 128, 128)
FINE_ODD_SHAPE_3D = (112, 64, 32)
FINE_DT_3D = 0.000625
FINE_HEATER_3D = 0.015625
# 2D (nz, nx) with a stable dt_solver and a 30-substep heater step each:
# at Ra=1e4 the same rate, kappa (4/dx^2 + 4/dz^2), is ~275 at 256x128
# (dt_solver <= 0.0091; 0.005 gives 1.38) and ~1,101 at 512x256 (<= 0.0023;
# 0.0015 gives 1.65)
FINE_GRIDS_2D = {(128, 256): (0.005, 0.15), (256, 512): (0.0015, 0.045)}
# K5's z split runs on columns of nz >= 107 levels, where the cases' noise
# (CASE_AMP, second differences over dz = 2 / nz) gives outputs up to
# ~10^3 (div and gw at nz = 112), and one float32 rounding of them is
# ~6e-5: there the float32 plain version itself is ~2e-4 off float64, far
# past K5's gates, and so is single-CTA K5 at nz = 106 (its host build).
# Each output is held against the plain version run in float64 on the same
# inputs, within SPLIT_VS_PLAIN times the float32 plain version's own
# error there, or within K5's gate (K3_FIELD_ATOL, K3_G_ATOL) where that is
# larger (K2's rule).
SPLIT_VS_PLAIN = 4.0
FINE_WRAPPERS_3D = STAGE_WRAPPERS + ("stage_rk_3d_xy_split",)
FINE_WRAPPERS_2D = K1_WRAPPERS + ("env_step_2d_cluster", "env_step_2d_global")


def split_stage_parity(solver, case, prefix=""):
    """Stage 0, 1, 2 of ``stage_rk_3d_xy`` (K5's z split on these columns)
    and of the float32 plain version against the plain version run in
    float64 on the same inputs, each stage fed the float32 plain outputs of
    the one before -> (errors by stage and output, {check: (error, bound)})
    with SPLIT_VS_PLAIN's bounds."""
    def flat(out):
        return (*out[:5], *(out[5] or ()))

    by_stage, errs, g_prev = {}, {}, None
    stage_case = dict(case)
    for stage in range(3):
        got = k3_run(solver, stage_case, stage, g_prev, True, k3d.stage_rk_3d_xy)
        want = k3_run(solver, stage_case, stage, g_prev, False)
        ref = k3_run(solver, {k: v.double() for k, v in stage_case.items()}, stage,
                     None if g_prev is None else tuple(g.double() for g in g_prev), False)
        names = K3_OUT + (G_OUT if stage < 2 else ())
        kernel = abs_diffs(names, flat(ref), flat(got))
        plain = abs_diffs(names, flat(ref), flat(want))
        rec = {"kernel_vs_plain_float32": max(abs_diffs(names, flat(got), flat(want)).values())}
        for n in names:
            gate = K3_G_ATOL if n in G_OUT else K3_FIELD_ATOL
            bound_n = max(gate, SPLIT_VS_PLAIN * plain[n])
            rec[n] = {"kernel": kernel[n], "plain_float32": plain[n], "bound": bound_n}
            errs[f"{prefix}stage{stage}_{n}"] = (kernel[n], bound_n)
        by_stage[f"stage{stage}"] = rec
        stage_case.update(zip("uvwb", want[:4]), q=solver.solve(want[4]))
        g_prev = want[5]
        del got, ref
    return by_stage, errs


def fine_grids(device, envs_3d=16, shape_3d=FINE_SHAPE_3D, odd_envs=64,
               odd_shape=FINE_ODD_SHAPE_3D, dt_3d=FINE_DT_3D, heater_3d=FINE_HEATER_3D, steps=3,
               flowstats_ra=2000, k1_envs=8, k1_shape=(128, 256), k1_substeps=(6, 50),
               grids_2d=FINE_GRIDS_2D, envs_2d=((1024, (128, 256)), (64, (256, 512))),
               observation_shape=(8, 48), timing_envs_2d=1024, reps=3) -> dict:
    """Phase 41: the grids where the JAX package runs its kernels and the
    port used to raise. 3D: K5's z split at each stage against its plain
    version on ``shape_3d`` (``envs_3d``) and ``odd_shape`` (``odd_envs``),
    ``split_stage_parity``; ``RBC3DVectorEnv(envs_3d, shape_3d)`` reset and
    ``steps`` steps (finite, Nu, divergence, the split's launches, K4 one a
    step, single-CTA K5 and K3 none); ``flowstats_ra.perform_experiment``
    at one Ra, one env, ``steps`` steps on that grid. 2D: K1's off-chip
    instance with its slabs in global scratch against its plain version on
    ``k1_shape`` at ``k1_envs`` after 6 (K1_ATOL) and 50 (K1_MAIN_ATOL)
    substeps, and at "bf16x3" and "default" with phase 39's gates;
    ``RBC2DVectorEnv`` on each of ``envs_2d`` (reset, ``steps`` steps,
    ``check_2d``, the instance ``steps`` launches and no other K1
    instance). On the card: both instances' occupancy and CUDA-event times,
    the split's per stage at ``shape_3d``, K1's at ``timing_envs_2d`` on
    ``k1_shape`` (6 substeps), beside their plain versions and bounds."""
    begin = time.perf_counter()
    device = torch.device(device)
    dtype = working_dtype(device)
    gated, out, parts = {}, {"phase": "fine_grids"}, {}
    mark = [begin]

    def part(name):  # the seconds since the last part, under ``name``
        now = time.perf_counter()
        parts[name], mark[0] = now - mark[0], now

    # ---- 3D: K5's z split --------------------------------------------------
    nz, ny, nx = shape_3d
    out["split_ctas"] = {"x".join(map(str, sh)): stage_xy_split_size(sh[0])
                         for sh in (shape_3d, odd_shape)}
    solver, case = make_case_3d(device, envs_3d, shape_3d, seed=41, dt_solver=dt_3d)
    out["path_3d"] = solver.path
    out["split_by_stage"], errs = split_stage_parity(solver, case)
    gated.update(errs)
    solver_odd, case_odd = make_case_3d(device, odd_envs, odd_shape, seed=42, dt_solver=dt_3d)
    out["split_odd_by_stage"], errs = split_stage_parity(solver_odd, case_odd, "odd_")
    gated.update(errs)
    del case_odd
    part("split_parity")

    env = RBC3DVectorEnv(envs_3d, state_shape=shape_3d, dt_solver=dt_3d,
                         heater_duration=heater_3d, dtype=dtype, device=device)
    state, obs, ts, _, rec = drive_3d(env, steps, seed=0, counted=FINE_WRAPPERS_3D)
    n_stages = steps * 3 * len(env.params.substep_dts())
    expect_launches(device, rec["launches"], {"stage_rk_3d": 0, "stage_rk_3d_xy": 0,
                                              "correct_3d": steps,
                                              "stage_rk_3d_xy_split": n_stages})
    out["main_path_3d"] = {**rec, **check_3d(env, state, obs, ts),
                           "substeps_per_step": len(env.params.substep_dts())}
    del env, state, obs, ts
    part("main_path_3d")

    reset_counters()
    start = time.perf_counter()
    record = fs3d.perform_experiment(flowstats_ra, steps, [nz, ny, nx], dt_3d, heater_3d, 1, 0,
                                     str(device))
    _sync(device)
    launches = {k: WRAPPERS[k].launches for k in FINE_WRAPPERS_3D}
    expect_launches(device, launches, {"stage_rk_3d": 0, "stage_rk_3d_xy": 0,
                                       "correct_3d": steps, "stage_rk_3d_xy_split": n_stages})
    nusselt = record["nusselt"]
    if len(nusselt) != steps or not all(NU_RANGE_3D[0] <= n <= NU_RANGE_3D[1] for n in nusselt):
        raise AssertionError(f"flowstats Nu {nusselt} outside {NU_RANGE_3D}")
    _finite_record(record, ("nusselt", "max_u", "max_v", "max_w"))
    out["flowstats_3d"] = {"ra": flowstats_ra, "nusselt": nusselt, "max_w": max(record["max_w"]),
                           "seconds": time.perf_counter() - start, "launches": launches}
    part("flowstats_3d")

    # ---- 2D: K1's off-chip instance with its slabs in global scratch --------
    k1_nz, k1_nx = k1_shape
    if device.type == "cuda" and env_step_2d_slabs_on_chip(k1_nx, k1_nz):
        raise AssertionError(f"{k1_shape} keeps K1's slabs on the chip")
    k1_dt = grids_2d[tuple(k1_shape)][0]
    k1 = {}
    for n_sub, atol in zip(k1_substeps, (K1_ATOL, K1_MAIN_ATOL)):
        s, c = make_case(device, k1_envs, k1_shape, heater_duration=n_sub * k1_dt, seed=43,
                         dtype=torch.float32, dt_solver=k1_dt)
        err = abs_diffs(K1_OUT, k1_run(s, c, True), k1_run(s, c, False))
        k1[f"substeps_{n_sub}"] = err
        gated[f"env_step_2d_global_{n_sub}"] = (max(err.values()), atol)
        if n_sub == k1_substeps[0]:  # the TF32 instances, with phase 39's gates
            err = abs_diffs(K1_OUT, k1_run(s, c, True, "high"), k1_run(s, c, False, "high"))
            k1["bf16x3"] = err
            gated["env_step_2d_global_bf16x3"] = (max(err.values()), K1_ATOL)
            one = k1_tf32_errors(s, c, k1_run(s, c, True, "default"))
            k1["default_vs_float64"] = one
            gated["env_step_2d_global_default"] = (one["kernel"], one["bound"])
        del s, c
    out["env_step_2d_global"] = k1
    part("global_slabs_parity")

    out["main_path_2d"] = {}
    for num_envs, shape in envs_2d:
        dt, heater = grids_2d[tuple(shape)]
        env = RBC2DVectorEnv(num_envs, state_shape=shape, dt_solver=dt, heater_duration=heater,
                             observation_shape=observation_shape, dtype=dtype, device=device)
        rng = np.random.default_rng(1)
        actions = [rng.uniform(-1.0, 1.0, (num_envs, env.params.n_heaters)) for _ in range(steps)]
        state, _ = env.reset(seed=0)
        _sync(device)
        reset_counters()
        start = time.perf_counter()
        for a in actions:
            state, ts = env.step(state, a)
        _sync(device)
        steps_s = time.perf_counter() - start
        launches = {k: WRAPPERS[k].launches for k in FINE_WRAPPERS_2D}
        expect_launches(device, launches, {**dict.fromkeys(FINE_WRAPPERS_2D, 0),
                                           "env_step_2d_global": steps})
        out["main_path_2d"]["x".join(map(str, shape[::-1]))] = {
            "num_envs": num_envs, "dt_solver": dt, "substeps_per_step":
            env.params.substeps_per_env_step, "steps_s": steps_s,
            "env_steps_per_s": num_envs * steps / steps_s, "launches": launches,
            **check_2d(env, state, ts)}
        del env, state, ts
    part("main_path_2d")

    failed = {k: v for k, v in gated.items() if not v[0] <= v[1]}
    if failed:
        raise AssertionError(f"fine-grid checks failed (error, bound): {failed}")
    out["gated"] = {k: {"error": e, "bound": b} for k, (e, b) in gated.items()}
    out["max_abs_err"] = {
        "stage_rk_3d_xy_split": max(e for k, (e, _) in gated.items() if k.startswith("stage")),
        "env_step_2d_global": gated[f"env_step_2d_global_{k1_substeps[-1]}"][0]}
    out["launches"] = {"stage_rk_3d_xy_split": out["main_path_3d"]["launches"],
                       "env_step_2d_global": out["main_path_2d"][
                           "x".join(map(str, envs_2d[0][1][::-1]))]["launches"]}

    times = {}
    if device.type == "cuda":
        out["occupancy"] = {"stage_rk_3d_xy_split": k3d.stage_xy_occupancy(nz),
                            "env_step_2d_global": k2d.env_step_2d_occupancy(k1_nx, k1_nz)}
        g_prev = k3_run(solver, case, 0, None, True, k3d.stage_rk_3d_xy)[5]
        stages = []
        for stage in range(3):
            gp = g_prev if stage else None
            work = stage_rk_3d_work(envs_3d, nx, ny, nz, stage)
            bound_ms, bound_by = bound(work)
            ms = _cuda_ms(lambda: k3_run(solver, case, stage, gp, True, k3d.stage_rk_3d_xy), reps)
            stages.append({"ms": ms, "plain_ms": _cuda_ms(
                lambda: k3_run(solver, case, stage, gp, False), 1), "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / ms, **work})
        times["stage_rk_3d_xy_split"] = {
            **{k: sum(st[k] for st in stages) / 3 for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": stages[1]["bound_by"], "num_envs": envs_3d,
            "by_stage": stages}
        del case, g_prev
        s, c = make_case(device, timing_envs_2d, k1_shape, heater_duration=k1_substeps[0] * k1_dt,
                         seed=45, dtype=torch.float32, dt_solver=k1_dt)
        work = env_step_work(timing_envs_2d, k1_nx, k1_nz, k1_substeps[0])
        bound_ms, bound_by = bound(work)
        ms = _cuda_ms(lambda: k1_run(s, c, True), reps)
        times["env_step_2d_global"] = {
            "ms": ms, "plain_ms": _cuda_ms(lambda: k1_run(s, c, False), 1),
            "bound_ms": bound_ms, "bound_by": bound_by, "num_envs": timing_envs_2d,
            "substeps": k1_substeps[0], **work}
        for rec in times.values():
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        part("timing")
    out["times"] = times
    out["seconds"], out["seconds_by_part"] = time.perf_counter() - begin, parts
    return out


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def kernel_records(parity: dict, launches: dict, times: dict) -> list:
    """One record per kernel: launches from its main path, the gated parity
    error at the main path's shapes, and this run's times and bounds (K2's
    bound is its own function's; ``pallas_bound_ms`` the Pallas kernel's,
    which also reads p_hy)."""
    return [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name],
         "max_abs_err": parity[MAIN_SHAPE_CHECK[name]],
         **{k: times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         **{k: times[name][k] for k in ("pallas_bound_ms",) if k in times[name]}}
        for name in WRAPPERS
    ]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def main() -> int:
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    wall = time.perf_counter()
    emit(phase_build())
    parity = kernel_parity(device)
    emit(parity)
    k2_want = {"grid": "specialised", "runtime_grid": "runtime", "general_grid": "general"}
    if parity["tendencies_2d_instances"] != k2_want:
        raise AssertionError(f"K2 instances {parity['tendencies_2d_instances']}, "
                             f"expected {k2_want}")
    path = main_path(device)
    card = card_line()
    emit({**path, "card": card})
    times = timing(device)
    emit(times)
    parity_3d = kernel_parity_3d(device)
    emit(parity_3d)
    path_3d = main_path_3d(device)
    emit({**path_3d, "card": card})
    times_3d = timing_3d(device)
    emit({**times_3d, "card": card})
    emit(selection(device))
    parity_big = kernel_parity_big(device)
    emit(parity_big)
    path_big = main_path_big(device)
    emit({**path_big, "card": card})
    times_big = timing_big(device)
    emit({**times_big, "card": card})
    parity_field = kernel_parity_field(device)
    emit(parity_field)
    both = {"grid": "march", "odd_grid": "march", "big_grid": "general"}
    if parity_field["k6_instances"] != both:
        raise AssertionError(f"K6 instances {parity_field['k6_instances']}, expected {both}")
    path_field = main_path_field(device)
    emit({**path_field, "card": card})
    times_field = timing_field(device)
    emit({**times_field, "card": card})
    emit({**bank_oracles(device), "card": card})
    emit({**policy_parity(device), "card": card})
    emit({**rl_eval_2d(device), "card": card})
    train_2d = rl_train_2d(device)
    emit({**train_2d, "card": card})
    emit({**policy_parity_3d(device), "card": card})
    emit({**rl_eval_3d(device), "card": card})
    emit({**rl_train_3d(device), "card": card})
    emit({**rl_generalist_2d(device), "card": card})
    emit({**burnin(device), "card": card})
    emit({**flowstats_2d(device), "card": card})
    emit({**flowstats_3d(device), "card": card})
    emit({**probe_2d(device), "card": card})
    emit({**probe_3d(device), "card": card})
    hooks = profiling_hooks(device)
    hooks["beside"] = profiling_beside(times_3d, train_2d)
    emit({**hooks, "card": card})
    emit({**single_env_2d(device), "card": card})
    emit({**single_env_3d(device), "card": card})
    emit({**ablate_actuation_3d(device), "card": card})
    emit({**example_vectorized(device), "card": card})
    emit({**example_timing(device), "card": card})
    emit({**example_ppo_native(device), "card": card})
    emit({**launchers(device), "card": card})
    emit({**multi_rank(device), "card": card})
    rates = {"main_path": path["env_steps_per_s"], "main_path_3d": path_3d["env_steps_per_s"],
             "main_path_big": path_big["env_steps_per_s"]}
    emit({**measurement(device, rates), "card": card})
    options = lazy_options(device)
    emit({**options, "card": card})
    precisions = poisson_precision_2d(device)
    emit({**precisions, "card": card})
    path_cluster = main_path_cluster(device)
    emit({**path_cluster, "card": card})
    fine = fine_grids(device)
    emit({**fine, "card": card})
    tf32 = {"env_step_2d_tf32x3": "bf16x3", "env_step_2d_tf32": "default"}
    # each kernel's launches from the main path that is its own (K4 runs on
    # every 3D path; its count is the training grid's lazy path, its error
    # the larger of the two grids')
    errors = {**parity["max_abs_err"], **parity_3d["max_abs_err"],
              "stage_rk_3d_xy": parity_big["max_abs_err"]["stage_rk_3d_xy"],
              **parity_field["max_abs_err"], **options["max_abs_err"],
              **precisions["max_abs_err"], **fine["max_abs_err"]}
    errors["correct_3d"] = max(errors["correct_3d"], parity_big["max_abs_err"]["correct_3d"])
    field_names = ("field_tendency_3d", "div_3d")
    emit({"kernels": kernel_records(
        errors,
        {**path["launches"], **path_3d["launches"],
         "stage_rk_3d_xy": path_big["launches"]["stage_rk_3d_xy"],
         **{k: path_field["launches"][k] for k in field_names},
         "stage_rk_3d_rhat": options["launches"]["stage_qp"]["stage_rk_3d_rhat"],
         **{k: precisions["launches"][name][k] for k, name in tf32.items()},
         "env_step_2d_cluster": path_cluster["launches"]["env_step_2d_cluster"],
         **{k: fine["launches"][k][k] for k in fine["launches"]}},
        {**times["kernels"], **times_3d["kernels"],
         "stage_rk_3d_xy": times_big["kernels"]["stage_rk_3d_xy"],
         **{k: times_field["kernels"][k] for k in field_names},
         "stage_rk_3d_rhat": options["times"]["stage_rk_3d_rhat"],
         **{k: precisions["times"][k] for k in tf32}, **fine["times"]})})
    emit({"phase": "total", "seconds": time.perf_counter() - wall})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
