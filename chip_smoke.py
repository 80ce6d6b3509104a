#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adaptive_mcmc_tpu_torch) once on an NVIDIA
GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernel sources from csrc/ at the
start, one nvcc process each, all at once.  K2 and K3 have one
instantiation per device potential (csrc/common.cuh): eight schools
noncentered and centered (d = 10), kidiq (d = 4) and diamonds (d = 26).
Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, the nvcc build times, ptxas's registers, stack frame and
   spills of every kernel; the lanes per chain of both K1 kernels at
   (4096, 10) and of each K2/K3 instantiation, and the warps per SM each
   keeps resident at its check's chain count;
2. K1 (csrc/chol_update.cu), its chains-last kernel against its plain
   PyTorch version and its chains-first kernel against the chains-last one
   bit for bit, on the card at (C, d) = (4096, 10), (1024, 26), (37, 5) and
   every d from 1 to 32, the NaN of an indefinite downdate, strict
   triangularity; card times of both kernels, the plain version and
   torch.linalg.cholesky_ex of the re-formed L Lᵀ + coef v vᵀ at
   (4096, 10), (1024, 26), (417792, 10), the batch of 4096 chains x 102
   the SA sampler brings, and the SA path's (1024, 10) and (104448, 10)
   (CUDA events around CUDA-graph replays); then the ARWMH lockstep step's
   kernels (csrc/arwmh_step.cu) against the plain operators they replace
   on the same inputs at (4096, 10) and (100, 26), a NaN potential, a
   rejection by NaN and an update that goes NaN among them: propose within
   the bound of two summation orders, accept -> K1 -> settle bit for bit
   but as_change (within d^2 + 1 ulp), and the card times of each beside
   its plain ops and its bound (each must beat its plain ops at
   (4096, 10));
3. K2 (csrc/arwmh_fused.cu), each instantiation against its plain version
   on injected draws, 16 steps with frames: eight schools noncentered and
   centered at (4096, 10), kidiq at (4096, 4), diamonds at (1024, 26);
   times of both;
4. K3 (csrc/asss_fused.cu), each instantiation against its plain version
   on injected draws, 16 steps with 4 frames at thinning 4: every field
   and frame, and each chain's iteration count exactly: eight schools
   noncentered and centered at (4096, 10), kidiq at (4096, 4), diamonds at
   (1024, 26); its device potential against the target's potential_fn;
   times of both; the bail-out (max_shrinkage_iters=0 stays put bit for
   bit);
5. the ARWMH main path: MCMC(arwmh(eight_schools_noncentered()),
   num_warmup=5000, num_samples=20000, thinning=10, n_chains=4096) with the
   lockstep step (through the step's three kernels and K1, each launched
   once a step, its steps replayed from a CUDA graph) and
   with ARWMHConfig(fused=True) (through K2), and the µs per step of a long
   K2 step_n; before it, the graph run of 500 + 1500 lockstep steps against
   the eager loop from the same seed bit for bit;
6. the ASSS main path: the same MCMC call with
   asss(..., ASSSConfig(fused=True)) (through K3), and the µs per step of a
   long step_n; then the lockstep step and the pipelined step_n (both
   through K1) for 250 + 750 steps from fresh positions under the adapted
   scale of the K3 run; then the pipelined machine from its CUDA graph
   (blocks of GRAPH_ITERS iterations, step_n keeping its graph) against
   the same blocks run eagerly, bit for bit (two step_n calls, then
   collect_n with frames; final state, frames, the generator's next
   draws) on eight schools at 4096 chains and diamonds at 1024; then ASSS's
   lockstep step from its CUDA graphs (the part before the shrinkage loop,
   blocks of kernels/asss.py SHRINK_TRIPS trips, the part after it)
   against the same blocks run eagerly, bit for bit: probe of 250 steps on
   eight schools at 4096 chains with adaptation (final state, mean trips
   per chain, the generator's next draws; K1 launched once per step), and
   a frozen seeded sample_pnx on the mixture at 100000 chains (n = 5)
   against eager=True and the per-trip loop (SHRINK_TRIPS 1); the trial
   of SHRINK_TRIPS (4, 8, 16, 32: host ms per step on eight schools and
   per step of the frozen rollout at d = 1);
7. the slice: MCMC(asss(diamonds(), ASSSConfig(fused=True))) and
   MCMC(arwmh(diamonds(), ARWMHConfig(fused=True))) at 1024 chains through
   K3 and K2, against the PosteriorDB gold draws; kidiq through K3 and K2
   at 4096 chains, against the float64 OLS fit; centered eight schools
   through K3 and K2 (finite draws: its funnel makes a short posterior
   gate unreliable);
   every path: posterior checks, launch counts (all counts set to 0 just
   before the path and read just after it) and chain-iters/s;
   then the diagnostics (no kernel of csrc/ on their path; the counts set
   to 0 before and read after): eight sets of 10000 draws, four from each
   diamonds run, against the gold draws (10000, 26), evaluate_run's shape:
   pth_moment_rmse, mmd_heuristic_many, wasserstein_sinkhorn,
   max_sliced_wasserstein (1000 directions) and the batched ε-auction
   (B = 8, n = m = 10000, cold, then warm-started from its own prices:
   rounds per ε level, the dual certificate (D − P)/n ≤ ε_final in
   float64, a permutation each; every round through the auction kernel:
   its launches and auction.kernel_rounds equal auction.rounds), ms per
   round of the auction kernel against the plain round at block 1024, 128
   and 16 for B = 8 and n = m = 625 and 10000, each beside its bound (the
   bytes it reads over 3.35 TB/s), and before each timing the kernel's
   rounds against the plain round's, bit for bit after each of 48 rounds
   from zero and from solved prices; at n = 1000 the auction from the
   graph against eager=True bit for bit and within ε_final of the port's
   native Hungarian, which equals SciPy's cost, and each metric on the card
   against the CPU (rtol 1e-4); the Lipschitz-NN τ of the AR(1) kernel at
   the estimator's defaults (ρ = 0.5, 0.9 within (0.6ρ, 1.15ρ)), of frozen
   ARWMH and ASSS on N(0, 1) at figures.py's sizes (100 probes x 1000
   samples, 8 batches, 100 steps: rollouts of 100000 chains), the host ms
   of a frozen rollout step from the graph and eagerly, the decay curves
   (n = 1, 4, 16; 10000 samples: τ(P) < 1, ARWMH's last below its first,
   ASSS's every τ below 1) and invariance_ks at 10^6 samples (< 1.5 x the
   null threshold; the wrong-target control > 3 x);
8. SA through K1: the graph run of 100 + 100 steps at 1024 chains against
   the eager loop bit for bit (3 K1 launches per step in both), then
   MCMC(sa(eight_schools_noncentered()), num_warmup=2500,
   num_samples=25000, thinning=10, n_chains=1024) against the quadrature
   truths of mu and log tau, K1 launched 3 x 27500 times; NUTS at 1024
   chains, its machine from the CUDA graph: step_n of 50 then collect_n of
   25 frames at thinning 2 against the eager blocks bit for bit (final
   state, frames, the generator's next draws, trips), the trial of trips
   per graph replay (GRAPH_TRIPS set to 8, 16, 32, 64 in turn),
   MCMC(nuts(eight_schools_noncentered()),
   700 + 500) against the quadrature truths (mean and sd of log tau, mean
   mu; the tau median of every eight-schools run beside the quadrature's)
   and MCMC(nuts(kidiq()), 500 + 500) through the kidiq gate, with
   acceptance, num_steps, divergences, trips, ms per trip, chain-iters/s,
   and no kernel of csrc/ launched; the experiment harness through the
   CLI's functions (adaptive_mcmc_tpu_torch.experiments): run_w_eval of
   the ten W_EVAL_BUDGETS cells at 100 seeds on their default drivers,
   each budget cut by its HARNESS_SCALES entry (the CLI's --scale), NUTS
   at fan_out=16, then diamonds ARWMH and ASSS again through K2 and K3
   (RunConfig.fused, the sweep's --fused) at the same scales, each cell
   through its gate (eight schools: mean mu and mean log tau against the
   quadrature; kidiq: every mean within 0.1 posterior sd of the
   quadrature; diamonds NUTS: diamonds_gate; the four diamonds ARWMH and
   ASSS cells, too short to converge here: the npz's draws and potential
   energies equal bit for bit those of run_mcmc_sharded driven directly
   with the same kernel, seed and budget) with its wall, chain-iters/s,
   driver stamp (collect_n:K2 / collect_n:K3 where fused) and its K1, K2
   or K3 launches; posterior_predictive on the kidiq ARWMH cell's draws
   (y_rep's mean over draws against X @ E[beta] within 3 MC standard
   errors); cross_chain_moments and sharded_gelman_rubin on the eight
   schools ARWMH cell's draws against torch's mean and var and the split
   R-hat at fp32 tolerance; run_lr_decay of centered eight schools ASSS on
   the machine (n_pow 4, one decay) and of centered eight schools ARWMH
   through K2 (n_pow 4, three decays), every summary on the log grid and
   stamped with its driver; evaluate_run on the default drivers' three
   diamonds cells against the gold draws (exact W on 8 seeds in one
   batch, the Hungarian check on seeds 0 and 1, no Sinkhorn column, as
   the sweep grades; seconds per metric column); K2 and K3 at the w_eval
   shape (100 chains, each target's d): µs per step of a timed step_n
   beside its bound per step; the
   checkpointed driver (ARWMH on std_normal(3), 64 chains) interrupted after its first
   chunk and resumed against run_mcmc bit for bit, and
   collect_states_logscale(n_pow=4)'s grid; the port's bench
   (adaptive_mcmc_tpu_torch.bench.main(): five numeric cells);
   one step of entry(); the 16 figure families' data
   (adaptive_mcmc_tpu_torch.analysis.figures, --data-only) at figures.py's
   default sizes on the card: seconds per family, peak device memory,
   every sample_pnx rollout on the CUDA device, K1's launches from
   adaptation_drift, the theory gates (figures.theory_gates: acceptance
   falling with the step size through 0.234, invariance KS under 1.5 x
   its null, frozen ASSS's τ_x(P) on N(0, 1) at most 1 within its
   Monte-Carlo error, E[x_next] on N(0, 1) shrinking toward 0 with n);
   artifact_figures' data over the harness's runs (at the harness's end);
   the multi-process phase (A15; adaptive_mcmc_tpu_torch.parallel over
   torch.distributed, each process this script started again with
   --multi-process-worker, loading the libraries built above): (a) NCCL,
   one process per card (one process, and on a machine of several cards
   all of them): eight schools ARWMH through K1 from its CUDA graph at 4096
   chains a process (500 + 1500 steps, thinning 10) and diamonds ASSS
   through K3 at 1024 (1000 + 1000), each process's block of the gathered
   run_mcmc_sharded draws equal bit for bit to a one-process run of it
   from the rank's generator, the collectives over the mesh against one
   process's on the gathered draws (rtol 1e-6), chain-iters/s per process;
   (b) dryrun_multichip(2) over gloo on the card, then two gloo processes
   sharing card 0: diamonds ARWMH through K2 at 512 chains a process, each
   block against its one-process twin bit for bit, and a seeded frozen
   ASSS sample_pnx at 100000 chains (n = 5) split over the two, each block
   against the one-process eager rollout of it;
   then the host time per step, kernels per step
   (the six largest by device time) and device idle share of the ARWMH
   lockstep step and the SA step, per trip of the NUTS machine, eager
   and from the graph, per auction round from the graph at each block
   width, per step (per iteration) of the ASSS machine from its graph
   beside the eager machine's row of PERF.md §5, of ASSS's lockstep step
   eagerly and from its graphs beside PR 2's row, and of the frozen ASSS
   rollout step at 100000 chains eagerly and from its graphs beside PR 9's
   (torch.profiler; last, because the profiler once on slows every later
   launch of the process);
9. one JSON line of kernel results, one entry per K1 kernel, per K2/K3
   instantiation, for the auction's round and for each of the ARWMH step's
   kernels (with its
   lanes per chain and its bound: the larger of the bytes it must move over
   3.35 TB/s and its float operations over 67 TFLOP/s, counted from the
   check's inputs and, for K3, its iteration counts), then the contract
   line last.
"""

import contextlib
import dataclasses
import importlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

K1_TOL = 1e-5                 # the tolerance of the Pallas parity tests
K2_RTOL, K2_ATOL = 2e-5, 2e-6
# tighter than test_pallas.py's 2e-4 / 2e-5 for the JAX K3: the kernel and
# its plain version round alike
K3_RTOL, K3_ATOL = 2e-5, 2e-6
N_CHAINS, NUM_WARMUP, NUM_SAMPLES, THINNING = 4096, 5000, 20000, 10
# the depths below marked "time" are kept short so that the diagnostics
# phase fits in the script's time
K1_ASSS_WARMUP, K1_ASSS_SAMPLES = 250, 750                      # time
# the graph run against the eager loop, and the profiled windows of each
GRAPH_CHECK_WARMUP, GRAPH_CHECK_SAMPLES = 500, 1500
PROFILE_STEPS = {"eager": 200, "graph": 1000}
# K1's timed shapes: the main path's, diamonds', the batch SA brings at 4096
# chains (x N = max(102, 2d) at d = 10), and the two of the SA path at 1024
# chains: the first update per chain, the next two per candidate
K1_SA_SHAPES = ((1024, 10), (104448, 10))
K1_SHAPES = ((4096, 10), (1024, 26), (417792, 10)) + K1_SA_SHAPES
KERNELS = ("chol_update", "arwmh_fused", "asss_fused", "auction",
           "arwmh_step")
# the slice: ASSS on diamonds through K3, sized from the JAX package's ASSS
# on the CPU (64 chains, pipelined driver), which needed 200000 warmup
# steps before the gold bands held (PERF.md)
SLICE_CHAINS, SLICE_WARMUP, SLICE_SAMPLES = 1024, 300000, 50000
# ARWMH on diamonds through K2, sized from the JAX package's ARWMH on the
# CPU (64 chains, scripts/size_arwmh_diamonds.py; PERF.md)
ARWMH_DIAMONDS_WARMUP, ARWMH_DIAMONDS_SAMPLES = 1000000, 50000
DIAMONDS_MAX_MEAN_ERR = 0.3            # max_k |mean_k - gold_k| / gold_sd_k
DIAMONDS_SD_RATIO = (0.7, 1.4)         # sampled sd / gold sd, every k
KIDIQ_WARMUP, KIDIQ_SAMPLES = 5000, 10000
KIDIQ_MEAN_ERR, KIDIQ_SIGMA_REL = 0.1, 0.03   # in OLS s.e.; of the resid sd
CENTERED_WARMUP, CENTERED_SAMPLES = 2000, 2000
# kidiq posterior sd of log sigma, about (the s.e. of beta come from OLS)
KIDIQ_LOG_SIGMA_SD = 0.035
# the SA path: the bench's SA cell (1024 chains), run as tests/test_sa.py
# runs it, against the 2-D quadrature truths of eight schools
SA_CHAINS, SA_WARMUP, SA_SAMPLES = 1024, 2500, 25000
SA_MU, SA_LOG_TAU, SA_MU_TOL, SA_LOG_TAU_TOL = 4.397, 0.8022, 0.2, 0.15
SA_GRAPH_CHECK_WARMUP, SA_GRAPH_CHECK_SAMPLES = 100, 100
SA_PROFILE_STEPS = {"eager": 50, "graph": 300}
# the NUTS path: the bench's NUTS cell (1024 chains); the graph run against
# the eager blocks; eight schools against the quadrature truths with
# tests/test_nuts.py's bands, kidiq through kidiq_gate; a trial of the
# machine trips per CUDA graph replay; the profiled windows (transitions)
NUTS_CHAINS = 1024
NUTS_CHECK_WARMUP, NUTS_CHECK_STEPS = 100, 50                   # time
NUTS_CHECK_FRAMES, NUTS_CHECK_THINNING = 25, 2                  # time
NUTS_WARMUP, NUTS_SAMPLES = 700, 500
NUTS_KIDIQ_WARMUP, NUTS_KIDIQ_SAMPLES = 250, 250               # time
NUTS_LOG_TAU_TOL, NUTS_SD_LOG_TAU_TOL, NUTS_MU_TOL = 0.045, 0.06, 0.25
NUTS_BLOCK_TRIAL, NUTS_TRIAL_STEPS = (8, 16, 32, 64), 50        # time
# short profiled windows: torch.profiler's processing grows with its events,
# some 360 kernels per trip (a 50-transition window took over a minute)
NUTS_PROFILE_STEPS = {"eager": 2, "graph": 5}                  # time
# the eight-schools tau median of every run, by run
TAU_MEDIANS = {}
# the drivers on the card: ARWMH on std_normal(3) at 64 chains
DRIVER_CHAINS, DRIVER_WARMUP, DRIVER_SAMPLES, DRIVER_CHUNK = 64, 100, 400, 200
# the diagnostics phase: evaluate_run's shape (8 sets of 10000 draws, four
# from each phase-7 diamonds run, against the gold draws); the checks
# against the Hungarian, SciPy, the CPU and eager at DIAG_CHECK_N (Sinkhorn
# and the exact W against the CPU on DIAG_SINKHORN_CPU sets: the CPU's
# Sinkhorn at n = 1000 takes about a second per set); the rounds of the
# auction's profiled window
DIAG_N, DIAG_SETS_PER_RUN, DIAG_FRAMES = 10000, 4, 40
DIAG_CHECK_N, DIAG_SINKHORN_CPU, DIAG_RTOL = 1000, 2, 1e-4          # time
DIAG_DIRECTIONS, DIAG_PROFILED_ROUNDS = 1000, 64
# the auction round's timed shapes (n = m, B = 8) and block widths; the
# counters every round of a solve on the card adds to
AUCTION_ROUND_NS, AUCTION_ROUND_BLOCKS = (625, 10000), (1024, 128, 16)
AUCTION_MATCH_ROUNDS = 48   # rounds of the kernel held to the plain round
AUCTION_COUNTERS = ("auction.rounds", "auction.kernel_rounds")
# the AR(1) kernel (tests/test_contraction.py's band) at the estimator's
# defaults; frozen ARWMH and ASSS at figures.py's sizes; the decay curves;
# invariance at the notebook's size
AR1_RHOS, AR1_SIGMA, AR1_POINTS = (0.5, 0.9), 0.3, 24
FIG_POINTS, FIG_SAMPLES, FIG_BATCHES, FIG_STEPS = 100, 1000, 8, 100
DIAG_TIMED_ROLLOUTS = 20
DECAY_NS, DECAY_SAMPLES = (1, 4, 16), 10_000
INVARIANCE_SAMPLES = 1_000_000
# the ASSS machine from its CUDA graph against its eager blocks: (target,
# chains, steps per step_n call, frames, thinning); the profiled windows
ASSS_GRAPH_CHECKS = (("eight_schools_noncentered", N_CHAINS, 25, 10, 5),
                     ("diamonds", SLICE_CHAINS, 10, 5, 2))
# (torch.profiler's processing grows with its events: 200 diamonds steps
# are some 10^6 kernels and took over a minute; 20 give the same figures
# per iteration)
ASSS_PROFILE_WARMUP, ASSS_PROFILE_STEPS = 100, 20                # time
# the eager machine's row of PERF.md §5 (eight schools, 4096 chains)
ASSS_EAGER_ROW = ("9.2725 ms per step, 2.41 iterations per step, 231.4 "
                  "kernels and 338.98 µs busy per iteration, idle 0.9119")
# ASSS's lockstep step from its CUDA graphs against its eager blocks: probe
# on eight schools with adaptation (K1 chains first), and the frozen seeded
# rollout of the figures on the mixture (probes x samples, steps)
LOCKSTEP_CHECK_STEPS = 250
ROLLOUT_PROBES, ROLLOUT_SAMPLES, ROLLOUT_N = 100, 1000, 5
# the trial of kernels/asss.py SHRINK_TRIPS (shrinkage trips per block):
# eight schools (d = 10) at N_CHAINS chains and the figures' frozen
# rollouts (d = 1) at ROLLOUT_PROBES x ROLLOUT_SAMPLES chains
SHRINK_TRIAL, SHRINK_TRIAL_STEPS, SHRINK_TRIAL_ROLLOUTS = (4, 8, 16, 32), 50, 5
# the profiled windows of ASSS's lockstep step (steps) beside PR 2's eager
# row, and of the frozen ASSS rollout step at 100000 chains beside PR 9's
# (torch.profiler's processing grows with its events, some 1300 kernels a
# step: 20 steps and 5 rollouts give the same figures per step)
ASSS_LOCKSTEP_PROFILE_STEPS = {"eager": 20, "graph": 20}         # time
ROLLOUT_PROFILED = 5                                            # time
ASSS_LOCKSTEP_PR2_ROW = ("19.7806 ms per step, 1337.6 kernels and 1921.79 "
                         "µs busy per step, idle 0.9028 (PR 2, eager)")
ROLLOUT_PR9_ROW = "9.7-13.9 ms per step (PR 9, eager)"
# the figure families' data at figures.py's default sizes (--data-only)
FIGURES_DIR = Path(__file__).resolve().parent / "mcmc_runs" \
    / "chip_smoke_figures"
# the experiment harness: every w_eval cell at 100 seeds on the posterior's
# own d and data, its iteration budget cut by the CLI's --scale (time);
# NUTS fanned out 16 ways as scripts/run_full_sweeps.py does; one lr_decay
# cell; evaluate_run on the diamonds cells (exact W on 8 seeds in one
# batch of 8, the Hungarian check on seeds 0 and 1; no Sinkhorn column,
# 15 s a cell, which the diagnostics phase times at this shape).  A scale
# stays only where its gate held on the card: diamonds NUTS at 0.112 left
# 2 of 100 chains 3 gold sd off (sd ratio up to 1.75), at 0.16 none
HARNESS_SEEDS = 100
HARNESS_SCALES = {                                              # time
    ("eight_schools", "arwmh"): 0.1,
    ("eight_schools", "asss"): 0.2,
    ("eight_schools", "nuts"): 0.016,
    ("eight_schools", "sa"): 0.1,
    ("kidiq", "arwmh"): 0.2,
    ("kidiq", "asss"): 0.2,
    ("kidiq", "nuts"): 0.096,
    ("diamonds", "arwmh"): 0.001,
    ("diamonds", "asss"): 0.0005,
    ("diamonds", "nuts"): 0.16,
}
# diamonds' gold bands need some 10^6 warmup steps of ARWMH and 2 x 10^5 of
# ASSS (PERF.md §4), the w_eval budgets' 10^6 and 5 x 10^5 at --scale 1
# (11 and 5.5 million steps in all): the sweep runs them through K2 and K3
# (its --fused) and grades them against the gold
# (mcmc_runs/torch_h100/results_state.json).  Here these two cells run
# twice at the scales above, too short to converge: on their default
# drivers (the sweep without --fused: the lockstep ARWMH through K1's
# chains-first kernel at d = 26, the ASSS machine through its chains-last
# one), then through K2 and K3 as the sweep's --fused runs them
# (RunConfig.fused).  Their gate is the harness itself: the npz's draws and
# potential energies against run_mcmc_sharded driven directly (the same
# kernel built by hand, a generator of the config's seed, the same
# budget), bit for bit
HARNESS_DIRECT = (("diamonds", "arwmh"), ("diamonds", "asss"))
# lr_decay: one cell on the ASSS machine (K1; one decay, cut from three
# for time) and one through K2 (three decays); (target, kernel, n_pow,
# decays (None: all three), fused)
HARNESS_LR_DECAY = ("eight_schools_centered", "asss", 4, (2.0 / 3.0,), None)
HARNESS_LR_DECAY_K2 = ("eight_schools_centered", "arwmh", 4, None, True)
# K2 and K3 at the w_eval shape (100 chains, each target's d): a timed
# step_n of each, beside its bound per step
W_EVAL_STEPS = {"arwmh_fused": 20000, "asss_fused": 5000}
# posterior_predictive on the harness's kidiq ARWMH draws; the collectives
# on its eight-schools ARWMH draws (fp32 tolerance: |a - b| <= atol + rtol
# |b|)
COLLECTIVE_RTOL, COLLECTIVE_ATOL = 1e-5, 1e-6
HARNESS_EVAL_SEEDS, HARNESS_EVAL_BATCH = 8, 8
# eight schools: tests/test_sa.py's bands on mean mu and mean log tau;
# kidiq: every coordinate's mean within 0.1 posterior sd of the quadrature
HARNESS_MU_TOL, HARNESS_LOG_TAU_TOL, HARNESS_KIDIQ_ERR = 0.2, 0.15, 0.1
HARNESS_DIR = Path(__file__).resolve().parent / "mcmc_runs" / "chip_smoke"
# the multi-process phase (A15): (a) NCCL, one process per card: eight
# schools ARWMH through K1 (chains a process, warmup, samples, thinning)
# and diamonds ASSS through K3; (b) gloo, two processes sharing card 0:
# diamonds ARWMH through K2 and a seeded frozen ASSS sample_pnx at
# ROLLOUT_PROBES x ROLLOUT_SAMPLES chains (n = ROLLOUT_N)
MP_ARWMH = (4096, 500, 1500, 10)
MP_ASSS_DIAMONDS = (1024, 1000, 1000, 10)                       # time
MP_K2_DIAMONDS = (512, 1000, 1000, 10)                          # time
# the collectives over the mesh against one process's on the gathered
# draws: float32 sums taken in another order (exact on one process)
MP_COLLECTIVE_RTOL, MP_COLLECTIVE_ATOL = 1e-6, 1e-7
MP_TIMEOUT = 120.0        # seconds a group of processes may take
MP_WORKER = "--multi-process-worker"
# the TPU kernels the instantiations replace
K2_REPLACES = "adaptive_mcmc_tpu/ops/pallas/arwmh_fused.py:426"
K3_REPLACES = "adaptive_mcmc_tpu/ops/pallas/asss_fused.py:526"
# the auction kernel replaces no Pallas kernel: the JAX round is XLA
AUCTION_REPLACES = "none (adaptive_mcmc_tpu/metrics/assignment.py, XLA)"
K1_REPLACES = "adaptive_mcmc_tpu/ops/pallas/chol_update.py:107"
# the ARWMH lockstep step's kernels replace no Pallas kernel: the JAX step
# is one jitted program; their shapes: the main path's and diamonds' on the
# harness's default driver, the first the kernels line's
STEP_REPLACES = "none (adaptive_mcmc_tpu/kernels/arwmh.py step, XLA)"
STEP_SHAPES = ((4096, 10), (100, 26))
STEP_EPS = 1e-6
STEP_KW = dict(num_warmup=5, lr_decay=2.0 / 3.0, target_accept_prob=0.234,
               adapt=True)
TARGETS = ("eight_schools_noncentered", "eight_schools_centered", "kidiq",
           "diamonds")
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# float operations of one potential evaluation (one per add, multiply,
# division, square root or transcendental), from csrc/common.cuh
POTENTIAL_OPS = {
    "eight_schools_noncentered": 142,    # 14 + 16 per school
    "eight_schools_centered": 143,
    "kidiq": 11 * 434 + 24,              # 11 per data row
    "diamonds": 830,                     # 576 of them in u = Lᵀ(b − b̂)
}


def counted(name: str) -> int:
    """The port's counter ``name`` (utils.profiling) so far."""
    from adaptive_mcmc_tpu_torch.utils import profiling
    return profiling.totals().get(name, 0)


def require(ok, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def device_ms(fn, reps: int, replays: int = 5) -> float:
    """Milliseconds of card time per call of ``fn``: CUDA events around
    replays of a CUDA graph that holds ``reps`` calls, so the host's launch
    cost stays out of the window (a call of the eager plain versions costs
    the host far more than the card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm call outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and bound_by of work that must move nbytes and do ops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rank1_ops(d: int) -> int:
    """The GGMS74-C1 update: 12 per column's scalars, 6 per entry."""
    return 12 * d + 6 * d * (d + 1) // 2


def k1_bound(C: int, d: int) -> dict:
    """The lower triangle of Lt, vt and coef in (the kernel never reads the
    upper triangle), the whole (d, d, C) factor out; 10 per column, 5 per
    entry."""
    tri = d * (d + 1) // 2
    return bound(4 * C * (tri + d + 1 + d * d),
                 C * (10 * d + 5 * tri))


def k2_bound(name: str, C: int, d: int, S: int, F: int,
             n_data: int) -> dict:
    """State in (x, loc, the lower triangle of L, pe, map, lam) and out (x,
    loc, the whole L, pe, map, lam, as), injected draws and data in, frames
    out; per step the proposal, potential, MH test, running means and
    rank-1 update, and as_change on each frame and the last step."""
    tri = d * (d + 1) // 2
    state_in, state_out = 2 * d + tri + 3, 2 * d + d * d + 4
    nbytes = 4 * ((state_in + state_out) * C + S * (d + 1) * C
                  + F * (d + 2) * C + n_data)
    step = (3 * tri + 2 * d) + POTENTIAL_OPS[name] + 15 + 3 * d \
        + rank1_ops(d)
    return bound(nbytes, C * (S * step + (F + 1) * 5 * tri))


def k3_bound(name: str, C: int, d: int, n_steps: int, F: int, iters,
             n_data: int) -> dict:
    """State in (x, loc, the lower triangle of S, pe, as) and out (x, loc,
    the whole S, pe, as, the iteration count), data in, frames out; the
    draws each chain used: 3 uniforms per iteration (this run's iteration
    counts) and d + 1 normals per transition it opened (n_steps).  Per
    iteration the inverse map, potential and slice test; per landing the
    adaptation (rank-1 update, dloc and dS sums) and the next transition's
    projection and velocity."""
    total = int(iters.sum())
    tri = d * (d + 1) // 2
    state_in, state_out = 2 * d + tri + 2, 2 * d + d * d + 3
    nbytes = 4 * ((state_in + state_out) * C + 3 * total
                  + n_steps * (d + 1) * C + F * (d + 2) * C + n_data)
    iteration = 3 * tri + 5 * d + 9 + POTENTIAL_OPS[name]
    land = 6 * d + rank1_ops(d) + 3 * tri + 3
    begin = 3 * d * (d - 1) // 2 + 14 * d + 18
    return bound(nbytes, (total - C) * iteration + C * n_steps * (land + begin))


def chol_inputs(C: int, d: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(C, d, d)) * 0.4
    L = np.linalg.cholesky(np.einsum("cij,ckj->cik", a, a) + np.eye(d))
    Lt = torch.tensor(L.transpose(1, 2, 0), dtype=torch.float32, device=dev)
    vt = torch.tensor(rng.normal(size=(d, C)), dtype=torch.float32,
                      device=dev)
    coef = torch.tensor(np.linspace(0.01, 0.9, C), dtype=torch.float32,
                        device=dev)
    return Lt.contiguous(), vt, coef


def k1_times(k1, dev, C: int, d: int, card: str) -> dict:
    """Card times at (C, d): both kernels, the plain version and the
    library's way to the same factor, Cholesky of the re-formed
    L Lᵀ + coef v vᵀ (the port never calls it); one result per layout."""
    Lt, vt, coef = chol_inputs(C, d, seed=0, dev=dev)
    L, v = Lt.permute(2, 0, 1).contiguous(), vt.t().contiguous()
    reps = 100 if C * d * d < 10_000_000 else 10
    first_ms = device_ms(lambda: k1.chol_update(L, v, coef), reps)
    last_ms = device_ms(lambda: k1.chol_update_cl(Lt, vt, coef), reps)
    plain_ms = device_ms(
        lambda: k1.chol_update_cl_reference(Lt, vt, coef), reps // 10)
    A = (L @ L.transpose(1, 2)
         + coef[:, None, None] * v[:, :, None] * v[:, None, :]).contiguous()
    lib_err = float((torch.linalg.cholesky_ex(A).L
                     - k1.chol_update(L, v, coef)).abs().max())
    library_ms = device_ms(lambda: torch.linalg.cholesky_ex(A), reps // 10)
    b = k1_bound(C, d)
    print(f"K1 ({C}, {d}): chains first {first_ms:.6f} ms, chains last "
          f"{last_ms:.6f} ms, plain {plain_ms:.6f} ms, "
          f"torch.linalg.cholesky_ex {library_ms:.6f} ms (max abs difference "
          f"{lib_err:.3e}), bound {b['bound_ms']:.6f} ms by {b['bound_by']} "
          f"on {card}")
    return {layout: {"ms": ms, "plain_ms": plain_ms, **b,
                     "library_ms": library_ms}
            for layout, ms in (("first", first_ms), ("last", last_ms))}


def check_k1(k1, dev, card: str) -> dict:
    """Both K1 kernels against their plain versions, and against each other
    bit for bit; returns the kernels-line results of the chains-first and
    the chains-last kernel at the main path's (4096, 10), each with its own
    worst error over every shape checked."""
    worst = {"first": 0.0, "last": 0.0}
    main_shapes = [(4096, 10), (1024, 26), (37, 5), *K1_SA_SHAPES]
    for C, d in main_shapes + [(37, d) for d in range(1, 33) if d != 5]:
        Lt, vt, coef = chol_inputs(C, d, seed=C + d, dev=dev)
        got = k1.chol_update_cl(Lt, vt, coef)
        L, v = Lt.permute(2, 0, 1).contiguous(), vt.t().contiguous()
        first = k1.chol_update(L, v, coef)
        want = k1.chol_update_cl_reference(Lt, vt, coef)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_first = float(
            (first - k1.chol_update_reference(L, v, coef)).abs().max())
        require(err <= K1_TOL, f"K1 disagrees at C={C} d={d}: {err}")
        require(err_first <= K1_TOL,
                f"K1 chains-first disagrees at C={C} d={d}: {err_first}")
        require(torch.equal(first, got.permute(2, 0, 1)),
                f"K1 chains-first differs from chains-last at C={C} d={d}")
        upper = torch.triu(first, diagonal=1)
        require(bool((upper == 0).all()), f"K1 not triangular at d={d}")
        require(bool((torch.diagonal(got, 0, 0, 1) > 0).all()),
                f"K1 diagonal not positive at d={d}")
        worst = {"first": max(worst["first"], err_first),
                 "last": max(worst["last"], err)}
        if (C, d) in main_shapes:
            print(f"K1 C={C} d={d}: max_abs_err chains last {err:.3e}, "
                  f"chains first {err_first:.3e}, chains first equals "
                  f"chains last bit for bit")
    # an indefinite downdate gives NaN where the plain version does
    d, C = 4, 128
    Lt = torch.eye(d, device=dev)[:, :, None].expand(d, d, C).contiguous()
    vt = torch.zeros((d, C), device=dev)
    vt[0] = 10.0
    coef = torch.full((C,), -1.0, device=dev)
    want = k1.chol_update_cl_reference(Lt, vt, coef)
    for got in (k1.chol_update_cl(Lt, vt, coef),
                k1.chol_update(Lt.permute(2, 0, 1).contiguous(),
                               vt.t().contiguous(), coef).permute(1, 2, 0)):
        require(bool(torch.isnan(got).any()), "K1 downdate gave no NaN")
        require(torch.equal(torch.isnan(got), torch.isnan(want)),
                "K1 NaN pattern differs from the plain version")
    times = {shape: k1_times(k1, dev, *shape, card) for shape in K1_SHAPES}
    return {layout: {"max_abs_err": worst[layout], **res}
            for layout, res in times[K1_SHAPES[0]].items()}


def step_inputs(C: int, d: int, seed: int, dev) -> dict:
    """A state and a proposal's results at (C, d) for the ARWMH step's
    kernels: chol_inputs' factors, a NaN potential in chain 0's state, a
    NaN proposed potential in chain 1 (a rejection) and in chain 2 a mean
    at +inf, whose rank-1 update goes NaN (the guard keeps the factor)."""
    Lt, _, _ = chol_inputs(C, d, seed, dev)
    g = torch.Generator(dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)
    p = dict(x=normal(C, d), pe=normal(C).abs() * 5, x_prop=normal(C, d),
             pe_prop=normal(C).abs() * 5,
             u=torch.rand((C,), generator=g, device=dev),
             mean_ap=torch.rand((C,), generator=g, device=dev),
             loc=normal(C, d), L=Lt.permute(2, 0, 1).contiguous(),
             log_lam=normal(C) * 0.5, z=normal(C, d))
    p["pe"][0] = float("nan")
    p["pe_prop"][1] = float("nan")
    p["loc"][2] = float("inf")
    p["pe_prop"][2] = -1.0          # accepted: delta = x' - inf
    return p


def float_ulps(a, b) -> int:
    """The largest distance in units of the last place between two float32
    tensors of finite entries."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def check_step_kernels(ks, ka, k1, dev, card: str) -> dict:
    """The ARWMH lockstep step's kernels (csrc/arwmh_step.cu) against the
    plain operators they replace (kernels/arwmh.py propose_plain,
    accept_plain, settle_plain) on the same card inputs, at STEP_SHAPES:
    propose within the bound of two orders of a float32 sum of d products
    (the plain version is a cuBLAS gemv), accept -> K1 -> settle bit for bit
    before and after the warmup's clock reset but as_change (a sum of d^2
    squares in the kernel's own order: within d^2 + 1 units in the last
    place, its non-finite entries alike); then card times of each beside
    its plain ops and its bound.  Returns the kernels-line results at the
    main path's (4096, 10)."""
    u = 2.0 ** -24
    out = {}
    for C, d in STEP_SHAPES:
        p = step_inputs(C, d, seed=C + d, dev=dev)
        got = ks.propose(p["x"], p["L"], p["log_lam"], p["z"], STEP_EPS)
        want = ka.propose_plain(p["x"], p["L"], p["log_lam"], p["z"],
                                STEP_EPS)
        P = p["L"].double() * p["log_lam"].double().exp()[:, None, None] \
            + STEP_EPS * torch.eye(d, device=dev, dtype=torch.float64)
        terms = (P.abs() * p["z"].double().abs()[:, None, :]).sum(-1)
        diff = (got.double() - want.double()).abs()
        require(bool((diff <= 2 * (d + 1) * u * terms
                      + 2 * u * want.double().abs()).all()),
                f"arwmh_propose at ({C}, {d}) off the plain proposal by "
                f"{float(diff.max()):.3e}")
        errs = {"propose": float(diff.max()), "accept": 0.0, "settle": 0.0}
        ulps = 0
        for clock in (2, 9):
            i = torch.full((), clock, dtype=torch.int32, device=dev)
            tails = []
            for accept, settle in ((ks.accept, ks.settle),
                                   (ka.accept_plain, ka.settle_plain)):
                a = accept(p["x"], p["pe"], p["x_prop"], p["pe_prop"],
                           p["u"], p["mean_ap"], i, p["loc"], p["L"],
                           p["log_lam"], **STEP_KW)
                tails.append((a, settle(
                    p["L"], k1.chol_update(a.scaled, a.delta, a.gamma),
                    p["log_lam"], a.log_step_size, i)))
            (a, s), (a0, s0) = tails
            for name, x, y in [*zip(a._fields, a, a0),
                               *zip(("scale", "clock"), s[::2], s0[::2])]:
                require(torch.equal(x.contiguous().view(torch.int32),
                                    y.contiguous().view(torch.int32)),
                        f"arwmh step kernels at ({C}, {d}), clock {clock}: "
                        f"{name} differs from the plain operators")
            fin = torch.isfinite(s0[1])
            require(torch.equal(torch.isfinite(s[1]), fin),
                    f"as_change's non-finite entries at ({C}, {d})")
            ulps = max(ulps, float_ulps(s[1][fin], s0[1][fin]))
            errs["settle"] = max(errs["settle"], float(
                (s[1][fin] - s0[1][fin]).abs().max()))
        require(ulps <= d * d + 1,
                f"as_change at ({C}, {d}) {ulps} ulp off the plain norm")
        i = torch.full((), 9, dtype=torch.int32, device=dev)
        acc = ks.accept(p["x"], p["pe"], p["x_prop"], p["pe_prop"], p["u"],
                        p["mean_ap"], i, p["loc"], p["L"], p["log_lam"],
                        **STEP_KW)
        updated = k1.chol_update(acc.scaled, acc.delta, acc.gamma)
        vec, one, fac = C * d, C, C * d * d
        cases = {
            # (the call, its plain version, floats read and written once
            # (the clock's int32 as one), float operations)
            "propose": (lambda f: f(p["x"], p["L"], p["log_lam"], p["z"],
                                    STEP_EPS),
                        ks.propose, ka.propose_plain, 3 * vec + fac + one,
                        vec * (4 * d + 1) + one),
            "accept": (lambda f: f(p["x"], p["pe"], p["x_prop"],
                                   p["pe_prop"], p["u"], p["mean_ap"], i,
                                   p["loc"], p["L"], p["log_lam"],
                                   **STEP_KW),
                       ks.accept, ka.accept_plain,
                       6 * vec + 9 * one + 2 * fac + 1,
                       one * 16 + 4 * vec + fac),
            "settle": (lambda f: f(p["L"], updated, p["log_lam"],
                                   acc.log_step_size, i),
                       ks.settle, ka.settle_plain, 3 * fac + 3 * one + 2,
                       7 * fac + 2 * one),
        }
        for name, (call, kernel, plain, floats, ops) in cases.items():
            ms = device_ms(lambda: call(kernel), 100)
            plain_ms = device_ms(lambda: call(plain), 100)
            b = bound(4 * floats, ops)
            print(f"arwmh_{name} ({C}, {d}): kernel {ms:.6f} ms, plain ops "
                  f"{plain_ms:.6f} ms ({plain_ms / ms:.1f}x), bound "
                  f"{b['bound_ms']:.6f} ms by {b['bound_by']} "
                  f"({4 * floats / 1e6:.3f} MB), max abs error against "
                  f"the plain ops {errs[name]:.3e} on {card}")
            if (C, d) == STEP_SHAPES[0]:
                require(ms < plain_ms, f"arwmh_{name} slower than the plain "
                        f"ops it replaces at ({C}, {d})")
                out[name] = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": errs[name], **b}
        print(f"arwmh step kernels ({C}, {d}): propose within its bound of "
              f"the plain proposal, accept -> K1 -> settle equal to the "
              f"plain operators bit for bit but as_change, {ulps} ulp off")
    return out


def gold_draws(amt) -> np.ndarray:
    """The PosteriorDB gold draws of diamonds (10000, 26), flat
    unconstrained, float64 (vendored in the port's ``models/_data``)."""
    return np.load(amt.models.data.DATA_DIR
                   / "diamonds.npy").astype(np.float64)


def kidiq_ols(amt):
    """float64 OLS fit of the kidiq data: (b̂, standard errors, residual
    sd).  Under the flat prior on beta the posterior mean of beta is b̂."""
    d = amt.models.data.kidiq()
    X = np.stack([np.ones(len(d["kid_score"])), d["mom_hs"], d["mom_iq"]],
                 axis=1).astype(np.float64)
    y = d["kid_score"].astype(np.float64)
    xtx = X.T @ X
    b_hat = np.linalg.solve(xtx, X.T @ y)
    r = y - X @ b_hat
    s2 = (r @ r) / (len(y) - X.shape[1])
    return b_hat, np.sqrt(np.diag(np.linalg.inv(xtx)) * s2), np.sqrt(s2)


def start_state(amt, name: str, C: int, g, dev):
    """(x, loc, lower factor) of a kernel check.  Eight schools: uniform
    (-2, 2) positions, loc x and the identity.  Kidiq and diamonds: where
    the posterior puts its mass, under a factor of its size, as after
    warmup (from uniform positions the 16 steps barely move them)."""
    t = getattr(amt, name)()
    d = t.dim
    if name.startswith("eight_schools"):
        x = torch.rand((C, d), generator=g, device=dev) * 4 - 2
        return x, x.clone(), torch.eye(d, device=dev).expand(C, d, d)
    if name == "kidiq":
        b_hat, se, s = kidiq_ols(amt)
        mean = np.append(b_hat, np.log(s))
        sd = np.append(se, KIDIQ_LOG_SIGMA_SD)
        S = np.diag(sd)
    else:
        gold = gold_draws(amt)
        mean, S = gold.mean(0), np.linalg.cholesky(np.cov(gold.T))
        sd = np.sqrt(np.diag(np.cov(gold.T)))
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    x = mean_t + torch.randn((C, d), generator=g, device=dev) \
        * torch.tensor(sd, dtype=torch.float32, device=dev)
    S_t = torch.tensor(S, dtype=torch.float32, device=dev)
    return x, mean_t.expand(C, d).clone(), S_t.expand(C, d, d)


def check_device_potential(k3, t, x) -> float:
    """The target's __device__ potential against its potential_fn on the
    card at the rows of x; returns the max abs difference."""
    got, want = k3.device_potential(t, x), t.potential_fn(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)
    return float((got.double() - want.double()).abs().max())


def check_k2(amt, k2, dev, name: str, C: int) -> dict:
    t = getattr(amt, name)()
    cfg = amt.ARWMHConfig(num_warmup=4)
    S, d = 16, t.dim
    g = torch.Generator(dev).manual_seed(123)
    x, loc, L = start_state(amt, name, C, g, dev)
    state = (x, t.potential_fn(x), torch.zeros(C, device=dev), loc,
             L.contiguous(), torch.zeros(C, device=dev), 0)
    noise = torch.randn((S, C, d), generator=g, device=dev)
    unif = torch.rand((S, C), generator=g, device=dev)
    drive = k2.build_fused_arwmh(t, cfg)

    def kernel():
        return drive(state, S, 4, 4, noise=noise, unif=unif)

    def plain():
        return k2.fused_arwmh_reference(t, cfg, state, S, 4, 4,
                                        noise=noise, unif=unif)

    (got, gf), (want, wf) = kernel(), plain()
    torch.cuda.synchronize()
    require(int(got[6]) == int(want[6]) == S, "K2 step counter")
    pairs = list(zip(got[:6], want[:6])) + [(got[7], want[7])] \
        + [(gf[k], wf[k]) for k in wf]
    worst = 0.0
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=K2_RTOL, atol=K2_ATOL)
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    moved = (got[0] != state[0]).any(dim=1).float().mean()
    require(float(moved) > 0.5, f"K2 {name}: only {float(moved)} moved")
    print(f"K2 {name} C={C} d={d} S={S}: max_abs_err={worst:.3e}, "
          f"chains moved {float(moved):.3f}")
    ms = device_ms(kernel, 10)
    plain_ms = device_ms(plain, 1)
    print(f"K2 {name} ({C}, d={d}, 16 steps): kernel {ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms")
    n_data = t.data.on(dev)["kernel_data"].numel()
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **k2_bound(name, C, d, S, 4, n_data), "library_ms": None}


def check_k3(amt, k3, dev, name: str, C: int) -> dict:
    t = getattr(amt, name)()
    cfg = amt.ASSSConfig(num_warmup=8)
    n_steps, F, thin, d = 16, 4, 4, t.dim
    g = torch.Generator(dev).manual_seed(321)
    x, loc, S = start_state(amt, name, C, g, dev)
    state = (x, t.potential_fn(x), loc, S.contiguous(), 0,
             torch.zeros(C, device=dev))
    rows = 1024
    unif3 = torch.rand((rows, 3, C), generator=g, device=dev) \
        .clamp_(1e-6, 1 - 1e-6)
    n01 = torch.randn((rows, d + 1, C), generator=g, device=dev)
    drive = k3.build_fused_asss(t, cfg)
    _, _, iters0 = drive(state, n_steps, F, thin, unif3=unif3, n01=n01,
                         return_iters=True)
    used = int(iters0.max())
    require(used <= rows, f"K3 ran {used} iterations past {rows} draw rows")
    # time and compare on exactly the rows the longest chain used
    u3, nn = unif3[:used].contiguous(), n01[:used].contiguous()

    def kernel():
        return drive(state, n_steps, F, thin, unif3=u3, n01=nn,
                     return_iters=True)

    def plain():
        return k3.fused_asss_reference(t, cfg, state, n_steps, F, thin,
                                       unif3=u3, n01=nn, return_iters=True)

    (got, gf, gi), (want, wf, wi) = kernel(), plain()
    torch.cuda.synchronize()
    require(torch.equal(gi, wi) and torch.equal(gi, iters0),
            f"K3 {name}: iteration counts differ from the plain version's")
    require(int(got[4]) == int(want[4]) == n_steps, "K3 step counter")
    pairs = [(got[k], want[k]) for k in (0, 1, 2, 3, 5)] \
        + [(gf[k], wf[k]) for k in wf]
    worst = 0.0
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=K3_RTOL, atol=K3_ATOL)
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    require(torch.equal(gf["position"][:, -1], got[0]),
            "K3 last frame is not the final state")
    moved = (got[0] != state[0]).any(dim=1).float().mean()
    require(float(moved) > 0.5, f"K3 {name}: only {float(moved)} moved")
    pot_err = max(check_device_potential(k3, t, x),
                  check_device_potential(k3, t, got[0]))
    print(f"K3 {name} C={C} d={d} {n_steps} steps: max_abs_err={worst:.3e}, "
          f"iterations per chain {float(gi.float().mean()):.2f} mean, "
          f"{int(gi.min())}..{used}, chains moved {float(moved):.3f}; "
          f"device potential vs potential_fn max abs {pot_err:.3e}")
    ms = device_ms(kernel, 10)
    plain_ms = device_ms(plain, 1)
    print(f"K3 {name} ({C}, d={d}, 16 steps, {used} draw rows): kernel "
          f"{ms:.6f} ms, plain {plain_ms:.6f} ms")
    if name == "eight_schools_noncentered":
        check_k3_bailout(amt, k3, t, state, g)
    n_data = t.data.on(dev)["kernel_data"].numel()
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **k3_bound(name, C, d, n_steps, F, gi, n_data),
            "library_ms": None}


def check_k3_bailout(amt, k3, t, state, g) -> None:
    """With max_shrinkage_iters=0 every transition stays put."""
    bail = k3.build_fused_asss(t, amt.ASSSConfig(max_shrinkage_iters=0))
    out, frames, iters = bail(state, 8, 2, 4, generator=g,
                              return_iters=True)
    torch.cuda.synchronize()
    require(torch.equal(out[0], state[0]) and torch.equal(out[1], state[1]),
            "K3 bail-out moved a chain")
    require(torch.equal(frames["position"][:, -1], state[0]),
            "K3 bail-out frame")
    require(int(out[4]) == 8 and bool((iters == 9).all()),
            "K3 bail-out step or iteration count")
    print("K3 bail-out: positions unchanged bit for bit, i advanced by 8")


def reset_launches(*modules) -> None:
    for m in modules:
        m.launches = 0


def eight_schools_bands(name: str, sites) -> None:
    mu_mean = float(sites["mu"].mean())
    tau_median = float(sites["tau"].median())
    TAU_MEDIANS[name] = tau_median
    print(f"{name}: mu mean {mu_mean:.4f}, tau median {tau_median:.4f}")
    require(abs(mu_mean - 4.4) < 0.3, f"{name}: mu mean {mu_mean}")
    require(abs(tau_median - 2.9) < 0.4, f"{name}: tau median {tau_median}")


def run_main_path(amt, fused: bool, card: str):
    """The ARWMH main path through K1 (lockstep) or K2 (fused); returns
    (rate, last state)."""
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.arwmh(t, amt.ARWMHConfig(fused=fused)),
                    num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
                    thinning=THINNING, n_chains=N_CHAINS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mcmc.print_summary()
    print(mcmc.diagnostics_str())
    draws = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    require(draws.is_pinned(), "draws not in pinned host memory")
    require(tuple(draws.shape) == (NUM_SAMPLES // THINNING, N_CHAINS, t.dim),
            f"draws shape {tuple(draws.shape)}")
    require(bool(torch.isfinite(draws).all()), "non-finite draws")
    accept = float(mcmc.last_state.mean_accept_prob.mean())
    name = "ARWMH fused (K2)" if fused else "ARWMH lockstep (K1, graph)"
    rate = N_CHAINS * (NUM_WARMUP + NUM_SAMPLES) / wall
    eight_schools_bands(name, mcmc.get_samples())
    print(f"{name}: mean acceptance {accept:.4f}")
    print(f"{name}: {rate:.1f} chain-iters/s ({N_CHAINS} chains x "
          f"{NUM_WARMUP + NUM_SAMPLES} steps in {wall:.3f} s, build "
          f"excluded) on {card}")
    require(0.15 < accept < 0.35, f"mean acceptance {accept}")
    return rate, mcmc.last_state


def check_graph_equals_eager(amt, k1) -> None:
    """run_mcmc of the ARWMH lockstep step at full width from the CUDA
    graph and from the eager loop, same seed, same init_state: draws and
    last state bit for bit, init_state untouched, K1 counted once per step
    in both, and successive frames different."""
    t = amt.eight_schools_noncentered()
    from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors
    W, N = GRAPH_CHECK_WARMUP, GRAPH_CHECK_SAMPLES
    kernel = amt.arwmh(t, amt.ARWMHConfig(num_warmup=W))
    init = kernel.init(torch.Generator("cuda").manual_seed(11),
                       n_chains=N_CHAINS)
    kept = [x.clone() for x in state_tensors(init)]
    runs = {}
    for eager in (True, False):
        k1.launches = 0
        g = torch.Generator("cuda").manual_seed(12)
        samples, extras, last = amt.run_mcmc(
            kernel, g, W, N, thinning=THINNING, n_chains=N_CHAINS,
            init_state=init, extra_fields=("potential_energy",), eager=eager)
        torch.cuda.synchronize()
        runs[eager] = (samples, extras["potential_energy"],
                       state_tensors(last), k1.launches,
                       torch.rand(8, generator=g, device="cuda"))
    e, gr = runs[True], runs[False]
    require(e[3] == gr[3] == W + N,
            f"K1 launches: eager {e[3]}, graph {gr[3]}, steps {W + N}")
    require(torch.equal(e[0], gr[0]) and torch.equal(e[1], gr[1]),
            "graph run's draws differ from the eager loop's")
    require(all(torch.equal(a, b) for a, b in zip(e[2], gr[2])),
            "graph run's last state differs from the eager loop's")
    require(torch.equal(e[4], gr[4]),
            "the generator stands elsewhere after the graph run")
    require(all(torch.equal(a, b)
                for a, b in zip(state_tensors(init), kept)),
            "run_mcmc wrote into the caller's init_state")
    frames = gr[0]
    moved = (frames[1:] != frames[:-1]).any(dim=2).float().mean()
    require(float(moved) > 0.1, f"successive frames repeat: {float(moved)}")
    print(f"ARWMH lockstep graph run equals the eager run bit for bit: "
          f"{N // THINNING} frames of {N_CHAINS} chains, last state, the "
          f"generator's next draws; init_state untouched; K1 launches "
          f"{gr[3]} = steps in both; chains moved between frames "
          f"{float(moved):.3f}")


def profile_lockstep(kernel, label: str, n_chains: int, steps: int,
                     eager: bool, card: str) -> dict:
    """Host time per step of ``kernel``'s lockstep step (host clock around
    a synchronised window, no profiler), then the same, kernels per step
    and device busy per step of a second window under torch.profiler.  The
    idle share is measured in the profiled window alone: 1 - busy / host
    time, both of that window.  Beside it stands an estimate, not a
    measurement: the profiled window's busy time against the first
    window's host time, which is the idle share without the profiler if the
    kernels take the same time in both."""
    from torch.profiler import ProfilerActivity, profile
    from adaptive_mcmc_tpu_torch.infer.mcmc import advancer
    name = "eager" if eager else "graph"
    g = torch.Generator("cuda").manual_seed(21)
    state = kernel.init(g, n_chains=n_chains)
    # the CUDA graph run_mcmc takes: StepBlocks of THINNING steps, or the
    # lockstep parts of a step with an inner loop (ASSS)
    drive = advancer(kernel, g, state, THINNING, eager)

    def advance(n):
        nonlocal state
        state = drive(state, n)
    advance(10 * THINNING)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    advance(steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance(steps)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    n_kernels, busy_us = device_activity(prof, f"{label} {name}", steps,
                                         "step")
    out = {"host_ms": host_ms, "traced_ms": traced_ms,
           "kernels": n_kernels / steps, "busy_us": busy_us / steps,
           "idle": 1.0 - busy_us / steps / (traced_ms * 1e3),
           "idle_unprofiled": 1.0 - busy_us / steps / (host_ms * 1e3)}
    print(f"{label} {name}, {steps} steps at {n_chains} chains: host "
          f"time per step {out['host_ms']:.4f} ms ({out['traced_ms']:.4f} "
          f"under the profiler), kernels per step {out['kernels']:.1f}, "
          f"device busy per step {out['busy_us']:.2f} µs, device idle share "
          f"{out['idle']:.4f}, measured in the profiled window (estimate "
          f"without the profiler, busy time of that window over the host "
          f"time of the other: {out['idle_unprofiled']:.4f}) on {card}")
    return out


def device_activity(prof, label: str, per: int, unit: str) -> tuple:
    """(kernels, device busy µs) of a torch.profiler window, and its six
    largest kernels by device time, per ``unit`` (``per`` of them)."""
    n_kernels, busy_us, by_name = 0, 0.0, []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None) \
                or getattr(ev, "self_cuda_time_total", 0.0)
            n_kernels += ev.count
            busy_us += us
            by_name.append((us, ev.count, ev.key))
    for us, count, key in sorted(by_name, reverse=True)[:6]:
        print(f"{label}: {us / per:.2f} µs and {count / per:.1f} "
              f"launches per {unit} in {key[:90]}")
    require(n_kernels > 0 and busy_us > 0,
            "torch.profiler recorded no device activity")
    return n_kernels, busy_us


def profile_pair(label: str, kernel, n_chains: int, steps: dict,
                 card: str) -> None:
    """profile_lockstep eager and from the graph, and one line of both."""
    prof = {eager: profile_lockstep(kernel, label, n_chains,
                                    steps["eager" if eager else "graph"],
                                    eager, card)
            for eager in (True, False)}
    print(f"{label} step, eager -> graph: host time "
          f"{prof[True]['host_ms']:.4f} -> {prof[False]['host_ms']:.4f} ms, "
          f"kernels {prof[True]['kernels']:.1f} -> "
          f"{prof[False]['kernels']:.1f}, idle share "
          f"{prof[True]['idle']:.4f} -> {prof[False]['idle']:.4f} "
          f"under the profiler (estimate without it "
          f"{prof[True]['idle_unprofiled']:.4f} -> "
          f"{prof[False]['idle_unprofiled']:.4f})")


def run_asss_fused(amt, card: str):
    """The ASSS main path through K3; returns (rate, last state)."""
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.asss(t, amt.ASSSConfig(fused=True)),
                    num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
                    thinning=THINNING, n_chains=N_CHAINS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mcmc.print_summary()
    print(mcmc.diagnostics_str())
    draws = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    require(draws.is_pinned(), "ASSS draws not in pinned host memory")
    require(tuple(draws.shape) == (NUM_SAMPLES // THINNING, N_CHAINS, t.dim),
            f"ASSS draws shape {tuple(draws.shape)}")
    require(bool(torch.isfinite(draws).all()), "non-finite ASSS draws")
    name = "ASSS fused (K3)"
    eight_schools_bands(name, mcmc.get_samples())
    rate = N_CHAINS * (NUM_WARMUP + NUM_SAMPLES) / wall
    print(f"{name}: {rate:.1f} chain-iters/s ({N_CHAINS} chains x "
          f"{NUM_WARMUP + NUM_SAMPLES} steps in {wall:.3f} s, build "
          f"excluded) on {card}")
    return rate, mcmc.last_state


def step_n_us(kernel, state, n_steps: int, label: str, card: str) -> float:
    """µs per step of one long production-mode step_n (CUDA events)."""
    g = torch.Generator("cuda").manual_seed(7)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = kernel.step_n(state, n_steps, g)
    end.record()
    end.synchronize()
    require(int(out.i) == int(state.i) + n_steps, "step_n step counter")
    us = start.elapsed_time(end) * 1000.0 / n_steps
    print(f"{label} step_n of {n_steps} steps at {state.position.shape[0]} "
          f"chains: {us:.4f} µs per step on {card}")
    return us


def run_asss_k1(amt, adapted, lockstep: bool, card: str) -> float:
    """An ASSS driver through K1 (the lockstep step, or the pipelined
    step_n), from fresh positions under the adapted (loc, scale) of the K3
    run, its adaptation clock continuing from that run's."""
    t = amt.eight_schools_noncentered()
    kernel = amt.asss(t)
    if lockstep:
        kernel = dataclasses.replace(kernel, step_n=None, collect_n=None)
    name = "ASSS lockstep (K1)" if lockstep else "ASSS pipelined (K1)"
    g = torch.Generator("cuda").manual_seed(1 if lockstep else 2)
    start = kernel.init(g, n_chains=N_CHAINS,
                        adapt_state=adapted.adapt_state)._replace(i=adapted.i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, _, last = amt.run_mcmc(
        kernel, g, K1_ASSS_WARMUP, K1_ASSS_SAMPLES, thinning=THINNING,
        n_chains=N_CHAINS, init_state=start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(samples.is_cuda and bool(torch.isfinite(samples).all()),
            f"{name}: draws not finite on the card")
    moved = float((last.position != start.position).any(dim=1).float()
                  .mean())
    require(moved > 0.99, f"{name}: only {moved} of the chains moved")
    eight_schools_bands(name, t.constrain(samples))
    steps = K1_ASSS_WARMUP + K1_ASSS_SAMPLES
    rate = N_CHAINS * steps / wall
    print(f"{name}: {rate:.1f} chain-iters/s ({N_CHAINS} chains x {steps} "
          f"steps in {wall:.3f} s) on {card}")
    return rate


def run_fused(amt, name: str, sampler: str, C: int, num_warmup: int,
              num_samples: int, card: str):
    """One target through K3 (ASSS) or K2 (ARWMH) from MCMC(...).run(...);
    returns (chain-iters/s, flat unconstrained draws (T, C, d) on the
    card)."""
    t = getattr(amt, name)()
    kernel = (amt.asss(t, amt.ASSSConfig(fused=True)) if sampler == "ASSS"
              else amt.arwmh(t, amt.ARWMHConfig(fused=True)))
    mcmc = amt.MCMC(kernel, num_warmup=num_warmup, num_samples=num_samples,
                    thinning=THINNING, n_chains=C)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mcmc.print_summary()
    print(mcmc.diagnostics_str())
    label = f"{sampler} fused ({'K3' if sampler == 'ASSS' else 'K2'}) {name}"
    draws = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    require(draws.is_pinned(),
            f"{label}: draws not in pinned host memory")
    require(tuple(draws.shape) == (num_samples // THINNING, C, t.dim),
            f"{label}: draws shape {tuple(draws.shape)}")
    require(bool(torch.isfinite(draws).all()), f"{label}: non-finite draws")
    steps = num_warmup + num_samples
    rate = C * steps / wall
    print(f"{label}: {rate:.1f} chain-iters/s ({C} chains x {steps} steps "
          f"in {wall:.3f} s, build excluded) on {card}")
    return rate, draws


def diamonds_gate(amt, draws, label: str) -> None:
    """The pooled draws against the gold: every coordinate's mean within
    DIAMONDS_MAX_MEAN_ERR gold sd, every sd ratio in DIAMONDS_SD_RATIO."""
    gold = gold_draws(amt)
    gm, gsd = gold.mean(0), gold.std(0)
    x = draws.double()
    flat = x.reshape(-1, x.shape[-1])
    err = np.abs(flat.mean(0).cpu().numpy() - gm) / gsd
    ratio = flat.std(0).cpu().numpy() / gsd
    # chains whose own mean is 3 gold sd off in some coordinate (stuck)
    chain_err = (x.mean(0).cpu().numpy() - gm) / gsd
    stuck = int((np.abs(chain_err) > 3.0).any(axis=1).sum())
    print(f"{label} vs gold: max standardized mean error {err.max():.4f} "
          f"(coordinate {int(err.argmax())}), sd ratio "
          f"[{ratio.min():.4f}, {ratio.max():.4f}], chains 3 gold sd off "
          f"{stuck} of {x.shape[1]}")
    require(err.max() <= DIAMONDS_MAX_MEAN_ERR,
            f"{label}: mean error {err.max()}")
    lo, hi = DIAMONDS_SD_RATIO
    require(lo <= ratio.min() and ratio.max() <= hi,
            f"{label}: sd ratio [{ratio.min()}, {ratio.max()}]")


def kidiq_gate(amt, draws, label: str) -> None:
    """beta's posterior mean within KIDIQ_MEAN_ERR OLS s.e. of b̂, sigma's
    posterior median within KIDIQ_SIGMA_REL of the residual sd."""
    b_hat, se, s = kidiq_ols(amt)
    flat = draws.double().reshape(-1, 4)
    err = np.abs(flat[:, :3].mean(0).cpu().numpy() - b_hat) / se
    sigma_rel = float(torch.exp(flat[:, 3]).median()) / s - 1.0
    print(f"{label}: |mean(beta) - OLS| / se {np.round(err, 4).tolist()}, "
          f"sigma median / resid sd - 1 = {sigma_rel:.5f}")
    require(err.max() <= KIDIQ_MEAN_ERR, f"{label}: beta mean error {err}")
    require(abs(sigma_rel) <= KIDIQ_SIGMA_REL,
            f"{label}: sigma median off by {sigma_rel}")


def check_sa_graph_equals_eager(amt, k1) -> None:
    """run_mcmc of the SA step at the SA path's width from the CUDA graph
    and from the eager loop, same seed, same init_state: frames, extras,
    last state and the generator's next draws bit for bit, K1 launched
    three times per step in both."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors
    W, N = SA_GRAPH_CHECK_WARMUP, SA_GRAPH_CHECK_SAMPLES
    kernel = amt.sa(amt.eight_schools_noncentered(),
                    amt.SAConfig(num_warmup=W))
    init = kernel.init(torch.Generator("cuda").manual_seed(31),
                       n_chains=SA_CHAINS)
    runs = {}
    for eager in (True, False):
        k1.launches = 0
        g = torch.Generator("cuda").manual_seed(32)
        samples, extras, last = amt.run_mcmc(
            kernel, g, W, N, thinning=THINNING, n_chains=SA_CHAINS,
            init_state=init, extra_fields=("potential_energy",
                                           "accept_prob"), eager=eager)
        torch.cuda.synchronize()
        runs[eager] = ([samples, *extras.values()], state_tensors(last),
                       k1.launches, torch.rand(8, generator=g, device="cuda"))
    e, gr = runs[True], runs[False]
    require(e[2] == gr[2] == 3 * (W + N),
            f"SA K1 launches: eager {e[2]}, graph {gr[2]}, steps {W + N}")
    require(all(torch.equal(a, b) for a, b in zip(e[0], gr[0])),
            "SA graph run's frames differ from the eager loop's")
    require(all(torch.equal(a, b) for a, b in zip(e[1], gr[1])),
            "SA graph run's last state differs from the eager loop's")
    require(torch.equal(e[3], gr[3]),
            "the generator stands elsewhere after the SA graph run")
    print(f"SA graph run equals the eager run bit for bit: {N // THINNING} "
          f"frames of {SA_CHAINS} chains with potential_energy and "
          f"accept_prob, last state, the generator's next draws; K1 "
          f"launches {gr[2]} = 3 x {W + N} steps in both")


def run_sa(amt, k1, card: str):
    """The SA path through K1: MCMC(sa(eight_schools_noncentered())) at
    SA_CHAINS, against the quadrature truths of mu and log tau; returns
    (chain-iters/s, K1 launches)."""
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.sa(t), num_warmup=SA_WARMUP,
                    num_samples=SA_SAMPLES, thinning=THINNING,
                    n_chains=SA_CHAINS)
    reset_launches(k1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.launches
    mcmc.print_summary()
    print(mcmc.diagnostics_str())
    draws = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    require(draws.is_pinned(), "SA draws not in pinned host memory")
    require(tuple(draws.shape) == (SA_SAMPLES // THINNING, SA_CHAINS, t.dim),
            f"SA draws shape {tuple(draws.shape)}")
    require(bool(torch.isfinite(draws).all()), "non-finite SA draws")
    mu = float(draws[..., 0].double().mean())
    log_tau = float(draws[..., 1].double().mean())
    steps = SA_WARMUP + SA_SAMPLES
    rate = SA_CHAINS * steps / wall
    print(f"SA (K1): mean mu {mu:.4f} (truth {SA_MU}), mean log tau "
          f"{log_tau:.4f} (truth {SA_LOG_TAU}); K1 launches {launches} for "
          f"{steps} steps; {rate:.1f} chain-iters/s ({SA_CHAINS} chains x "
          f"{steps} steps in {wall:.3f} s, {wall / steps * 1e3:.4f} ms per "
          f"step) on {card}")
    require(abs(mu - SA_MU) < SA_MU_TOL, f"SA mu mean {mu}")
    require(abs(log_tau - SA_LOG_TAU) < SA_LOG_TAU_TOL,
            f"SA log tau mean {log_tau}")
    require(launches == 3 * steps, f"SA K1 launches {launches}, 3 x {steps}")
    return rate, launches


def eight_schools_truth(amt) -> dict:
    """Quadrature moments of the eight-schools (mu, log tau) marginal and
    the median of tau: integrating theta_base out gives y_j ~ N(mu,
    sigma_j^2 + tau^2).  A numpy copy of the JAX package's
    experiments/quadrature.py eight_schools_truth, over the port's data,
    with the median added."""
    d = amt.models.data.eight_schools()
    y = np.asarray(d["y"], np.float64)
    sigma = np.asarray(d["sigma"], np.float64)
    mus = np.linspace(-25.0, 35.0, 1200)
    lts = np.linspace(-14.0, 5.0, 1900)
    MU, LT = np.meshgrid(mus, lts, indexing="ij")
    TAU = np.exp(LT)
    lp = -0.5 * (MU / 5.0) ** 2
    lp += np.log(2.0 / np.pi) - np.log(5.0 * (1.0 + (TAU / 5.0) ** 2)) + LT
    var = sigma[None, None, :] ** 2 + TAU[..., None] ** 2
    lp += np.sum(-0.5 * np.log(2.0 * np.pi * var)
                 - 0.5 * (y[None, None, :] - MU[..., None]) ** 2 / var,
                 axis=-1)
    w = np.exp(lp - lp.max())
    w /= w.sum()
    e_lt, e_mu = float((w * LT).sum()), float((w * MU).sum())
    cdf = np.cumsum(w.sum(axis=0))
    return {"mean_log_tau": e_lt,
            "sd_log_tau": float(np.sqrt((w * LT ** 2).sum() - e_lt ** 2)),
            "mean_mu": e_mu,
            "median_tau": float(np.exp(np.interp(0.5, cdf, lts)))}


def check_nuts_graph_equals_eager(amt, tn, card: str):
    """step_n then collect_n of NUTS at the bench's width from the CUDA
    graph and from the eager blocks, same seed, same init: final state,
    frames and the generator's next draws bit for bit; returns the graph
    run's final state (after warmup)."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors
    k = amt.nuts(amt.eight_schools_noncentered(),
                 amt.NUTSConfig(num_warmup=NUTS_CHECK_WARMUP))
    init = k.init(torch.Generator("cuda").manual_seed(51),
                  n_chains=NUTS_CHAINS)
    runs = {}
    for eager in (True, False):
        g = torch.Generator("cuda").manual_seed(52)
        trips0 = counted("nuts.trips")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = k.step_n(init, NUTS_CHECK_STEPS, g, eager=eager)
        s, frames = k.collect_n(s, NUTS_CHECK_FRAMES, NUTS_CHECK_THINNING, g,
                                eager=eager)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[eager] = (state_tensors(s), list(frames.values()),
                       torch.rand(8, generator=g, device="cuda"),
                       counted("nuts.trips") - trips0, wall, s)
    e, gr = runs[True], runs[False]
    require(all(torch.equal(a, b) for a, b in zip(e[0], gr[0])),
            "NUTS graph run's final state differs from the eager blocks'")
    require(all(torch.equal(a, b) for a, b in zip(e[1], gr[1])),
            "NUTS graph run's frames differ from the eager blocks'")
    require(torch.equal(e[2], gr[2]),
            "the generator stands elsewhere after the NUTS graph run")
    require(e[3] == gr[3], f"NUTS trips: eager {e[3]}, graph {gr[3]}")
    frames = gr[1][0]
    require(bool(torch.isfinite(frames).all())
            and not bool((frames == 0).all(dim=-1).any()),
            "NUTS frames not all written")
    n = NUTS_CHECK_STEPS + NUTS_CHECK_FRAMES * NUTS_CHECK_THINNING
    print(f"NUTS graph run equals the eager blocks bit for bit: step_n of "
          f"{NUTS_CHECK_STEPS} then collect_n of {NUTS_CHECK_FRAMES} frames "
          f"at thinning {NUTS_CHECK_THINNING}, {NUTS_CHAINS} chains: final "
          f"state, frames, the generator's next draws; {gr[3]} trips in "
          f"both ({gr[3] / n:.2f} per transition); eager {e[4]:.3f} s "
          f"({e[4] / e[3] * 1e3:.4f} ms per trip), graph {gr[4]:.3f} s "
          f"({gr[4] / gr[3] * 1e3:.4f} ms per trip, the capture included) "
          f"on {card}")
    return gr[5]


def nuts_block_trial(amt, tn, state, card: str) -> None:
    """step_n of NUTS_TRIAL_STEPS transitions from the CUDA graph with
    kernels.nuts.GRAPH_TRIPS (machine trips per replay) set to each length
    of NUTS_BLOCK_TRIAL for the trial's duration, after a warm call that
    captures it: ms per trip and wall.  The trial that chose GRAPH_TRIPS."""
    k = amt.nuts(amt.eight_schools_noncentered(),
                 amt.NUTSConfig(num_warmup=NUTS_CHECK_WARMUP))
    kept = tn.GRAPH_TRIPS
    try:
        for block in NUTS_BLOCK_TRIAL:
            tn.GRAPH_TRIPS = block
            g = torch.Generator("cuda").manual_seed(53)
            k.step_n(state, 10, g)
            trips0 = counted("nuts.trips")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = k.step_n(state, NUTS_TRIAL_STEPS, g)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trips = counted("nuts.trips") - trips0
            require(bool(torch.isfinite(out.position).all()), "NUTS trial")
            print(f"NUTS block trial: {block} trips per replay, step_n of "
                  f"{NUTS_TRIAL_STEPS} at {NUTS_CHAINS} chains: {trips} "
                  f"trips, {wall / trips * 1e3:.4f} ms per trip, "
                  f"{wall:.4f} s, {NUTS_CHAINS * NUTS_TRIAL_STEPS / wall:.1f}"
                  f" chain-iters/s on {card}")
    finally:
        tn.GRAPH_TRIPS = kept


def run_nuts(amt, tn, name: str, warmup: int, samples: int, card: str):
    """MCMC(nuts(target), ...) at NUTS_CHAINS from the CUDA graph; returns
    flat unconstrained draws (T, C, d) on the card and the rate."""
    t = getattr(amt, name)()
    mcmc = amt.MCMC(amt.nuts(t), num_warmup=warmup, num_samples=samples,
                    n_chains=NUTS_CHAINS)
    trips0 = counted("nuts.trips")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trips = counted("nuts.trips") - trips0
    mcmc.print_summary()
    print(mcmc.diagnostics_str())
    draws = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    label = f"NUTS {name}"
    require(draws.is_pinned(),
            f"{label}: draws not in pinned host memory")
    require(tuple(draws.shape) == (samples, NUTS_CHAINS, t.dim),
            f"{label}: draws shape {tuple(draws.shape)}")
    require(bool(torch.isfinite(draws).all()), f"{label}: non-finite draws")
    last = mcmc.last_state
    accept = float(last.mean_accept_prob.mean())
    steps = warmup + samples
    rate = NUTS_CHAINS * steps / wall
    print(f"{label}: acceptance {accept:.4f}, mean num_steps "
          f"{float(last.num_steps.float().mean()):.2f} (leapfrogs of each "
          f"chain's last transition), diverging in the last transition "
          f"{int(last.diverging.sum())} of {NUTS_CHAINS}, {trips} trips "
          f"({trips / steps:.2f} per transition, {wall / trips * 1e3:.4f} ms "
          f"per trip), {rate:.1f} chain-iters/s ({NUTS_CHAINS} chains x "
          f"{steps} transitions in {wall:.3f} s) on {card}")
    require(0.6 < accept < 0.99, f"{label}: acceptance {accept}")
    return draws, rate


def nuts_eight_schools_gate(amt, draws) -> None:
    """mean and sd of log tau and mean of mu against the quadrature truths
    (tests/test_nuts.py's bands), and the tau median of every eight-schools
    run of this script beside the quadrature's."""
    truth = eight_schools_truth(amt)
    s = draws.double().reshape(-1, draws.shape[-1]).cpu().numpy()
    m_lt, sd_lt, m_mu = s[:, 1].mean(), s[:, 1].std(), s[:, 0].mean()
    TAU_MEDIANS["NUTS"] = float(np.median(np.exp(s[:, 1])))
    print(f"NUTS eight schools vs quadrature: mean log tau {m_lt:.4f} "
          f"(truth {truth['mean_log_tau']:.4f}), sd log tau {sd_lt:.4f} "
          f"({truth['sd_log_tau']:.4f}), mean mu {m_mu:.4f} "
          f"({truth['mean_mu']:.4f})")
    print(f"eight-schools tau median: quadrature {truth['median_tau']:.4f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in TAU_MEDIANS.items()))
    require(abs(m_lt - truth["mean_log_tau"]) < NUTS_LOG_TAU_TOL,
            f"NUTS mean log tau {m_lt}")
    require(abs(sd_lt - truth["sd_log_tau"]) < NUTS_SD_LOG_TAU_TOL,
            f"NUTS sd log tau {sd_lt}")
    require(abs(m_mu - truth["mean_mu"]) < NUTS_MU_TOL, f"NUTS mean mu {m_mu}")


def profile_nuts(amt, tn, state, eager: bool, card: str) -> dict:
    """Host time, kernels and device busy per machine trip of a NUTS
    step_n from ``state``, eagerly or from the graph: the host clock over
    one window, torch.profiler over a second; idle share as in
    profile_lockstep."""
    from torch.profiler import ProfilerActivity, profile
    name = "eager" if eager else "graph"
    n = NUTS_PROFILE_STEPS[name]
    k = amt.nuts(amt.eight_schools_noncentered(),
                 amt.NUTSConfig(num_warmup=NUTS_CHECK_WARMUP))
    g = torch.Generator("cuda").manual_seed(61)
    k.step_n(state, 2, g, eager=eager)
    windows = []
    for profiled in (False, True):
        trips0 = counted("nuts.trips")
        torch.cuda.synchronize()
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if profiled \
            else contextlib.nullcontext()
        with ctx as prof:
            t0 = time.perf_counter()
            k.step_n(state, n, g, eager=eager)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trips = counted("nuts.trips") - trips0
        windows.append((wall * 1e3 / trips, trips, prof))
    (host_ms, _, _), (traced_ms, n_trips, prof) = windows
    n_kernels, busy_us = device_activity(prof, f"NUTS {name}", n_trips,
                                         "trip")
    out = {"host_ms": host_ms, "traced_ms": traced_ms,
           "kernels": n_kernels / n_trips, "busy_us": busy_us / n_trips,
           "idle": 1.0 - busy_us / n_trips / (traced_ms * 1e3),
           "idle_unprofiled": 1.0 - busy_us / n_trips / (host_ms * 1e3)}
    print(f"NUTS {name}, step_n of {n} transitions at {NUTS_CHAINS} chains "
          f"({n_trips} trips): host time per trip {host_ms:.4f} ms "
          f"({traced_ms:.4f} under the profiler), kernels per trip "
          f"{out['kernels']:.1f}, device busy per trip {out['busy_us']:.2f} "
          f"µs, device idle share {out['idle']:.4f} in the profiled window "
          f"(estimate without the profiler {out['idle_unprofiled']:.4f}) on "
          f"{card}")
    return out


def check_drivers(amt) -> None:
    """ARWMH on std_normal(3) through the checkpointed driver, interrupted
    after its first chunk and resumed with another generator seed, against
    one uninterrupted run_mcmc: draws and last state bit for bit; and the
    log-grid collection's iteration counts."""
    import tempfile
    from adaptive_mcmc_tpu_torch.infer import (
        collect_states_logscale, ns_logscale, run_mcmc_checkpointed)
    from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors
    kernel = amt.arwmh(amt.std_normal(3))
    W, N, C, chunk = DRIVER_WARMUP, DRIVER_SAMPLES, DRIVER_CHAINS, \
        DRIVER_CHUNK

    def gen(seed):
        return torch.Generator("cuda").manual_seed(seed)

    want, _, want_last = amt.run_mcmc(kernel, gen(41), W, N, thinning=4,
                                      n_chains=C)
    with tempfile.TemporaryDirectory() as d:
        run_mcmc_checkpointed(kernel, gen(41), W, chunk, thinning=4,
                              n_chains=C, checkpoint_dir=d, chunk_size=chunk)
        got, _, got_last = run_mcmc_checkpointed(
            kernel, gen(999), W, N, thinning=4, n_chains=C,
            checkpoint_dir=d, chunk_size=chunk)
    require(np.array_equal(want.cpu().numpy(), got),
            "the resumed checkpointed run's draws differ")
    require(all(torch.equal(a, b) for a, b in zip(state_tensors(want_last),
                                                 state_tensors(got_last))),
            "the resumed checkpointed run's last state differs")
    states, last = collect_states_logscale(kernel, gen(42), n_pow=4,
                                           n_chains=C)
    require(torch.equal(states.i.cpu(), ns_logscale(4)),
            "collect_states_logscale's grid")
    require(states.position.is_cuda
            and bool(torch.isfinite(states.position).all()),
            "collect_states_logscale's states")
    print(f"checkpointed ARWMH ({C} chains, {W} + {N} steps, chunks of "
          f"{chunk}) interrupted after its first chunk and resumed equals "
          f"run_mcmc bit for bit; collect_states_logscale(n_pow=4): "
          f"{states.position.shape[0]} states, i equals ns_logscale(4), "
          f"last i {int(last.i)}")


def check_bench() -> dict:
    """python -m adaptive_mcmc_tpu_torch.bench's main(): its JSON line,
    five numeric cells, every ess_per_sec null."""
    from adaptive_mcmc_tpu_torch import bench
    res = bench.main()
    cells = {c["metric"]: c for c in [res, *res["extras"]]}
    require(len(cells) == 5, f"bench cells {list(cells)}")
    for name, c in cells.items():
        require(isinstance(c["value"], float) and c["value"] > 0,
                f"bench cell {name}: {c['value']}")
        require(c["ess_per_sec"] is None, f"bench {name} ess_per_sec")
    return res


def check_entry() -> None:
    from adaptive_mcmc_tpu_torch.entry import entry
    fn, (state,) = entry()
    out = fn(state)
    torch.cuda.synchronize()
    require(out.position.is_cuda and int(out.i) == 1
            and bool(torch.isfinite(out.position).all()),
            "entry()'s step")
    print(f"entry(): one ARWMH step of {out.position.shape[0]} chains on "
          f"the card, finite")


# ---------------------------------------------------------------------------
# The diagnostics: sample-quality metrics, the ε-auction, sample_pnx, the
# Lipschitz-NN contraction estimators, invariance and contraction curves.
# ---------------------------------------------------------------------------

def diamond_sets(draws) -> list:
    """DIAG_SETS_PER_RUN sets of DIAG_N draws (T, C, d) -> (DIAG_N, d)
    each: DIAG_FRAMES frames spread over the run, of a block of
    DIAG_N / DIAG_FRAMES chains per set."""
    T, C, d = draws.shape
    per = DIAG_N // DIAG_FRAMES
    frames = draws[::T // DIAG_FRAMES][:DIAG_FRAMES]
    return [frames[:, j * per:(j + 1) * per].reshape(DIAG_N, d).contiguous()
            for j in range(DIAG_SETS_PER_RUN)]


def timed(fn):
    """(fn(), host seconds), the clock closed by torch.cuda.synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dual_certificate(cost, col, prices) -> float:
    """(D − P) / n in float64 for benefit b = −cost and the auction's
    prices: D = Σ_j p_j + Σ_i max_j (b_ij − p_j), P = Σ_i b_{i,σ(i)}.  For a
    complete assignment under ε-complementary slackness it is at most ε."""
    b = -cost.double()
    p = prices.double()
    n = b.shape[0]
    dual = p.sum() + (b - p[None, :]).max(dim=1).values.sum()
    primal = b[torch.arange(n, device=b.device), col].sum()
    return float((dual - primal) / n)


def is_permutation(col, n: int) -> bool:
    return bool((torch.bincount(col, minlength=n) == 1).all())


def levels_line(ta) -> str:
    return ", ".join(f"ε {eps:.4g}: {run} rounds ({live} live)"
                     for eps, run, live in ta.last_levels)


def check_metrics(amt, sets, card: str) -> dict:
    """The metrics at evaluate_run's shape (8 sets of 10000 diamonds draws
    against the gold draws), the auction's dual certificate, and at
    DIAG_CHECK_N the auction against the Hungarian, the Hungarian against
    SciPy, each metric against the CPU, and the graph against eager."""
    from scipy.optimize import linear_sum_assignment as scipy_lsap
    from adaptive_mcmc_tpu_torch.metrics import assignment as ta
    from adaptive_mcmc_tpu_torch.metrics import sliced as tsl
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak
    from adaptive_mcmc_tpu_torch.utils import profiling
    m = amt.metrics
    dev = torch.device("cuda")
    gold = torch.tensor(gold_draws(amt), dtype=torch.float32, device=dev)
    xs = torch.stack(sets).to(dev)      # MCMC.run's draws are host tensors
    S, n, d = xs.shape
    times = {}
    rmse, times["moment RMSE"] = timed(
        lambda: [float(m.pth_moment_rmse(x, gold, 1.0)) for x in xs])
    mmd, times["MMD (S = 8)"] = timed(
        lambda: m.mmd_heuristic_many(xs, gold).cpu().numpy())
    sink, times["Sinkhorn"] = timed(
        lambda: [m.wasserstein_sinkhorn(x, gold) for x in xs])
    g = torch.Generator("cuda").manual_seed(0)
    msw, times["max-sliced"] = timed(lambda: [float(
        m.max_sliced_wasserstein(x, gold, g, n_directions=DIAG_DIRECTIONS))
        for x in xs])
    costs, times["cost matrices"] = timed(lambda: torch.stack(
        [m.minkowski_cost_matrix(x, gold) for x in xs]))
    rows = torch.arange(n, device=dev)
    auction = {}
    launched_at_start = ak.launches
    for label, init in (("cold", None), ("warm", "cold")):
        before = profiling.totals().get("graph.replays", 0)
        counts = {c: profiling.totals().get(c, 0) for c in AUCTION_COUNTERS}
        launched = ak.launches
        (col, prices), secs = timed(lambda: ta.auction_assignment_batch(
            costs, return_prices=True,
            prices_init=None if init is None else auction[init][1]))
        auction[label] = (col, prices)
        eps_final = ta.last_levels[-1][0]
        w = [float(costs[i][rows, col[i]].mean()) for i in range(S)]
        gaps = [dual_certificate(costs[i], col[i], prices[i])
                for i in range(S)]
        require(all(is_permutation(c, n) for c in col),
                f"auction ({label}): not a permutation")
        require(max(gaps) <= eps_final,
                f"auction ({label}): (D - P)/n {max(gaps)} > ε_final "
                f"{eps_final}")
        rounds = sum(r for _, r, _ in ta.last_levels)
        counts = {c: profiling.totals().get(c, 0) - counts[c]
                  for c in AUCTION_COUNTERS}
        require(counts["auction.rounds"] == rounds
                and counts["auction.kernel_rounds"] == rounds
                and ak.launches - launched == rounds,
                f"auction ({label}): {rounds} rounds, counters {counts}, "
                f"launches {ak.launches - launched}")
        times[f"auction {label}"] = secs
        print(f"auction {label}, B = {S}, n = m = {n}: {secs:.3f} s, "
              f"{rounds} rounds ({levels_line(ta)}), "
              f"{profiling.totals()['graph.replays'] - before} graph "
              f"replays, auction kernel launches {ak.launches - launched}, "
              f"auction.kernel_rounds {counts['auction.kernel_rounds']}; W "
              f"{[round(v, 6) for v in w]}; dual certificate (D - P)/n max "
              f"{max(gaps):.3e} <= ε_final {eps_final:.3e}; on {card}")
    print("diagnostics metrics on the diamonds sets (d = 26) against the "
          f"gold draws (n = {n}): moment RMSE {[round(v, 6) for v in rmse]}, "
          f"MMD {[round(float(v), 6) for v in mmd]}, Sinkhorn "
          f"{[round(v, 6) for v in sink]}, max-sliced "
          f"{[round(v, 6) for v in msw]}")
    print("diagnostics metric seconds on " + card + ": " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    timed_from = ak.launches
    timing = auction_round_times(ta, ak, costs, auction["cold"][1], card)
    del costs
    # the timing's graphs count a launch per capture, not per replay: the
    # kernels line counts the solves' launches only
    resumed_at = ak.launches
    check_small(amt, ta, tsl, xs[:, :DIAG_CHECK_N], gold[:DIAG_CHECK_N],
                scipy_lsap, card)
    timing["launches"] = timed_from - launched_at_start \
        + ak.launches - resumed_at
    print(f"auction kernel launches in the solves: {timing['launches']}")
    return timing


def check_small(amt, ta, tsl, xs, gold, scipy_lsap, card: str) -> None:
    """At DIAG_CHECK_N: the auction (graph = eager bit for bit) within
    ε_final of the port's Hungarian, which equals SciPy's cost; every
    metric on the card against the CPU at rtol DIAG_RTOL."""
    m = amt.metrics
    S, n, _ = xs.shape
    costs = torch.stack([m.minkowski_cost_matrix(x, gold) for x in xs])
    (cg, pg), graph_s = timed(lambda: ta.auction_assignment_batch(
        costs, return_prices=True))
    eps_final = ta.last_levels[-1][0]
    rounds = sum(r for _, r, _ in ta.last_levels)
    (ce, pe), eager_s = timed(lambda: ta.auction_assignment_batch(
        costs, return_prices=True, eager=True))
    require(torch.equal(cg, ce) and torch.equal(pg, pe),
            "auction: the graph run differs from eager=True")
    print(f"auction at n = {n}, B = {S}: graph {graph_s:.3f} s, eager "
          f"{eager_s:.3f} s for {rounds} rounds ({graph_s / rounds * 1e3:.4f}"
          f" against {eager_s / rounds * 1e3:.4f} ms per round), equal bit "
          f"for bit (assignments and prices) on {card}")
    host = costs.double().cpu().numpy()
    worst = 0.0
    t_native = t_scipy = 0.0
    for i in range(S):
        t0 = time.perf_counter()
        col = ta.linear_sum_assignment(host[i], solver="native")
        t1 = time.perf_counter()
        _, col_s = scipy_lsap(host[i])
        t2 = time.perf_counter()
        t_native, t_scipy = t_native + t1 - t0, t_scipy + t2 - t1
        w_h = host[i][np.arange(n), col].mean()
        w_s = host[i][np.arange(n), col_s].mean()
        w_a = host[i][np.arange(n), cg[i].cpu().numpy()].mean()
        require(abs(w_h - w_s) <= 1e-9 * max(1.0, w_s),
                f"native Hungarian {w_h} against SciPy {w_s}")
        require(w_a - w_h <= eps_final,
                f"auction W {w_a} against the Hungarian {w_h}: over ε_final "
                f"{eps_final}")
        worst = max(worst, w_a - w_h)
    print(f"at n = {n}: auction W - Hungarian W at most {worst:.3e} <= "
          f"ε_final {eps_final:.3e}; native Hungarian = SciPy's cost on all "
          f"{S}; host seconds for {S}: native {t_native:.3f}, SciPy "
          f"{t_scipy:.3f}")
    dirs = torch.randn((DIAG_DIRECTIONS, xs.shape[2]),
                       generator=torch.Generator().manual_seed(1))
    checks = {
        "moment RMSE": lambda x, y, D: torch.stack(
            [m.pth_moment_rmse(a, y, 1.0) for a in x]),
        "MMD": lambda x, y, D: m.mmd_heuristic_many(x, y),
        "Sinkhorn": lambda x, y, D: torch.tensor(
            [m.wasserstein_sinkhorn(a, y) for a in x[:DIAG_SINKHORN_CPU]]),
        "max-sliced": lambda x, y, D: torch.stack(
            [tsl.sliced_from_directions(a, y, D).max() for a in x]),
        "exact W": lambda x, y, D: torch.tensor(
            [m.wasserstein_dist11_p(a, y) for a in x[:DIAG_SINKHORN_CPU]]),
    }
    errs = {}
    for name, fn in checks.items():
        got = fn(xs, gold, dirs.cuda()).cpu()
        want = fn(xs.cpu(), gold.cpu(), dirs)
        err = float(((got - want).abs() / want.abs()).max())
        require(err <= DIAG_RTOL, f"{name} on the card against the CPU: "
                                  f"relative error {err}")
        errs[name] = err
    print(f"metrics on the card against the CPU at n = {n}, largest "
          f"relative error (rtol {DIAG_RTOL}): " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items()))


def auction_round_times(ta, ak, costs, prices, card: str) -> dict:
    """ms per auction round, the kernel against the plain round, at each
    block width of the ladder, B = 8, for n = m = 625 (the leading corner
    of the diagnostics' costs) and 10000: CUDA events around graph
    replays (device_ms) of a reset and a round, less those of the reset
    alone, so every round starts from an empty assignment and min(block,
    n) rows bid.  Beside each, its bound: the bytes a round reads (the
    bidders' benefit rows, the prices, the assignment) over 3.35 TB/s.
    Before the timing of each, the kernel's rounds against the plain
    round's (:func:`auction_rounds_match`).  Returns the kernels-line
    result at the grade's shape (n = 625, block 16) and the auction at
    n = 10000 for the profiled window at the end."""
    out = {}
    for n in AUCTION_ROUND_NS:
        benefit = -costs[:, :n, :n].contiguous()
        start = prices[:, :n].contiguous()
        auction = ta._Auction(benefit, start, eager=True)
        twin = ta._Auction(benefit, start, eager=True)
        B = benefit.shape[0]
        eps = ta.last_levels[-1][0] * 10.0

        def plain(width):
            ak.auction_round_reference(
                auction.benefit, auction.prices, auction.row_to_col,
                auction.col_owner, auction.eps, auction.live, width)

        for width in AUCTION_ROUND_BLOCKS:
            K = min(width, n)
            matched = []
            for label, p0 in (("zero", torch.zeros_like(start)),
                              ("solved", start)):
                bad = auction_rounds_match(auction, twin, ak, width, eps, p0)
                require(bad == 0,
                        f"auction round, B = {B}, n = m = {n}, block "
                        f"{width}, from {label} prices: the kernel differs "
                        f"from the plain round after round {bad}")
                matched.append(label)
            auction.prices.copy_(start)
            reps = 20 if K * n > 1_000_000 else 100
            reset_ms = device_ms(lambda: auction.reset(eps), reps)
            ms = {}
            for name, fn in (("kernel", auction.round), ("plain", plain)):
                ms[name] = device_ms(
                    lambda: (auction.reset(eps), fn(width)), reps) - reset_ms
            b = bound(B * (4 * K * n + 4 * n + 8 * (n + 1)), 2 * B * K * n)
            out[(n, width)] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                               **b}
            print(f"auction round, B = {B}, n = m = {n}, block {width} "
                  f"({K} bidders): kernel {ms['kernel']:.6f} ms, plain "
                  f"{ms['plain']:.6f} ms ({ms['plain'] / ms['kernel']:.1f}x),"
                  f" bound {b['bound_ms']:.6f} ms by {b['bound_by']} "
                  f"({ms['kernel'] / b['bound_ms']:.1f}x the bound); reset "
                  f"{reset_ms:.6f} ms; equal to the plain round bit for bit "
                  f"(row_to_col, col_owner, prices, live) after each of "
                  f"{AUCTION_MATCH_ROUNDS} rounds from "
                  f"{' and '.join(matched)} prices; on {card}")
        del twin
    auction.eager = False
    return {"auction": auction, "kernel": out[(625, 16)]}


def auction_rounds_match(auction, twin, ak, width: int, eps: float,
                         prices) -> int:
    """AUCTION_MATCH_ROUNDS rounds at ``width`` from one start (``prices``,
    an empty assignment at ``eps``): the kernel on ``auction``, the plain
    round on ``twin``, which shares its benefit.  Returns 0 when
    row_to_col, col_owner, prices and live are equal after every round,
    else the first round after which they differ."""
    for a in (auction, twin):
        a.prices.copy_(prices)
        a.reset(eps)
    fields = ("row_to_col", "col_owner", "prices", "live")
    for r in range(1, AUCTION_MATCH_ROUNDS + 1):
        auction.round(width)
        ak.auction_round_reference(twin.benefit, twin.prices,
                                   twin.row_to_col, twin.col_owner,
                                   twin.eps, twin.live, width)
        if not all(torch.equal(getattr(auction, f), getattr(twin, f))
                   for f in fields):
            return r
    return 0


def profile_auction(timing: dict, card: str) -> None:
    """Kernels per round and the device's idle share of auction rounds
    replayed from the graph, each block width, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from adaptive_mcmc_tpu_torch.metrics import assignment as ta
    auction = timing["auction"]
    k = ta.ROUNDS_PER_GRAPH
    for width in AUCTION_ROUND_BLOCKS:
        auction._block(k, width)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DIAG_PROFILED_ROUNDS // k):
                auction._block(k, width)
            torch.cuda.synchronize()
            host_us = (time.perf_counter() - t0) * 1e6
        n_kernels, busy_us = device_activity(
            prof, f"auction block {width}", DIAG_PROFILED_ROUNDS, "round")
        print(f"auction block {width} from the graph: "
              f"{n_kernels / DIAG_PROFILED_ROUNDS:.1f} kernels and "
              f"{busy_us / DIAG_PROFILED_ROUNDS:.2f} µs busy per round, "
              f"host {host_us / DIAG_PROFILED_ROUNDS:.2f} µs per round "
              f"under the profiler, device idle share "
              f"{1.0 - busy_us / host_us:.4f} on {card}")


def ar1_sampler(rho: float, sigma: float):
    """P(x, ·) = N(ρx, σ²) on the device of the probes: τ(P) = ρ."""
    def sample_px(seed, X, n_samples):
        gen = torch.Generator(X.device).manual_seed(seed)
        noise = torch.randn((X.shape[0], n_samples, X.shape[1]),
                            generator=gen, device=X.device)
        return rho * X[:, None, :] + sigma * noise

    return sample_px


def rollout_ms(amt, kernel, adapt, X, eager: bool) -> float:
    """Host ms per one-step frozen rollout of FIG_SAMPLES draws at each
    probe point (sample_pnx, n = 1), after a warm call."""
    amt.sample_pnx(kernel, 0, X, adapt, n=1, n_samples=FIG_SAMPLES,
                   eager=eager)
    _, secs = timed(lambda: [amt.sample_pnx(
        kernel, s, X, adapt, n=1, n_samples=FIG_SAMPLES, eager=eager)
        for s in range(DIAG_TIMED_ROLLOUTS)])
    return secs * 1e3 / DIAG_TIMED_ROLLOUTS


def check_contraction(amt, card: str) -> None:
    """τ of the AR(1) kernel at the estimator's defaults against ρ; τ of
    frozen ARWMH and ASSS on N(0, 1) at figures.py's sizes; the decay
    curves; invariance at 10^6 and the wrong-target control."""
    from adaptive_mcmc_tpu_torch import analysis as an
    from adaptive_mcmc_tpu_torch import contraction as co
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(4)
    X = torch.linspace(-3, 3, AR1_POINTS, device=dev)[:, None]
    for rho in AR1_RHOS:
        (tau, _, _), secs = timed(lambda: co.compute_wasserstein_contraction(
            ar1_sampler(rho, AR1_SIGMA), g, X))
        print(f"AR(1) ρ = {rho}: τ {float(tau):.4f} (band "
              f"({0.6 * rho:.3f}, {1.15 * rho:.3f})), {secs:.3f} s at the "
              f"defaults (1000 samples, 10 + 100 batches, 100 steps) on "
              f"{card}")
        require(0.6 * rho < float(tau) < 1.15 * rho, f"AR(1) τ {float(tau)}")
    t1 = amt.std_normal(1)
    frozen = {"ARWMH": an.frozen_arwmh(t1, device=dev),
              "ASSS": an.frozen_asss(t1, device=dev)}
    Xf = torch.linspace(-2.5, 2.5, FIG_POINTS, device=dev)[:, None]
    ms = {(name, eager): rollout_ms(amt, *frozen[name], Xf, eager=eager)
          for name in frozen for eager in (False, True)}
    print(f"frozen rollout step at {FIG_POINTS * FIG_SAMPLES} chains, host "
          f"ms: ARWMH from the graph {ms[('ARWMH', False)]:.4f}, eagerly "
          f"{ms[('ARWMH', True)]:.4f}; ASSS from its graphs "
          f"{ms[('ASSS', False)]:.4f}, eagerly {ms[('ASSS', True)]:.4f} "
          f"({ROLLOUT_PR9_ROW}) on {card}")
    for name, (k, adapt) in frozen.items():
        (tau, _, _), secs = timed(lambda: co.compute_wasserstein_contraction(
            co.make_sample_px(k, adapt), g, Xf,
            sample_batch_size=FIG_SAMPLES, n_train_batches=FIG_BATCHES,
            max_steps=FIG_STEPS))
        print(f"frozen {name} on N(0, 1): τ {float(tau):.4f}, {secs:.3f} s "
              f"({FIG_POINTS} probes x {FIG_SAMPLES} samples, "
              f"{FIG_BATCHES} train and 100 eval batches, {FIG_STEPS} steps) "
              f"on {card}")
        require(np.isfinite(float(tau)), f"frozen {name} τ not finite")
        taus_fn = an.taus_finite_difference if name == "ARWMH" \
            else an.taus_finite_difference_arctan
        xs = torch.linspace(-2, 2, 5, device=dev)
        curve, secs = timed(lambda: an.contraction_decay_curve(
            k, g, xs, adapt, ns=DECAY_NS, taus_fn=taus_fn,
            n_samples=DECAY_SAMPLES).cpu().numpy())
        print(f"frozen {name} decay curve, n = {DECAY_NS}: "
              f"{[round(float(v), 4) for v in curve]} ({taus_fn.__name__}, "
              f"{DECAY_SAMPLES} samples, {secs:.3f} s)")
        require(curve[0] < 1.0, f"frozen {name}: τ(P) {curve[0]} >= 1")
        if name == "ARWMH":
            require(curve[-1] < curve[0], f"frozen {name}: no decay")
        else:
            require(bool((curve < 1.0).all()), f"frozen {name}: τ >= 1")

    def normal(gen, n):
        return torch.randn((n, 1), generator=gen, device=gen.device)

    thr = an.ks_null_threshold(INVARIANCE_SAMPLES)
    for name, k in (("ARWMH", amt.arwmh(t1)), ("ASSS", amt.asss(t1)),
                    ("ARWMH, target N(2, 1)",
                     amt.arwmh(amt.mvn(np.array([2.0]), np.eye(1))))):
        ks, secs = timed(lambda: an.invariance_ks(k, normal, g,
                                                  INVARIANCE_SAMPLES))
        control = "N(2" in name
        print(f"invariance KS, {name}, {INVARIANCE_SAMPLES} samples: "
              f"{ks:.6f} ({ks / thr:.3f} x the null threshold {thr:.6f}), "
              f"{secs:.3f} s")
        require(ks > 3.0 * thr if control else ks < 1.5 * thr,
                f"invariance KS {name}: {ks}")


def run_diagnostics(amt, sets, counters, card: str) -> dict:
    """The diagnostics phase; returns what the profiled window at the end
    needs.  No kernel of csrc/ but the auction's is on its path."""
    t0 = time.perf_counter()
    reset_launches(*counters)
    timing = check_metrics(amt, sets, card)
    check_contraction(amt, card)
    require(all(mod.launches == 0 for mod in counters),
            "the diagnostics launched a sampling kernel of csrc/")
    print(f"diagnostics phase: {time.perf_counter() - t0:.1f} s")
    return timing



# ---------------------------------------------------------------------------
# The ASSS machine from its CUDA graph, and the experiment harness.
# ---------------------------------------------------------------------------

def asss_runs(amt, kernel, init, n_steps: int, n_frames: int,
              thinning: int) -> list:
    """Two step_n calls (the second replays the graph the first kept),
    then collect_n with frames, eagerly and from the CUDA graph, each from
    a generator of the same seed: per mode (state and frame tensors, the
    generator's next draws, seconds)."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors
    out = []
    for eager in (True, False):
        g = torch.Generator("cuda").manual_seed(9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = kernel.step_n(init, n_steps, g, eager=eager)
        s = kernel.step_n(s, n_steps, g, eager=eager)
        s, frames = kernel.collect_n(s, n_frames, thinning, g, eager=eager)
        torch.cuda.synchronize()
        out.append(([*state_tensors(s), *frames.values(),
                     torch.rand(4, generator=g, device="cuda")],
                    time.perf_counter() - t0))
    return out


def check_asss_graph(amt, k1, card: str) -> dict:
    """The pipelined ASSS machine from its CUDA graph against the eager
    blocks bit for bit, per ASSS_GRAPH_CHECKS target; returns each
    target's state after warmup, for the profile."""
    m = importlib.import_module("adaptive_mcmc_tpu_torch.ops.cuda.asss_fused")
    states = {}
    for name, C, n, F, thin in ASSS_GRAPH_CHECKS:
        t = getattr(amt, name)()
        k = amt.asss(t, amt.ASSSConfig(num_warmup=ASSS_PROFILE_WARMUP))
        init = k.init(torch.Generator("cuda").manual_seed(5), n_chains=C)
        k1.launches = 0
        (e, e_s), (gr, g_s) = asss_runs(amt, k, init, n, F, thin)
        require(k1.launches > 0, f"ASSS {name}: K1 never launched")
        require(len(e) == len(gr) and all(torch.equal(a, b)
                                          for a, b in zip(e, gr)),
                f"ASSS {name}: the graph run differs from the eager blocks")
        require(int(gr[0]) == 2 * n + F * thin, f"ASSS {name} step counter")
        steps = 2 * n + F * thin
        print(f"ASSS machine graph run equals the eager blocks bit for bit: "
              f"{name} at {C} chains, two step_n of {n} then collect_n of "
              f"{F} frames at thinning {thin} (final state, frames, the "
              f"generator's next draws); {e_s * 1e3 / steps:.4f} ms per "
              f"step eagerly, {g_s * 1e3 / steps:.4f} from the graph "
              f"(capture included; block {m.GRAPH_ITERS} iterations) on "
              f"{card}")
        states[name] = k.step_n(init, ASSS_PROFILE_WARMUP,
                                torch.Generator("cuda").manual_seed(6))
    return states


def profile_asss_machine(amt, name: str, state, card: str) -> dict:
    """Host time per step of the machine's step_n from its CUDA graph (host
    clock around a synchronised window), then kernels and device busy per
    iteration under torch.profiler over a second window; idle share as in
    profile_lockstep, beside the eager machine's row."""
    from torch.profiler import ProfilerActivity, profile
    from adaptive_mcmc_tpu_torch.utils import profiling

    def iterations() -> int:
        return profiling.totals().get("asss.machine_iters", 0)

    k = amt.asss(getattr(amt, name)(),
                 amt.ASSSConfig(num_warmup=ASSS_PROFILE_WARMUP))
    g = torch.Generator("cuda").manual_seed(8)
    n = ASSS_PROFILE_STEPS
    state = k.step_n(state, n, g)         # captures; the windows replay
    windows = []
    for profiled in (False, True):
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if profiled \
            else contextlib.nullcontext()
        with ctx as prof:
            torch.cuda.synchronize()
            i0, t0 = iterations(), time.perf_counter()
            state = k.step_n(state, n, g)
            torch.cuda.synchronize()
            windows.append(((time.perf_counter() - t0) * 1e3 / n,
                            (iterations() - i0) / n))
    iters = windows[1][1]
    n_kernels, busy_us = device_activity(prof, f"ASSS machine {name}",
                                         n, "step")
    out = {"host_ms": windows[0][0], "traced_ms": windows[1][0],
           "iters": iters, "kernels": n_kernels / n / iters,
           "busy_us": busy_us / n / iters,
           "idle": 1.0 - busy_us / n / (windows[1][0] * 1e3),
           "idle_unprofiled": 1.0 - busy_us / n / (windows[0][0] * 1e3)}
    C = state.position.shape[0]
    print(f"ASSS pipelined (K1) from the CUDA graph, {name}, {n} steps at "
          f"{C} chains: host time per step {out['host_ms']:.4f} ms "
          f"({out['traced_ms']:.4f} under the profiler), {iters:.2f} "
          f"iterations per step, kernels per iteration "
          f"{out['kernels']:.1f}, device busy per iteration "
          f"{out['busy_us']:.2f} µs, device idle share {out['idle']:.4f} in "
          f"the profiled window (estimate without the profiler "
          f"{out['idle_unprofiled']:.4f}) on {card}; the eager machine's row "
          f"(eight schools, 4096 chains): {ASSS_EAGER_ROW}")
    return out


def direct_drive(amt, cfg) -> dict:
    """A w_eval cell's draws without the harness: its kernel built by hand
    (through K2 / K3 where the config is fused), run_mcmc_sharded from a
    generator of the config's seed at its budget (fan-out 1, no chunk cap),
    pooled by hand into the npz's (seeds, draws, ...) layout."""
    from adaptive_mcmc_tpu_torch.parallel import run_mcmc_sharded
    target = getattr(amt, cfg.target)()
    if cfg.kernel == "arwmh":
        kernel = amt.arwmh(target, amt.ARWMHConfig(
            lr_decay=cfg.lr_decay, num_warmup=cfg.num_warmup, adapt=True,
            fused=cfg.fused))
    else:
        kernel = amt.asss(target, amt.ASSSConfig(
            lr_decay=cfg.lr_decay, num_warmup=cfg.num_warmup,
            fused=cfg.fused))
    require(cfg.fan_out == 1 and cfg.chains_per_seed == 1,
            f"{cfg.run_name()}: one chain per seed")
    samples, extras, _ = run_mcmc_sharded(
        kernel, torch.Generator("cuda").manual_seed(cfg.seed0),
        cfg.num_warmup, cfg.num_samples, thinning=cfg.thinning,
        n_chains=cfg.n_seeds, extra_fields=("potential_energy", "as_change"))
    return {"samples": samples.transpose(0, 1).cpu().numpy(),
            "potential_energy":
                extras["potential_energy"].transpose(0, 1).cpu().numpy()}


def harness_gate(amt, cfg, npz: dict, label: str) -> str:
    """The cell's pooled draws against the posterior's truth: eight schools
    and kidiq against the port's quadrature (experiments/quadrature.py),
    diamonds NUTS against the gold draws (diamonds_gate); the HARNESS_DIRECT
    cells against direct_drive, bit for bit."""
    from adaptive_mcmc_tpu_torch.experiments import quadrature
    target, kernel = cfg.target, cfg.kernel
    samples = npz["samples"]
    flat = samples.reshape(-1, samples.shape[-1]).astype(np.float64)
    if (target, kernel) in HARNESS_DIRECT:
        t0 = time.perf_counter()
        want = direct_drive(amt, cfg)
        for k, v in want.items():
            require(npz[k].shape == v.shape and np.array_equal(npz[k], v),
                    f"{label}: {k} differs from run_mcmc_sharded's")
        print(f"{label}: samples {samples.shape} and potential_energy equal "
              f"bit for bit those of run_mcmc_sharded driven directly (same "
              f"kernel, seed {cfg.seed0} and budget; "
              f"{time.perf_counter() - t0:.3f} s)")
        return "run_mcmc_sharded, bit for bit"
    if target == "diamonds":
        diamonds_gate(amt, torch.from_numpy(samples.swapaxes(0, 1)), label)
        return "gold"
    if target == "eight_schools":
        tr = quadrature.eight_schools_truth()
        mu, lt = flat[:, 0].mean(), flat[:, 1].mean()
        print(f"{label}: mean mu {mu:.4f} (quadrature {tr['mean_mu']:.4f}), "
              f"mean log tau {lt:.4f} ({tr['mean_log_tau']:.4f})")
        require(abs(mu - tr["mean_mu"]) < HARNESS_MU_TOL,
                f"{label}: mean mu {mu}")
        require(abs(lt - tr["mean_log_tau"]) < HARNESS_LOG_TAU_TOL,
                f"{label}: mean log tau {lt}")
        return "quadrature"
    tr = quadrature.kidiq_truth()
    mean = np.concatenate([tr["mean_beta"], [tr["mean_log_sigma"]]])
    sd = np.concatenate([tr["sd_beta"], [tr["sd_log_sigma"]]])
    err = np.abs(flat.mean(0) - mean) / sd
    print(f"{label}: |mean - quadrature| / posterior sd "
          f"{np.round(err, 4).tolist()} ([beta(3), log sigma])")
    require(err.max() <= HARNESS_KIDIQ_ERR, f"{label}: mean error {err}")
    return "quadrature"


def check_lr_decay(amt, runner, summaries, cell, out_dir, label: str,
                   card: str) -> None:
    """run_lr_decay of one HARNESS_LR_DECAY-like cell; every summary on
    the log grid, finite and stamped with its driver where fused."""
    target, kernel, n_pow, decays, fused = cell
    t0 = time.perf_counter()
    paths = runner.run_lr_decay(
        target, kernel, n_pow=n_pow, n_seeds=HARNESS_SEEDS,
        out_dir=str(out_dir / label.replace(" ", "_")), verbose=False,
        fused=fused, **({} if decays is None else {"lr_decays": decays}))
    grid = amt.ns_logscale(n_pow).numpy()
    for p in paths:
        meta, cols = summaries.read_lr_decay_summary(
            summaries.summary_path_for(p))
        require(np.array_equal(cols["i"], grid)
                and all(np.isfinite(v).all() for v in cols.values()),
                f"lr_decay summary {p.name}")
        require(meta.get("driver") == ("step_n:"
                                       + runner.FUSED_KERNELS[kernel]
                                       if fused else None),
                f"lr_decay {label}: driver {meta.get('driver')}")
    print(f"harness lr_decay {target}/{kernel} ({label}), n_pow {n_pow}, "
          f"{len(paths)} decay(s) x {HARNESS_SEEDS} seeds: "
          f"{time.perf_counter() - t0:.3f} s, {len(grid)} grid points per "
          f"decay, summaries finite on {card}")


def check_posterior_predictive(amt, samples, card: str) -> None:
    """posterior_predictive on a kidiq cell's draws (seeds, draws, 4) on the
    card: y_rep's mean over the draws against X @ E[β] (E[β] the draws'
    mean).  Their difference at observation j is the mean over draws of
    σ_k z_kj, with MC standard error s_j = sqrt(mean σ² / n); the mean over
    the 434 observations of the difference in s_j (sd 1 / sqrt(434) under
    the model) and of its square (sd sqrt(2 / 434)) are held within 3 of
    their standard errors."""
    from adaptive_mcmc_tpu_torch.analysis import posterior_predictive
    t0 = time.perf_counter()
    x = torch.from_numpy(samples.reshape(-1, samples.shape[-1])).cuda()
    target = amt.kidiq()
    out = posterior_predictive(target, torch.Generator("cuda").manual_seed(3),
                               x)["kid_score_rep"]
    d = amt.models.data.kidiq()
    X = torch.from_numpy(np.stack([np.ones_like(d["mom_hs"]), d["mom_hs"],
                                   d["mom_iq"]], 1)).double().cuda()
    sites = target.constrain(x.double())
    n, n_obs = out.shape
    require(out.is_cuda, "posterior_predictive ran off the card")
    require(n_obs == X.shape[0] and bool(torch.isfinite(out).all()),
            f"posterior_predictive: y_rep {tuple(out.shape)}")
    diff = out.double().mean(0) - X @ sites["beta"].mean(0)
    se = torch.sqrt((sites["sigma"] ** 2).mean() / n)
    zs = (diff / se).cpu().numpy()
    z_mean = float(zs.mean()) * np.sqrt(n_obs)
    z_sq = (float((zs ** 2).mean()) - 1.0) / np.sqrt(2.0 / n_obs)
    print(f"posterior_predictive kidiq on {n} draws x {n_obs} observations: "
          f"y_rep mean - X E[beta] in MC standard errors: mean "
          f"{zs.mean():.4f} ({z_mean:.3f} of its s.e.), mean square "
          f"{(zs ** 2).mean():.4f} ({z_sq:.3f} of its s.e.), max "
          f"{np.abs(zs).max():.3f}; {time.perf_counter() - t0:.3f} s on "
          f"{card}")
    require(abs(z_mean) <= 3.0 and abs(z_sq) <= 3.0,
            "posterior_predictive location off X @ E[beta]")


def check_collectives(amt, samples, card: str) -> None:
    """cross_chain_moments and sharded_gelman_rubin on a cell's draws
    (seeds, draws, d) on the card against plain torch mean and var and
    infer.diagnostics' split R̂ (float64 of the same draws), at fp32
    tolerance."""
    from adaptive_mcmc_tpu_torch.infer.diagnostics import gelman_rubin
    from adaptive_mcmc_tpu_torch.parallel import (
        chain_mesh,
        cross_chain_moments,
        sharded_gelman_rubin,
    )
    x = torch.from_numpy(samples).cuda()          # (chains, draws, d)
    last = x[:, -1]
    mean, var = cross_chain_moments(last, chain_mesh())
    want_m = last.double().mean(0)
    want_v = last.double().var(0, correction=0)
    by_draw = x.transpose(0, 1).contiguous()       # (draws, chains, d)
    rhat = sharded_gelman_rubin(by_draw, chain_mesh())
    want_r = gelman_rubin(by_draw.double())
    errs = [float(((a.double() - b).abs()
                   / (COLLECTIVE_ATOL + COLLECTIVE_RTOL * b.abs())).max())
            for a, b in ((mean, want_m), (var, want_v), (rhat, want_r))]
    print(f"collectives on {tuple(x.shape)} draws (chains, draws, d): "
          f"|err| / (atol + rtol |want|) at most: cross_chain_moments mean "
          f"{errs[0]:.4f}, var {errs[1]:.4f}; sharded_gelman_rubin "
          f"{errs[2]:.4f} against split R-hat (max R-hat "
          f"{float(rhat.max()):.4f}) on {card}")
    require(mean.is_cuda and rhat.is_cuda, "collectives left the card")
    require(max(errs) <= 1.0, f"collectives: {errs}")


def w_eval_fused_times(amt, card: str) -> None:
    """K2 and K3 at the w_eval shape (100 chains, each target's d): µs per
    step of one timed step_n (CUDA events) from a state warmed by a short
    one, beside the bound per step at that shape (k2_bound / k3_bound; K3's
    from this run's iteration counts)."""
    from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3
    C = HARNESS_SEEDS
    for name in ("eight_schools_noncentered", "eight_schools_centered",
                 "kidiq", "diamonds"):
        t = getattr(amt, name)()
        n_data = t.data.on(torch.device("cuda"))["kernel_data"].numel()
        for lib, S in W_EVAL_STEPS.items():
            g = torch.Generator("cuda").manual_seed(11)
            if lib == "arwmh_fused":
                kernel = amt.arwmh(t, amt.ARWMHConfig(fused=True))
            else:
                kernel = amt.asss(t, amt.ASSSConfig(fused=True))
            state = kernel.step_n(kernel.init(g, n_chains=C), 1000, g)
            us = step_n_us(kernel, state, S, f"w_eval shape {lib}[{name}]",
                           card)
            if lib == "arwmh_fused":
                b = k2_bound(name, C, t.dim, S, 0, n_data)
            else:
                drive = k3.build_fused_asss(t, kernel.config)
                a = state.adapt_state
                _, _, iters = drive((state.position, state.potential_energy,
                                     a.loc, a.scale, state.i,
                                     state.as_change), S, 0, 1,
                                    generator=g, return_iters=True)
                b = k3_bound(name, C, t.dim, S, 0, iters, n_data)
            print(f"w_eval shape {lib}[{name}] ({C}, {t.dim}): {us:.4f} µs "
                  f"per step, bound {b['bound_ms'] * 1e3 / S:.6f} µs per "
                  f"step by {b['bound_by']} ({us / (b['bound_ms'] * 1e3 / S):.1f}x)"
                  f" on {card}")


def run_harness(amt, k1, counters, card: str):
    """Every w_eval cell through run_w_eval at HARNESS_SEEDS seeds on its
    default driver, its budget cut by HARNESS_SCALES (the CLI's --scale),
    NUTS fanned out 16 ways, then the HARNESS_DIRECT cells again through K2
    and K3; each cell's gate; the lr_decay cells (the ASSS machine, K2);
    evaluate_run on the default drivers' diamonds cells against the gold
    draws with the Hungarian check; posterior_predictive and the
    collectives on the cells' draws.  Returns K1's launches (chains first,
    chains last) and K2's and K3's by (lib, target)."""
    import shutil
    from adaptive_mcmc_tpu_torch.experiments import cli, configs, evaluate
    from adaptive_mcmc_tpu_torch.experiments import runner, summaries
    k1, k2, k3 = counters
    out_dir = HARNESS_DIR
    shutil.rmtree(out_dir, ignore_errors=True)
    first = last = 0
    fused_launches = {}
    npzs = {}
    cells = [(t, k, s, None) for (t, k), s in HARNESS_SCALES.items()]
    cells += [(t, k, HARNESS_SCALES[(t, k)], True) for t, k in HARNESS_DIRECT]
    for target, kernel, scale, fused in cells:
        t_cell = time.perf_counter()
        budget = cli._scaled_budget(target, kernel, scale)
        fan = 16 if kernel == "nuts" else 1
        require((budget["num_samples"] // budget["thinning"]) % fan == 0,
                f"{target}/{kernel}: draws do not divide by {fan}")
        cfg = configs.RunConfig(target=target, kernel=kernel,
                                n_seeds=HARNESS_SEEDS, fan_out=fan,
                                out_dir=str(out_dir / ("fused" if fused
                                                       else "default")),
                                fused=fused, **budget)
        reset_launches(*counters)
        npz = runner.run_w_eval(cfg, verbose=False)
        n_k1 = k1.launches
        if fused:
            mod, lib = (k2, "arwmh_fused") if kernel == "arwmh" \
                else (k3, "asss_fused")
            n_fused = mod.launches
            fused_launches[(lib, target)] = n_fused
            require(n_k1 == 0 and n_fused > 0,
                    f"{target}/{kernel}: {lib} launched {n_fused} times, "
                    f"K1 {n_k1}")
            launched = f"{lib} launches {n_fused}"
        else:
            if kernel == "asss":
                last += n_k1
            elif kernel != "nuts":
                first += n_k1
            require(n_k1 > 0 if kernel != "nuts" else n_k1 == 0,
                    f"{target}/{kernel}: K1 launched {n_k1} times")
            require(all(m.launches == 0 for m in counters if m is not k1),
                    f"{target}/{kernel} launched K2 or K3")
            launched = f"K1 launches {n_k1}"
        with np.load(npz, allow_pickle=False) as d:
            arrays = {k: d[k] for k in ("samples", "potential_energy")}
            meta = json.loads(str(d["meta"]))
        samples = arrays["samples"]
        draws = budget["num_samples"] // budget["thinning"]
        d_t = runner.TARGETS[target]().dim
        require(samples.shape == (HARNESS_SEEDS, draws, d_t)
                and bool(np.isfinite(samples).all()),
                f"{target}/{kernel}: samples {samples.shape}")
        stamp = meta["driver"]
        require(stamp == f"collect_n:{runner.FUSED_KERNELS[kernel]}"
                if fused else ":" not in stamp,
                f"{target}/{kernel}: driver {stamp}")
        label = f"harness {target}/{kernel}" + (
            f" through {runner.FUSED_KERNELS[kernel]}" if fused else "")
        gate = harness_gate(amt, cfg, arrays, label)
        print(f"{label}: scale {scale} ({budget['num_warmup']} + "
              f"{budget['num_samples']} steps, thinning "
              f"{budget['thinning']}, fan-out {fan}), {HARNESS_SEEDS} "
              f"seeds: wall {meta['wall_seconds']:.3f} s, "
              f"{meta['chain_iters_per_sec']:.1f} chain-iters/s, driver "
              f"{meta['driver']}, {launched}, gate: {gate}; "
              f"{time.perf_counter() - t_cell:.1f} s with the gate on "
              f"{card}")
        if fused:
            continue
        npzs[(target, kernel)] = npz
        if (target, kernel) == ("kidiq", "arwmh"):
            check_posterior_predictive(amt, samples, card)
        elif (target, kernel) == ("eight_schools", "arwmh"):
            check_collectives(amt, samples, card)
    reset_launches(*counters)
    check_lr_decay(amt, runner, summaries, HARNESS_LR_DECAY, out_dir,
                   "the ASSS machine", card)
    last += k1.launches
    require(k1.launches > 0, "lr_decay never launched K1")
    reset_launches(*counters)
    check_lr_decay(amt, runner, summaries, HARNESS_LR_DECAY_K2, out_dir,
                   "through K2", card)
    key = ("arwmh_fused", HARNESS_LR_DECAY_K2[0])
    fused_launches[key] = fused_launches.get(key, 0) + k2.launches
    require(k2.launches > 0 and k1.launches == 0,
            f"lr_decay through K2 launched K2 {k2.launches}, K1 "
            f"{k1.launches} times")
    gold = gold_draws(amt)
    for kernel in ("arwmh", "asss", "nuts"):
        timings = {}
        npz = npzs[("diamonds", kernel)]
        table = evaluate.evaluate_run(
            npz, gold, npz.parent / f"eval_{kernel}.csv",
            exact_wasserstein_seeds=HARNESS_EVAL_SEEDS,
            exact_w_batch=HARNESS_EVAL_BATCH, sinkhorn=False, timings=timings)
        w = table["wasserstein"][:HARNESS_EVAL_SEEDS]
        require(bool(np.isfinite(w).all()), f"diamonds/{kernel}: W {w}")
        cols = ", ".join(
            f"{c} {np.nanmean(table[c]):.6f} ± {np.nanstd(table[c], ddof=1):.6f}"
            for c in ("rmse_means", "wasserstein", "mmd", "ess_median"))
        secs = ", ".join(f"{c} {s:.3f} s" for c, s in timings.items())
        print(f"harness evaluate diamonds/{kernel} against the gold draws "
              f"(exact W on {HARNESS_EVAL_SEEDS} seeds, batch "
              f"{HARNESS_EVAL_BATCH}, the Hungarian check held): {cols}; "
              f"seconds per column: {secs} on {card}")
    run_artifact_figures([out_dir / "default", out_dir / "the_ASSS_machine",
                          out_dir / "through_K2"], card)
    shutil.rmtree(out_dir, ignore_errors=True)
    w_eval_fused_times(amt, card)
    return first, last, fused_launches


# ---------------------------------------------------------------------------
# ASSS's lockstep step from its CUDA graphs, and the figure families.
# ---------------------------------------------------------------------------

def check_asss_lockstep_graph(amt, k1, card: str) -> int:
    """ASSS's lockstep step from its CUDA graphs (the part before the
    shrinkage loop, a block of SHRINK_TRIPS trips, the part after it)
    against the same blocks run eagerly, bit for bit: probe of
    LOCKSTEP_CHECK_STEPS steps on eight schools at N_CHAINS chains with
    adaptation (final state, mean trips per chain, the generator's next
    draws; K1 chains first once per step in both), then a frozen seeded
    sample_pnx on the mixture (captured, then replayed) against eager=True
    and against the eager loop with SHRINK_TRIPS = 1, which is the step's
    loop before blocks (a host read per trip; tests/
    test_torch_asss_lockstep_graph.py holds the two equal).  Returns the
    graph run's K1 launches."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors
    ta = importlib.import_module("adaptive_mcmc_tpu_torch.kernels.asss")
    t = amt.eight_schools_noncentered()
    k = amt.asss(t, amt.ASSSConfig(num_warmup=ASSS_PROFILE_WARMUP))
    init = k.init(torch.Generator("cuda").manual_seed(13), n_chains=N_CHAINS)
    runs = {}
    for eager in (True, False):
        k1.launches = 0
        g = torch.Generator("cuda").manual_seed(14)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, trips = k.probe(init, LOCKSTEP_CHECK_STEPS, g, eager=eager)
        torch.cuda.synchronize()
        runs[eager] = ([*state_tensors(s), trips,
                        torch.rand(8, generator=g, device="cuda")],
                       k1.launches, time.perf_counter() - t0)
    (e, e_k1, e_s), (gr, g_k1, g_s) = runs[True], runs[False]
    n = LOCKSTEP_CHECK_STEPS
    require(e_k1 == g_k1 == n,
            f"ASSS lockstep K1 launches: eager {e_k1}, graph {g_k1}, {n}")
    require(all(torch.equal(a, b) for a, b in zip(e, gr)),
            "ASSS lockstep: the graph run differs from the eager blocks")
    require(int(gr[0]) == n and bool(torch.isfinite(gr[1]).all()),
            "ASSS lockstep: step counter or positions")
    print(f"ASSS lockstep step from its CUDA graphs equals the eager blocks "
          f"bit for bit: probe of {n} steps on eight schools at {N_CHAINS} "
          f"chains with adaptation (final state, mean trips per chain "
          f"{float(gr[-2].mean()):.4f}, the generator's next draws); K1 "
          f"launches {g_k1} = steps in both; {e_s * 1e3 / n:.4f} ms per step "
          f"eagerly, {g_s * 1e3 / n:.4f} from the graphs (capture "
          f"included; SHRINK_TRIPS {ta.SHRINK_TRIPS}) on {card}")
    kf, adapt = amt.analysis.frozen_asss(amt.gaussian_mixture_1d(),
                                         device="cuda")
    X = torch.linspace(-2.5, 2.5, ROLLOUT_PROBES, device="cuda")[:, None]

    def rollout(eager: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = amt.sample_pnx(kf, 21, X, adapt, n=ROLLOUT_N,
                             n_samples=ROLLOUT_SAMPLES, eager=eager)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (captured, c_s), (replayed, r_s) = rollout(False), rollout(False)
    eager, e_s = rollout(True)
    saved, ta.SHRINK_TRIPS = ta.SHRINK_TRIPS, 1
    try:
        per_trip, p_s = rollout(True)
    finally:
        ta.SHRINK_TRIPS = saved
    require(torch.equal(captured, eager) and torch.equal(replayed, eager),
            "seeded frozen ASSS: the graph rollout differs from the eager "
            "blocks")
    require(torch.equal(per_trip, eager),
            "seeded frozen ASSS: the blocked rollout differs from the "
            "per-trip loop")
    C = ROLLOUT_PROBES * ROLLOUT_SAMPLES
    print(f"seeded frozen ASSS sample_pnx on the mixture at {C} chains, n = "
          f"{ROLLOUT_N}: from the graphs (captured, then replayed) equals "
          f"the eager blocks and the eager per-trip loop (SHRINK_TRIPS 1) "
          f"bit for bit; s per call: captured {c_s:.3f}, replayed "
          f"{r_s:.3f}, eager blocks {e_s:.3f}, per-trip loop {p_s:.3f} on "
          f"{card}")
    return g_k1


def shrink_trial(amt, card: str) -> None:
    """Host ms per step of ASSS's lockstep step from its CUDA graphs for
    each SHRINK_TRIPS of SHRINK_TRIAL: eight schools at N_CHAINS chains
    with adaptation (LockstepGraph over SHRINK_TRIAL_STEPS steps after a
    capturing call; trips run per step and probe's mean trips per chain)
    and the frozen seeded rollout of the figures (d = 1, n = ROLLOUT_N,
    SHRINK_TRIAL_ROLLOUTS calls after a capturing one)."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import LockstepGraph
    ta = importlib.import_module("adaptive_mcmc_tpu_torch.kernels.asss")
    t = amt.eight_schools_noncentered()
    k = amt.asss(t, amt.ASSSConfig(num_warmup=ASSS_PROFILE_WARMUP))
    start = k.init(torch.Generator("cuda").manual_seed(15),
                   n_chains=N_CHAINS)
    kf, adapt = amt.analysis.frozen_asss(amt.gaussian_mixture_1d(),
                                         device="cuda")
    X = torch.linspace(-2.5, 2.5, ROLLOUT_PROBES, device="cuda")[:, None]
    saved = ta.SHRINK_TRIPS
    rows = []
    try:
        for block in SHRINK_TRIAL:
            ta.SHRINK_TRIPS = block
            drive = LockstepGraph(k.step_parts,
                                  torch.Generator("cuda").manual_seed(16),
                                  "asss.step")
            p = drive.advance(start, 5)
            torch.cuda.synchronize()
            trips0, t0 = counted("asss.trips"), time.perf_counter()
            p = drive.advance(p["s"], SHRINK_TRIAL_STEPS)
            torch.cuda.synchronize()
            ms10 = (time.perf_counter() - t0) * 1e3 / SHRINK_TRIAL_STEPS
            run10 = (counted("asss.trips") - trips0) / SHRINK_TRIAL_STEPS
            mean10 = float(p["total"].mean()) / SHRINK_TRIAL_STEPS
            amt.sample_pnx(kf, 0, X, adapt, n=ROLLOUT_N,
                           n_samples=ROLLOUT_SAMPLES)
            torch.cuda.synchronize()
            trips0, t0 = counted("asss.trips"), time.perf_counter()
            for s in range(1, SHRINK_TRIAL_ROLLOUTS + 1):
                amt.sample_pnx(kf, s, X, adapt, n=ROLLOUT_N,
                               n_samples=ROLLOUT_SAMPLES)
            torch.cuda.synchronize()
            steps1 = SHRINK_TRIAL_ROLLOUTS * ROLLOUT_N
            ms1 = (time.perf_counter() - t0) * 1e3 / steps1
            run1 = (counted("asss.trips") - trips0) / steps1
            rows.append((block, ms10, ms1))
            print(f"SHRINK_TRIPS trial, {block} trips per block: eight "
                  f"schools at {N_CHAINS} chains {ms10:.4f} ms per step "
                  f"({run10:.1f} trips run per step, mean trips per chain "
                  f"{mean10:.4f}); frozen rollout on the mixture at "
                  f"{ROLLOUT_PROBES * ROLLOUT_SAMPLES} chains {ms1:.4f} ms "
                  f"per step ({run1:.1f} trips run per step) on {card}")
    finally:
        ta.SHRINK_TRIPS = saved
    best10 = min(rows, key=lambda r: r[1])[0]
    best1 = min(rows, key=lambda r: r[2])[0]
    print(f"SHRINK_TRIPS trial: fastest at d = 10 {best10}, at d = 1 "
          f"{best1}; the kernel's SHRINK_TRIPS is {saved}")


def profile_asss_lockstep(amt, card: str) -> None:
    """ASSS's lockstep step (step_n=None) eagerly and from its CUDA graphs
    through profile_pair, beside PR 2's eager row."""
    k = dataclasses.replace(
        amt.asss(amt.eight_schools_noncentered(),
                 amt.ASSSConfig(num_warmup=NUM_WARMUP)),
        step_n=None, collect_n=None)
    profile_pair("ASSS lockstep", k, N_CHAINS, ASSS_LOCKSTEP_PROFILE_STEPS,
                 card)
    print(f"ASSS lockstep step: PR 2's eager row at {N_CHAINS} chains: "
          f"{ASSS_LOCKSTEP_PR2_ROW}")


def profile_asss_rollout(amt, card: str) -> None:
    """The frozen ASSS rollout step of the diagnostics (N(0, 1), FIG_POINTS
    x FIG_SAMPLES chains, n = 1), eagerly and from its CUDA graphs: host
    ms per step over DIAG_TIMED_ROLLOUTS calls (no profiler), then kernels,
    device busy and idle share per step over ROLLOUT_PROFILED calls under
    torch.profiler; beside PR 9's eager row."""
    from torch.profiler import ProfilerActivity, profile
    kf, adapt = amt.analysis.frozen_asss(amt.std_normal(1), device="cuda")
    X = torch.linspace(-2.5, 2.5, FIG_POINTS, device="cuda")[:, None]
    n = ROLLOUT_PROFILED
    out = {}
    for eager in (True, False):
        host_ms = rollout_ms(amt, kf, adapt, X, eager)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, secs = timed(lambda: [amt.sample_pnx(
                kf, s, X, adapt, n=1, n_samples=FIG_SAMPLES, eager=eager)
                for s in range(n)])
        name = "eager" if eager else "graph"
        n_kernels, busy_us = device_activity(
            prof, f"frozen ASSS rollout {name}", n, "step")
        traced_ms = secs * 1e3 / n
        out[eager] = (host_ms, traced_ms, n_kernels / n, busy_us / n,
                      1.0 - busy_us / n / (traced_ms * 1e3))
        print(f"frozen ASSS rollout step {name} at {FIG_POINTS * FIG_SAMPLES}"
              f" chains: host {host_ms:.4f} ms ({traced_ms:.4f} under the "
              f"profiler), kernels {n_kernels / n:.1f}, device busy "
              f"{busy_us / n:.2f} µs, idle share {out[eager][4]:.4f} in the "
              f"profiled window on {card}")
    print(f"frozen ASSS rollout step, eager -> graph: host "
          f"{out[True][0]:.4f} -> {out[False][0]:.4f} ms, kernels "
          f"{out[True][2]:.1f} -> {out[False][2]:.1f}, idle share "
          f"{out[True][4]:.4f} -> {out[False][4]:.4f}; {ROLLOUT_PR9_ROW}")


def run_figures(amt, counters, card: str) -> int:
    """The 16 families' data (analysis.figures, --data-only) on the card at
    figures.py's default sizes into FIGURES_DIR: seconds per family, the
    peak device memory, every sample_pnx rollout on the CUDA device, K1
    launched (adaptation_drift) and K2/K3 not, and the theory gates
    (figures.theory_gates).  Returns K1's launches."""
    import shutil
    F = importlib.import_module("adaptive_mcmc_tpu_torch.analysis.figures")
    k1, k2, k3 = counters
    shutil.rmtree(FIGURES_DIR, ignore_errors=True)
    reset_launches(*counters)
    before = {d: counted(f"rollouts.{d}") for d in ("cpu", "cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = F.main(FIGURES_DIR, device="cuda", data_only=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    require(list(seconds) == list(F.ALL_FIGURES), "figures: families")
    data = {name: F.load_data(FIGURES_DIR / f"{name}.npz")
            for name in F.ALL_FIGURES}
    for name, secs in seconds.items():
        size = (FIGURES_DIR / f"{name}.npz").stat().st_size
        print(f"figures {name}: data in {secs:.3f} s ({size} bytes) on "
              f"{card}")
    devices = {d: counted(f"rollouts.{d}") - n for d, n in before.items()}
    require(devices.get("cpu", 0) == 0 and devices.get("cuda", 0) > 0,
            f"figures: sample_pnx rollouts by device {devices}")
    require(k1.launches > 0 and k2.launches == k3.launches == 0,
            f"figures: K1 {k1.launches}, K2 {k2.launches}, K3 "
            f"{k3.launches} launches")
    for name, value, limit, held in F.theory_gates(data):
        print(f"figures gate {name}: {value:.6g} against {limit:.6g}: "
              f"{'held' if held else 'FAILED'}")
        require(held, f"figures gate {name}: {value} against {limit}")
    print(f"figures: 16 families in {sum(seconds.values()):.1f} s, peak "
          f"device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), sample_pnx rollouts "
          f"{devices}, K1 launches {k1.launches} (adaptation_drift), data "
          f"in {FIGURES_DIR} on {card}")
    return k1.launches


def run_artifact_figures(runs: list, card: str) -> None:
    """analysis.artifact_figures' data part on the card over the harness's
    run roots; families without their artifacts are listed as skipped."""
    A = importlib.import_module(
        "adaptive_mcmc_tpu_torch.analysis.artifact_figures")
    for root in runs:
        t0 = time.perf_counter()
        made, skipped = A.main(FIGURES_DIR / "artifacts", runs=root,
                               device="cuda", data_only=True)
        print(f"artifact figures over {root.name}: {len(made)} made, "
              f"{len(skipped)} skipped (missing artifacts), "
              f"{time.perf_counter() - t0:.3f} s on {card}")


def layouts(amt, build, chains: dict) -> dict:
    """Lanes per chain of both K1 kernels at the main path's (4096, 10) and
    of every K2 and K3 instantiation, printed with the warps its check's
    chain count makes and how many of them each SM holds (the occupancy
    calculator, from ptxas's registers)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d = amt.eight_schools_noncentered().dim
    todo = [("chol_update", f"d{d}", "first", N_CHAINS),
            ("chol_update", f"cl_d{d}", "last", N_CHAINS)]
    todo += [("chol_update", f"d{d}", f"first at {C} chains", C)
             for C, _ in K1_SHAPES[2:]]
    todo += [(lib, getattr(amt, name)().device_potential, name, None)
             for lib in ("arwmh_fused", "asss_fused") for name in TARGETS]
    out = {}
    for lib, tag, name, k1_chains in todo:
        lanes, threads, per_sm = build.layout(lib, tag, k1_chains)
        require(lanes >= 1 and threads % 32 == 0 and per_sm > 0,
                f"{lib}[{tag}] layout")
        C = k1_chains or chains[name]
        blocks = -(-C * lanes // threads)
        warps = blocks * threads // 32
        resident = min(per_sm, -(-blocks // sms)) * threads // 32
        print(f"layout {lib}[{tag}]: {lanes} lanes per chain; {C} chains "
              f"make {warps} warps in {blocks} blocks of {threads} threads "
              f"on {sms} SMs ({min(blocks, sms)} SMs hold a block); an SM "
              f"holds at most {per_sm} blocks, so {resident} warps resident "
              f"per SM where it has work, in "
              f"{-(-blocks // (per_sm * sms))} wave(s)")
        if name == "first":
            require(min(blocks, sms) >= 128,
                    f"K1 chains first puts a block on {min(blocks, sms)} SMs")
        out[(lib, name)] = lanes
    return out


def mp_sharded(amt, mesh, counters, label: str, kernel, seed: int,
               budget: tuple, extra_fields: tuple) -> tuple:
    """``kernel`` through run_mcmc_sharded on ``mesh`` at ``budget``
    (chains a process, warmup, samples, thinning) after a short untimed
    run, its kernels' launches counted from 0 around it; then this
    process's block against a one-process run of it from the rank's
    generator, bit for bit (draws, extra fields, last state).  Returns
    (gathered draws, last state, chain-iters/s of this process, launches
    by module name)."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors
    from adaptive_mcmc_tpu_torch.parallel import (
        ChainMesh,
        chain_sharding,
        rank_generator,
        run_mcmc_sharded,
    )
    C, warmup, samples, thinning = budget
    dev = mesh.device
    # a short run first: a fresh process pays its first launches, the
    # graph's capture and the gather's first collective there
    run_mcmc_sharded(kernel, torch.Generator(dev).manual_seed(seed + 1),
                     thinning, thinning, thinning=thinning,
                     n_chains=C * mesh.size, mesh=mesh)
    reset_launches(*counters)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    s, extras, last = run_mcmc_sharded(
        kernel, torch.Generator(dev).manual_seed(seed), warmup, samples,
        thinning=thinning, n_chains=C * mesh.size, mesh=mesh,
        extra_fields=extra_fields)
    torch.cuda.synchronize(dev)
    rate = (warmup + samples) * C / (time.perf_counter() - t0)
    launches = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in counters}
    rows = chain_sharding(mesh, C * mesh.size)
    s1, extras1, last1 = run_mcmc_sharded(
        kernel, rank_generator(torch.Generator(dev).manual_seed(seed),
                               mesh.rank), warmup, samples,
        thinning=thinning, n_chains=C, mesh=ChainMesh(dev),
        extra_fields=extra_fields)
    require(torch.equal(s[:, rows], s1)
            and all(torch.equal(extras[f][:, rows], extras1[f])
                    for f in extra_fields)
            and all(torch.equal(a, b) for a, b in zip(state_tensors(last),
                                                      state_tensors(last1))),
            f"{label}: rank {mesh.rank}'s block differs from its "
            f"one-process run")
    require(bool(torch.isfinite(s).all()), f"{label}: non-finite draws")
    print(f"{label}: rank {mesh.rank} of {mesh.size} on {dev}: its block "
          f"of {C} chains equals its one-process run bit for bit; "
          f"{rate:.1f} chain-iters/s this rank; launches {launches}",
          flush=True)
    return s, last, rate, launches


def mp_collectives(mesh, draws, label: str) -> float:
    """cross_chain_moments and sharded_gelman_rubin over the mesh on this
    process's block of ``draws`` (frames, chains, d) against one process's
    on the gathered draws; returns the largest |err| / (atol + rtol
    |want|)."""
    from adaptive_mcmc_tpu_torch.parallel import (
        ChainMesh,
        chain_sharding,
        cross_chain_moments,
        sharded_gelman_rubin,
    )
    rows = chain_sharding(mesh, draws.shape[1])
    alone = ChainMesh(mesh.device)
    got = [*cross_chain_moments(draws[-1, rows], mesh),
           sharded_gelman_rubin(draws[:, rows], mesh)]
    want = [*cross_chain_moments(draws[-1], alone),
            sharded_gelman_rubin(draws, alone)]
    err = max(float(((a.double() - b.double()).abs()
                     / (MP_COLLECTIVE_ATOL
                        + MP_COLLECTIVE_RTOL * b.double().abs())).max())
              for a, b in zip(got, want))
    require(err <= 1.0, f"{label}: the collectives over the mesh differ "
                        f"from one process's ({err:.3f})")
    return err


def mp_nccl(amt, mesh, counters, card: str) -> dict:
    """Phase (a) in one process of the NCCL group."""
    t = amt.eight_schools_noncentered()
    k = amt.arwmh(t, amt.ARWMHConfig(num_warmup=MP_ARWMH[1]))
    s, _, rate, arwmh_n = mp_sharded(
        amt, mesh, counters, "A15 NCCL eight schools ARWMH (K1)", k, 41,
        MP_ARWMH, ("potential_energy",))
    err = mp_collectives(mesh, s, "A15 NCCL")
    k = amt.asss(amt.diamonds(), amt.ASSSConfig(
        fused=True, num_warmup=MP_ASSS_DIAMONDS[1]))
    _, _, asss_rate, asss_n = mp_sharded(
        amt, mesh, counters, "A15 NCCL diamonds ASSS (K3)", k, 42,
        MP_ASSS_DIAMONDS, ("potential_energy",))
    require(arwmh_n["chol_update"] > 0 and asss_n["asss_fused"] > 0,
            f"A15 NCCL: K1 {arwmh_n['chol_update']}, K3 "
            f"{asss_n['asss_fused']} launches")
    print(f"A15 NCCL rank {mesh.rank} of {mesh.size}: chain-iters/s this "
          f"rank: eight schools ARWMH (K1) {rate:.1f}, diamonds ASSS (K3) "
          f"{asss_rate:.1f}; collectives against one process's at most "
          f"{err:.4f} of rtol {MP_COLLECTIVE_RTOL} atol {MP_COLLECTIVE_ATOL}"
          f" on {card}", flush=True)
    return {"arwmh_rate": rate, "asss_rate": asss_rate,
            "launches": [["chol_update", None, arwmh_n["chol_update"]],
                         ["asss_fused", "diamonds", asss_n["asss_fused"]]]}


def mp_gloo(amt, mesh, counters, card: str) -> dict:
    """Phase (b) in one of two gloo processes sharing card 0."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import map_state
    from adaptive_mcmc_tpu_torch.parallel import (
        ChainMesh,
        chain_sharding,
        rank_seed,
    )
    k = amt.arwmh(amt.diamonds(), amt.ARWMHConfig(
        fused=True, num_warmup=MP_K2_DIAMONDS[1]))
    _, _, rate, k2_n = mp_sharded(
        amt, mesh, counters, "A15 gloo diamonds ARWMH (K2)", k, 43,
        MP_K2_DIAMONDS, ("potential_energy", "as_change"))
    require(k2_n["arwmh_fused"] > 0, "A15 gloo: K2 never launched")
    kf, adapt = amt.analysis.frozen_asss(amt.gaussian_mixture_1d(),
                                         device=mesh.device)
    P, S = ROLLOUT_PROBES, ROLLOUT_SAMPLES
    X = torch.linspace(-2.5, 2.5, P, device=mesh.device)[:, None]
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = amt.sample_pnx(kf, 21, X, adapt, n=ROLLOUT_N, n_samples=S,
                         mesh=mesh)
    torch.cuda.synchronize(mesh.device)
    pnx_s = time.perf_counter() - t0
    rows = chain_sharding(mesh, P * S)
    t0 = time.perf_counter()

    def grid(a):
        lead = a[:, None] if a.dim() else a
        return lead.expand((P, S) + tuple(a.shape[1:])) \
            .reshape((P * S,) + tuple(a.shape[1:]))[rows]

    # the twin in the eager blocks, which equal the graphs' (PR 12)
    alone = amt.sample_pnx(kf, rank_seed(21, mesh.rank), grid(X),
                           map_state(grid, adapt), n=ROLLOUT_N, n_samples=1,
                           mesh=ChainMesh(mesh.device), eager=True)
    torch.cuda.synchronize(mesh.device)
    alone_s = time.perf_counter() - t0
    require(out.shape == (P, S, 1) and torch.equal(
        out.reshape(P * S, 1)[rows], alone[:, 0]),
        f"A15 gloo: rank {mesh.rank}'s sample_pnx block differs from its "
        f"one-process rollout")
    print(f"A15 gloo rank {mesh.rank} of {mesh.size}: diamonds ARWMH (K2) "
          f"{rate:.1f} chain-iters/s this rank; seeded frozen ASSS "
          f"sample_pnx at {P * S} chains (n = {ROLLOUT_N}) in "
          f"{pnx_s:.3f} s (its first in this process: captures "
          f"included), its block of {rows.stop - rows.start} equal to the "
          f"one-process eager rollout of it ({alone_s:.3f} s) bit for bit, "
          f"on "
          f"{card}", flush=True)
    return {"k2_rate": rate,
            "launches": [["arwmh_fused", "diamonds", k2_n["arwmh_fused"]]]}


def mp_worker(argv: list) -> int:
    """One process of the multi-process phase: ``nccl`` (its own card) or
    ``gloo`` (card 0), rank, world size, rendezvous URL, the launch's
    time.time().  Prints its report as one line ``A15_REPORT {json}``."""
    import datetime

    import torch.distributed as dist

    import adaptive_mcmc_tpu_torch as amt
    from adaptive_mcmc_tpu_torch.bench import card_name
    from adaptive_mcmc_tpu_torch.ops.cuda import _build
    from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused as k2
    from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3
    from adaptive_mcmc_tpu_torch.ops.cuda import chol_update as k1
    from adaptive_mcmc_tpu_torch.parallel import (
        chain_mesh,
        initialize_distributed,
    )
    part, rank, world, init_method, launched = argv
    rank, world = int(rank), int(world)
    dev = torch.device("cuda", rank if part == "nccl" else 0)
    initialize_distributed(init_method, world, rank, device=dev,
                           backend=part,
                           timeout=datetime.timedelta(seconds=60))
    print(f"A15 {part} process {rank} of {world}: in its process group "
          f"{time.time() - float(launched):.1f} s after its launch",
          flush=True)
    try:
        mesh = chain_mesh()
        require(mesh.size == world and mesh.device == dev,
                f"mesh {mesh}")
        run = mp_nccl if part == "nccl" else mp_gloo
        report = run(amt, mesh, (k1, k2, k3), card_name())
        require(not _build.build_seconds,
                f"process {rank} ran nvcc: {_build.build_seconds}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("A15_REPORT " + json.dumps(report), flush=True)
    return 0


def run_multiprocess(card: str) -> dict:
    """The multi-process phase (A15): (a) NCCL, one process per card, at
    one process and, on a machine of several cards, at all of them; (b)
    dryrun_multichip(2) over gloo on the card, then two gloo processes
    sharing card 0.  Every process loads the libraries built at the start
    (one that runs nvcc fails); a process's failure, a timeout or a failed
    init fails the run.  Returns the launches of K1 (its chains-first
    kernel, target None), K2 and K3 (by target) summed over the processes,
    keyed (library, target)."""
    from adaptive_mcmc_tpu_torch.entry import (
        dryrun_multichip,
        free_tcp_address,
        run_workers,
    )
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    script = str(Path(__file__).resolve())
    launches: dict = {}
    rates = {}

    def group(part: str, world: int) -> list:
        url, launched = free_tcp_address(), str(time.time())
        outs = run_workers(lambda r: [script, MP_WORKER, part, str(r),
                                      str(world), url, launched],
                           world, MP_TIMEOUT, f"A15 {part} at {world}")
        reports = []
        for r, out in enumerate(outs):
            for line in out.splitlines():
                if line.startswith("A15_REPORT "):
                    reports.append(json.loads(line.split(" ", 1)[1]))
                elif line.startswith("A15 "):
                    print(f"  [process {r}] {line}")
        require(len(reports) == world, f"A15 {part}: {len(reports)} reports "
                                       f"from {world} processes")
        for rep in reports:
            for lib, target, n in rep["launches"]:
                launches[(lib, target)] = launches.get((lib, target), 0) + n
        return reports

    count = torch.cuda.device_count()
    for world in [1] + ([count] if count > 1 else []):
        reps = group("nccl", world)
        rates[world] = [r["arwmh_rate"] for r in reps]
    # the dry run's two processes beside the two gloo processes, all on
    # card 0 (no rate of (b) is a scaling figure)
    with ThreadPoolExecutor(1) as pool:
        dryrun = pool.submit(dryrun_multichip, 2, backend="gloo")
        reps = group("gloo", 2)
        dryrun.result()
    print(f"A15 chain-iters/s per process, eight schools ARWMH (K1) at "
          f"{MP_ARWMH[0]} chains a process: " + "; ".join(
              f"{w} NCCL process(es): " + ", ".join(f"{x:.1f}" for x in r)
              for w, r in rates.items())
          + f"; diamonds ARWMH (K2) at {MP_K2_DIAMONDS[0]} chains, two gloo "
          f"processes sharing card 0 (one card's SMs between them: no "
          f"scaling figure): " + ", ".join(f"{r['k2_rate']:.1f}"
                                           for r in reps) + f" on {card}")
    print(f"A15 multi-process phase: {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    return launches


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 lanes: int, res: dict) -> dict:
    return dict(name=name, route="cuda",
                source=f"adaptive_mcmc_tpu_torch/csrc/{source}",
                replaces=replaces, launches=launches, lanes=lanes, **res)


def main() -> int:
    t_start = time.perf_counter()

    t_phase = [t_start]

    def elapsed(phase: str) -> None:
        now = time.perf_counter()
        print(f"chip_smoke: {phase} done {now - t_start:.1f} s after the "
              f"start ({now - t_phase[0]:.1f} s)")
        t_phase[0] = now

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import adaptive_mcmc_tpu_torch as amt
    from adaptive_mcmc_tpu_torch.bench import card_name
    from adaptive_mcmc_tpu_torch.ops.cuda import _build
    from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused as k2
    from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_step as ks
    from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as auction_kernel
    from adaptive_mcmc_tpu_torch.ops.cuda import chol_update as k1
    tn = importlib.import_module("adaptive_mcmc_tpu_torch.kernels.nuts")

    # 1. device
    card = card_name()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build(*KERNELS)
    print(f"build {', '.join(KERNELS)}: {time.perf_counter() - t0:.3f} s "
          f"in parallel (nvcc " + ", ".join(
              f"{n} {_build.build_seconds.get(n, 0.0):.3f} s"
              for n in KERNELS) + ")")
    for name in KERNELS:
        _build.load(name)
        for line in _build.ptxas_summary(name):
            print(f"ptxas {name}: {line}")

    chains = {name: SLICE_CHAINS if name == "diamonds" else N_CHAINS
              for name in TARGETS}
    lanes = layouts(amt, _build, chains)

    # 2.-4. kernels against their plain versions
    elapsed("build and device")
    k1_res = check_k1(k1, dev, card)
    # the module: the package's kernels namespace binds arwmh to the builder
    step_res = check_step_kernels(
        ks, importlib.import_module("adaptive_mcmc_tpu_torch.kernels.arwmh"),
        k1, dev, card)
    elapsed("K1 and the ARWMH step kernels' checks")
    k2_res = {name: check_k2(amt, k2, dev, name, chains[name])
              for name in TARGETS}
    k3_res = {name: check_k3(amt, k3, dev, name, chains[name])
              for name in TARGETS}
    counters = (k1, k2, k3)
    elapsed("K2 and K3 checks")

    # 5. the ARWMH main path, through K1 (from the CUDA graph) and K2
    check_graph_equals_eager(amt, k1)
    reset_launches(*counters)
    ks.propose_launches = ks.accept_launches = ks.settle_launches = 0
    lock_rate, _ = run_main_path(amt, fused=False, card=card)
    k1_main = k1.launches
    step_main = (ks.propose_launches, ks.accept_launches, ks.settle_launches)
    require(k1_main == NUM_WARMUP + NUM_SAMPLES
            and set(step_main) == {k1_main},
            f"K1 launches {k1_main}, propose, accept and settle {step_main} "
            f"on the lockstep path, steps {NUM_WARMUP + NUM_SAMPLES}")
    reset_launches(*counters)
    fused_rate, arwmh_last = run_main_path(amt, fused=True, card=card)
    k2_main = k2.launches
    print(f"launches: ARWMH lockstep chol_update {k1_main}, ARWMH fused "
          f"arwmh_fused {k2_main}")
    require(k1_main > 0, "the lockstep ARWMH path never launched K1")
    require(k2_main > 0, "the fused ARWMH path never launched K2")
    k2_us = step_n_us(amt.arwmh(amt.eight_schools_noncentered(),
                                amt.ARWMHConfig(fused=True)),
                      arwmh_last, NUM_SAMPLES, "ARWMH fused (K2)", card)

    elapsed("the ARWMH main path")

    # 6. the ASSS main path through K3, then the ASSS drivers through K1
    reset_launches(*counters)
    asss_rate, asss_last = run_asss_fused(amt, card)
    k3_main = k3.launches
    require(k3_main > 0, "the ASSS main path never launched K3")
    k3_us = step_n_us(amt.asss(amt.eight_schools_noncentered(),
                               amt.ASSSConfig(fused=True)),
                      asss_last, NUM_WARMUP, "ASSS fused (K3)", card)
    k1_asss = {}
    for lockstep in (True, False):
        reset_launches(*counters)
        rate = run_asss_k1(amt, asss_last, lockstep, card)
        k1_asss[lockstep] = (rate, k1.launches)
        require(k1.launches > 0, "an ASSS driver never launched K1")
    print(f"launches: ASSS fused asss_fused {k3_main}, ASSS lockstep "
          f"chol_update {k1_asss[True][1]}, ASSS pipelined chol_update "
          f"{k1_asss[False][1]}")
    print(f"chain-iters/s on {card}: ARWMH lockstep {lock_rate:.1f}, ARWMH "
          f"fused {fused_rate:.1f} ({k2_us:.4f} µs per step in step_n), "
          f"ASSS fused {asss_rate:.1f} "
          f"({k3_us:.4f} µs per step in step_n), ASSS lockstep "
          f"{k1_asss[True][0]:.1f}, ASSS pipelined {k1_asss[False][0]:.1f}")

    elapsed("the ASSS paths")

    # the pipelined ASSS machine from its CUDA graph against the eager blocks
    asss_states = check_asss_graph(amt, k1, card)
    elapsed("the ASSS machine's graph")

    # ASSS's lockstep step from its CUDA graphs against its eager blocks,
    # and the trial of its shrinkage trips per block
    reset_launches(*counters)
    k1_lockstep = check_asss_lockstep_graph(amt, k1, card)
    shrink_trial(amt, card)
    elapsed("ASSS's lockstep graph and the SHRINK_TRIPS trial")

    # 7. the slice: diamonds through K3 and K2 with the gold check; kidiq
    # through K3 and K2 with its OLS check; centered eight schools through
    # K3 and K2
    launches = {("arwmh_fused", "eight_schools_noncentered"): k2_main,
                ("asss_fused", "eight_schools_noncentered"): k3_main}
    rates = {}
    sets = []
    paths = [("diamonds", "ASSS", SLICE_CHAINS, SLICE_WARMUP, SLICE_SAMPLES),
             ("diamonds", "ARWMH", SLICE_CHAINS, ARWMH_DIAMONDS_WARMUP,
              ARWMH_DIAMONDS_SAMPLES)]
    for name, warmup, samples in (
            ("kidiq", KIDIQ_WARMUP, KIDIQ_SAMPLES),
            ("eight_schools_centered", CENTERED_WARMUP, CENTERED_SAMPLES)):
        paths += [(name, "ASSS", N_CHAINS, warmup, samples),
                  (name, "ARWMH", N_CHAINS, warmup, samples)]
    for name, sampler, C, warmup, samples in paths:
        mod, lib = (k3, "asss_fused") if sampler == "ASSS" \
            else (k2, "arwmh_fused")
        reset_launches(*counters)
        rate, draws = run_fused(amt, name, sampler, C, warmup, samples, card)
        launches[(lib, name)] = mod.launches
        rates[(sampler, name)] = rate
        label = f"{sampler} fused {name}"
        print(f"launches: {label} {lib} {mod.launches}")
        require(mod.launches > 0, f"{label} never launched {lib}")
        if name == "diamonds":
            diamonds_gate(amt, draws, label)
            sets += diamond_sets(draws)
        elif name == "kidiq":
            kidiq_gate(amt, draws, label)
        else:
            sites = getattr(amt, name)().constrain(draws)
            print(f"{label}: mu mean {float(sites['mu'].mean()):.4f}, tau "
                  f"median {float(sites['tau'].median()):.4f} (no gate)")
        del draws
    print(f"chain-iters/s on {card}: " + ", ".join(
        f"{sampler} fused {name} {rate:.1f}"
        for (sampler, name), rate in rates.items()))

    elapsed("the slice")

    # the diagnostics: metrics on the diamonds draws, the auction, the
    # contraction estimators, invariance
    diag = run_diagnostics(amt, sets, counters, card)
    del sets
    elapsed("the diagnostics")

    # 8. SA through K1, the drivers, the bench and entry()
    check_sa_graph_equals_eager(amt, k1)
    _, k1_sa = run_sa(amt, k1, card)
    elapsed("the SA path")

    # NUTS: the machine from the CUDA graph against the eager blocks, the
    # block trial, eight schools against the quadrature, kidiq
    t_nuts = time.perf_counter()
    nuts_state = check_nuts_graph_equals_eager(amt, tn, card)
    nuts_block_trial(amt, tn, nuts_state, card)
    reset_launches(*counters)
    draws, nuts_es_rate = run_nuts(amt, tn, "eight_schools_noncentered",
                                   NUTS_WARMUP, NUTS_SAMPLES, card)
    nuts_eight_schools_gate(amt, draws)
    draws, nuts_kidiq_rate = run_nuts(amt, tn, "kidiq", NUTS_KIDIQ_WARMUP,
                                      NUTS_KIDIQ_SAMPLES, card)
    kidiq_gate(amt, draws, "NUTS kidiq")
    del draws
    require(all(m.launches == 0 for m in counters),
            "the NUTS path launched a kernel of csrc/")
    print(f"NUTS phases: {time.perf_counter() - t_nuts:.1f} s; "
          f"chain-iters/s on {card}: eight schools {nuts_es_rate:.1f}, kidiq "
          f"{nuts_kidiq_rate:.1f}")
    elapsed("the NUTS path")

    # the experiment harness: the ten w_eval cells on their default drivers,
    # diamonds ARWMH and ASSS again through K2 and K3, lr_decay,
    # evaluate_run, posterior_predictive, the collectives, K2 and K3 at the
    # w_eval shape
    *k1_harness, harness_fused = run_harness(amt, k1, counters, card)
    for key, n in harness_fused.items():
        launches[key] += n
    elapsed("the experiment harness")
    check_drivers(amt)
    check_bench()
    check_entry()
    elapsed("the drivers, the bench and entry()")

    # the 16 figure families' data at figures.py's sizes
    k1_figures = run_figures(amt, counters, card)
    elapsed("the figure families")

    # the port across processes (A15): NCCL one process per card, gloo two
    # processes on card 0, dryrun_multichip(2)
    mp_launches = run_multiprocess(card)
    k1_mp = mp_launches.pop(("chol_update", None))
    for key, n in mp_launches.items():
        launches[key] += n
    elapsed("the multi-process phase (A15)")

    # the lockstep steps under torch.profiler, after every timed path: once
    # the profiler has been on, every later launch of the process costs the
    # host more
    profile_pair("ARWMH lockstep",
                 amt.arwmh(amt.eight_schools_noncentered(),
                           amt.ARWMHConfig(num_warmup=NUM_WARMUP)),
                 N_CHAINS, PROFILE_STEPS, card)
    profile_pair("SA", amt.sa(amt.eight_schools_noncentered(),
                              amt.SAConfig(num_warmup=SA_WARMUP)),
                 SA_CHAINS, SA_PROFILE_STEPS, card)
    prof = {eager: profile_nuts(amt, tn, nuts_state, eager, card)
            for eager in (True, False)}
    profile_auction(diag, card)
    for name, state in asss_states.items():
        profile_asss_machine(amt, name, state, card)
    profile_asss_lockstep(amt, card)
    profile_asss_rollout(amt, card)
    elapsed("the profiled windows")
    print(f"NUTS trip, eager -> graph: host time "
          f"{prof[True]['host_ms']:.4f} -> {prof[False]['host_ms']:.4f} ms, "
          f"kernels {prof[True]['kernels']:.1f} -> "
          f"{prof[False]['kernels']:.1f}, idle share "
          f"{prof[True]['idle']:.4f} -> {prof[False]['idle']:.4f} "
          f"under the profiler")

    # 9. results
    # K1's chains-first kernel ran the ARWMH lockstep path, ASSS's lockstep
    # step (its run through K1 and its graph check), the SA path, the
    # harness's ARWMH and SA cells on their default drivers and the
    # figures' adaptation_drift and the A15 processes' ARWMH, its
    # chains-last kernel the pipelined ASSS machine and the harness's ASSS
    # cells on the machine and its machine lr_decay; K2 and K3 the
    # harness's fused diamonds cells (K2 its lr_decay cell too) and the A15
    # processes' diamonds runs
    k1_first = k1_main + k1_asss[True][1] + k1_lockstep + k1_sa \
        + k1_harness[0] + k1_figures + k1_mp
    print(f"launches: chol_update (chains first) {k1_first} = ARWMH "
          f"lockstep {k1_main} + ASSS lockstep {k1_asss[True][1]} + its "
          f"graph check {k1_lockstep} + SA {k1_sa} + harness "
          f"{k1_harness[0]} + figures {k1_figures} + A15 processes "
          f"{k1_mp}")
    kernels = [kernel_entry("chol_update", "chol_update.cu", K1_REPLACES,
                            k1_first,
                            lanes[("chol_update", "first")],
                            k1_res["first"]),
               kernel_entry("chol_update_cl", "chol_update.cu", K1_REPLACES,
                            k1_asss[False][1] + k1_harness[1],
                            lanes[("chol_update", "last")], k1_res["last"])]
    for lib, source, replaces, res in (
            ("arwmh_fused", "arwmh_fused.cu", K2_REPLACES, k2_res),
            ("asss_fused", "asss_fused.cu", K3_REPLACES, k3_res)):
        for name in TARGETS:
            tag = getattr(amt, name)().device_potential
            kernels.append(kernel_entry(f"{lib}[{tag}]", source, replaces,
                                        launches[(lib, name)],
                                        lanes[(lib, name)], res[name]))
    # the auction at the grade's shape (B = 8, n = m = 625, block 16), its
    # lanes per bidder those the kernel launches with there
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels.append(kernel_entry(
        "auction_round", "auction.cu", AUCTION_REPLACES, diag["launches"],
        32 * auction_kernel.warps_per_bidder(8, 16, 625, sms),
        diag["kernel"]))
    # the ARWMH step's kernels: their launches on the lockstep main path,
    # lanes per chain at (4096, 10)
    for kname, n, lanes_per_chain in zip(("propose", "accept", "settle"),
                                         step_main, (STEP_SHAPES[0][1], 32,
                                                     32)):
        kernels.append(kernel_entry(f"arwmh_{kname}", "arwmh_step.cu",
                                    STEP_REPLACES, n, lanes_per_chain,
                                    step_res[kname]))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, "
          f"builds included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(mp_worker(sys.argv[2:]) if sys.argv[1:2] == [MP_WORKER]
             else main())
