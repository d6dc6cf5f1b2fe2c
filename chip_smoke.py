#!/usr/bin/env python3
"""Smoke test of ptnn_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Two other modes print measurements and run no smoke: ``--walls [DIR]`` (the
kernel times and walls of the checkout at DIR, to compare two checkouts on
one card: ``walls``), and ``--precond-seeds SEED ...`` (the ChEES kernel
comparisons, regression and iris, on other inputs: ``precond_seeds``).
``--phases PHASE ...`` runs only those phases, with the kernels built: the
smoke runs the digits CNN's MALA / ChEES receipts and the grids (the sweeps,
the grid families, the VR and surrogate grids with the parity runner) so,
each group in a subprocess of its own beside the
phases of the main process (``BACKGROUND``), and prints their lines when
they end.

Phases, one line each or more (a failing phase raises and the exit code is
not 0):
  1. device: needs torch.cuda; prints nvidia-smi's "name, power.limit" line
     and the toolchain's versions;
  2. build: compiles the nine ptnn_torch/csrc/*.cu (six *_block.cu,
     drift_epoch.cu, fnn_eval.cu, conv1_relu_pool.cu) with nvcc into build/,
     one nvcc per source, all at once, with ptxas' register report; both
     regression RW kernels (each warps a chain of the fixed-shape one), the
     regression MALA variants (warps a chain), every drift_epoch
     instantiation, the three regression HMC variants, the nine
     classification HMC variants (warps a chain x route), the three
     classification MALA variants (warps a chain), the MALA / HMC kernels'
     generic route (csrc/gen_chain.cuh: one MALA and three HMC routes in
     each task), every fnn_eval
     instantiation and both conv kernels must spill nothing, and every
     classification RW instantiation (both kernels, each fixed-shape
     network at each warps a chain) must have no stack frame either; the
     regression MALA plan at 64, 130 and 1024 chains and the RW plan at 64
     and 1024, the regression HMC exchange route (cluster or cooperative
     grid) the card's occupancy gives the ChEES layouts at 1024, 256 and 52
     chains, the classification HMC launch plan (warps a chain, route) at
     64, 256, 52 and 1024 chains, the classification MALA plan at 64, 256
     and 1024, the classification RW plan at the four RW presets' widths
     and at 1000 chains, the generic route's plans (warps a block, where the
     vectors live, warps a chain, exchange route) at Sunspot (4, 20, 1) and
     (4, 64, 1) and at Cancer (9, 12, 2) and TicTac (9, 10, 2), and the
     eval's plans (cluster, row tiles, warps) at the per-step paths' widths;
  3. kernel: each CUDA block kernel against its plain PyTorch version on the
     same CUDA tensors at the main paths' widths. Sunspot: RW at 1000 chains
     and at the path's 64 x 100 steps, adapt off and on, by the fixed-shape
     kernel, and a (4, 7, 1) network by the generic kernel; MALA at the
     path's 64 chains and at 1024 x 10 steps across the warm start, the
     preconditioner's start and the end of adaptation, each checked to take
     its planned warps a chain;
     HMC with ChEES at 1024 chains (8 panels), leapfrog 16; HMC without
     ChEES at leapfrog 8; and the swap sweep against the CPU's.
     Classification: the RW kernel on iris at 1000 x 100, adapt off and on,
     on all rows of Cancer (9, 12, 2), TicTac (9, 25, 2) and Ionosphere
     (34, 50, 2) at 10 and 1000 chains, each by the fixed-shape kernel at
     its planned warps a chain, and a (4, 7, 3) network on iris's rows by
     the generic kernel; iris MALA at 64
     (the path's width) and 1024 x 10 across the phases, each checked to
     take its planned warps a chain; HMC with ChEES at 64 chains (one panel), 256
     (two) and 52 (a half-empty last block), leapfrog 16, and without ChEES
     at 130 and 1024 chains, leapfrog 8, each held with the float64
     witness and checked to take its planned route. (Sunspot HMC
     with ChEES also at 256 chains, two panels, and 52, a half-empty last
     block.) At the shapes ptnn_torch.auto builds (results/auto_study.md):
     Sunspot HMC with ChEES at 63 chains (7 ladders x 9 rungs, 8 blocks of
     8, the last ragged), and iris MALA and ChEES HMC on the (4, 10, 3)
     network auto infers at 63 chains (9 ladders x 7 rungs). The MALA and
     HMC kernels' generic route: mala_block and hmc_block (ChEES) at (4,
     20, 1) and (4, 64, 1) on Sunspot's rows at 64 and 1024 chains (ChEES
     over 256 x 4), mala_cls_block and hmc_cls_block with and without ChEES
     at Cancer's (9, 12, 2) on its rows at 64 and 256 chains, and MALA and
     ChEES at auto's (9, 10, 2) on TicTac's rows at 64, each held as above
     (the generic MALA with the float64 witness too) and checked to take
     the generic route. The per-step sampler's kernels: the drift epoch at Sunspot
     (4, 10, 1) 64 chains (depth 1 and 2), Ionosphere (34, 50, 2) 10 chains
     on 245 rows and PenDigit (16, 30, 10) 10 chains on all 7494 train
     rows, then every distinct bundled topology and one the generic kernel
     runs, 10 chains on 64 random rows, each checking which kernel ran; the
     FNN eval at Sunspot 64 chains, Ionosphere 10 and 64 and PenDigit 10
     (all 7494 / 3498 rows), on the train rows, on the test rows and on both
     in one launch (the pair); the grid routes of both (phase_grid_kernels):
     the drift with a rate a chain (the regression grid's 210 chains on
     Sunspot's rows), with each cell's rows (its 21 cells, ACFinance's 238
     rows padded to 298) and with the envelope's parameter mask (the small
     bucket's 15 cells in (34, 50, 3), the generic kernel), the eval pair
     with each cell's rows, row counts and class counts at both grids, each
     against its plain version (w within rtol 2e-4 of each chain's scale
     and atol 2e-5, the masked parameters exactly 0; ll within rtol 1e-4 of
     its terms, rmse within 2e-4, acc exact) and timed by a CUDA graph
     beside the one-dataset route at the same chains. The
     CNN's fused stage 1, conv1_relu_pool, at the digits widths (256 and
     128 chains x 1257 and 540 images, the fixed-shape kernel), ragged shapes, three
     input channels and the MNIST side (the generic kernel), and the fused
     CNN forward against the plain one; the wide networks
     (phase_wide_kernels): the drift epoch and the eval
     pair at (4, 200, 1) on Sunspot's rows at 64 chains, (784, 16, 10) on
     1000 / 200 seeded rows at 64, (16, 20, 40) (40 classes, two output
     chunks) at 64, (784, 80, 10) (one chain's weights past a block: in
     device memory) at 8 and (3000, 8, 3) (the eval's inputs a tile at a
     time) at 4, each against its plain version (w within rtol 2e-4 of each
     chain's scale, ll within rtol 1e-4 of its terms, acc exact outside
     fragile argmaxes) with the route it took and its time, and the
     per-step Langevin run at (4, 200, 1), 64 x 500, its launches the plan;
  4. end to end, each path with its launch counts set to 0 just before it,
     through ptnn_torch.sample, each checked against the bands of the JAX
     package's records: the Sunspot rw_fused sampler (64 chains x 5000,
     every launch by the fixed-shape kernel), the quality flagship
     chees16_fused_256x4 (1024 x 8000) and mala_fused_16x4 (64 x 5000,
     every launch at the planned warps a chain); the iris RW preset (10 x
     5000) and the Cancer, TicTac and Ionosphere RW presets (10 x 5000 on
     all rows, seeds 0-4, their medians against bands around ptnn's
     records), every launch by the fixed-shape kernel at its planned warps
     a chain; the iris
     quality flagship chees16_fused_16x4 (64 x 8000, seeds 1-3) against the
     served-accuracy gate of 96.76; iris mala_fused_16x4 (64 x 8000);
     the generic route (phase_generic_end_to_end): bench's _cls_variants
     at Cancer's (9, 12, 2), mala_fused_16x4 and chees16_fused_16x4 (64 x
     4000, seeds 1-3, medians) and Sunspot's at (4, 20, 1) (seed 0), cold
     test accuracy or RMSE, accept, swap and round trips inside the mean
     +- 4 sd of ptnn's per-step sampler on the CPU (GEN_REF), every block
     launch by the generic route, one fnn_eval launch at init and one at
     the temper switch; python -m ptnn_torch.auto Cancer --target speed
     --chains 64 --steps 4000 --replicate 2 as a subprocess, fused with no
     fallback warning, its cold accuracy in the Cancer MALA band; TicTac's
     (9, 25, 2) mala_fused_16x4 (64 x 200) falling back with ptnn's
     warning;
     then the per-step sampler: Sunspot lg_pallas (64 x 5000, Langevin
     gradients), Sunspot rw per-step (64 x 5000) and Ionosphere legacy LG
     (10 x 5000), each with its drift and eval launches held to the plan (one
     eval a step for the train and the test rows);
     then the model zoo on the digits images: the Bayesian CNN,
     cnn.digits_spec(fused_eval=True), at cnn_digits's default width, 256
     chains on all 1257 / 540 rows, 1600 steps (the default 2000 cut in PR
     15), with its conv launches held to the plan; the same at 64 chains x 300 held to bands around the JAX
     package's run on the CPU; the fused eval against the plain eval on the
     same noise; a deep MLP; and the cnn_digits command line as a
     subprocess, with its artifact tree;
     then the per-step preconditioned family, each path with one eval
     launch a step (the test rows under MALA and HMC) plus init_state's and
     the temper switch's, every other kernel 0: Sunspot's fused twin
     chees16_fused_16x4 (64 x 2000; mala_fused_16x4's run above is the
     other twin), then bench.py's per-step mala, hmc, mala_16x4 and
     chees16_16x4 (64 chains, seed 0; mala and mala_16x4 at 5000 samples,
     hmc and chees16_16x4 at 2000), the MALA runs' cold RMSE in
     0.01-0.04 and the HMC runs' in 0.005-0.0239, the twinned runs' mean
     accept and swap within 3 points of their twin's, the others' accept in
     40-75 %;
     Ionosphere's mala_fused_16x4 (bench.py's _cls_variants at 64 x 4000,
     seeds 1-3), which must fall back with ptnn's warning (w 1852 does not
     fit the fused block) and run per step, medians per-draw cold accuracy
     68-80 % and 14-28 round trips per ladder per 1k steps (BENCH_r05.json:
     73.72, 20.8), served accuracy printed; the digits CNN with
     digits_spec(fused_eval=True) at scripts/cnn_convergence.py's
     configuration, 128 chains = 32 ladders x 4 rungs, seeds 1 and 2, 16
     cold rungs' w recorded every steps // 512: MALA at 2000 steps
     (record_thin 3; the script's 4000 cut in PR 14) and ChEES (8 leapfrog
     steps) at 1000: medians served
     accuracy >= 97 % (MALA) / 95 % (ChEES) (the cold draws thinned along
     the draw axis, then pooled), per-draw 90-96 % / 86-96 %, pooled
     function-space R-hat <= 1.15 (ptnn's rows: 99.17 / 98.24, 93.59 /
     91.71, 1.034 / 1.042), ChEES traj_len in [1, 8] and varying
     (hmc, chees16_16x4 and its fused twin at 2000 samples, not 5000, and
     Ionosphere at 4000, not 8000, keep the smoke inside its time);
     then the run lifecycle: record_thin on the card (rw_fused 64 x 5000 at
     thin 3, the gather regime, and at the longest block + 3, the sparse
     one, lg_pallas 64 x 5000 at thin 7: every kept row equal to the
     unthinned run's at ptnn's positions bit for bit, the final state
     equal, peak device memory and trace host copy printed); the paper's
     command lines as five subprocesses at once, python -m
     ptnn_torch.experiments.regression --problem Sunspot (Langevin, 10 x
     10,000), the same with --no-langevin --fused --roundtrip and with
     --no-langevin --fused --replicate 2, and
     ptnn_torch.experiments.classification --problem iris (10 x 5000) and
     --fused, each with its artifact tree, master row, launches against the
     plan and test / swap / accept against bands from ptnn's own command
     line on the CPU, seeds 0-4; python -m ptnn_torch.predict --calibrate
     --ic on the Sunspot and iris trees, the served RMSE / accuracy inside
     the run's band; cnn_digits --checkpoint at 64 x 100; and the
     regression command line's default run with checkpoints every 2 chunks
     in a subprocess, SIGKILLed after its first checkpoint, run again on
     the same path, and held to an uninterrupted run bit for bit (every
     trace and state tensor), with a whole-run checkpoint's size and save
     time; then the variational-reference paths, as subprocesses at once:
     python -m ptnn_torch.experiments.regression --problem Sunspot --vref
     --evidence --roundtrip (Langevin per step, 10 x 10,000, the T = inf
     rung), --no-langevin --vr-rounds 3 --evidence (full covariance, ptnn's
     w_size warning) and classification --problem iris --vref --evidence
     (served by ptnn_torch.predict), each with evidence.txt anchored and
     finite, rounds_history.md, the regeneration at beta = 0 100 % and the
     launches of the plan (nothing for the reference), against bands from
     ptnn's own command lines on the CPU, seeds 0-19; the single-chain
     sampler, mcmc.single_chain_config("regression", (4, 10, 1),
     samples=10,000), seeds 0-2, against ptnn's bands (accept, test RMSE,
     the share of test targets in predictive_bands' 5-95 % band); a --vref
     run at 10 x 2000 SIGKILLed after its first checkpoint and resumed bit
     for bit (vr_* and n_regen_* included); and in this process the
     evidence model selection of scripts/evidence_model_selection.py
     (hidden 2 and 6, 16-chain VR ladders tuned by tuning.tune_ladder,
     seeds 4, 14, 24 at 1600 steps a chain), each seed's abs log Z, PSIS-LOO
     elpd and RMSE and the barrier against ptnn's bands, the ranking
     printed; then surrogate-assisted PT and ptnn_torch.auto
     (phase_surrogate_auto): the six surrogate arms at
     scripts/bench_modes.py's configuration (Sunspot, 64 x 2000, Langevin,
     maxtemp 5, chunks of 250: plain, anchored, delayed acceptance with RW
     and with MALA inner moves, per-rung fits, the MLP family), each
     against the mean +- 4 sigma of ptnn's runs on the CPU (seeds 0-19),
     its evals and drifts exactly the plan its host decisions give, each DA
     arm's final carried ll a true eval's; chain-steps/s of plain,
     anchored and DA with the train rows tiled 1 and 64 times; at once as
     subprocesses, python -m ptnn_torch.auto Sunspot --target quality and
     iris --target speed (--chains 64 --steps 8000 --replicate 3,
     results/auto_study.md), their barrier, shape, execution, cold metric
     and R-hat against ptnn's records widened by its pilot's spread, their
     launches the plan, their trees served by ptnn_torch.predict; and the DA
     arm checkpointed every chunk, SIGKILLed after a checkpoint saved in the
     middle of a segment and resumed bit for bit (ring, fit and segment
     included); then the sweeps (phase_sweeps), through ptnn_torch.sweeps:
     dataset_grid at scripts/grid_parity.py's configuration (the seven
     series x rw, lg001, lg01, 10 chains a cell, maxtemp 5, swap ratio
     0.01: 210 chains) at 10,000 samples (1000 a chain; the script's
     100,000 cut), classification_grid's small bucket (iris, Ionosphere,
     Cancer x seeds 0-4: 150 chains in the (34, 50, 3) envelope) in RW and
     in legacy LG at 5000 samples (the script's 50,000 cut), every cell's
     test_mean, accept_pct and swap_pct inside the mean +- 4 sigma of
     ptnn's own call on the CPU over 20 seeds, launches exactly the plan (2
     drift epochs a step and 1 eval pair a step for the whole grid, + init
     and the temper switch); the Sunspot lg01 cell against the single
     per-step run of its stream (accept and swap counts equal, statistics
     within rtol 2e-4); the big bucket (bank-additional, PenDigit, chess)
     in batch drift mode, 500 steps, finite, launches as planned; each
     grid's chain-steps/s beside the card's name and power limit; then
     replica-exchange SGLD and the bfloat16 eval (phase_sgld_bf16):
     scripts/sgld_lr_scale_study.py's configuration (Sunspot, 8 chains x
     4000 steps, B = 32, corrected swaps every 10 with SVRG anchors every
     20) in both sg_lr_scale arms and with exact swaps, seeds 0-2, medians
     of swap %, cold test RMSE and round trips inside the mean +- 4 sigma
     of ptnn's runs on the CPU (seeds 0-19), launches exactly the plan (one
     eval a swap event, one an anchor refresh, init's; no drift); python -m
     ptnn_torch.experiments.cnn_digits --chains 64 --steps 300
     --sgld-batch 32 as a subprocess and its configuration on the CNN with
     the fused eval in this process, both against ptnn's command line
     (seeds 0-4), conv launches the plan; a sgld run SIGKILLed after its
     first checkpoint and resumed bit for bit, anchors included;
     scripts/bench_modes.py's bf16_eval and da_mala_bf16 arms (Sunspot 64
     x 2000) against ptnn's bands, no eval launch; each path's ms a step
     and chain-steps/s beside the card's name and power limit; then the
     grids of the other families (phase_grid_families), through
     ptnn_torch.sweeps: seed sweeps of bench's per-step Sunspot MALA (10
     cells x 64 chains x 2000) and chees16_16x4 (10 x 64 x 1000), of the
     sgld study's "none" arm (20 x 8 x 4000) and of bench_modes' bf16_eval
     (10 x 64 x 2000), and the sgld "exact" arm's swap_interval_sweep at
     intervals (10, 20, 0) x 5; every cell's test_mean, accept_pct and
     swap_pct inside the mean +- 4 sigma of ptnn's own sweep on the CPU (20
     cells), each arm's mean over its cells inside ptnn's band of such a
     mean, launches exactly the plan (one eval launch a step or a swap
     event, or two drift epochs a step, for every cell at once); each
     grid's chain-steps/s beside a single run's times its cells; then the
     grids of the variational reference and of the surrogate modes
     (phase_grid_vref): seed sweeps of the regression command line's
     --vref (Langevin, the T = inf rung; 20 cells x 10 chains x 2000, the
     command line's 10,000 cut) and of the classification one's on iris
     (10 x 10 x 5000), every cell and each arm's mean inside ptnn's bands
     (mean +- 4 sigma of ptnn's 20 cells), every cell's regeneration
     accepted every time (beta = 0), launches exactly the plan; the
     anchored and delayed-acceptance arms of scripts/bench_modes.py as seed
     sweeps (5 x 64 x 500) equal to the plain grid bit for bit, with its
     launches (ptnn's grid never refits); python -m
     ptnn_torch.experiments.parity regression at phase_sweeps'
     configuration equal to its grid bit for bit, then at the full budget
     (21 cells x 10 x 10,000), printed, every cell finite;
  5. throughput: throughput_runner at 2000 samples per chain (Sunspot
     rw_fused at 64 and 1024 chains, mala_fused_16x4, chees16_fused_256x4;
     iris chees16_fused_16x4 and chees16_fused_64x4; lg_pallas at 500),
     and each
     kernel's time against its plain version's for one block (one epoch,
     one eval) at its path's widths (the RW and MALA blocks, both tasks,
     also as device time, a CUDA graph of 100 calls; the RW blocks also at
     1024 chains, the classification one also at the Cancer, TicTac and
     Ionosphere presets' widths;
     the eval at Sunspot, Ionosphere and
     PenDigit, one set and the pair; the iris MALA block also at 256 and
     1024 chains at 4 and at 1 warp a chain); the CNN's chain-steps/s (256
     chains x 50 steps), the conv
     kernel's time against its plain version's and the library's
     (F.conv2d + relu + F.avg_pool2d), one drift and one eval of a CNN
     step, and stage 2 as the port multiplies it against one grouped
     F.conv2d; the per-step preconditioned family's chain-steps/s (the CNN
     with MALA and ChEES at 128 chains x 10 steps, Sunspot mala_16x4 and
     chees16_16x4 at 64 x 100) and one CNN value-and-grad beside one
     Langevin drift at 128 and 256 chains;
  6. one JSON line listing the kernels (time, device time where measured,
     plain time, bound, launches,
     largest difference from the plain version; kernels 2-5 add their
     generic route's ``generic_*`` time, device time, plain time, bound and
     launches, timed at the generic end-to-end arms' 64 chains in phase 5),
     then the device line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the end-to-end bands: what the JAX package reads for the same config
# (results/rw_adaptive.md, the bench.py gate of 0.0239). Its 64-rung
# maxtemp-5 ladder swaps at 82.6-83.1% (per-step sampler, seeds 0 and 1;
# ptnn/config.py notes ~85%): the 50-55% of the verify notes is the
# 10-chain preset's.
COLD_RMSE = (0.01, 0.04)
COLD_ACCEPT = (3.0, 20.0)
MEAN_ACCEPT = (10.0, 35.0)
SWAP = (70.0, 92.0)
# chees16_fused_256x4: bench.py's flagship_gate (cold RMSE <= 0.0239; ptnn
# reads 0.0102, results/ensemble_scaling_fused.md:37, per-replica
# 0.0092-0.0111, results/mala_basins.md); accept and swap near the 55.0 %
# and 48.3 % ptnn's fused chees16 16x4 reads (ROUND3.md:298-299);
# round trips near 20 per ladder per 1k steps (BENCH_r05.json: 5142 / 256
# ladders; 318.5 / 16 for mala_fused_16x4).
FLAGSHIP_RMSE = (0.0, 0.0239)
FLAGSHIP_ACCEPT = (40.0, 70.0)
FLAGSHIP_SWAP = (33.0, 63.0)
TRIPS_PER_LADDER = (10.0, 30.0)
# mala_fused_16x4: ptnn's cold RMSE 0.0254 (results/mala_basins.md:15)
MALA_RMSE = (0.01, 0.04)
DEVICE = "cuda"
MARGIN = 1e-5  # decisions closer than this may flip with rounding
# summation order and expf rounding differ. ll is the difference of two
# terms of size 1e2-1e3 that cancel, so its rtol applies to the size of
# those terms (the plain version's ``ll_scale``), not to ll itself.
RTOL, ATOL = 1e-4, 1e-5
# the MALA and HMC kernels. Rounding is amplified through the gradient
# steps: a trajectory of up to 16 leapfrog steps moves a chain's whole
# vector, so w, w_last, g_like and the Welford buffers are held on the
# scale of the chain's vector (its largest entry), ll on the scale of its
# cancelling terms, the ChEES first moment on |m1| + sqrt(v2), the rest
# elementwise. The first card run of this comparison measured up to 6.4e-4
# of those scales (chees_m1) and 3.9e-4 of ll's terms (HMC, leapfrog 8).
# g_like is a function of w that moves ~30x faster than w near a mode, so
# the kernel's g_like is held to the gradient at the kernel's own w.
P_RTOL, P_ATOL = 1e-3, 1e-4
P_MARGIN = 1e-5  # |u - a| of the w and eta blocks
# The float64 witness of the MALA and HMC comparisons. The leapfrog steps
# amplify float32 rounding and, under ChEES, so do the rung sums (each
# chain's dsq is a difference of two sums of squares), so in a chaotic
# chain the plain float32 version itself sits several tolerances from the
# exact result, and the kernel, summing in another order, elsewhere. The
# plain version runs again in float64 on the same inputs; in every chain
# that took the same decisions in both runs (under ChEES, every replica of
# its rung), the kernel may differ from the plain float32 version by the
# tolerance plus WITNESS_R times the plain version's largest distance from
# float64 in that chain and quantity.
WITNESS_R = 4.0
TRAJ_MARGIN = 1e-5  # distance of tau_traj / eps to a leapfrog-count boundary
KERNELS = ("rw_block", "mala_block", "hmc_block", "rw_cls_block",
           "mala_cls_block", "hmc_cls_block", "drift_epoch", "fnn_eval",
           "conv1_relu_pool")
# what each kernel replaces: the TPU kernel of ptnn (file:line)
REPLACES = {
    "rw_block": "ptnn/ops/pallas_step.py:307 (_rw_block_kernel, regression)",
    "mala_block": "ptnn/ops/pallas_step.py:596",
    "hmc_block": "ptnn/ops/pallas_step.py:903",
    "rw_cls_block":
        "ptnn/ops/pallas_step.py:307 (_rw_block_kernel, classification)",
    "mala_cls_block": "ptnn/ops/pallas_step.py:1339",
    "hmc_cls_block": "ptnn/ops/pallas_step.py:1589",
    "drift_epoch": "ptnn/ops/pallas_drift.py:42",
    "fnn_eval": "ptnn/ops/pallas_eval.py:52",
    "conv1_relu_pool": "ptnn/ops/pallas_conv.py:39",
}
# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores and
# HBM3 bandwidth; a kernel's bound is the larger of its operations over the
# one and its bytes (inputs read once, outputs written once) over the other
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SIGMOID_OPS = 4  # negate, exp, add, divide
# iris (ptnn's CLS_GATE, bench.py:288-294) and its end-to-end bands
IRIS_TOPO = (4, 12, 3)
# the ensemble ptnn_torch.auto builds for iris (results/auto_study.md): 9
# ladders x 7 rungs of the (4, 10, 3) network it infers
AUTO_IRIS = dict(topology=(4, 10, 3), n_ladders=9, record_w_chains=9)
# the classification RW presets the fixed-shape kernel runs: (topology, all
# rows, train + test)
CLS_RW_SETS = {"iris": (IRIS_TOPO, 150), "Cancer": ((9, 12, 2), 699),
               "TicTac": ((9, 25, 2), 958), "Ionosphere": ((34, 50, 2), 354)}
CLS_ROWS = {name: rows for name, (_t, rows) in CLS_RW_SETS.items()}
# the bundled sets whose networks the generic kernel runs
GENERIC_SETS = {"winequality-red": (11, 50, 10), "abalone": (8, 30, 29)}
# the MALA / HMC kernels' generic route (csrc/gen_chain.cuh): the Sunspot
# widths phase 3 holds, and the classification sets: Cancer's own network
# and the (9, 10, 2) ptnn_torch.auto infers for Cancer and TicTac
GEN_REG_TOPOS = ((4, 20, 1), (4, 64, 1))
# (4, 64, 1) ChEES at the flagship's step 0.01 on N(0, 1) weights is
# chaotic: in a few chains a trajectory parts the plain float32 version and
# the kernel from float64 by more than the comparison's witness allows
# (each as far as the other, in distribution). phase_generic_rounding holds
# the two versions' rounding to one distribution there; the exact
# comparison runs at half the step
GEN_CHAOS_STEP = dict(step_w=0.005)
# |kernel - float64| / |plain - float32 - float64| over the trace ll entries
# of the chains that decide alike: the median and 90th percentile at most
GEN_ROUNDING = (1.5, 8.0)
CANCER_TOPO, AUTO_NINE = (9, 12, 2), (9, 10, 2)
IRIS_GATE = 96.76  # served posterior-predictive cold accuracy, median
# the iris RW preset (classification_preset((4, 12, 3), 50_000), fused):
# ptnn's fused sampler on the CPU, seeds 0-4 (python
# tests/test_torch_fused_driver.py rw 0 1 2 3 4): cold-rung test accuracy
# over the second half 67.93-73.51, mean accept 94.54-95.31 %, swap
# 72.56-76.87 %; the port's plain versions on the CPU, same seeds:
# 69.42-76.82, 94.46-94.83, 73.02-78.68. The cold rung's accuracy trace is
# slow to mix (one run is one draw of it), hence the wide band.
IRIS_RW_ACC = (55.0, 85.0)
IRIS_RW_ACCEPT = (90.0, 98.0)
IRIS_RW_SWAP = (65.0, 85.0)
# the Cancer, TicTac and Ionosphere RW presets (classification_preset(topo,
# 50_000), fused, 10 x 5000): bands of the medians over seeds 0-4 of (test
# accuracy mean over every chain from row 2499 on, mean accept %, swap %).
# ptnn's per-step sampler on the CPU, the record that matches the preset,
# seeds 0-19 (PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_rw_cls.py
# NAME 0 1 ... 19): means Cancer 93.81, 89.85, 76.94 (sd 3.86, 0.42, 2.59);
# TicTac 75.53, 91.63, 74.34 (4.57, 0.53, 2.28); Ionosphere 55.44, 90.31,
# 73.24 (8.68, 0.61, 2.17); each band the mean +- 4 sd of a median of five,
# 1.2533 sd / sqrt(5), Cancer's accuracy capped at 100. (results/
# cls_grid_rw.md reads Cancer 88.44 +- 0.89 in the six sets' envelope, where
# Cancer's cell is padded; its small-sets bucket reads 95.14 +- 2.21.)
CLS_RW_SEEDS = (0, 1, 2, 3, 4)
CLS_RW_BANDS = {
    "Cancer": ((85.15, 100.0), (88.91, 90.79), (71.12, 82.76)),
    "TicTac": ((65.28, 85.79), (90.45, 92.81), (69.23, 79.46)),
    "Ionosphere": ((35.98, 74.91), (88.94, 91.68), (68.39, 78.10)),
}
# iris chees16_fused_16x4, ptnn's fused sampler on the CPU, seeds 1-3
# (python tests/test_torch_fused_driver.py flagship 1 2 3): served cold
# accuracy over every second-half draw 95.56 / 97.78 / 97.78, over a
# 2000-draw subsample 95.56 / 95.56 / 97.78, over bench.py's stride (replica
# 0 alone) 97.78 each; per-draw cold accuracy 87.55-87.72 %, mean accept
# 65.93-66.51 %, swap 61.51-61.82 %, 23.31-23.70 round trips per ladder per
# 1k steps (BENCH_r05.json: 97.78, 87.71 and 378.12 / 16 = 23.63)
CHEES_ACCEPT = (58.0, 75.0)
CHEES_SWAP = (54.0, 70.0)
CHEES_TRIPS = (18.0, 30.0)  # per ladder per 1k steps
CHEES_DRAW_ACC = (84.0, 91.0)
PTNN_MALA_SERVED, PTNN_MALA_TRIPS = 97.78, 364.62 / 16
# the iris comparisons' inputs: scales at which both MALA and HMC reject
# some proposals, and a seed whose blocks put no chain within the margins
CLS_SEED = 7
CLS_STEP_MALA, CLS_STEP_HMC = 0.3, 0.1
# iris mala_fused_16x4 64 x 8000, seed 1: ptnn's records (BENCH_r05.json:
# per-draw cold accuracy 87.15, 364.62 / 16 = 22.79 round trips per ladder
# per 1k steps, served 97.78); the port's one-warp-per-chain kernel read
# 87.68, 22.41 and 97.78 on an H100. Bands as the flagship's, on the median
# over seeds 1-3 as the flagship's gate; the served gate at the tie row's
# 95.56 % (43 of the 45 test rows, counted in rows: 43 / 45 is 95.5556 %,
# below the rounded figure), which one seed may read.
MALA_DRAW_ACC = (84.0, 91.0)
MALA_TRIPS = (18.0, 30.0)
MALA_SERVED_ROWS = 43  # of iris's 45 test rows
# the eval kernel's launches at the per-step paths' widths: (label, chains,
# row sets, topology)
EVAL_PLANS = (("Sunspot pair", 64, (298, 198), (4, 10, 1)),
              ("Ionosphere pair", 10, (245, 109), (34, 50, 2)),
              ("Ionosphere train", 10, (245,), (34, 50, 2)),
              ("PenDigit pair", 10, (7494, 3498), (16, 30, 10)))


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    sys.path.insert(0, str(ROOT))
    import ptnn_torch
    from ptnn_torch.ops import _build

    check(Path(ptnn_torch.__file__).resolve().is_relative_to(ROOT),
          f"ptnn_torch imported from {ptnn_torch.__file__}, not this checkout")
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"[1/6] device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"nvcc '{nvcc[-1] if nvcc else '?'}', triton {triton_v}")


def phase_build():
    """Every source, one nvcc each, all at once; ptxas' report; and for the
    redesigned kernels (both regression RW kernels, every regression MALA
    instantiation, every drift_epoch instantiation, the three HMC variants,
    the nine classification HMC variants, the classification MALA
    variants, the eval and conv kernels) the registers and spill bytes,
    which must be 0, the HMC exchange route the card gives the ChEES
    layouts, and the MALA, RW and classification HMC launch plans."""
    from ptnn_torch.ops import _build, precond_cls_step, precond_step

    t0 = time.perf_counter()
    built = _build.build_all(list(KERNELS))
    wall = time.perf_counter() - t0
    print(f"[2/6] build: {len(built)} sources in parallel in {wall:.2f} s")
    for name, b in built.items():
        ptxas = [ln.split("ptxas info    :")[-1].strip()
                 for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"[2/6] build: {name}.cu -> {b.path.relative_to(ROOT)} (nvcc "
              f"{b.seconds:.2f} s); ptxas: {' | '.join(ptxas)}")
    for name in ("rw_block", "mala_block", "drift_epoch", "hmc_block",
                 "hmc_cls_block", "mala_cls_block", "fnn_eval",
                 "conv1_relu_pool", "rw_cls_block"):
        entries = _build.ptxas_report(built[name].log)
        check(entries, f"{name}: no ptxas report")
        for e in entries:
            print(f"[2/6] build: {name} {demangle(e.kernel)}: {e.registers} "
                  f"registers, {e.spill_stores} / {e.spill_loads} bytes of "
                  f"spill stores / loads, {e.stack_frame}-byte stack frame")
            check(e.spill_stores == 0 and e.spill_loads == 0,
                  f"{name} {e.kernel} spills")
            # a stack frame without spills is local memory all the same
            check(name != "rw_cls_block" or e.stack_frame == 0,
                  f"{name} {e.kernel} has a {e.stack_frame}-byte stack frame")
    for c in (1024, 256, 52):
        panel = min(c, precond_step.PANEL)
        blocks, cluster = precond_step.hmc_layout(c, panel)
        smem = precond_step.smem_bytes(496, 4, True, hmc=True)
        route, why = precond_step.hmc_route(DEVICE, smem, cluster, blocks)
        print(f"[2/6] build: hmc_block ChEES at {c} chains: {blocks} blocks, "
              f"panels of {cluster} blocks; route {route} ({why})")
    for c, chees in ((64, True), (256, True), (52, True), (1024, True),
                     (1024, False)):
        plan = precond_cls_step.card_plan(
            DEVICE, c, min(c, precond_step.PANEL) if chees else 0, 150)
        print(f"[2/6] build: hmc_cls_block {'ChEES' if chees else 'plain'} at "
              f"{c} chains: WPC {plan.wpc}, {plan.per_block} chains a block, "
              f"{plan.blocks} blocks, route {plan.route} ({plan.why}), "
              f"{plan.smem} bytes of shared memory")
    for c in (64, 130, 1024):
        plan = precond_step.card_mala_plan(DEVICE, c, 496)
        print(f"[2/6] build: mala_block at {c} chains: WPC {plan.wpc}, "
              f"{plan.per_block} chains a block, {plan.blocks} blocks "
              f"({plan.why}), {plan.smem} bytes of shared memory")
    from ptnn_torch.ops import block_step

    for c in (64, 1024):
        plan = block_step.card_rw_plan(DEVICE, c)
        print(f"[2/6] build: rw_block (4, 10, 1) at {c} chains: the "
              f"{block_step.variant((4, 10, 1))} kernel, {plan.warps} warps "
              f"a chain, {plan.blocks} blocks ({plan.why}), "
              f"{block_step.smem_bytes(496, (4, 10, 1), plan.warps)} bytes of "
              f"shared memory")
    for name, c in [(n, 10) for n in CLS_RW_SETS] + [("iris", 1000),
                                                     ("TicTac", 1000)]:
        topo, rows = CLS_RW_SETS[name]
        plan = block_step.card_rw_cls_plan(DEVICE, c, rows)
        print(f"[2/6] build: rw_cls_block {name} {topo} at {c} chains: the "
              f"{block_step.cls_variant(topo)} kernel, {plan.warps} warps a "
              f"chain, {plan.blocks} blocks ({plan.why}), "
              f"{block_step.cls_smem_bytes(rows, topo, 'fixed', plan.warps)} "
              f"bytes of shared memory")
    for c in (64, 256, 1024):
        plan = precond_cls_step.card_mala_plan(DEVICE, c, 150)
        print(f"[2/6] build: mala_cls_block at {c} chains: WPC {plan.wpc}, "
              f"{plan.per_block} chains a block, {plan.blocks} blocks "
              f"({plan.why}), {plan.smem} bytes of shared memory")
    # the MALA / HMC kernels' generic route at the widths phase 3 holds
    for topo in GEN_REG_TOPOS:
        for c in (64, 1024):
            plans = (("mala_block", precond_step.card_mala_plan(
                DEVICE, c, 496, topo)), ("hmc_block ChEES",
                                        precond_step.card_hmc_plan(
                                            DEVICE, c, min(c, 128), 496,
                                            topo)))
            for name, plan in plans:
                print(f"[2/6] build: {name} {topo} at {c} chains: the "
                      f"{plan.variant} route, {plan.warps} warps a block, "
                      f"vectors in {plan.vectors} memory, WPC {plan.wpc}, "
                      f"{plan.per_block} chains a block, {plan.blocks} blocks"
                      f"{', route ' + plan.route if 'hmc' in name else ''} "
                      f"({plan.why}), {plan.smem} bytes of shared memory")
    for set_name, topo in (("Cancer", CANCER_TOPO), ("TicTac", AUTO_NINE)):
        rows = CLS_ROWS[set_name]
        for c in (64, 256):
            plans = (("mala_cls_block", precond_cls_step.card_mala_plan(
                DEVICE, c, rows, topo)),
                     ("hmc_cls_block ChEES", precond_cls_step.card_plan(
                         DEVICE, c, min(c, 128), rows, topo)),
                     ("hmc_cls_block plain", precond_cls_step.card_plan(
                         DEVICE, c, 0, rows, topo)))
            for name, plan in plans:
                print(f"[2/6] build: {name} {set_name} {topo} at {c} chains: "
                      f"the {plan.variant} route, {plan.warps} warps a "
                      f"block, vectors in {plan.vectors} memory, WPC "
                      f"{plan.wpc}, {plan.per_block} chains a block, "
                      f"{plan.blocks} blocks"
                      f"{', route ' + plan.route if 'hmc' in name else ''} "
                      f"({plan.why}), {plan.smem} bytes of shared memory")
    from ptnn_torch.ops import fnn_eval

    wide = tuple((f"{label} pair", c, (n_tr or 298, n_te or 198), topo)
                 for label, topo, _t, c, n_tr, n_te in WIDE_CASES)
    for label, c, rows, topo in EVAL_PLANS + wide:
        plan = fnn_eval.launch_plan(c, rows, topo)
        print(f"[2/6] build: fnn_eval {label} {topo} C={c} rows {rows}: "
              f"clusters of {plan.cluster} blocks, {plan.tile_rows} rows a "
              f"block, {plan.row_groups} x {plan.hid_groups} warps (HPW "
              f"{plan.hid_per_warp}), {plan.blocks} blocks, {plan.smem} bytes "
              f"of shared memory, weights "
              f"{'in device memory' if plan.w_global else 'staged'}, inputs "
              f"{plan.in_tile} a stage, outputs {plan.out_chunk} a chunk")
    from ptnn_torch.ops import drift

    for label, c, rows, topo in wide:
        lay = drift.plan(c, rows[0], 1, topo)
        print(f"[2/6] build: drift_epoch {label.split()[0]} {topo} C={c} "
              f"rows {rows[0]}: the {lay.kind} kernel, "
              f"{lay.chains_per_block} chains a block, weights in "
              f"{lay.weights} memory, tiles of {lay.tile_rows} rows, "
              f"{lay.blocks} blocks, {lay.smem} bytes of shared memory")


def demangle(name):
    """``drift_reg_kernel<4, 10, 1, 4, 0>`` from its mangled entry name
    (a bool argument as 0 / 1)."""
    import re

    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    ident = name[m.end():m.end() + int(m.group(1))]
    rest = name[m.end() + int(m.group(1)):]
    args = (re.findall(r"L[ib](\d+)E", rest) if rest.startswith("I")
            else [])
    return f"{ident}<{', '.join(args)}>" if args else ident


def sunspot():
    from ptnn_torch import data

    return data.load_regression("Sunspot")


def block_inputs(c, k, device, adapt, seed=7, topo=(4, 10, 1)):
    """Random state (with its true ll and prior), noise and uniforms for one
    block of ``k`` steps over ``c`` chains of the (4, H, 1) network ``topo``
    on Sunspot, made with numpy."""
    import numpy as np
    import torch

    from ptnn_torch import PTConfig, kernel
    from ptnn_torch.models import fnn
    from ptnn_torch.ops import block_step
    from ptnn_torch.sampler import make_dataset

    rng = np.random.default_rng(seed)
    prob = sunspot()
    cfg = PTConfig(task="regression", topology=topo,
                   num_samples=c * 1000, num_chains=c).validate()
    ds = make_dataset(cfg, prob.train, prob.test, device)
    w_dim = fnn.w_size(cfg.topology)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    st = kernel.init_state(cfg, ds, init_w=f(rng.normal(size=(c, w_dim))))
    state = dict(
        w=st.w, w_last=st.w_last, eta=st.eta, ll=st.ll, prior=st.prior,
        rmse_train=st.rmse_train, rmse_test=st.rmse_test,
        n_accept=st.n_accept,
        log_step_w=f(np.log(0.025) + 0.3 * rng.normal(size=c)),
    )
    noise = (
        f(rng.normal(size=(k, c, w_dim))),
        f(rng.normal(size=(k, c))),
        f(rng.uniform(size=(k, c))),
    )
    scal = dict(step_w=0.025, step_eta=0.2, sigma_sq=25.0, nu_1=0.0,
                nu_2=0.0, adapt=adapt, adapt_rate=0.05, adapt_target=0.234,
                burn_end=60, task_cls=False)
    kdata = block_step.prep_data(ds.x_train, ds.y_train, ds.x_test, ds.y_test)
    adapttemp = f(np.geomspace(1.0, 5.0, c))
    return state, noise, kdata, adapttemp, cfg.topology, scal


def compare_block(c, k, length, adapt, topo=(4, 10, 1)):
    """One RW block against its plain version on the same CUDA tensors,
    checked to run the kernel ``block_step.variant`` gives ``topo``;
    returns (chains under the margin, accepts, max |diff|, the kernel)."""
    import torch

    from ptnn_torch.ops import block_step

    state, noise, kdata, at, topo, scal = block_inputs(c, k, DEVICE, adapt,
                                                       topo=topo)
    args = (state, *noise, 0, length, kdata, at, topo, scal)
    kinds = dict(block_step.variant_launches)
    new_k, tr_k = block_step.fused_rw_block(*args, record_w=True)
    taken = [v for v in kinds if block_step.variant_launches[v] > kinds[v]]
    check(taken == [block_step.variant(topo)],
          f"rw_block ran {taken} for {topo}")
    new_r, tr_r = block_step.rw_block_reference(*args, record_w=True,
                                                diagnostics=True)
    torch.cuda.synchronize()
    ok = tr_r["margin"] > MARGIN
    n_close = int((~ok).sum())
    check(n_close <= max(0.01 * c, 1), f"{n_close} of {c} chains within "
          f"{MARGIN} of a decision boundary")
    na = new_r["n_accept"]
    check(0 < int(na.sum()) < length * c, "block accepted all or nothing")
    check(torch.equal(new_k["n_accept"][ok], na[ok]), "n_accept differs")
    check(torch.equal(tr_k["accept_count"][:, ok], tr_r["accept_count"][:, ok]),
          "accept_count rows differ")
    err = 0.0
    pairs = [(new_k[n][ok], new_r[n][ok], new_r[n][ok], n) for n in (
        "w", "w_last", "eta", "prior", "rmse_train", "rmse_test",
        "log_step_w")]
    pairs += [(tr_k[n][:, ok], tr_r[n][:, ok], tr_r[n][:, ok], "trace " + n)
              for n in ("rmse_train", "rmse_test", "w")]
    pairs += [(new_k["ll"][ok], new_r["ll"][ok], tr_r["ll_scale_final"][ok],
               "ll"),
              (tr_k["ll"][:, ok], tr_r["ll"][:, ok], tr_r["ll_scale"][:, ok],
               "trace ll")]
    for a, b, scale, name in pairs:
        check(torch.isfinite(a).all(), f"{name}: kernel output not finite")
        diff = (a - b).abs()
        bad = int((diff > ATOL + RTOL * scale.abs()).sum())
        check(bad == 0, f"{name}: {bad} entries off, max |diff| "
              f"{float(diff.max()):.3g}")
        err = max(err, float(diff.max()))
    return n_close, int(na.sum()), err, taken[0]


def time_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, calls=100, reps=5):
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between two CUDA events.
    The host issues one replay, not ``calls`` wrappers, so a wrapper's host
    work, which ``time_ms`` measures where it exceeds the kernel, is left
    out; the graph's gap between two kernel nodes is in."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * calls)


def rw_kernel_call(c, k, record_w):
    """The kernel call of one k-step Sunspot RW block at c chains (no
    adaptation) and its inputs."""
    from ptnn_torch.ops import block_step

    state, noise, kdata, at, topo, scal = block_inputs(c, k, DEVICE, False)
    args = (state, *noise, 0, k, kdata, at, topo, scal)
    return (lambda: block_step.fused_rw_block(*args, record_w=record_w),
            args)


def time_block(c, k, record_w):
    """Times of one k-step Sunspot RW block at c chains, from the host loop
    and as device time (``graph_ms``), and of its plain version, all on the
    card, and the block's bound."""
    from ptnn_torch.ops import block_step

    kern, args = rw_kernel_call(c, k, record_w)
    state, nw, ne, u, _s, _l, kdata, at, topo, _scal = args
    plain = lambda: block_step.rw_block_reference(*args, record_w=record_w)
    k_ms, p_ms = timing(kern, plain, 20, 3)
    new, tr = kern()
    ops = block_ops("rw", topo, c, k, kdata["n_tr"], kdata["n_te"])
    b_ms, b_by = bound(ops, tensor_bytes(state, nw, ne, u, kdata["rows"], at,
                                         new, tr))
    return dict(ms=k_ms, graph_ms=min(graph_ms(kern) for _ in range(2)),
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def phase_kernel():
    """The regression RW kernels against their plain version: the
    fixed-shape kernel at 1000 and at the path's 64 chains, adapt off and
    on, and the generic kernel on a network the repository does not bundle;
    returns the largest float difference."""
    k, length = 100, 90
    errs = []
    for c, adapt, topo in ((1000, False, (4, 10, 1)), (1000, True, (4, 10, 1)),
                           (64, False, (4, 10, 1)), (64, True, (4, 10, 1)),
                           (64, True, (4, 7, 1))):
        n_close, n_acc, err, kind = compare_block(c, k, length, adapt, topo)
        errs.append(err)
        print(f"[3/6] kernel: rw_block {topo} by the {kind} kernel, "
              f"adapt={adapt} C={c} K={k} length={length}: {n_acc} accepts, "
              f"accept counters exact, {n_close} chains under the {MARGIN} "
              f"margin, floats within rtol {RTOL} atol {ATOL}, ll's rtol on "
              f"its terms (max |diff| {err:.3g})")
    return max(errs)


def rw_fused_cfg(chains, samples, **kw):
    """bench.py's rw_fused config (Sunspot FNN (4,10,1), maxtemp 5, swap
    every 100, tempered_times_T payloads, half_exp bubbling sweeps)."""
    from ptnn_torch import PTConfig

    base = dict(task="regression", topology=(4, 10, 1),
                num_samples=chains * samples, num_chains=chains, maxtemp=5.0,
                swap_interval=100, swap_offset=0,
                swap_payload="tempered_times_T",
                use_langevin_gradients=False, record_w=False, fused_step=True)
    base.update(kw)
    return PTConfig(**base).validate()


def phase_swap():
    """The bubbling sweep on the card against the same sweep on the CPU, on
    tempered_times_T-sized payloads at the widths the throughput runs use."""
    import numpy as np
    import torch

    from ptnn_torch.parallel import swap

    rng = np.random.default_rng(11)
    n_acc = 0
    for c in (64, 1024):
        payload = torch.from_numpy((rng.normal(size=c) * 3.0).astype(np.float32))
        us = torch.from_numpy(rng.uniform(size=c - 1).astype(np.float32))
        ref = swap.sweep_permutation(payload, us)
        got = swap.sweep_permutation(payload.to(DEVICE), us.to(DEVICE))
        check(torch.equal(got.perm.cpu(), ref.perm), f"sweep perm differs at C={c}")
        check(int(got.n_accepted) == int(ref.n_accepted), "sweep count differs")
        check(torch.allclose(got.pair_accept.cpu(), ref.pair_accept,
                             rtol=RTOL, atol=1e-6), "pair_accept differs")
        n_acc += int(ref.n_accepted)
    print(f"[3/6] swap: bubbling sweeps at C=64 and 1024 on the card equal "
          f"the CPU's ({n_acc} accepted pairs)")


def phase_end_to_end():
    import numpy as np

    from ptnn_torch.ops import roundtrip

    from ptnn_torch.ops import block_step

    cfg = rw_fused_cfg(64, 5000, record_w=True, track_replicas=True)
    res, launches, n_blocks = run_counted("rw_block", cfg)
    kinds = {v: n for v, n in block_step.variant_launches.items() if n}
    check(kinds == {"fixed": launches}, f"rw_block launches by kernel "
          f"{kinds}, planned all by the fixed-shape kernel")
    tr = res.traces
    s, c = cfg.samples_per_chain, cfg.num_chains
    for name in ("ll", "rmse_train", "rmse_test", "accept_count", "replica"):
        check(tr[name].shape == (s, c), f"trace {name} shape {tr[name].shape}")
    check(tr["w"].shape == (s, c, 61), f"trace w shape {tr['w'].shape}")
    for name in ("ll", "rmse_train", "rmse_test", "w"):
        check(np.isfinite(tr[name]).all(), f"trace {name} not finite")
    cold_rmse = float(np.mean(tr["rmse_test"][s // 2:, 0]))
    cold_acc = float(res.accept_ratio_per_chain[0])
    mean_acc = float(np.mean(res.accept_ratio_per_chain))
    rt = roundtrip.roundtrip_stats(tr["replica"])
    print(f"[4/6] end to end: Sunspot rw_fused {c} chains x {s} samples in "
          f"{res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} chain-steps/s "
          f"incl. trace fetch); cold test RMSE {cold_rmse:.5f}, cold accept "
          f"{cold_acc:.2f}%, mean accept {mean_acc:.2f}%, swap "
          f"{res.swap_percent:.2f}%, round trips {int(rt.round_trips.sum())} "
          f"({rt.rate_per_kstep:.3f}/1k steps); kernel launches {launches} "
          f"for {n_blocks} planned blocks, by kernel {kinds}")
    for name, v, (lo, hi) in (("cold test RMSE", cold_rmse, COLD_RMSE),
                              ("cold accept %", cold_acc, COLD_ACCEPT),
                              ("mean accept %", mean_acc, MEAN_ACCEPT),
                              ("swap %", res.swap_percent, SWAP)):
        check(lo <= v <= hi, f"{name} {v:.4f} outside [{lo}, {hi}]")
    return launches


def phase_throughput():
    import ptnn_torch

    prob = sunspot()
    for c in (64, 1024):
        runner = ptnn_torch.throughput_runner(rw_fused_cfg(c, 2000),
                                              prob.train, prob.test,
                                              device=DEVICE)
        reps = [runner() for _ in range(3)]
        rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
        t = time_block(c, 100, record_w=False)
        print(f"[5/6] throughput: {c} chains x 2000 samples: median "
              f"{rate:.0f} chain-steps/s over 3 reps (accept "
              f"{reps[0]['accept_pct']:.1f}%, swap {reps[0]['swap_pct']:.1f}%); "
              f"one 100-step block: kernel {t['ms']:.4f} ms a call from the "
              f"host loop, {t['graph_ms']:.4f} ms of device time (a CUDA "
              f"graph of 100 calls), plain version {t['plain_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")


def precond_cfg(chains, samples, proposal, **kw):
    """bench.py's mala_fused_16x4 / chees16_fused_256x4 shape: FNN
    (4, 10, 1), maxtemp 5, 4-rung replicated ladders, DEO swaps every 10,
    warm start to 10 %, preconditioner from 30 %."""
    base = dict(proposal=proposal, n_ladders=chains // 4, adapt_rate=0.1,
                swap_style="even_odd", swap_interval=10, warmstart_frac=0.1,
                precond_start_frac=0.3)
    if proposal == "hmc":
        base.update(hmc_leapfrog=16, hmc_adapt_traj=True, step_w=0.01)
    base.update(kw)
    return rw_fused_cfg(chains, samples, **base)


def precond_inputs(cfg, k, start, phases, seed=7):
    """Random state at ``cfg``'s widths on Sunspot (init_state at N(0, 1)
    weights, so ll, prior and g_like are exact), per-chain jittered scales,
    noise and uniforms for one block of ``k`` steps from ``start``, made
    with numpy; ``phases`` overrides warm_end, pc_start and burn_end."""
    import numpy as np
    import torch

    from ptnn_torch import fused, kernel
    from ptnn_torch.ops import block_step
    from ptnn_torch.sampler import make_dataset

    from ptnn_torch.models import fnn

    rng = np.random.default_rng(seed)
    prob = sunspot()
    c, w = cfg.num_chains, fnn.w_size(cfg.topology)
    ds = make_dataset(cfg, prob.train, prob.test, DEVICE)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    st = kernel.init_state(cfg, ds, init_w=f(rng.normal(size=(c, w))))
    state = fused._to_kernel_state(st, cfg)
    state["log_step_w"] = f(np.log(cfg.step_w) + 0.3 * rng.normal(size=c))
    noise = dict(w=f(rng.normal(size=(k, c, w))),
                 eta=f(rng.normal(size=(k, c))),
                 u=f(rng.uniform(size=(k, c))),
                 u_eta=f(rng.uniform(size=(k, c))),
                 u_jit=f(rng.uniform(size=(k, c))),
                 u_traj=kernel.vdc_u(torch.arange(start, start + k,
                                                  device=DEVICE)))
    if cfg.proposal != "hmc":
        del noise["u_jit"], noise["u_traj"]
    scal = dict(fused._scalars(cfg), **phases)
    kdata = block_step.prep_data(ds.x_train, ds.y_train, ds.x_test, ds.y_test)
    temps = np.geomspace(1.0, 5.0, cfg.rungs_per_ladder)
    at = f(np.tile(temps, cfg.n_ladders))
    return state, noise, kdata, at, scal


def upcast(tree):
    """``tree`` (a dict of tensors and numbers) with every floating tensor
    in float64: the same inputs, for the float64 witness."""
    import torch

    return {n: v.double() if torch.is_tensor(v) and v.is_floating_point()
            else v for n, v in tree.items()}


def chain_max(x, axis):
    """The largest entry of ``x`` in each chain: (C,) over every axis but
    the chain ``axis``."""
    x = x.movedim(axis, 0)
    return x.reshape(x.shape[0], -1).amax(dim=1)


def compare_precond(cfg, k, start, phases, seed=7):
    """One block of the MALA or HMC kernel against its plain version on the
    same CUDA tensors, with the plain version run again in float64 as the
    witness (WITNESS_R). A chain whose decision (|u - a|) or leapfrog count
    (tau_traj / eps at an integer) fell within the margin may differ; under
    ChEES it feeds its rung's sums, so every replica of its (panel, rung)
    is left out, and at most 1 % of the chains or one such group may be.
    Returns (excluded chains, excluded groups, accepts, max |diff| of the
    floats, witness), ``witness`` a dict of what_past (quantity -> entries
    past the float32 tolerance that the witness allows), r_needed (the
    largest multiple of the plain version's distance from float64 those
    entries needed) and worst (quantity, |kernel - float64|, |plain -
    float64|) at the entry that needed it."""
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import precond_step

    hmc = cfg.proposal == "hmc"
    state, noise, kdata, at, scal = precond_inputs(cfg, k, start, phases,
                                                   seed)
    args = (state, noise, start, k, kdata, at, cfg.topology, scal)
    kern = precond_step.fused_hmc_block if hmc else precond_step.fused_mala_block
    plain = (precond_step.hmc_block_reference if hmc
             else precond_step.mala_block_reference)
    name = "hmc_block" if hmc else "mala_block"
    before = precond_step.launches[name]
    new_k, tr_k = kern(*args, record_w=True)
    check(precond_step.launches[name] == before + 1, f"{name} did not launch")
    new_r, tr_r = plain(*args, record_w=True, diagnostics=True)
    new_d, tr_d = plain(upcast(state), upcast(noise), start, k, upcast(kdata),
                        at.double(), cfg.topology, scal, record_w=True)
    torch.cuda.synchronize()
    c = cfg.num_chains
    close = (tr_r["margin"] <= P_MARGIN) | (tr_r["traj_margin"] <= TRAJ_MARGIN)
    # the chains whose float64 run took the float32 run's decisions
    same = new_d["n_accept"] == new_r["n_accept"]
    for n in ("accept_count", "traj_len"):
        if n in tr_r:
            same &= (tr_d[n] == tr_r[n]).all(dim=0)
    n_groups, group_size = 0, 1
    if hmc and scal["chees"]:
        panel = scal["rungs"] * scal["n_ladders"]
        group_size = scal["n_ladders"]
        idx = torch.arange(c, device=DEVICE)
        group = (idx // panel) * scal["rungs"] + idx % scal["rungs"]
        tainted = torch.zeros(int(group.max()) + 1, dtype=torch.bool,
                              device=DEVICE)
        tainted[group[close]] = True
        n_groups = int(tainted.sum())
        close = tainted[group]
        apart = torch.zeros_like(tainted)
        apart[group[~same]] = True
        same = ~apart[group]
    ok = ~close
    n_close = int(close.sum())
    check(n_close <= max(0.01 * c, group_size),
          f"{name}: {n_close} of {c} chains within the decision margins "
          f"({n_groups} ChEES groups)")
    na = new_r["n_accept"]
    check(0 < int(na.sum()) < k * c, f"{name}: block accepted all or nothing")
    exact = [(new_k["n_accept"][ok], na[ok], "n_accept")]
    exact += [(tr_k[n][:, ok], tr_r[n][:, ok], "trace " + n)
              for n in ("accept_count", "traj_len") if n in tr_r]
    for a, b, what in exact:
        bad = int((a != b).sum())
        check(bad == 0, f"{name}: {what} differs in {bad} entries")
    if hmc:
        tl = tr_k["traj_len"][:, ok]
        check(float(tl.min()) >= 1.0 and float(tl.max()) <= scal["leapfrog"],
              f"{name}: traj_len outside [1, {scal['leapfrog']}]")
    vec_scale = lambda v: v.abs().amax(dim=-1, keepdim=True).expand_as(v)
    # (kernel, plain, float64 witness or None, scale, chain axis, what)
    pairs = []
    for n, v in new_r.items():
        if n in ("n_accept", "ll"):
            continue
        scale, wit = (vec_scale(v) if v.dim() == 2 else v), new_d[n]
        if n == "chees_m1":
            scale = v.abs() + new_r["chees_v2"].abs().sqrt()
        if n == "g_like":  # a function of the kernel's own w: no witness
            v = fnn.neg_half_sse_grad(new_k["w"], kdata["x_tr"], kdata["y_tr"],
                                      cfg.topology)[1]
            scale, wit = vec_scale(v), None
        pairs.append((new_k[n], v, wit, scale, 0, n))
    pairs += [(tr_k[n], tr_r[n], tr_d[n], tr_r[n], 1, "trace " + n)
              for n in ("rmse_train", "rmse_test")]
    pairs.append((tr_k["w"], tr_r["w"], tr_d["w"], vec_scale(tr_r["w"]), 1,
                  "trace w"))
    pairs += [(new_k["ll"], new_r["ll"], new_d["ll"], tr_r["ll_scale_final"],
               0, "ll"),
              (tr_k["ll"], tr_r["ll"], tr_d["ll"], tr_r["ll_scale"], 1,
               "trace ll")]
    err, past, r_needed, worst = 0.0, {}, 0.0, None
    for a, b, wit, scale, axis, what in pairs:
        check(bool(torch.isfinite(a).all()), f"{name}: {what} not finite")
        shape = [1] * a.dim()
        shape[axis] = c
        keep = ok.reshape(shape).expand_as(a)
        diff = (a - b).abs()
        tol = P_ATOL + P_RTOL * scale.abs()
        d = torch.zeros_like(diff)
        if wit is not None:
            d = (chain_max((b - wit).abs(), axis) * same).reshape(
                shape).expand_as(a).to(diff.dtype)
        bad = int(((diff > tol + WITNESS_R * d) & keep).sum())
        check(bad == 0, f"{name}: {what}: {bad} entries off, max |diff| "
              f"{float(diff[keep].max()):.3g}")
        over = (diff > tol) & keep
        if bool(over.any()):
            past[what] = int(over.sum())
            need = torch.where(over, (diff - tol) / d, torch.zeros_like(d))
            at_max = int(need.argmax())
            if float(need.flatten()[at_max]) > r_needed:
                r_needed = float(need.flatten()[at_max])
                worst = (what,
                         float((a - wit).abs().flatten()[at_max]),
                         float((b - wit).abs().flatten()[at_max]))
        err = max(err, float(diff[keep].max()))
    return n_close, n_groups, int(na.sum()), err, dict(
        past=past, r_needed=r_needed, worst=worst)


def phase_generic_rounding():
    """The generic HMC route at (4, 64, 1) on Sunspot's rows, ChEES at the
    flagship's step, 64 and 1024 chains, where the trajectories are too
    chaotic for compare_precond: the kernel's and the plain float32
    version's distances from a float64 run over the trace ll entries of
    the chains that decide alike (accept_count and traj_len) must be one
    distribution (GEN_ROUNDING: the median and 90th percentile of their
    ratio)."""
    import torch

    from ptnn_torch.ops import precond_step

    phases = dict(warm_end=2, pc_start=4, burn_end=8)
    for c in (64, 1024):
        cfg = precond_cfg(c, 100, "hmc", topology=(4, 64, 1))
        state, noise, kdata, at, scal = precond_inputs(cfg, 10, 0, phases)
        args = (state, noise, 0, 10, kdata, at, cfg.topology, scal)
        _new_k, tr_k = precond_step.fused_hmc_block(*args, record_w=False)
        _new_r, tr_r = precond_step.hmc_block_reference(*args,
                                                        record_w=False)
        _new_d, tr_d = precond_step.hmc_block_reference(
            upcast(state), upcast(noise), 0, 10, upcast(kdata), at.double(),
            cfg.topology, scal, record_w=False)
        torch.cuda.synchronize()
        alike = torch.ones(c, dtype=torch.bool, device=DEVICE)
        for n in ("accept_count", "traj_len"):
            alike &= ((tr_k[n] == tr_r[n]) & (tr_d[n] == tr_r[n])).all(dim=0)
        e_k = (tr_k["ll"].double() - tr_d["ll"]).abs()[:, alike].flatten()
        e_p = (tr_r["ll"].double() - tr_d["ll"]).abs()[:, alike].flatten()
        ratio = (e_k / e_p.clamp(min=1e-12)).float()
        q50, q90 = (float(torch.quantile(ratio, q)) for q in (0.5, 0.9))
        print(f"[3/6] kernel: hmc_block (4, 64, 1) by the generic route, "
              f"ChEES, step {cfg.step_w}, C={c} K=10: over {int(alike.sum())}"
              f" chains that decide alike, |kernel - float64| / |plain - "
              f"float64| of trace ll median {q50:.3g}, 90th percentile "
              f"{q90:.3g} (at most {GEN_ROUNDING}); largest |kernel - "
              f"float64| {float(e_k.max()):.3g}, |plain - float64| "
              f"{float(e_p.max()):.3g}")
        check(q50 <= GEN_ROUNDING[0] and q90 <= GEN_ROUNDING[1],
              f"generic hmc_block (4, 64, 1) rounds unlike its plain version: "
              f"ratio median {q50:.3g}, 90th percentile {q90:.3g}")


def witness_text(wit):
    if not wit["past"]:
        return "no entry past the float32 tolerance"
    what, k64, p64 = wit["worst"]
    return (f"entries past the float32 tolerance {wit['past']}, within it "
            f"plus {wit['r_needed']:.3g}x (<= {WITNESS_R}) the plain "
            f"version's distance from float64; at the worst, {what}: kernel "
            f"{k64:.3g} and plain {p64:.3g} from float64")


def phase_precond_kernels():
    """The MALA and HMC kernels against their plain versions; returns the
    largest float difference of each."""
    out = {}
    cases = (
        # MALA at the path's width (WPC 8 on the H100) and at 1024 (WPC 1)
        ("mala_block", precond_cfg(64, 100, "precond_mala"), 10, 0,
         dict(warm_end=2, pc_start=5, burn_end=8)),
        ("mala_block", precond_cfg(1024, 100, "precond_mala"), 10, 0,
         dict(warm_end=2, pc_start=5, burn_end=8)),
        ("hmc_block", precond_cfg(1024, 100, "hmc"), 10, 0,
         dict(warm_end=2, pc_start=4, burn_end=8)),
        ("hmc_block", precond_cfg(1024, 100, "hmc", hmc_leapfrog=8,
                                  hmc_adapt_traj=False), 10, 0,
         dict(warm_end=2, pc_start=4, burn_end=8)),
        # ChEES on two panels, and on one panel whose last block is half
        # empty (52 chains: 7 blocks of 8)
        ("hmc_block", precond_cfg(256, 100, "hmc"), 10, 0,
         dict(warm_end=2, pc_start=4, burn_end=8)),
        ("hmc_block", precond_cfg(52, 100, "hmc"), 10, 0,
         dict(warm_end=2, pc_start=4, burn_end=8)),
        # the shape ptnn_torch.auto builds for Sunspot --target quality
        # (results/auto_study.md: 7 ladders x 9 rungs): one panel of 63
        # chains, 8 blocks of 8, the last ragged
        ("hmc_block", precond_cfg(63, 100, "hmc", n_ladders=7), 10, 0,
         dict(warm_end=2, pc_start=4, burn_end=8)),
    )
    # the generic route (csrc/gen_chain.cuh) on Sunspot's rows: (4, 20, 1)
    # (the vectors in shared memory) and (4, 64, 1) (in device memory), at
    # the fused paths' 64 chains and at 1024 (ChEES over 256 x 4). At (4,
    # 64, 1) the N(0, 1) test weights make ChEES at the flagship's step
    # chaotic (phase_generic_rounding): the exact comparison runs at half
    # that step
    cases += tuple(
        (name, precond_cfg(c, 100, proposal, topology=topo, **(
            GEN_CHAOS_STEP if name == "hmc_block" and topo[1] == 64
            else {})), 10, 0, dict(warm_end=2, pc_start=4, burn_end=8))
        for topo in GEN_REG_TOPOS for c in (64, 1024)
        for name, proposal in (("mala_block", "precond_mala"),
                               ("hmc_block", "hmc")))
    from ptnn_torch.ops import precond_step

    for name, cfg, k, start, phases in cases:
        routes = dict(precond_step.hmc_routes)
        wpcs = dict(precond_step.mala_wpcs)
        variants = dict(precond_step.variant_launches[name])
        n_close, n_groups, n_acc, err, wit = compare_precond(cfg, k, start,
                                                             phases)
        route = [r for r in routes if precond_step.hmc_routes[r] > routes[r]]
        out[name] = max(out.get(name, 0.0), err)
        topo = tuple(cfg.topology)
        variant = "fixed" if topo in precond_step.TOPOLOGIES else "generic"
        check(precond_step.variant_launches[name][variant]
              == variants[variant] + 1, f"{name} at {topo} did not take "
              f"its {variant} route")
        what = ("ChEES, " if cfg.hmc_adapt_traj and name == "hmc_block"
                else "") + (f"leapfrog {cfg.hmc_leapfrog}, route "
                            f"{'/'.join(route)}, "
                            if name == "hmc_block" else "")
        if name == "mala_block":
            plan = precond_step.card_mala_plan(DEVICE, cfg.num_chains, 496,
                                               topo)
            taken = [w for w in wpcs if precond_step.mala_wpcs[w] > wpcs[w]]
            check(taken == [plan.wpc], f"mala_block took WPC {taken}, "
                  f"planned {plan.wpc}")
            what = f"WPC {plan.wpc}, {plan.blocks} blocks, "
        if variant == "generic":
            plan = (precond_step.card_hmc_plan(
                DEVICE, cfg.num_chains, precond_step.PANEL if cfg.num_chains
                > precond_step.PANEL else cfg.num_chains, 496, topo)
                    if name == "hmc_block" else plan)
            what = (f"{topo} by the generic route ({plan.warps} warps a "
                    f"block, vectors in {plan.vectors} memory, WPC "
                    f"{plan.wpc}, {plan.blocks} blocks), " + what)
        print(f"[3/6] kernel: {name} {what}C={cfg.num_chains} K={k} "
              f"steps {start}-{start + k - 1} across {phases}: {n_acc} "
              f"accepts, counters{' and traj_len' if name == 'hmc_block' else ''}"
              f" exact; {n_close} chains ({n_groups} ChEES groups) excluded "
              f"under the {P_MARGIN} / {TRAJ_MARGIN} margins; floats within "
              f"rtol {P_RTOL} atol {P_ATOL}, ll's rtol on its terms (max "
              f"|diff| {err:.3g}); {witness_text(wit)}")
    return out


def cold_stats(res, cfg):
    """Cold-rung mean test RMSE over the second half, accept %, round trips
    per 1k steps per ladder."""
    import numpy as np

    from ptnn_torch.ops import roundtrip

    s = cfg.samples_per_chain
    cold = np.arange(0, cfg.num_chains, cfg.rungs_per_ladder)
    rmse = float(np.mean(res.traces["rmse_test"][s // 2:, cold]))
    rt = roundtrip.roundtrip_stats(res.traces["replica"],
                                   n_ladders=cfg.n_ladders)
    return rmse, float(np.mean(res.accept_ratio_per_chain)), \
        rt.rate_per_kstep / cfg.n_ladders


def run_counted(name, cfg, prob=None, seed=0):
    """One run of ``cfg`` through ptnn_torch.sample with every launch count
    set to 0 just before it; returns (result, ``name``'s launches, planned
    blocks) and checks that the two agree."""
    import ptnn_torch
    from ptnn_torch import fused

    prob = prob if prob is not None else sunspot()
    n_blocks = sum(len(seg) for seg in fused.block_plan(cfg))
    reset_launch_counts()
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                            device=DEVICE)
    launches = launch_count(name)
    check(launches == n_blocks, f"{name}: {launches} launches for "
          f"{n_blocks} planned blocks")
    return res, launches, n_blocks


def phase_flagship():
    """chees16_fused_256x4 as bench.py samples it for its quality gate."""
    import numpy as np

    from ptnn_torch.ops import precond_step

    cfg = precond_cfg(1024, 8000, "hmc", record_w=True, record_w_chains=256,
                      track_replicas=True)
    res, launches, n_blocks = run_counted("hmc_block", cfg)
    routes = {r: n for r, n in precond_step.hmc_routes.items() if n}
    tr = res.traces
    s, c = cfg.samples_per_chain, cfg.num_chains
    for name in ("ll", "rmse_train", "rmse_test", "accept_count", "replica",
                 "traj_len"):
        check(tr[name].shape == (s, c), f"trace {name} shape {tr[name].shape}")
    check(tr["w"].shape == (s, cfg.record_w_chains, 61),
          f"trace w shape {tr['w'].shape}")
    for name in ("ll", "rmse_train", "rmse_test", "w", "traj_len"):
        check(np.isfinite(tr[name]).all(), f"trace {name} not finite")
    rmse, acc, trips = cold_stats(res, cfg)
    tl = tr["traj_len"][1:]
    lt = res.final_state.log_traj.numpy()
    lt0 = np.log(0.5 * cfg.hmc_leapfrog * cfg.step_w)
    print(f"[4/6] end to end: chees16_fused_256x4 {c} chains x {s} samples in "
          f"{res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} chain-steps/s "
          f"incl. trace fetch); cold test RMSE {rmse:.5f} (gate "
          f"{FLAGSHIP_RMSE[1]}), mean accept {acc:.2f}%, swap "
          f"{res.swap_percent:.2f}%, round trips {trips:.2f} per ladder per "
          f"1k steps; traj_len {tl.min():.0f}-{tl.max():.0f} (mean "
          f"{tl.mean():.2f}); log_traj {lt.min():.3f}..{lt.max():.3f} from "
          f"{lt0:.3f}; kernel launches {launches} for {n_blocks} planned "
          f"blocks, by route {routes}")
    for what, v, (lo, hi) in (("cold test RMSE", rmse, FLAGSHIP_RMSE),
                              ("mean accept %", acc, FLAGSHIP_ACCEPT),
                              ("swap %", res.swap_percent, FLAGSHIP_SWAP),
                              ("round trips per ladder", trips,
                               TRIPS_PER_LADDER)):
        check(lo <= v <= hi, f"flagship {what} {v:.4f} outside [{lo}, {hi}]")
    check(tl.min() >= 1 and tl.max() <= 16 and len(np.unique(tl)) > 1,
          "traj_len stays in [1, 16] and varies")
    check(np.isfinite(lt).all() and not np.allclose(lt, lt0),
          "log_traj finite and moved")
    return launches


def phase_mala_end_to_end():
    """mala_fused_16x4 on Sunspot (64 x 5000, seed 0); returns its
    launches and its cold RMSE, mean accept and swap, which the per-step
    mala_16x4 is held to."""
    from ptnn_torch.ops import precond_step

    cfg = precond_cfg(64, 5000, "precond_mala", track_replicas=True)
    res, launches, n_blocks = run_counted("mala_block", cfg)
    wpcs = {w: n for w, n in precond_step.mala_wpcs.items() if n}
    plan = precond_step.card_mala_plan(DEVICE, 64, 496)
    rmse, acc, trips = cold_stats(res, cfg)
    print(f"[4/6] end to end: mala_fused_16x4 64 chains x 5000 samples in "
          f"{res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} "
          f"chain-steps/s); cold test RMSE {rmse:.5f}, mean accept "
          f"{acc:.2f}%, swap {res.swap_percent:.2f}%, round trips "
          f"{trips:.2f} per ladder per 1k steps; kernel launches {launches} "
          f"for {n_blocks} planned blocks, by warps a chain {wpcs}")
    check(MALA_RMSE[0] <= rmse <= MALA_RMSE[1],
          f"mala cold test RMSE {rmse:.4f} outside {MALA_RMSE}")
    check(wpcs == {plan.wpc: launches}, f"mala_block launches by WPC "
          f"{wpcs}, planned all at {plan.wpc}")
    return launches, dict(rmse=rmse, accept=acc, swap=res.swap_percent)


def precond_kernel_call(cfg, phases):
    """The kernel call of one 10-step Sunspot MALA or HMC block at cfg's
    widths from step 20, and its inputs."""
    from ptnn_torch.ops import precond_step

    state, noise, kdata, at, scal = precond_inputs(cfg, 10, 20, phases)
    args = (state, noise, 20, 10, kdata, at, cfg.topology, scal)
    kern = (precond_step.fused_hmc_block if cfg.proposal == "hmc"
            else precond_step.fused_mala_block)
    return lambda: kern(*args, record_w=False), args


def time_precond_block(cfg, phases, graph=False):
    """Times of one 10-step Sunspot MALA or HMC block at cfg's widths and of
    its plain version, and the block's bound; for the MALA kernel, whose
    call the host issues about as fast as the card runs it, and with
    ``graph``, also its device time (``graph_ms``, a CUDA graph of 100
    calls)."""
    from ptnn_torch.ops import precond_step

    kern, args = precond_kernel_call(cfg, phases)
    state, noise, _start, _k, kdata, at, _topo, _scal = args
    hmc = cfg.proposal == "hmc"
    plain = (precond_step.hmc_block_reference if hmc
             else precond_step.mala_block_reference)
    k_ms, p_ms = timing(kern, lambda: plain(*args, record_w=False), 10, 2)
    new, tr = kern()
    evals = float(tr["traj_len"].sum()) if hmc else None
    ops = block_ops("hmc" if hmc else "mala", cfg.topology, cfg.num_chains,
                    10, kdata["n_tr"], kdata["n_te"], evals)
    b_ms, b_by = bound(ops, tensor_bytes(state, noise, kdata["rows"], at,
                                         new, tr))
    out = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    if not hmc or graph:
        out["graph_ms"] = min(graph_ms(kern) for _ in range(2))
    return out


def phase_precond_throughput():
    import ptnn_torch

    prob = sunspot()
    adapting = dict(warm_end=0, pc_start=0, burn_end=1000)
    out = {}
    for name, cfg in (("mala_block", precond_cfg(64, 2000, "precond_mala")),
                      ("hmc_block", precond_cfg(1024, 2000, "hmc"))):
        runner = ptnn_torch.throughput_runner(cfg, prob.train, prob.test,
                                              device=DEVICE)
        reps = [runner() for _ in range(3)]
        rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
        t = out[name] = time_precond_block(cfg, adapting)
        tag = "chees16_fused_256x4" if name == "hmc_block" else "mala_fused_16x4"
        if name == "hmc_block":
            from ptnn_torch.ops import precond_step

            tag += " (route " + "/".join(
                r for r, n in precond_step.hmc_routes.items() if n) + ")"
        dev = (f" ({t['graph_ms']:.4f} ms of device time, a CUDA graph of "
               f"100 calls)" if "graph_ms" in t else "")
        print(f"[5/6] throughput: {tag} {cfg.num_chains} chains x 2000 "
              f"samples: median {rate:.0f} chain-steps/s over 3 reps (accept "
              f"{reps[0]['accept_pct']:.1f}%, swap {reps[0]['swap_pct']:.1f}%);"
              f" one adapting 10-step block: kernel {t['ms']:.4f} ms a call "
              f"from the host loop{dev}, plain version {t['plain_ms']:.3f} "
              f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a block's work.


def tensor_bytes(*trees):
    """Bytes of every tensor in the given dicts, tuples and tensors."""
    import torch

    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += tensor_bytes(*t.values())
        elif isinstance(t, (tuple, list)):
            total += tensor_bytes(*t)
    return total


def row_ops(topo, cls, grad):
    """Arithmetic of one data row: the forward (a multiply-add counts 2, a
    sigmoid SIGMOID_OPS), the loss (log-sum-exp and argmax, or the squared
    residual) and, with ``grad``, the backprop of ptnn's _fwd_grad_*."""
    i, h, o = topo
    ops = h * (2 * i + 1 + SIGMOID_OPS) + o * (2 * h + 1 + SIGMOID_OPS)
    ops += (5 * o + 2) if cls else 3
    if grad:
        ops += (6 * o if cls else 4) + h * (4 * o + 2 * i + 4)
    return ops


def bound(ops, nbytes):
    """(bound_ms, bound_by) of ``ops`` float32 operations moving ``nbytes``."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def block_ops(kind, topo, c, live, n_tr, n_te, evals=None):
    """Operations of one block: ``kind`` rw (both tasks), mala or hmc;
    ``evals`` the gradient evaluations the HMC block ran (its realized
    leapfrog counts), read from its traj_len trace."""
    from ptnn_torch.models import fnn

    cls = topo[2] > 1
    w = fnn.w_size(topo)
    if kind == "rw":
        return live * c * ((n_tr + n_te) * row_ops(topo, cls, False) + 4 * w)
    per_eval = n_tr * row_ops(topo, cls, True) + 12 * w
    step = n_te * row_ops(topo, cls, False) + 30 * w
    if kind == "mala":
        return live * c * (per_eval + step)
    return evals * per_eval + live * c * step


def timing(kern, plain, reps, plain_reps, warm=2):
    """(kernel ms, plain ms): alternated plain, kernel, kernel, plain."""
    p1 = time_ms(plain, plain_reps, warm=1)
    k1 = time_ms(kern, reps, warm=warm)
    k2 = time_ms(kern, reps, warm=warm)
    p2 = time_ms(plain, plain_reps, warm=1)
    return min(k1, k2), min(p1, p2)


# ---------------------------------------------------------------------------
# Classification (iris).


def iris():
    from ptnn_torch import data

    return data.load_classification("iris")


def iris_cfg(chains, samples, proposal, **kw):
    """bench.py's _cls_variants (bench.py:297-335) on iris: the
    classification preset at maxtemp 5, 4-rung replicated ladders, DEO
    swaps every 10 with untempered Metropolis payloads, warm start to 10 %,
    preconditioner from 30 %, the cold rungs' w recorded, replicas
    tracked; ChEES-16 for HMC."""
    from ptnn_torch import classification_preset

    base = classification_preset(IRIS_TOPO, num_samples=chains * samples,
                                 num_chains=chains, maxtemp=5.0)
    extra = (dict(hmc_leapfrog=16, hmc_adapt_traj=True, step_w=0.01)
             if proposal == "hmc" else {})
    fields = dict(
        proposal=proposal, n_ladders=chains // 4, adapt_rate=0.1,
        swap_style="even_odd", swap_interval=10, swap_rule="metropolis",
        swap_payload="untempered", warmstart_frac=0.1,
        precond_start_frac=0.3, record_w=True, record_w_chains=chains // 4,
        track_replicas=True, chunk_steps=1000, fused_step=True, **extra)
    fields.update(kw)
    return dataclasses.replace(base, **fields).validate()


def rw_preset_cfg(name="iris", samples=5000, chains=10, topo=None, **kw):
    """The classification RW preset of the bundled set ``name``,
    classification_preset(topology, 50_000): 10 chains, maxtemp 10, swap
    every 100 (after steps 99, 199, ...), fused; ``topo`` overrides the
    set's network."""
    from ptnn_torch import classification_preset

    cfg = classification_preset(topo or CLS_RW_SETS[name][0],
                                num_samples=chains * samples,
                                num_chains=chains)
    return dataclasses.replace(cfg, fused_step=True, **kw).validate()


def cls_inputs(cfg, k, start, phases=None, seed=CLS_SEED, name="iris"):
    """Random state at cfg's widths on all rows of the bundled set ``name``
    (init_state at N(0, 1) weights, so ll, prior and g_like are exact),
    per-chain jittered scales, noise and uniforms for one block of ``k``
    steps from ``start``, made with numpy; ``phases`` overrides the block
    scalars."""
    import numpy as np
    import torch

    from ptnn_torch import data, fused, kernel
    from ptnn_torch.models import fnn
    from ptnn_torch.ops import block_step
    from ptnn_torch.sampler import make_dataset

    rng = np.random.default_rng(seed)
    prob = data.load_classification(name)
    c, w = cfg.num_chains, fnn.w_size(cfg.topology)
    ds = make_dataset(cfg, prob.train, prob.test, DEVICE)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    st = kernel.init_state(cfg, ds, init_w=f(rng.normal(size=(c, w))))
    state = fused._to_kernel_state(st, cfg)
    state["log_step_w"] = f(np.log(cfg.step_w) + 0.3 * rng.normal(size=c))
    noise = dict(w=f(rng.normal(size=(k, c, w))),
                 u=f(rng.uniform(size=(k, c))))
    if cfg.proposal == "hmc":
        noise["u_jit"] = f(rng.uniform(size=(k, c)))
        noise["u_traj"] = kernel.vdc_u(torch.arange(start, start + k,
                                                    device=DEVICE))
    scal = dict(fused._scalars(cfg), **(phases or {}))
    kdata = block_step.prep_data(ds.x_train, ds.y_train, ds.x_test,
                                 ds.y_test, n_classes=cfg.topology[2])
    temps = np.geomspace(1.0, 5.0, cfg.rungs_per_ladder)
    at = f(np.tile(temps, cfg.n_ladders))
    return state, noise, kdata, at, scal


def cls_call(kind, state, noise, start, length, kdata, at, scal, plain,
             record_w=True, diagnostics=False, topo=IRIS_TOPO):
    """One block of the classification kernel ``kind`` (rw, mala, hmc), or
    of its plain version, on the network ``topo``."""
    from ptnn_torch.ops import block_step, precond_cls_step

    extra = dict(diagnostics=True) if diagnostics else {}
    if kind == "rw":
        fn = block_step.rw_block_reference if plain else block_step.fused_rw_block
        return fn(state, noise["w"], None, noise["u"], start, length, kdata,
                  at, topo, scal, record_w=record_w, **extra)
    if kind == "hmc":
        fn = (precond_cls_step.hmc_cls_block_reference if plain
              else precond_cls_step.fused_hmc_cls_block)
    else:
        fn = (precond_cls_step.mala_cls_block_reference if plain
              else precond_cls_step.fused_mala_cls_block)
    return fn(state, noise, start, length, kdata, at, topo, scal,
              record_w=record_w, **extra)


def compare_cls(kind, cfg, k, length, start, phases, seed=CLS_SEED,
                name="iris"):
    """One block of a classification kernel against its plain version on
    the same CUDA tensors, on the rows of the bundled set ``name``. Chains
    within a decision margin (|u - a|, or the leapfrog count's boundary;
    under ChEES their whole (panel, rung) group) are left out, at most 1 %
    (RW: or one chain). RW's chains whose plain float32 and float64 runs
    decide apart count among them, and in each the kernel must decide as
    the float64 run wherever that run's |u - a| stays above the margin
    (``block_step.rw_cls_witness``). acc and rmse are exact functions of
    the argmax: they must match exactly wherever their source proposal's
    every row keeps its argmax through a 1e-5 move of the logits
    (block_step.argmax_fragile), at most 1 % of the entries may not. RW's
    are also held exactly to the plain evaluation at the kernel's own
    weights, and the entries fragile there, or whose plain evaluation
    differs between the two versions' weights, count among those 1 %
    (``block_step.rw_cls_own_weights``). HMC's floats carry the float64
    witness of compare_precond (WITNESS_R): the kernel sums a chain's rows
    over several warps, in another order than the plain version; so do
    RW's on the networks of ``block_step.RW_CLS_UNHELD``. Returns
    (excluded chains, excluded groups, accepts, what each rule excluded,
    max |diff| of the floats, what it was, witness)."""
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import block_step, precond_cls_step

    state, noise, kdata, at, scal = cls_inputs(cfg, k, start, phases, seed,
                                               name)
    topo = tuple(cfg.topology)
    name = KERNEL_OF[kind]
    before = launch_count(name)
    new_k, tr_k = cls_call(kind, state, noise, start, length, kdata, at,
                           scal, plain=False, topo=topo)
    check(launch_count(name) == before + 1, f"{name} did not launch")
    new_r, tr_r = cls_call(kind, state, noise, start, length, kdata, at,
                           scal, plain=True, diagnostics=True, topo=topo)
    new_d = tr_d = None
    c = cfg.num_chains
    same = torch.ones(c, dtype=torch.bool, device=DEVICE)
    # the float64 witness, the same inputs in float64: HMC's, and the
    # generic route's MALA on hundreds of rows, as the regression MALA's
    if kind == "hmc" or (kind == "mala"
                         and topo not in precond_cls_step.TOPOLOGIES):
        new_d, tr_d = cls_call(kind, upcast(state), upcast(noise), start,
                               length, upcast(kdata), at.double(), scal,
                               plain=True, topo=topo)
        same = new_d["n_accept"] == new_r["n_accept"]
        for n in ("accept_count", "traj_len"):
            if n in tr_r:
                same &= (tr_d[n] == tr_r[n]).all(dim=0)
    torch.cuda.synchronize()
    close = tr_r["margin"] <= P_MARGIN
    if "traj_margin" in tr_r:
        close |= tr_r["traj_margin"] <= TRAJ_MARGIN
    excluded = dict(margin=int(close.sum()))
    if kind == "rw":  # the float64 witness of the decisions
        apart, off, run_d = block_step.rw_cls_witness(
            state, noise["w"], noise["u"], start, length, kdata, at, topo,
            scal, (new_k, tr_k), (new_r, tr_r), P_MARGIN)
        check(not bool(off.any()), f"{name}: in {int(off.sum())} chains "
              f"the kernel decides apart from the plain version's float64 "
              f"run outside the {P_MARGIN} margin")
        # on the networks of RW_CLS_UNHELD, |ll| of 1e3-1e4 lets the plain
        # version's float32 rounding move an adapting chain's step, and so
        # its weights, past the tolerance: their floats take the witness
        if topo in block_step.RW_CLS_UNHELD:
            (new_d, tr_d), same = run_d, ~apart
        excluded["rounding"] = int((apart & ~close).sum())
        close |= apart
    n_groups = 0
    if kind == "hmc" and scal["chees"]:
        panel = scal["rungs"] * scal["n_ladders"]
        idx = torch.arange(c, device=DEVICE)
        group = (idx // panel) * scal["rungs"] + idx % scal["rungs"]
        tainted = torch.zeros(int(group.max()) + 1, dtype=torch.bool,
                              device=DEVICE)
        tainted[group[close]] = True
        n_groups = int(tainted.sum())
        close = tainted[group]
        apart = torch.zeros_like(tainted)
        apart[group[~same]] = True
        same = ~apart[group]
    ok = ~close
    n_close = int(close.sum())
    # the RW blocks, as compare_block: 1 %, or one chain of fewer than 100
    allowed = max(0.01 * c, 1) if kind == "rw" else 0.01 * c
    check(n_close <= allowed, f"{name}: {n_close} of {c} chains within the "
          f"decision margins ({n_groups} ChEES groups)")
    na = new_r["n_accept"]
    check(0 < int(na.sum()) < length * c, f"{name}: accepted all or nothing")
    exact = [(new_k["n_accept"][ok], na[ok], "n_accept")]
    exact += [(tr_k[n][:, ok], tr_r[n][:, ok], "trace " + n)
              for n in ("accept_count", "traj_len") if n in tr_r]
    sure = ok & ~tr_r["argmax_fragile_final"]
    t_sure = ok[None, :] & ~tr_r["argmax_fragile"]
    excluded["fragile"] = int((~t_sure[:, ok]).sum())
    if kind == "rw":  # also exact at the kernel's own weights
        bad, frag, drift = block_step.rw_cls_own_weights(
            state, (new_k, tr_k), (new_r, tr_r), kdata, topo)
        check(bad == 0, f"{name}: acc or rmse differs from the plain "
              f"evaluation at the kernel's own weights in {bad} entries")
        for rule, mask in (("fragile_own", frag), ("drift", drift)):
            excluded[rule] = int((mask[:-1] & t_sure)[:, ok].sum())
            t_sure &= ~mask[:-1]
            sure &= ~mask[-1]
    n_fragile = int((~t_sure[:, ok]).sum())
    excluded["share"] = n_fragile / t_sure[:, ok].numel()
    # a network whose share the 1 % cannot hold runs per-step: its case
    # reports the share, and the fused gate must refuse it
    held = kind != "rw" or topo not in block_step.RW_CLS_UNHELD
    check(not held or excluded["share"] <= 0.01,
          f"{name}: {n_fragile} trace entries from fragile argmaxes "
          f"({excluded_text(excluded)})")
    for n in ("acc_train", "acc_test", "rmse_train", "rmse_test"):
        exact.append((new_k[n][sure], new_r[n][sure], n))
        exact.append((tr_k[n][t_sure], tr_r[n][t_sure], "trace " + n))
    for a, b, what in exact:
        bad = int((a != b).sum())
        check(bad == 0, f"{name}: {what} differs in {bad} entries")
    vec_scale = lambda v: v.abs().amax(dim=-1, keepdim=True).expand_as(v)
    rtol, atol = (RTOL, ATOL) if kind == "rw" else (P_RTOL, P_ATOL)
    # (kernel, plain, float64 witness or None, scale, chain axis, what)
    pairs = []
    for n, v in new_r.items():
        if n in ("n_accept", "acc_train", "acc_test", "rmse_train",
                 "rmse_test"):
            continue
        scale = vec_scale(v) if v.dim() == 2 else v
        wit = None if new_d is None else new_d[n]
        if n == "chees_m1":
            scale = v.abs() + new_r["chees_v2"].abs().sqrt()
        if n == "g_like":  # the gradient at the kernel's own w: no witness
            v = fnn.multinomial_ll_grad(new_k["w"], kdata["x_tr"],
                                        kdata["yi_tr"], topo)[1]
            scale, wit = vec_scale(v), None
        pairs.append((new_k[n], v, wit, scale, 0, n))
    # the multinomial ll is a sum of negative terms: held on its own size
    pairs.append((tr_k["ll"], tr_r["ll"], None if tr_d is None else tr_d["ll"],
                  tr_r["ll"], 1, "trace ll"))
    pairs.append((tr_k["w"], tr_r["w"], None if tr_d is None else tr_d["w"],
                  vec_scale(tr_r["w"]), 1, "trace w"))
    err, err_of, past, r_needed, worst = 0.0, "", {}, 0.0, None
    for a, b, wit, scale, axis, what in pairs:
        check(bool(torch.isfinite(a).all()), f"{name}: {what} not finite")
        shape = [1] * a.dim()
        shape[axis] = c
        keep = ok.reshape(shape).expand_as(a)
        diff = (a - b).abs()
        tol = atol + rtol * scale.abs()
        d = torch.zeros_like(diff)
        if wit is not None:
            d = (chain_max((b - wit).abs(), axis) * same).reshape(
                shape).expand_as(a).to(diff.dtype)
        bad = int(((diff > tol + WITNESS_R * d) & keep).sum())
        check(bad == 0, f"{name}: {what}: {bad} entries off, max |diff| "
              f"{float(diff[keep].max()):.3g}")
        over = (diff > tol) & keep
        if bool(over.any()):
            past[what] = int(over.sum())
            need = torch.where(over, (diff - tol) / d, torch.zeros_like(d))
            at_max = int(need.argmax())
            if float(need.flatten()[at_max]) > r_needed:
                r_needed = float(need.flatten()[at_max])
                worst = (what, float((a - wit).abs().flatten()[at_max]),
                         float((b - wit).abs().flatten()[at_max]))
        if float(diff[keep].max()) > err:
            err, err_of = float(diff[keep].max()), (
                f"{what}, of size {float(b[keep].abs().max()):.3g}")
    return (n_close, n_groups, int(na.sum()), excluded, err, err_of,
            dict(past=past, r_needed=r_needed, worst=worst))


KERNEL_OF = {"rw": "rw_cls_block", "mala": "mala_cls_block",
             "hmc": "hmc_cls_block"}


def excluded_text(excluded):
    """compare_cls's exclusions, rule by rule."""
    chains = dict(margin="within the decision margins",
                  rounding="more whose plain float32 and float64 runs decide "
                           "apart (the kernel decides as the float64 run in "
                           "each, outside its margin)")
    entries = dict(fragile="fragile in the plain version",
                   fragile_own="more fragile at the kernel's own weights",
                   drift="more whose plain evaluation differs between the "
                         "two versions' weights")
    say = lambda rules: ", ".join(f"{excluded[r]} {text}"
                                  for r, text in rules.items()
                                  if r in excluded)
    return (f"chains {say(chains)}; trace entries {say(entries)} "
            f"({100 * excluded['share']:.3f} % of them)")


def rw_cls_taken(kinds, warps, topo, chains, rows, n):
    """Checks that the ``n`` rw_cls_block launches since the counts were
    ``kinds`` (by kernel) and ``warps`` (the fixed kernel's, by warps a
    chain) all took the kernel ``block_step.cls_variant`` gives ``topo`` at
    the warps the card's plan gives; returns what ran, as text."""
    from ptnn_torch.ops import block_step

    kind = block_step.cls_variant(topo)
    ran = {v: block_step.cls_variant_launches[v] - kinds.get(v, 0)
           for v in block_step.cls_variant_launches}
    check(ran == {"fixed": n if kind == "fixed" else 0,
                  "generic": n if kind == "generic" else 0},
          f"rw_cls_block ran {ran} for {tuple(topo)}, planned {n} {kind}")
    if kind == "generic":
        return "the generic kernel"
    plan = block_step.card_rw_cls_plan(DEVICE, chains, rows)
    by = {w: m - warps.get(w, 0) for w, m in block_step.rw_cls_warps.items()
          if m != warps.get(w, 0)}
    check(by == {plan.warps: n}, f"rw_cls_block launches by warps {by}, "
          f"planned {n} at {plan.warps}")
    return f"the fixed kernel at {plan.warps} warps a chain"


def phase_cls_kernels():
    """The three classification kernels against their plain versions (RW on
    every fixed-shape network, and by the generic kernel on winequality-red,
    abalone and a (4, 7, 3); MALA and HMC on iris); returns the largest
    float difference of each. The networks of ``block_step.RW_CLS_UNHELD``
    are held to everything but the 1 % of fragile trace entries, which
    their share reaches: the fused gate must refuse them."""
    from ptnn_torch import fused
    from ptnn_torch.ops import block_step, precond_cls_step

    out = {}
    phases = dict(warm_end=2, pc_start=4, burn_end=8)
    hmc = lambda c, **kw: iris_cfg(c, 100, "hmc", step_w=CLS_STEP_HMC, **kw)
    plain = dict(hmc_leapfrog=8, hmc_adapt_traj=False)
    rw = lambda name, c, adapt, topo=None: (
        "rw", rw_preset_cfg(name, 1000, c, topo, adapt_step_size=adapt), 100,
        90, 0, dict(adapt=adapt, burn_end=60) if adapt else dict(adapt=False),
        name)
    # iris at 1000 chains, adapt off and on; the other fixed-shape networks
    # on their sets' rows at the presets' 10 chains and at 1000; networks
    # the generic kernel runs: winequality-red's and abalone's on their
    # rows, and a (4, 7, 3)
    cases = [rw("iris", 1000, False), rw("iris", 1000, True)]
    cases += [rw(name, c, c > 10) for name in ("Cancer", "TicTac",
                                               "Ionosphere")
              for c in (10, 1000)]
    cases += [rw(name, c, c > 10, topo) for name, topo in GENERIC_SETS.items()
              for c in (10, 1000)]
    cases += [rw("iris", 64, True, (4, 7, 3))]
    cases += [
             # MALA at the path's width (WPC 4 on the H100) and at 1024
             ("mala", iris_cfg(64, 100, "precond_mala",
                               step_w=CLS_STEP_MALA), 10, 10, 0,
              dict(warm_end=2, pc_start=5, burn_end=8), "iris"),
             ("mala", iris_cfg(1024, 100, "precond_mala",
                               step_w=CLS_STEP_MALA), 10, 10, 0,
              dict(warm_end=2, pc_start=5, burn_end=8), "iris"),
             # ChEES on one panel, on two, and on one of 13 ladders whose
             # last block is half empty; without ChEES a ragged count and
             # the full card
             ("hmc", hmc(64), 10, 10, 0, phases, "iris"),
             ("hmc", hmc(256), 10, 10, 0, phases, "iris"),
             ("hmc", hmc(52), 10, 10, 0, phases, "iris"),
             ("hmc", hmc(130, n_ladders=26, record_w_chains=26, **plain), 10,
              10, 0, phases, "iris"),
             ("hmc", hmc(1024, **plain), 10, 10, 0, phases, "iris"),
             # the shapes ptnn_torch.auto builds for iris (results/
             # auto_study.md: 9 ladders x 7 rungs of its (4, 10, 3)
             # network): MALA (--target speed) and ChEES (quality)
             ("mala", iris_cfg(63, 100, "precond_mala", step_w=CLS_STEP_MALA,
                               **AUTO_IRIS), 10, 10, 0,
              dict(warm_end=2, pc_start=5, burn_end=8), "iris"),
             ("hmc", hmc(63, **AUTO_IRIS), 10, 10, 0, phases, "iris")]
    # the generic route: Cancer's (9, 12, 2) on its rows at 64 and 256
    # chains, MALA and HMC with and without ChEES; auto's (9, 10, 2) on
    # TicTac's rows at 64, MALA and ChEES
    gen = lambda c, proposal, topo, **kw: iris_cfg(
        c, 100, proposal, topology=topo, step_w=(
            CLS_STEP_HMC if proposal == "hmc" else CLS_STEP_MALA), **kw)
    mala_phases = dict(warm_end=2, pc_start=5, burn_end=8)
    for c in (64, 256):
        cases += [("mala", gen(c, "precond_mala", CANCER_TOPO), 10, 10, 0,
                   mala_phases, "Cancer"),
                  ("hmc", gen(c, "hmc", CANCER_TOPO), 10, 10, 0, phases,
                   "Cancer"),
                  ("hmc", gen(c, "hmc", CANCER_TOPO, **plain), 10, 10, 0,
                   phases, "Cancer")]
    cases += [("mala", gen(64, "precond_mala", AUTO_NINE), 10, 10, 0,
               mala_phases, "TicTac"),
              ("hmc", gen(64, "hmc", AUTO_NINE), 10, 10, 0, phases,
               "TicTac")]
    for kind, cfg, k, length, start, phases, set_name in cases:
        routes = dict(precond_cls_step.hmc_cls_routes)
        wpcs = dict(precond_cls_step.mala_cls_wpcs)
        kinds = dict(block_step.cls_variant_launches)
        warps = dict(block_step.rw_cls_warps)
        name = KERNEL_OF[kind]
        topo = tuple(cfg.topology)
        generic = kind != "rw" and topo not in precond_cls_step.TOPOLOGIES
        variants = dict(precond_cls_step.variant_launches.get(name, {}))
        n_close, n_groups, n_acc, excluded, err, err_of, wit = compare_cls(
            kind, cfg, k, length, start, phases, name=set_name)
        out[name] = max(out.get(name, 0.0), err)
        what, wit_txt = "", ""
        rows = CLS_ROWS.get(set_name, 150)
        if generic:
            check(precond_cls_step.variant_launches[name]["generic"]
                  == variants["generic"] + 1, f"{name} at {topo} did not "
                  f"take the generic route")
            wit_txt = f"; {witness_text(wit)}"
        if kind == "hmc":
            c = cfg.num_chains
            panel = min(c, 128) if cfg.hmc_adapt_traj else 0
            plan = precond_cls_step.card_plan(DEVICE, c, panel, rows, topo)
            taken = [r for r in routes
                     if precond_cls_step.hmc_cls_routes[r] > routes[r]]
            check(taken == [plan.route], f"hmc_cls_block took {taken}, "
                  f"planned {plan.route}")
            what = (f"ChEES ({c // panel} panels), " if panel else "")
            what += (f"leapfrog {cfg.hmc_leapfrog}, WPC {plan.wpc}, "
                     f"{plan.blocks} blocks, route {plan.route}, ")
            wit_txt = f"; {witness_text(wit)}"
        if kind != "rw" and tuple(cfg.topology) != IRIS_TOPO:
            what = f"{tuple(cfg.topology)} {cfg.n_ladders} x " \
                f"{cfg.rungs_per_ladder} rungs, " + what
        if kind == "mala":
            plan = precond_cls_step.card_mala_plan(DEVICE, cfg.num_chains,
                                                   rows, topo)
            taken = [w for w in wpcs
                     if precond_cls_step.mala_cls_wpcs[w] > wpcs[w]]
            check(taken == [plan.wpc], f"mala_cls_block took WPC {taken}, "
                  f"planned {plan.wpc}")
            what += f"WPC {plan.wpc}, {plan.blocks} blocks, "
        if generic:
            what = (f"{set_name} by the generic route ({plan.warps} warps a "
                    f"block, vectors in {plan.vectors} memory), " + what)
        if kind == "rw":
            what = rw_cls_taken(kinds, warps, cfg.topology, cfg.num_chains,
                                CLS_ROWS.get(set_name), 1)
            what = f"{set_name} {tuple(cfg.topology)} by {what}, "
            if tuple(cfg.topology) in block_step.RW_CLS_UNHELD:
                reason = fused.topology_reason(cfg)
                check(reason is not None, f"{set_name}'s RW preset runs "
                      f"fused, unheld")
                what += f"not held ({reason}), "
                wit_txt = f"; {witness_text(wit)}"
        print(f"[3/6] kernel: {name} {what}C={cfg.num_chains} K={k} "
              f"length={length} {phases}: {n_acc} accepts, counters"
              f"{' and traj_len' if kind == 'hmc' else ''} exact; {n_close} "
              f"chains ({n_groups} ChEES groups) excluded, acc and rmse "
              f"exact elsewhere but in the entries excluded: "
              f"{excluded_text(excluded)}; floats within rtol "
              f"{RTOL if kind == 'rw' else P_RTOL}, ll on its own size (max "
              f"|diff| {err:.3g}: {err_of}){wit_txt}")
    return out


def launch_count(name):
    from ptnn_torch.ops import (block_step, conv_stage, drift, fnn_eval,
                                precond_cls_step, precond_step)

    if name == "conv1_relu_pool":
        return conv_stage.launches
    if name == "drift_epoch":
        return drift.launches
    if name == "fnn_eval":
        return fnn_eval.launches
    if name == "rw_block":
        return block_step.launches
    if name == "rw_cls_block":
        return block_step.cls_launches
    if name in precond_cls_step.launches:
        return precond_cls_step.launches[name]
    return precond_step.launches[name]


def reset_launch_counts():
    from ptnn_torch.ops import (block_step, conv_stage, drift, fnn_eval,
                                precond_cls_step, precond_step)

    conv_stage.launches = 0
    conv_stage.fixed_launches = 0
    block_step.launches = 0
    block_step.cls_launches = 0
    drift.launches = 0
    fnn_eval.launches = 0
    for counts in (precond_step.launches, precond_cls_step.launches,
                   precond_step.hmc_routes, precond_cls_step.hmc_cls_routes,
                   precond_step.mala_wpcs, precond_cls_step.mala_cls_wpcs,
                   block_step.variant_launches, block_step.cls_variant_launches,
                   block_step.rw_cls_warps, drift.variant_launches,
                   drift.route_launches,
                   *precond_step.variant_launches.values(),
                   *precond_cls_step.variant_launches.values()):
        for key in counts:
            counts[key] = 0


def served_accuracy(cfg, res, prob):
    """bench.py:421-441's served cold accuracy: the accuracy on the test
    rows of predict.posterior_predict's labels over the second half's
    cold-rung weights, pooled over the replicas without bench.py:433's
    aliasing (its stride over the pooled rows is a multiple of the replica
    count and keeps replica 0 alone). Returns (served % over every draw,
    served % over ~2000 draws thinned along the draw axis, the (draws,
    replicas, W) cold weights, the rows the served predictor misclassifies
    with their class probabilities). The gate reads the first: iris's served
    accuracy is 43 or 44 of 45 rows, decided by one row whose posterior-mean
    class probabilities tie to 1e-3, and a 2000-draw subsample's noise
    flips it (ptnn reads the same, PERF.md)."""
    import numpy as np

    from ptnn_torch import predict

    b = cfg.samples_per_chain // 2
    cold = np.asarray(res.traces["w"][b:])  # (draws, R, W)
    nx = cfg.topology[0]
    y = prob.test[:, nx].astype(np.int64)

    def served(pool):
        pred = predict.posterior_predict(cfg, pool, prob.test[:, :nx],
                                         device=DEVICE)
        return float(np.mean(pred["label"] == y)) * 100.0, pred

    step = max(1, cold.shape[0] // max(1, 2000 // cold.shape[1]))
    acc_all, pred = served(cold.reshape(-1, cold.shape[-1]))
    wrong = " ".join(
        f"{i}:{y[i]}->({', '.join(f'{q:.3f}' for q in pred['probs'][i])})"
        for i in np.nonzero(pred["label"] != y)[0])
    return (acc_all, served(cold[::step].reshape(-1, cold.shape[-1]))[0],
            cold, wrong)


def iris_stats(cfg, res):
    """Per-draw cold accuracy (second half, every ladder's rung 0), mean
    accept %, round trips per ladder per 1k steps."""
    import numpy as np

    from ptnn_torch.ops import roundtrip

    s = cfg.samples_per_chain
    cold = np.arange(0, cfg.num_chains, cfg.rungs_per_ladder)
    acc = float(np.mean(res.traces["acc_test"][s // 2:, cold]))
    rt = roundtrip.roundtrip_stats(res.traces["replica"],
                                   n_ladders=cfg.n_ladders)
    return acc, float(np.mean(res.accept_ratio_per_chain)), \
        rt.rate_per_kstep / cfg.n_ladders


def phase_iris_end_to_end():
    """The iris RW preset, the quality flagship chees16_fused_16x4 (seeds
    1-3, the served-accuracy gate) and mala_fused_16x4; returns each
    kernel's launches in its run (the flagship's first seed)."""
    import numpy as np

    from ptnn_torch.ops import ess, precond_cls_step

    prob = iris()
    launches = {}
    # --- the RW preset ------------------------------------------------------
    cfg = rw_preset_cfg(record_w=True, track_replicas=True)
    res, n, n_blocks = run_counted("rw_cls_block", cfg, prob)
    taken = rw_cls_taken({}, {}, cfg.topology, cfg.num_chains, 150, n)
    launches["rw_cls_block"] = n
    tr = res.traces
    s, c = cfg.samples_per_chain, cfg.num_chains
    for name in ("ll", "acc_train", "acc_test", "rmse_test", "accept_count"):
        check(tr[name].shape == (s, c), f"trace {name} shape {tr[name].shape}")
        check(np.isfinite(tr[name]).all(), f"trace {name} not finite")
    check(tr["w"].shape == (s, c, 99), f"trace w shape {tr['w'].shape}")
    acc = float(np.mean(tr["acc_test"][s // 2:, 0]))
    mean_acc = float(np.mean(res.accept_ratio_per_chain))
    print(f"[4/6] end to end: iris RW preset {c} chains x {s} samples in "
          f"{res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} chain-steps/s "
          f"incl. trace fetch); cold test accuracy {acc:.2f}% (ptnn 67.93-"
          f"73.51), mean accept {mean_acc:.2f}% (94.54-95.31), swap "
          f"{res.swap_percent:.2f}% (72.56-76.87); kernel launches {n} for "
          f"{n_blocks} planned blocks, all by {taken}")
    for what, v, (lo, hi) in (("cold test accuracy", acc, IRIS_RW_ACC),
                              ("mean accept %", mean_acc, IRIS_RW_ACCEPT),
                              ("swap %", res.swap_percent, IRIS_RW_SWAP)):
        check(lo <= v <= hi, f"iris RW {what} {v:.4f} outside [{lo}, {hi}]")
    # --- the quality flagship, three seeds ----------------------------------
    cfg = iris_cfg(64, 8000, "hmc")
    served, rows = [], []
    for seed in (1, 2, 3):
        res, n, n_blocks = run_counted("hmc_cls_block", cfg, prob, seed=seed)
        launches.setdefault("hmc_cls_block", n)
        plan = precond_cls_step.card_plan(DEVICE, 64, 64, 150)
        routes = {r: k for r, k in precond_cls_step.hmc_cls_routes.items() if k}
        check(routes == {plan.route: n}, f"hmc_cls_block routes {routes}, "
              f"planned {n} by {plan.route}")
        for name in ("ll", "acc_test", "traj_len", "replica"):
            check(np.isfinite(res.traces[name]).all(),
                  f"trace {name} not finite")
        check(res.traces["w"].shape == (cfg.samples_per_chain, 16, 99),
              f"trace w shape {res.traces['w'].shape}")
        acc_s, acc_thin, cold, wrong = served_accuracy(cfg, res, prob)
        draw, accept, trips = iris_stats(cfg, res)
        tl = res.traces["traj_len"][1:]
        ess_s = (ess.pooled_multi_ess(cold, max_params=16) / cold.shape[0]
                 * res.chain_steps_per_sec / cfg.num_chains)
        served.append(acc_s)
        rows.append((draw, accept, res.swap_percent, trips))
        print(f"[4/6] end to end: iris chees16_fused_16x4 seed {seed}, 64 "
              f"chains x 8000 samples in {res.elapsed_s:.3f} s "
              f"({res.chain_steps_per_sec:.0f} chain-steps/s incl. trace "
              f"fetch): served cold accuracy {acc_s:.2f}% over every draw "
              f"({acc_thin:.2f}% over 2000; misclassified row:label->probs "
              f"{wrong}), per-draw {draw:.2f}%, mean "
              f"accept {accept:.2f}%, swap {res.swap_percent:.2f}%, round "
              f"trips {trips:.2f} per ladder per 1k steps; "
              f"pooled cold ESS/s {ess_s:.1f}; traj_len {tl.min():.0f}-"
              f"{tl.max():.0f} (mean {tl.mean():.2f}); kernel launches {n} "
              f"for {n_blocks} planned blocks, all by the {plan.route} route "
              f"at WPC {plan.wpc}")
        check(tl.min() >= 1 and tl.max() <= 16 and len(np.unique(tl)) > 1,
              "traj_len stays in [1, 16] and varies")
    med = statistics.median(served)
    print(f"[4/6] end to end: iris quality gate: median served cold accuracy "
          f"{med:.2f}% over seeds 1-3 ({', '.join(f'{a:.2f}' for a in served)};"
          f" ptnn 95.56, 97.78, 97.78) against the gate {IRIS_GATE}")
    check(med >= IRIS_GATE, f"iris served accuracy {med:.2f} < {IRIS_GATE}")
    for i, (what, (lo, hi)) in enumerate((("per-draw accuracy", CHEES_DRAW_ACC),
                                          ("mean accept %", CHEES_ACCEPT),
                                          ("swap %", CHEES_SWAP),
                                          ("round trips per ladder",
                                           CHEES_TRIPS))):
        v = statistics.median(r[i] for r in rows)
        check(lo <= v <= hi, f"iris flagship {what} {v:.4f} outside "
              f"[{lo}, {hi}]")
    # --- mala_fused_16x4 -----------------------------------------------------
    cfg = iris_cfg(64, 8000, "precond_mala")
    plan = precond_cls_step.card_mala_plan(DEVICE, 64, 150)
    rows = []
    for seed in (1, 2, 3):
        res, n, n_blocks = run_counted("mala_cls_block", cfg, prob, seed=seed)
        launches.setdefault("mala_cls_block", n)
        wpcs = {w: k for w, k in precond_cls_step.mala_cls_wpcs.items() if k}
        check(wpcs == {plan.wpc: n}, f"mala_cls_block launches by WPC {wpcs}, "
              f"planned {n} at WPC {plan.wpc}")
        acc_s, _thin, _cold, _wrong = served_accuracy(cfg, res, prob)
        draw, accept, trips = iris_stats(cfg, res)
        for name in ("ll", "acc_test", "replica"):
            check(np.isfinite(res.traces[name]).all(),
                  f"mala trace {name} not finite")
        right = round(acc_s * len(prob.test) / 100.0)
        rows.append((right, draw, trips))
        print(f"[4/6] end to end: iris mala_fused_16x4 seed {seed}, 64 chains "
              f"x 8000 samples in {res.elapsed_s:.3f} s: served cold accuracy "
              f"{acc_s:.2f}% ({right} of {len(prob.test)} rows), per-draw "
              f"{draw:.2f}%, mean accept {accept:.2f}%, swap "
              f"{res.swap_percent:.2f}%, round trips {trips:.2f} per ladder "
              f"per 1k steps; kernel launches {n} for {n_blocks} planned "
              f"blocks, all at WPC {plan.wpc}")
    right, draw, trips = (statistics.median(r[i] for r in rows)
                          for i in range(3))
    print(f"[4/6] end to end: iris mala_fused_16x4 medians over seeds 1-3: "
          f"served {right} of {len(prob.test)} rows (gate "
          f"{MALA_SERVED_ROWS}; ptnn seed 1 {PTNN_MALA_SERVED}%), per-draw "
          f"{draw:.2f}% (ptnn seed 1 87.15), round trips {trips:.2f} "
          f"({PTNN_MALA_TRIPS:.2f})")
    check(right >= MALA_SERVED_ROWS, f"iris mala serves a median {right} of "
          f"{len(prob.test)} test rows right, fewer than {MALA_SERVED_ROWS}")
    for what, v, (lo, hi) in (("per-draw accuracy", draw, MALA_DRAW_ACC),
                              ("round trips per ladder", trips, MALA_TRIPS)):
        check(lo <= v <= hi, f"iris mala median {what} {v:.4f} outside "
              f"[{lo}, {hi}]")
    return launches


# ---------------------------------------------------------------------------
# The MALA / HMC kernels' generic route end to end (phase_generic_end_to_end)

# bench.py's _cls_variants at Cancer's (9, 12, 2) and the regression
# mala_fused_16x4 / chees16_fused_16x4 shape at (4, 20, 1): 64 chains x
# 4000 samples (bench's 8000 cut to keep the smoke inside its time); Cancer
# on seeds 1-3 (their medians), Sunspot on seed 0. Each statistic must fall
# inside the mean +- 4 sd of ptnn's PER-STEP sampler on the same
# configuration on the CPU (ptnn holds its fused and per-step paths to one
# distribution, ptnn/fused.py:37-42): ``python
# tests/test_torch_precond_widths.py ARM SEED...`` over seeds 0-19 (MALA)
# and 0-9 (ChEES, about 400 / 190 s a seed on the CPU). Sunspot's ChEES
# takes ptnn's FUSED sampler (``... sunspot20-chees fused 0 ... 9``, about
# 140 s a seed): there ptnn's two paths part, its fused runs spreading 3x
# wider in cold RMSE (sd 1.32e-4 against 4.6e-5) and one (seed 6, 0.012533)
# leaving the per-step band (0.012134-0.012503). (mean, sd) of the cold
# rungs' test accuracy % (Cancer) or RMSE (Sunspot) over the second half,
# mean accept %, swap %, round trips per ladder per 1k steps.
GEN_SAMPLES, GEN_SEEDS = 4000, (1, 2, 3)
GEN_REF = {  # (mean, sd) over ptnn's seeds on the CPU
    "cancer-mala": dict(seeds=20, metric=(98.31007, 0.014896),
                        accept=(55.25375, 0.79296), swap=(69.64785, 0.46106),
                        trips=(25.04688, 0.21225)),
    "cancer-chees": dict(seeds=10, metric=(98.31718, 0.0062796),
                         accept=(70.655, 0.49518), swap=(69.71828, 0.49490),
                         trips=(26.21563, 0.21573)),
    "sunspot20-mala": dict(seeds=20, metric=(0.0298722, 0.00036589),
                           accept=(47.716, 0.48108), swap=(44.81605, 0.50983),
                           trips=(19.66094, 0.079688)),
    "sunspot20-chees": dict(seeds=10, fused=True,
                            metric=(0.0124058, 0.00013158),
                            accept=(55.71418, 0.36387),
                            swap=(45.83089, 0.45879),
                            trips=(20.0875, 0.066373)),
}
GEN_ARMS = (("cancer-mala", "mala_fused_16x4"),
            ("cancer-chees", "chees16_fused_16x4"),
            ("sunspot20-mala", "mala_fused_16x4"),
            ("sunspot20-chees", "chees16_fused_16x4"))
# python -m ptnn_torch.auto Cancer --target speed (auto infers (9, 10, 2)),
# beside the other auto lines (phase_surrogate_auto)
AUTO_CANCER_ARGS = ["--target", "speed", "--chains", "64", "--steps",
                    "4000", "--replicate", "2"]
# ptnn refuses these fused configs (its VMEM gate): they must fall back
# with ptnn's warning and run per step (TicTac's at a short depth: the
# check is the gate's; Ionosphere's runs in phase_per_step_precond's bands)
TICTAC_FALLBACK = (64, 200)


def gen_band(arm, what):
    mean, sd = GEN_REF[arm][what]
    return (mean - 4.0 * sd, mean + 4.0 * sd)


def gen_cfg(arm, chains=64, samples=GEN_SAMPLES):
    """The generic-route arm ``arm`` (GEN_ARMS) of ptnn_torch, fused."""
    where, prop = arm.split("-")
    proposal = "hmc" if prop == "chees" else "precond_mala"
    if where == "cancer":
        return iris_cfg(chains, samples, proposal, topology=CANCER_TOPO)
    return precond_cfg(chains, samples, proposal, topology=(4, 20, 1),
                       track_replicas=True)


def run_fused_counted(kern, cfg, prob, seed):
    """One fused run through ptnn_torch.sample with every launch count set
    to 0 just before it. The plan: ``kern`` one launch a block, every one
    by the generic route; fnn_eval init_state's and the temper switch's;
    every other kernel 0; no fallback warning."""
    import warnings

    import numpy as np

    import ptnn_torch
    from ptnn_torch import fused
    from ptnn_torch.ops import precond_cls_step, precond_step

    n_blocks = sum(len(seg) for seg in fused.block_plan(cfg))
    n = cfg.n_steps
    reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                                device=DEVICE)
    fell = [str(w.message) for w in caught if "falling back" in
            str(w.message)]
    check(not fell, f"{cfg.topology} {cfg.proposal} fell back: {fell}")
    got = {k: launch_count(k) for k in KERNELS}
    want = dict({k: 0 for k in KERNELS}, **{
        kern: n_blocks, "fnn_eval": 1 + int(0 < cfg.temper_switch_step < n)})
    check(got == want, f"{kern} run launches {got}, planned {want}")
    mod = precond_cls_step if cfg.task == "classification" else precond_step
    check(mod.variant_launches[kern] == {"fixed": 0, "generic": n_blocks},
          f"{kern} launches by variant {mod.variant_launches[kern]}")
    for k in ("ll", "rmse_test", "acc_test", "accept_count", "replica"):
        check(np.isfinite(res.traces[k]).all(), f"trace {k} not finite")
    return res, n_blocks


def phase_generic_end_to_end():
    """The MALA and HMC kernels' generic route on the fused sampler: bench's
    Cancer mala_fused_16x4 and chees16_fused_16x4 (seeds 1-3) and Sunspot's
    at (4, 20, 1) (seed 0), each against ptnn's bands with its launches
    the plan; TicTac's (9, 25, 2) MALA falling back with ptnn's warning
    (python -m ptnn_torch.auto Cancer runs beside the other auto lines,
    phase_surrogate_auto). Returns the generic launches of each kernel."""
    import numpy as np

    from ptnn_torch import data

    launches = {}
    probs = {"cancer": data.load_classification("Cancer"),
             "sunspot20": sunspot()}
    for arm, variant in GEN_ARMS:
        where = arm.split("-")[0]
        cfg, prob = gen_cfg(arm), probs[where]
        cls = cfg.task == "classification"
        kern = ("hmc" if cfg.proposal == "hmc" else "mala") + (
            "_cls_block" if cls else "_block")
        rows = []
        for seed in (GEN_SEEDS if cls else (0,)):
            res, n_blocks = run_fused_counted(kern, cfg, prob, seed)
            launches[kern] = launches.get(kern, 0) + n_blocks
            if cls:
                metric, accept, trips = iris_stats(cfg, res)
            else:
                metric, accept, trips = cold_stats(res, cfg)
            rows.append((metric, accept, res.swap_percent, trips))
            line = (f"[4/6] generic: {where} {tuple(cfg.topology)} {variant} "
                    f"seed {seed}, {cfg.num_chains} chains x "
                    f"{cfg.samples_per_chain} samples in {res.elapsed_s:.3f} s "
                    f"({res.chain_steps_per_sec:.0f} chain-steps/s incl. "
                    f"trace fetch): cold test "
                    f"{'accuracy' if cls else 'RMSE'} {metric:.5f}, mean "
                    f"accept {accept:.2f}%, swap {res.swap_percent:.2f}%, "
                    f"round trips {trips:.2f} per ladder per 1k steps")
            if cfg.proposal == "hmc":
                tl = res.traces["traj_len"][1:]
                line += f", traj_len {tl.min():.0f}-{tl.max():.0f}"
                check(tl.min() >= 1 and tl.max() <= 16
                      and len(np.unique(tl)) > 1,
                      f"{arm} traj_len stays in [1, 16] and varies")
            print(line + f"; {kern} launches {n_blocks} (the plan, all by "
                  f"the generic route), fnn_eval init's and the switch's")
        med = [statistics.median(r[i] for r in rows) for i in range(4)]
        text = []
        for what, v in zip(("metric", "accept", "swap", "trips"), med):
            lo, hi = gen_band(arm, what)
            text.append(f"{what} {v:.5f} (band {lo:.5f}-{hi:.5f})")
            check(lo <= v <= hi, f"{arm} {what} {v:.5f} outside ptnn's band "
                  f"[{lo:.5f}, {hi:.5f}]")
        print(f"[4/6] generic: {arm} {variant} "
              f"{'medians over seeds 1-3' if cls else 'seed 0'}: "
              + ", ".join(text) + f" (ptnn "
              f"{'fused' if GEN_REF[arm].get('fused') else 'per step'}, "
              f"{GEN_REF[arm]['seeds']} seeds)")
    # --- TicTac (9, 25, 2): ptnn refuses it; it falls back and runs --------
    prob = data.load_classification("TicTac")
    c, samples = TICTAC_FALLBACK
    cfg = dataclasses.replace(iris_cfg(c, samples, "precond_mala"),
                              topology=(9, 25, 2)).validate()
    res, plan, fell = run_precond_counted(cfg, prob, fallback=True)
    acc, accept, _trips = iris_stats(cfg, res)
    print(f"[4/6] generic: TicTac (9, 25, 2) mala_fused_16x4 {c} chains x "
          f"{samples} samples falls back (\"{fell[0]}\") and runs per step "
          f"in {res.elapsed_s:.3f} s: cold test accuracy {acc:.2f}%, mean "
          f"accept {accept:.2f}%; fnn_eval launches {plan} (as planned)")
    return launches


def check_auto_cancer(stdout, out):
    """python -m ptnn_torch.auto Cancer --target speed (AUTO_CANCER_ARGS):
    fused by the generic route with no fallback warning, its launches the
    plan, its cold accuracy in the Cancer MALA band. Returns its
    launches."""
    fig = parse_auto(stdout)
    run_dir = out / "Cancer_0"
    seeds = int(AUTO_CANCER_ARGS[AUTO_CANCER_ARGS.index("--replicate") + 1])
    cfg, plan, got = auto_plan(run_dir, fig["launches"], seeds)
    check(got == plan, f"auto Cancer: launches {got}, planned {plan}")
    check(fig["fused"] and cfg.fused_step, f"auto Cancer did not fuse: "
          f"{fig['execution']}")
    check("falling back" not in stdout, "auto Cancer fell back")
    lo, hi = gen_band("cancer-mala", "metric")
    print(f"[4/6] auto: python -m ptnn_torch.auto Cancer "
          f"{' '.join(AUTO_CANCER_ARGS)}: {fig['wall']:.1f} s; "
          f"{tuple(cfg.topology)} by the generic route, {fig['ladders']} x "
          f"{fig['rungs']} = {fig['chains']} chains, {fig['proposal']}, "
          f"execution: {fig['execution']}; cold test acc % {fig['metric']} "
          f"+- {fig['metric_sd']} (band {lo:.3f}-{hi:.3f}); R-hat "
          f"{fig['rhat']:.3f} ({fig['verdict']}); launches {got} (as "
          f"planned)")
    check(lo <= fig["metric"] <= hi, f"auto Cancer cold accuracy "
          f"{fig['metric']} outside [{lo:.3f}, {hi:.3f}]")
    return got


def phase_cls_rw_end_to_end():
    """The Cancer, TicTac and Ionosphere RW presets at full width and data,
    each run on seeds 0-4 and held to its launch plan and, on the medians
    over those seeds, to its bands (the statistic of ptnn's records: the
    test accuracy over every chain from row samples * burn_in - 1 on; mean
    accept %; swap %)."""
    import numpy as np

    from ptnn_torch.models import fnn

    def run(name, seed):
        topo, rows = CLS_RW_SETS[name]
        prob = cls_set(name)
        cfg = rw_preset_cfg(name, record_w=True)
        res, n, n_blocks = run_counted("rw_cls_block", cfg, prob, seed=seed)
        taken = rw_cls_taken({}, {}, topo, cfg.num_chains, rows, n)
        tr = res.traces
        s, c = cfg.samples_per_chain, cfg.num_chains
        for t in ("ll", "acc_train", "acc_test", "rmse_test", "accept_count"):
            check(tr[t].shape == (s, c), f"{name} trace {t} shape "
                  f"{tr[t].shape}")
            check(np.isfinite(tr[t]).all(), f"{name} trace {t} not finite")
        check(tr["w"].shape == (s, c, fnn.w_size(topo)),
              f"{name} trace w shape {tr['w'].shape}")
        first = int(s * cfg.burn_in) - 1
        stats = (float(np.mean(tr["acc_test"][first:, :])),
                 float(np.mean(res.accept_ratio_per_chain)),
                 float(res.swap_percent))
        print(f"[4/6] end to end: {name} RW preset {topo} seed {seed}, {c} "
              f"chains x {s} samples in {res.elapsed_s:.3f} s: test accuracy "
              f"mean {stats[0]:.2f}%, mean accept {stats[1]:.2f}%, swap "
              f"{stats[2]:.2f}% (bands {CLS_RW_BANDS[name]}); kernel launches "
              f"{n} for {n_blocks} planned blocks, all by {taken}")
        return stats

    for name in ("Cancer", "TicTac", "Ionosphere"):
        runs = [run(name, seed) for seed in CLS_RW_SEEDS]
        stats = tuple(statistics.median(r[i] for r in runs) for i in range(3))
        print(f"[4/6] end to end: {name} RW preset, medians over seeds "
              f"{CLS_RW_SEEDS[0]}-{CLS_RW_SEEDS[-1]}: "
              f"{', '.join(f'{v:.2f}' for v in stats)}")
        for what, v, (lo, hi) in zip(("test accuracy mean", "mean accept %",
                                      "swap %"), stats, CLS_RW_BANDS[name]):
            check(lo <= v <= hi, f"{name} RW {what} median {v:.4f} outside "
                  f"[{lo}, {hi}]")


def cls_set(name):
    from ptnn_torch import data

    return data.load_classification(name)


def time_cls_block(kind, cfg, k, phases, record_w, name="iris", graph=False,
                   calls=100):
    """Times of one block of a classification kernel on the rows of the
    bundled set ``name`` (from the host loop) and its plain version, and
    the block's bound; for the MALA and RW kernels, whose calls the host
    may issue more slowly than the card runs them, and with ``graph``, also
    the device time (``graph_ms``, a CUDA graph of ``calls`` calls)."""
    state, noise, kdata, at, scal = cls_inputs(cfg, k, 20, phases, name=name)
    topo = tuple(cfg.topology)
    args = (kind, state, noise, 20, k, kdata, at, scal)
    kern = lambda: cls_call(*args, plain=False, record_w=record_w, topo=topo)
    plain = lambda: cls_call(*args, plain=True, record_w=record_w, topo=topo)
    k_ms, p_ms = timing(kern, plain, 10, 2)
    new, tr = kern()
    evals = float(tr["traj_len"].sum()) if kind == "hmc" else None
    ops = block_ops(kind, topo, cfg.num_chains, k, kdata["n_tr"],
                    kdata["n_te"], evals)
    b_ms, b_by = bound(ops, tensor_bytes(state, noise, kdata["rows"], at,
                                         new, tr))
    out = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    if kind in ("mala", "rw") or graph:
        out["graph_ms"] = min(graph_ms(kern, calls), graph_ms(kern, calls))
    return out


def phase_cls_throughput():
    import ptnn_torch
    from ptnn_torch.ops import precond_cls_step

    prob = iris()
    adapting = dict(warm_end=0, pc_start=0, burn_end=1000)
    for tag, cfg in (("chees16_fused_16x4", iris_cfg(64, 2000, "hmc")),
                     ("chees16_fused_64x4", iris_cfg(256, 2000, "hmc"))):
        runner = ptnn_torch.throughput_runner(cfg, prob.train, prob.test,
                                              device=DEVICE)
        reps = [runner() for _ in range(3)]
        rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
        print(f"[5/6] throughput: iris {tag} {cfg.num_chains} chains x 2000 "
              f"samples: median {rate:.0f} chain-steps/s over 3 reps (accept "
              f"{reps[0]['accept_pct']:.1f}%, swap {reps[0]['swap_pct']:.1f}%)")
    out = {
        "rw_cls_block": time_cls_block("rw", rw_preset_cfg(), 100,
                                       dict(adapt=False), True),
        "mala_cls_block": time_cls_block(
            "mala", iris_cfg(64, 2000, "precond_mala"), 10, adapting, False),
        "hmc_cls_block": time_cls_block("hmc", iris_cfg(64, 2000, "hmc"), 10,
                                        adapting, False),
    }
    for name, t in out.items():
        dev = (f" a call from the host loop, {t['graph_ms']:.4f} ms of device "
               f"time (a CUDA graph of 100 calls)" if "graph_ms" in t else "")
        print(f"[5/6] throughput: {name}, one block at its path's widths: "
              f"kernel {t['ms']:.4f} ms{dev}, plain version "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    from ptnn_torch.ops import block_step

    for name, c in (("iris", 1024), ("Cancer", 10), ("Cancer", 1024),
                    ("TicTac", 10), ("TicTac", 1024), ("Ionosphere", 10),
                    ("Ionosphere", 1024)):
        topo, rows = CLS_RW_SETS[name]
        plan = block_step.card_rw_cls_plan(DEVICE, c, rows)
        # at 1024 chains a block takes 0.7-11 ms, far past the host's
        # issue time: a graph of 20 calls is enough
        calls = 20 if c > 10 else 100
        t = time_cls_block("rw", rw_preset_cfg(name, 2000, c), 100,
                           dict(adapt=False), False, name=name, calls=calls)
        print(f"[5/6] throughput: rw_cls_block {name} {topo} at {c} chains "
              f"({plan.warps} warps a chain), K 100, no w trace: kernel "
              f"{t['graph_ms']:.4f} ms of device time (a CUDA graph of "
              f"{calls} calls), {t['ms']:.4f} ms a call from the host loop, plain "
              f"version {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    t = time_cls_block("hmc", iris_cfg(256, 2000, "hmc"), 10, adapting, False)
    print(f"[5/6] throughput: hmc_cls_block at 256 chains (chees16_fused_64x4"
          f"'s widths): kernel {t['ms']:.3f} ms, plain version "
          f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']})")
    for c in (256, 1024):
        plan = precond_cls_step.card_mala_plan(DEVICE, c, 150)
        t = time_cls_block("mala", iris_cfg(c, 2000, "precond_mala"), 10,
                           adapting, False)
        print(f"[5/6] throughput: mala_cls_block at {c} chains (WPC "
              f"{plan.wpc}, {plan.blocks} blocks): kernel {t['graph_ms']:.4f} "
              f"ms of device time (a CUDA graph of 100 calls), {t['ms']:.4f} "
              f"ms a call from the host loop, plain version "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    return out


def phase_generic_throughput():
    """One adapting 10-step block of each kernel's generic route at the
    fused paths' widths (64 chains: Sunspot (4, 20, 1), Cancer (9, 12, 2),
    HMC under ChEES): its time from the host loop and its device time (a
    CUDA graph of 100 calls), its plain version's, its bound. Returns the
    kernels line's ``generic_*`` fields."""
    adapting = dict(warm_end=0, pc_start=0, burn_end=1000)
    shapes = {"mala_block": ("Sunspot", gen_cfg("sunspot20-mala")),
              "hmc_block": ("Sunspot", gen_cfg("sunspot20-chees")),
              "mala_cls_block": ("Cancer", gen_cfg("cancer-mala")),
              "hmc_cls_block": ("Cancer", gen_cfg("cancer-chees"))}
    out = {}
    for name, (set_name, cfg) in shapes.items():
        if name.endswith("_cls_block"):
            t = time_cls_block("hmc" if cfg.proposal == "hmc" else "mala",
                               cfg, 10, adapting, False, name=set_name,
                               graph=True)
        else:
            t = time_precond_block(cfg, adapting, graph=True)
        out[name] = {f"generic_{k}": v for k, v in t.items()}
        out[name]["generic_shape"] = (f"{set_name} {tuple(cfg.topology)}, "
                                      f"{cfg.num_chains} chains, K 10")
        print(f"[5/6] throughput: {name} generic route, {set_name} "
              f"{tuple(cfg.topology)} {cfg.proposal}"
              f"{' ChEES' if cfg.hmc_adapt_traj else ''} at "
              f"{cfg.num_chains} chains, one adapting 10-step block: kernel "
              f"{t['graph_ms']:.4f} ms of device time (a CUDA graph of 100 "
              f"calls), {t['ms']:.4f} ms a call from the host loop, plain "
              f"version {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# The per-step sampler: the Langevin drift epoch and the FNN eval kernels.

# lg_pallas (bench.py's _variants(64, 5000, full=True)["lg_pallas"]): ptnn's
# per-step sampler on the CPU, seeds 0-4 (python tests/test_torch_step.py lg
# 0 1 2 3 4): cold-rung test RMSE over the second half 0.0217-0.0251, cold
# accept 9.9-10.9 %, mean accept 18.1-19.0 %, swap 82.7-86.0 %, Langevin
# 49.8-50.2 % (BENCH_r02.json: RMSE 0.0224, accept 18.3 %, swap 84.6 %)
LG_RMSE = (0.01, 0.04)
LG_COLD_ACCEPT = (3.0, 20.0)
LG_MEAN_ACCEPT = (14.0, 24.0)
LG_SWAP = (75.0, 92.0)
LANGEVIN = (48.0, 52.0)
# Ionosphere legacy LG (classification_preset((34, 50, 2), 50_000,
# legacy_lg=True), 10 x 5000): ptnn's 5-seed band 92.64 +- 0.92 test mean,
# accept 95.6 %, swap 55.6 % (PARITY.md:116); ptnn's per-step sampler on the
# CPU, seeds 0-4 (python tests/test_torch_step.py iono 0 1 2 3 4): test mean
# 91.87-93.72, mean accept 95.38-95.59 %, swap 53.3-63.3 %, Langevin
# 49.7-50.4 %. The test-mean band is +-2 sigma of the 5-seed band.
IONO_TEST_MEAN = (90.80, 94.48)
IONO_ACCEPT = (94.5, 96.5)
IONO_SWAP = (50.0, 66.0)
# the drift epoch: hundreds to thousands of dependent row updates summed in
# another order, so w is held on the scale of each chain's vector
D_RTOL, D_ATOL = 1e-3, 1e-4


def lg_cfg(chains, samples, **kw):
    """bench.py's lg_pallas: the rw config with Langevin gradients
    (langevin_prob 0.5, learn_rate 0.01, the reference q-ratio) and
    drift_mode "pallas", per-step."""
    return rw_fused_cfg(chains, samples, use_langevin_gradients=True,
                        drift_mode="pallas", fused_step=False, **kw)


def iono_cfg():
    """The reference's PT_EvalSwapLG Ionosphere row as
    scripts/cls_bands.py:54-66 builds it, with drift_mode "pallas"."""
    from ptnn_torch import classification_preset

    cfg = classification_preset((34, 50, 2), num_samples=50_000,
                                legacy_lg=True)
    return dataclasses.replace(cfg, record_w=False,
                               drift_mode="pallas").validate()


def drift_cases():
    """(label, topology, task, chains, x, t, depth, main) of the drift
    kernel's comparisons. At the main path's widths (``main``): Sunspot 64
    chains on its train rows (depth 1 and 2), Ionosphere 10 on its 245,
    PenDigit 10 on all 7494 train rows. Then every distinct topology of the
    bundled datasets (data.py), each at 10 chains on 64 random rows, and one
    topology outside the register kernel's table, which the generic kernel
    runs. Last, the VR paths' Langevin widths on Sunspot's train rows: 10
    chains (the command line) and 1 (the single chain)."""
    import numpy as np
    import torch

    from ptnn_torch import data
    from ptnn_torch.ops import drift

    f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=DEVICE).contiguous()
    out = []
    for label, prob, c, depth in (
            ("Sunspot", sunspot(), 64, 1), ("Sunspot", sunspot(), 64, 2),
            ("Ionosphere", data.load_classification("Ionosphere"), 10, 1),
            ("PenDigit", data.load_classification("PenDigit"), 10, 1)):
        topo = prob.topology if prob.task == "classification" else (4, 10, 1)
        i = topo[0]
        x, y = f(prob.train[:, :i]), f(prob.train[:, i])
        t = drift.make_targets(y, topo[2], prob.task).contiguous()
        out.append((label, topo, prob.task, c, x, t, depth, True))
    rng = np.random.default_rng(41)
    topos = sorted(set(data.CLASSIFICATION_TOPOLOGIES.values())
                   | {data.REGRESSION_TOPOLOGY}) + [(5, 20, 3)]
    for topo in topos:
        task = "regression" if topo[2] == 1 else "classification"
        x = f(rng.normal(size=(64, topo[0])))
        y = (f(rng.uniform(size=64)) if task == "regression"
             else f(rng.integers(0, topo[2], size=64)))
        t = drift.make_targets(y, topo[2], task).contiguous()
        out.append((f"random {drift.variant(topo)[0]}", topo, task, 10, x, t,
                    1, False))
    sun = out[0]
    for c in (10, 1):  # the VR paths' Langevin widths
        out.append(("Sunspot", *sun[1:3], c, *sun[4:7], False))
    return out


def drift_ops(topo, c, n, depth):
    """Arithmetic of ``depth`` epochs over ``n`` rows: per row the forward
    (2IH + 2HO multiply-adds, H + O sigmoids), the deltas (2HO + 3H + 4O)
    and the updates (3IH + 3HO + 2H + 2O)."""
    i, h, o = topo
    per_row = (5 * i * h + 7 * h * o + h * (SIGMOID_OPS + 6)
               + o * (SIGMOID_OPS + 7))
    return c * n * depth * per_row


def phase_drift_kernel():
    """The drift kernel against its plain version on the same CUDA tensors;
    returns the largest |diff|."""
    import numpy as np
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import drift

    rng = np.random.default_rng(23)
    err = 0.0
    for label, topo, _task, c, x, t, depth, _main in drift_cases():
        # on random rows, weights of half the scale keep the sigmoids of the
        # wider nets out of saturation, so the epoch moves w
        w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo)))
                            * (0.5 if label.startswith("random") else 1.0),
                            dtype=torch.float32, device=DEVICE)
        kind, group = drift.variant(topo)
        before = drift.launches, dict(drift.variant_launches)
        got = drift.sgd_epoch(w, x, t, topo, 0.01, mode="pallas", depth=depth)
        check(drift.launches == before[0] + 1
              and drift.variant_launches[kind] == before[1][kind] + 1,
              f"drift_epoch {topo}: the {kind} kernel did not launch")
        want = drift.sgd_epoch_sequential(w, x, t, topo, 0.01, depth)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"drift {label}: not finite")
        scale = want.abs().amax(dim=-1, keepdim=True)
        diff = (got - want).abs()
        bad = int((diff > D_ATOL + D_RTOL * scale).sum())
        rel = float((diff / scale).max())
        check(bad == 0, f"drift {label} {topo} depth {depth}: {bad} entries "
              f"off, max |diff| {float(diff.max()):.3g}")
        moved = float((want - w).abs().max())
        check(moved > 1e-3, f"drift {label}: the epoch did not move w")
        err = max(err, float(diff.max()))
        how = f"register kernel, G={group}" if kind == "register" else kind
        print(f"[3/6] kernel: drift_epoch {label} {topo} ({how}) C={c} "
              f"N={x.shape[0]} depth {depth}: w within rtol {D_RTOL} of each "
              f"chain's scale, atol {D_ATOL} (max |diff| "
              f"{float(diff.max()):.3g}, {rel:.3g} of the chain's scale; the "
              f"epoch moved w by up to {moved:.3g})")
    return err


# the networks the evidence model selection gives the eval kernel (phase 4),
# which FNN_LAYOUTS lacks: they take the generic instantiation
EVAL_GENERIC = ((4, 2, 1), (4, 6, 1))


def eval_cases():
    """(label, topology, task, chains, (x_tr, y_tr), (x_te, y_te)) at the
    per-step paths' widths, train and test rows: Sunspot 64 chains,
    Ionosphere 10 and 64 (the fused MALA config's fallback) and PenDigit 10
    (the drift's third width); and the VR paths': Sunspot 10 (the command
    lines) and 1 (the single chain), the model selection's (4, 2, 1) and
    (4, 6, 1) networks at 16 chains, and iris 10 (its --vref run); and the
    grid families' (phase_grid_families): Sunspot 160 chains (the sgld
    grid's 20 cells x 8: the pair at an exact swap event, the test rows at
    a corrected one, the train rows at an anchor refresh) and 640 (10 cells
    x 64: the test rows of a MALA or ChEES grid's step)."""
    import torch

    from ptnn_torch import data

    iono = data.load_classification("Ionosphere")
    out = []
    for label, prob, c, hidden in (
            ("Sunspot", sunspot(), 64, 10),
            ("Ionosphere", iono, 10, None),
            ("Ionosphere", iono, 64, None),
            ("PenDigit", data.load_classification("PenDigit"), 10, None),
            ("Sunspot", sunspot(), 10, 10),
            ("Sunspot", sunspot(), 1, 10),
            ("Sunspot", sunspot(), 16, 2),
            ("Sunspot", sunspot(), 16, 6),
            ("iris", iris(), 10, None),
            ("Sunspot", sunspot(), 160, 10),
            ("Sunspot", sunspot(), 640, 10)):
        topo = prob.topology if hidden is None else (4, hidden, 1)
        i = topo[0]
        f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                      device=DEVICE).contiguous()
        out.append((label, topo, prob.task, c,
                    (f(prob.train[:, :i]), f(prob.train[:, i])),
                    (f(prob.test[:, :i]), f(prob.test[:, i]))))
    return out


def eval_calls(label, topo, task, train, test):
    """The eval's calls of one case: (what, kernel call, plain call), each
    returning a tuple of (ll, rmse, acc) per row set: the train rows, the
    test rows, and both in one launch (the pair)."""
    from ptnn_torch.ops import fnn_eval

    def one(rows):
        return (lambda w, tau: (fnn_eval.fnn_eval(w, *rows, tau, topo, task),),
                lambda w, tau: (fnn_eval.fnn_eval_reference(w, *rows, tau,
                                                            topo, task),))

    pair = (lambda w, tau: fnn_eval.fnn_eval_pair(w, *train, *test, tau, topo,
                                                  task),
            lambda w, tau: fnn_eval.fnn_eval_pair_reference(
                w, *train, *test, tau, topo, task))
    return [(f"{label} train", *one(train), (train,)),
            (f"{label} test", *one(test), (test,)),
            (f"{label} pair", *pair, (train, test))]


def phase_eval_kernel():
    """The eval kernel against its plain version, one launch a call (the
    pair too): ll on the size of its cancelling terms, regression rmse
    within RTOL, classification acc and rmse exact where no row's argmax
    is fragile."""
    import math

    import numpy as np
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import _build, block_step, fnn_eval

    gen_hpw = _build.cu_define("fnn_eval.cu", "GEN_HPW")
    rng = np.random.default_rng(29)
    err = 0.0
    for label, topo, task, c, train, test in eval_cases():
        w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo))),
                            dtype=torch.float32, device=DEVICE)
        tau = torch.as_tensor(rng.uniform(0.01, 0.2, size=c),
                              dtype=torch.float32, device=DEVICE)
        generic = topo not in fnn_eval.layouts()
        check(generic == (topo in EVAL_GENERIC), f"fnn_eval {label} {topo}: "
              f"generic instantiation {generic}, expected the opposite")
        for what, kern, plain, sets in eval_calls(label, topo, task, train,
                                                  test):
            plan = fnn_eval.launch_plan(c, [x.shape[0] for x, _y in sets],
                                        topo)
            check(not generic or plan.hid_per_warp == gen_hpw,
                  f"fnn_eval {what} {topo}: {plan.hid_per_warp} hidden units "
                  f"a warp, the generic plan takes {gen_hpw}")
            before = fnn_eval.launches
            got = kern(w, tau)
            check(fnn_eval.launches == before + 1,
                  f"fnn_eval {what}: {fnn_eval.launches - before} launches")
            want = plain(w, tau)
            torch.cuda.synchronize()
            n_fragile, worst = 0, 0.0
            for (ll, rmse, acc), (r_ll, r_rmse, r_acc), (x, _y) in zip(
                    got, want, sets):
                n = x.shape[0]
                if task == "regression":
                    terms = (0.5 * n * torch.log(2 * math.pi * tau).abs()
                             + 0.5 * n * r_rmse ** 2 / tau)
                    check(bool(((rmse - r_rmse).abs()
                                <= ATOL + RTOL * r_rmse).all()),
                          f"{what}: rmse")
                    check(not bool(acc.any()), f"{what}: acc not 0")
                else:
                    terms = r_ll.abs()
                    sure = ~block_step.argmax_fragile(w, x, topo)
                    n_fragile += int((~sure).sum())
                    check(int((~sure).sum()) <= max(1, 0.1 * c),
                          f"{what}: {int((~sure).sum())} chains with fragile "
                          f"argmaxes")
                    check(torch.equal(acc[sure], r_acc[sure])
                          and torch.equal(rmse[sure], r_rmse[sure]),
                          f"{what}: acc or rmse differs")
                diff = (ll - r_ll).abs()
                check(bool((diff <= ATOL + RTOL * terms).all()),
                      f"{what}: ll off, max |diff| {float(diff.max()):.3g}")
                worst = max(worst, float(diff.max()))
            err = max(err, worst)
            metrics = (f"rmse within rtol {RTOL}" if task == "regression" else
                       f"acc and rmse exact outside {n_fragile} chains with "
                       f"fragile argmaxes")
            rows = " + ".join(str(x.shape[0]) for x, _y in sets)
            inst = "generic" if generic else "fixed-shape"
            print(f"[3/6] kernel: fnn_eval {what} {topo} C={c} N={rows}, one "
                  f"launch of the {inst} instantiation ({plan.cluster}-block "
                  f"clusters, {plan.row_groups} x {plan.hid_groups} warps of "
                  f"{plan.hid_per_warp} hidden units): ll within rtol {RTOL} of its terms (max |diff| "
                  f"{worst:.3g}), {metrics}")
    return err


def run_per_step_counted(cfg, prob, seed=0):
    """One per-step run through ptnn_torch.sample with every launch count
    set to 0 just before it; checks the plan: 2 drift launches a step with
    Langevin gradients (0 without), and 1 eval a step (the train and the
    test rows in one launch) plus init_state's and the temper switch's
    recompute."""
    import ptnn_torch

    n = cfg.n_steps
    plan_drift = 2 * n if cfg.use_langevin_gradients else 0
    plan_eval = n + 1 + int(0 < cfg.temper_switch_step < n)
    reset_launch_counts()
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                            device=DEVICE)
    got = {name: launch_count(name) for name in KERNELS}
    want = {name: 0 for name in KERNELS}
    want.update(drift_epoch=plan_drift, fnn_eval=plan_eval)
    check(got == want, f"per-step launches {got}, planned {want}")
    from ptnn_torch.ops import drift

    kind = drift.variant(cfg.topology)[0] if plan_drift else None
    check(not plan_drift or drift.variant_launches[kind] == plan_drift,
          f"drift launches by kernel {drift.variant_launches}, planned "
          f"{plan_drift} of the {kind} kernel")
    return res, got


def per_step_stats(cfg, res):
    import numpy as np

    s = cfg.samples_per_chain
    return dict(
        cold_rmse=float(np.mean(res.traces["rmse_test"][s // 2:, 0])),
        cold_accept=float(res.accept_ratio_per_chain[0]),
        mean_accept=float(np.mean(res.accept_ratio_per_chain)),
        swap=float(res.swap_percent),
        langevin=float(np.mean(res.langevin_ratio_per_chain)))


def phase_per_step_end_to_end():
    """Configurations 1-3 through ptnn_torch.sample, per-step, on the card;
    returns the launches of lg_pallas."""
    import numpy as np

    from ptnn_torch import data

    prob = sunspot()
    out = {}
    for tag, cfg, bands in (
            ("lg_pallas", lg_cfg(64, 5000),
             (("cold_rmse", LG_RMSE), ("cold_accept", LG_COLD_ACCEPT),
              ("mean_accept", LG_MEAN_ACCEPT), ("swap", LG_SWAP),
              ("langevin", LANGEVIN))),
            ("rw per-step", rw_fused_cfg(64, 5000, fused_step=False),
             (("cold_rmse", COLD_RMSE), ("cold_accept", COLD_ACCEPT),
              ("mean_accept", MEAN_ACCEPT), ("swap", SWAP)))):
        res, got = run_per_step_counted(cfg, prob)
        for name in ("ll", "rmse_train", "rmse_test", "accept_count"):
            check(res.traces[name].shape == (cfg.samples_per_chain,
                                             cfg.num_chains)
                  and np.isfinite(res.traces[name]).all(),
                  f"{tag}: trace {name}")
        st = per_step_stats(cfg, res)
        print(f"[4/6] end to end: Sunspot {tag} {cfg.num_chains} chains x "
              f"{cfg.samples_per_chain} samples in {res.elapsed_s:.3f} s "
              f"({res.chain_steps_per_sec:.0f} chain-steps/s incl. trace "
              f"fetch); cold test RMSE {st['cold_rmse']:.5f}, cold accept "
              f"{st['cold_accept']:.2f}%, mean accept {st['mean_accept']:.2f}%,"
              f" swap {st['swap']:.2f}%, Langevin {st['langevin']:.2f}%; "
              f"launches drift_epoch {got['drift_epoch']} (register kernel), "
              f"fnn_eval {got['fnn_eval']} (as planned)")
        for what, (lo, hi) in bands:
            check(lo <= st[what] <= hi, f"{tag} {what} {st[what]:.4f} outside "
                  f"[{lo}, {hi}]")
        if tag == "lg_pallas":
            out = dict(got)
    # --- Ionosphere legacy LG ----------------------------------------------
    prob = data.load_classification("Ionosphere")
    cfg = iono_cfg()
    res, got = run_per_step_counted(cfg, prob)
    tr = res.traces
    for name in ("ll", "acc_test", "rmse_test", "accept_count"):
        check(tr[name].shape == (cfg.samples_per_chain, cfg.num_chains)
              and np.isfinite(tr[name]).all(), f"Ionosphere trace {name}")
    cold = int(cfg.samples_per_chain * cfg.burn_in) - 1
    st = per_step_stats(cfg, res)
    st["test_mean"] = float(np.mean(tr["acc_test"][cold:, :]))
    print(f"[4/6] end to end: Ionosphere legacy LG {cfg.num_chains} chains x "
          f"{cfg.samples_per_chain} samples in {res.elapsed_s:.3f} s "
          f"({res.chain_steps_per_sec:.0f} chain-steps/s incl. trace fetch); "
          f"test-accuracy mean {st['test_mean']:.2f}% (ptnn 92.64 +- 0.92), "
          f"mean accept {st['mean_accept']:.2f}% (95.6), swap "
          f"{st['swap']:.2f}% (55.6), Langevin {st['langevin']:.2f}%; "
          f"launches drift_epoch {got['drift_epoch']} (register kernel), "
          f"fnn_eval {got['fnn_eval']} (as planned)")
    for what, (lo, hi) in (("test_mean", IONO_TEST_MEAN),
                           ("mean_accept", IONO_ACCEPT), ("swap", IONO_SWAP),
                           ("langevin", LANGEVIN)):
        check(lo <= st[what] <= hi, f"Ionosphere {what} {st[what]:.4f} "
              f"outside [{lo}, {hi}]")
    return out


def phase_per_step_throughput():
    """lg_pallas chain-steps/s (throughput_runner, LG_THR_SAMPLES), and one
    epoch and one eval at each width against the plain versions; returns
    the kernels' line entries at the main path's widths (Sunspot, 64
    chains: one epoch, and the eval of the train rows, as before the pair
    existed, with the pair the step launches under ``pair_*`` keys)."""
    import numpy as np
    import torch

    import ptnn_torch
    from ptnn_torch.models import fnn
    from ptnn_torch.ops import drift

    prob = sunspot()
    runner = ptnn_torch.throughput_runner(lg_cfg(64, LG_THR_SAMPLES),
                                          prob.train, prob.test,
                                          device=DEVICE)
    reps = [runner() for _ in range(3)]
    rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
    print(f"[5/6] throughput: lg_pallas 64 chains x {LG_THR_SAMPLES} samples: median "
          f"{rate:.0f} chain-steps/s over 3 reps (accept "
          f"{reps[0]['accept_pct']:.1f}%, swap {reps[0]['swap_pct']:.1f}%, "
          f"Langevin {reps[0]['langevin_pct']:.1f}%)")
    rng = np.random.default_rng(31)
    out = {}
    for label, topo, _task, c, x, t, depth, main in drift_cases():
        if not main:
            continue
        w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo))),
                            dtype=torch.float32, device=DEVICE)
        kern = lambda: drift.sgd_epoch(w, x, t, topo, 0.01, depth=depth)
        plain = lambda: drift.sgd_epoch_sequential(w, x, t, topo, 0.01, depth)
        big = x.shape[0] > 1000
        k_ms, p_ms = timing(kern, plain, 3 if big else 20, 1 if big else 2,
                            warm=1)
        n = x.shape[0]
        b_ms, b_by = bound(drift_ops(topo, c, n, depth),
                           4 * (2 * w.numel() + x.numel() + t.numel()))
        print(f"[5/6] throughput: drift_epoch {label} {topo} (G="
              f"{drift.variant(topo)[1]}) C={c} N={n} depth {depth}: kernel "
              f"{k_ms:.4f} ms ({1e3 * k_ms / (n * depth):.3f} us a row), "
              f"plain version {p_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
        if label == "Sunspot" and depth == 1:
            out["drift_epoch"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                      bound_by=b_by)
    for label, topo, task, c, train, test in eval_cases():
        w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo))),
                            dtype=torch.float32, device=DEVICE)
        tau = torch.full((c,), 0.05, dtype=torch.float32, device=DEVICE)
        for what, kern, plain, sets in eval_calls(label, topo, task, train,
                                                  test):
            k_call = lambda: kern(w, tau)
            p_call = lambda: plain(w, tau)
            issue_ms, p_ms = timing(k_call, p_call, 50, 10)
            dev_ms = min(graph_ms(k_call), graph_ms(k_call))
            rows = sum(x.shape[0] for x, _y in sets)
            b_ms, b_by = bound(
                c * rows * row_ops(topo, task != "regression", False),
                4 * (w.numel() + sum(x.numel() + y.numel() for x, y in sets)
                     + (1 + 3 * len(sets)) * c))
            n_txt = " + ".join(str(x.shape[0]) for x, _y in sets)
            print(f"[5/6] throughput: fnn_eval {what} {topo} C={c} N={n_txt}:"
                  f" kernel {dev_ms:.4f} ms of device time (a CUDA graph of "
                  f"100 calls), {issue_ms:.4f} ms a call issued from the host "
                  f"loop, plain version {p_ms:.3f} ms, bound {b_ms:.6f} ms "
                  f"({b_by})")
            if (what, c, topo) == ("Sunspot train", 64, (4, 10, 1)):
                out["fnn_eval"] = dict(ms=dev_ms, issue_ms=issue_ms,
                                       plain_ms=p_ms, bound_ms=b_ms,
                                       bound_by=b_by)
            if (what, c, topo) == ("Sunspot pair", 64, (4, 10, 1)):
                # what lg_pallas launches every step
                out["fnn_eval"].update(
                    pair_ms=dev_ms, pair_issue_ms=issue_ms, pair_plain_ms=p_ms,
                    pair_bound_ms=b_ms, pair_bound_by=b_by)
    return out


# ---------------------------------------------------------------------------
# The model zoo: the Bayesian CNN and a deep MLP on the digits images,
# through the per-step sampler; the CNN's fused stage 1 (conv1_relu_pool).

# cnn_digits's default configuration at 64 chains x 300 steps, all 1257 / 540
# rows: ptnn's per-step sampler on the CPU, seeds 0-2 (PYTHONPATH=. python
# tests/test_torch_zoo_step.py cnn 64 300 0 1 2), about an hour a seed: mean
# accept %, swap % (of 126 proposed pairs), Langevin %, and the ladder-mean and
# the cold rung's test accuracy over the second half. The bands are those
# three values widened: one run is one draw of a 300-step trace that has
# barely left chance (10 %), and the cold rung's accuracy is one chain's.
CNN_REF = dict(accept=(23.41, 23.73, 24.34), swap=(89.68, 95.24, 89.68),
               langevin=(50.27, 49.46, 49.82),
               ladder_acc=(9.92, 10.05, 10.83), cold_acc=(10.33, 3.67, 5.96))
CNN_BANDS = dict(accept=(20.0, 28.0), swap=(82.0, 99.0), langevin=LANGEVIN,
                 ladder_acc=(8.0, 13.0), cold_acc=(1.0, 20.0))
# the full-width run at cnn_digits's default width; its depth cut from the
# default 2000 steps to 1600, so that the smoke with the sweeps phase stays
# inside 1000 s (the cold test accuracy over the second half read 39.69 % at
# 2000 steps and 15.75 % at 1200 against the >= 15 % gate)
CNN_CHAINS, CNN_STEPS = 256, 1600
BAND_CHAINS, BAND_STEPS = 64, 300  # the run held to ptnn's bands
CMP_STEPS = 100  # fused eval against plain eval (no swap event: < 101)
CLI_CHAINS, CLI_STEPS = 128, 300  # the command line's run
CHANCE = 10.0  # ten classes
CNN_ABOVE_CHANCE = 5.0  # the full-width run's cold test accuracy over chance
C_ATOL = 1e-5  # conv kernel against plain: FMA contraction, summation order
F_ATOL = 1e-4  # the fused CNN forward against the plain one (logits)
# (chains, images, side, in_ch, out_ch) of the conv kernel's comparisons:
# the model zoo's runs (256 chains), the CNN's MALA / ChEES runs (128), ragged
CONV_SHAPES = ((256, 1257, 8, 1, 8), (256, 540, 8, 1, 8), (128, 1257, 8, 1, 8),
               (128, 540, 8, 1, 8), (130, 19, 8, 1, 8), (4, 6, 8, 3, 8),
               (32, 64, 28, 1, 8))


def digits():
    from ptnn_torch import data

    return data.load_digits(0)


def cnn_cfg(chains, steps, **kw):
    """python -m ptnn_torch.experiments.cnn_digits's default configuration:
    the classification preset at maxtemp 5, step_w 0.01, learn_rate
    step_w^2 / 2, Langevin gradients, swaps every 100, record_w off."""
    from ptnn_torch import classification_preset

    step_w = 0.01
    base = classification_preset(
        (64, 32, 10), num_samples=chains * steps, num_chains=chains,
        maxtemp=5.0, use_langevin_gradients=True,
        learn_rate=step_w * step_w / 2.0)
    extra = dict(swap_interval=100, step_w=step_w, record_w=False,
                 chunk_steps=min(500, steps))
    extra.update(kw)
    return dataclasses.replace(base, **extra).validate()


def conv_inputs(c, n, hw, in_ch, out_ch, seed=37):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    return (f(rng.uniform(size=(n, hw * hw * in_ch))),
            f(rng.normal(size=(c, 3, 3, in_ch, out_ch)) * 0.3),
            f(rng.normal(size=(c, out_ch)) * 0.1))


def phase_conv_kernel():
    """conv1_relu_pool against its plain version (F.conv2d + relu +
    avg_pool2d, TF32 off) at the main path's widths and the ragged ones, then
    the fused CNN forward against the plain chain-batched forward; returns
    the largest |diff| of the kernel."""
    import numpy as np
    import torch

    from ptnn_torch.models import cnn
    from ptnn_torch.ops import conv_stage

    err = 0.0
    for c, n, hw, in_ch, out_ch in CONV_SHAPES:
        x, w1, b1 = conv_inputs(c, n, hw, in_ch, out_ch)
        before = conv_stage.launches, conv_stage.fixed_launches
        got = conv_stage.conv1_relu_pool(x, w1, b1, hw, in_ch, out_ch)
        torch.cuda.synchronize()
        kind = conv_stage.launch_plan(c, n, hw, in_ch, out_ch).kernel
        check((conv_stage.launches, conv_stage.fixed_launches)
              == (before[0] + 1, before[1] + (kind == "fixed")),
              f"conv1_relu_pool did not launch its {kind} kernel")
        want = conv_stage.conv1_relu_pool_reference(x, w1, b1, hw, in_ch,
                                                    out_ch)
        check(got.shape == want.shape == (c, n, hw // 2, hw // 2, out_ch),
              f"conv shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "conv output not finite")
        diff = float((got - want).abs().max())
        check(diff <= C_ATOL, f"conv1_relu_pool C={c} N={n} hw={hw} "
              f"{in_ch}->{out_ch}: max |diff| {diff:.3g} > {C_ATOL}")
        check(float(want.abs().max()) > 0.1 and float((want == 0).float().mean())
              < 0.9, "conv comparison on a trivial output")
        err = max(err, diff)
        print(f"[3/6] kernel: conv1_relu_pool ({kind}) C={c} N={n} hw={hw} "
              f"{in_ch}->{out_ch}: within atol {C_ATOL} of F.conv2d + relu + "
              f"avg_pool2d, TF32 off (max |diff| {diff:.3g}, outputs up to "
              f"{float(want.abs().max()):.3g})")
    cfg = cnn.CnnConfig(image_hw=8, n_classes=10)
    prob = digits()
    rng = np.random.default_rng(41)
    ws = torch.as_tensor(rng.normal(size=(CNN_CHAINS, cnn.w_size(cfg))) * 0.2,
                         dtype=torch.float32, device=DEVICE)
    for rows in (prob.train, prob.test):
        x = torch.as_tensor(rows[:, :64], dtype=torch.float32, device=DEVICE)
        before = conv_stage.launches
        got = cnn.batched_forward_fused(ws, x, cfg)
        check(conv_stage.launches == before + 1, "the fused forward did not "
              "launch conv1_relu_pool")
        want = cnn.forward(ws, x, cfg)
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        check(diff <= F_ATOL, f"fused CNN forward: max |diff| {diff:.3g}")
        print(f"[3/6] kernel: batched_forward_fused C={CNN_CHAINS} "
              f"N={x.shape[0]}: logits within atol {F_ATOL} of the plain "
              f"chain-batched forward (max |diff| {diff:.3g}, logits up to "
              f"{float(want.abs().max()):.3g})")
    return err


def run_zoo_counted(cfg, prob, spec, seed=0):
    """One model-zoo run through ptnn_torch.sample with every launch count
    set to 0 just before it. The plan: no kernel but conv1_relu_pool, and
    that one once for each eval of a spec with the fused eval (two a step,
    init_state's, the temper switch's recompute), never otherwise."""
    import ptnn_torch

    n = cfg.n_steps
    fused = spec.batched_forward is not None
    plan = (2 * n + 1 + int(0 < cfg.temper_switch_step < n)) if fused else 0
    reset_launch_counts()
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                            device=DEVICE, model_spec=spec)
    got = {name: launch_count(name) for name in KERNELS}
    want = dict({name: 0 for name in KERNELS}, conv1_relu_pool=plan)
    check(got == want, f"model-zoo launches {got}, planned {want}")
    from ptnn_torch.ops import conv_stage

    check(conv_stage.fixed_launches == plan, f"{conv_stage.fixed_launches} "
          f"of the {plan} conv launches took the fixed-shape kernel")
    return res, plan


def zoo_stats(cfg, res):
    import numpy as np

    from ptnn_torch import kernel

    s = cfg.samples_per_chain
    tr = res.traces
    for name in ("ll", "acc_train", "acc_test", "rmse_test", "accept_count"):
        check(tr[name].shape == (s, cfg.num_chains)
              and np.isfinite(tr[name]).all(), f"trace {name}")
    acc = tr["acc_test"][s // 2:]
    n_events = sum(kernel.swap_due(cfg, i) for i in range(cfg.n_steps))
    return dict(accept=float(np.mean(res.accept_ratio_per_chain)),
                swap=float(res.swap_percent),
                langevin=float(np.mean(res.langevin_ratio_per_chain)),
                ladder_acc=float(np.mean(acc)),
                cold_acc=float(np.mean(acc[:, 0])),
                swap_events=n_events,
                swaps_proposed=int(res.final_state.n_swap_proposed))


def phase_zoo_end_to_end():
    """The model zoo through ptnn_torch.sample on the card, the cnn_digits
    command line as a subprocess meanwhile; returns the conv kernel's
    launches in the full-width run."""
    import shutil

    out = ROOT / "build" / "chip_smoke_cnn"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "ptnn_torch.experiments.cnn_digits",
           "--chains", str(CLI_CHAINS), "--steps", str(CLI_STEPS), "--adapt",
           "--out", str(out)]
    t0 = time.perf_counter()
    cli = popen(cmd)
    try:
        return _zoo_end_to_end(cli, out, t0)
    finally:  # a failed check leaves no subprocess behind
        if cli.poll() is None:
            cli.kill()
            cli.wait()


def _zoo_end_to_end(cli, out, t0):
    """The body of ``phase_zoo_end_to_end`` once its command line runs."""
    import numpy as np

    from ptnn_torch import kernel
    from ptnn_torch.models import cnn, mlp

    prob = digits()
    check(prob.train.shape == (1257, 65) and prob.test.shape == (540, 65),
          "digits rows")
    fused = cnn.digits_spec(fused_eval=True)
    check(fused.w_size == 3658, f"CNN w_size {fused.w_size}")
    # --- full width: cnn_digits's default configuration ---------------------
    cfg = cnn_cfg(CNN_CHAINS, CNN_STEPS)
    res, launches = run_zoo_counted(cfg, prob, fused)
    st = zoo_stats(cfg, res)
    print(f"[4/6] end to end: digits CNN {fused.name} {cfg.num_chains} chains "
          f"x {cfg.samples_per_chain} samples on {prob.train.shape[0]} / "
          f"{prob.test.shape[0]} rows in "
          f"{res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} chain-steps/s"
          f" incl. trace fetch); mean accept {st['accept']:.2f}%, swap "
          f"{st['swap']:.2f}% ({st['swaps_proposed']} pairs proposed in "
          f"{st['swap_events']} events), Langevin {st['langevin']:.2f}%; test "
          f"accuracy over the second half: cold {st['cold_acc']:.2f}%, ladder "
          f"mean {st['ladder_acc']:.2f}%, final cold "
          f"{res.traces['acc_test'][-1, 0]:.2f}%; conv1_relu_pool launches "
          f"{launches} (as planned), every other kernel 0")
    check(LANGEVIN[0] <= st["langevin"] <= LANGEVIN[1],
          f"CNN Langevin share {st['langevin']:.2f}")
    check(st["swap_events"] > 0 and st["swaps_proposed"]
          == st["swap_events"] * (cfg.num_chains - 1),
          f"CNN swaps proposed {st['swaps_proposed']} in {st['swap_events']} "
          f"events")
    check(st["cold_acc"] >= CHANCE + CNN_ABOVE_CHANCE,
          f"CNN cold test accuracy {st['cold_acc']:.2f}% is not "
          f"{CNN_ABOVE_CHANCE} above chance ({CHANCE}%)")
    check(0.0 < st["accept"] < 100.0, "CNN accepted all or nothing")
    # --- held to ptnn: 64 chains x 300, seed 0 ------------------------------
    cfg = cnn_cfg(BAND_CHAINS, BAND_STEPS)
    res, n_conv = run_zoo_counted(cfg, prob, fused, seed=0)
    st = zoo_stats(cfg, res)
    print(f"[4/6] end to end: digits CNN {BAND_CHAINS} chains x {BAND_STEPS} "
          f"samples, seed 0, in {res.elapsed_s:.3f} s; against ptnn's per-step "
          f"sampler on the CPU, seeds 0-2: " + "; ".join(
              f"{k} {st[k]:.2f} (ptnn {', '.join(f'{v:.2f}' for v in CNN_REF[k])}"
              f"; band {CNN_BANDS[k][0]}-{CNN_BANDS[k][1]})"
              for k in CNN_BANDS) + f"; conv1_relu_pool launches {n_conv}")
    for k, (lo, hi) in CNN_BANDS.items():
        check(lo <= st[k] <= hi, f"CNN {BAND_CHAINS} x {BAND_STEPS} {k} "
              f"{st[k]:.4f} outside [{lo}, {hi}]")
    # --- the fused eval against the plain eval, same seed and noise ---------
    cfg = cnn_cfg(BAND_CHAINS, CMP_STEPS)
    check(not any(kernel.swap_due(cfg, i) for i in range(cfg.n_steps)),
          "the fused-against-plain comparison expects independent chains "
          "(no swap event)")
    a, _ = run_zoo_counted(cfg, prob, fused, seed=0)
    b, _ = run_zoo_counted(cfg, prob, cnn.digits_spec(), seed=0)
    # a decision flips where |u - mh_prob| is under the evals' difference
    # (logits differ by ~1e-6, ll by ~1e-4 of 1257 terms): about one of the
    # 6336 decisions. A chain that flipped parts ways from there (no swaps
    # in 99 steps, so the others do not); at most 5 % of the chains may.
    same = (a.traces["accept_count"] == b.traces["accept_count"]).all(axis=0)
    check(int(same.sum()) >= 0.95 * BAND_CHAINS, f"fused vs plain eval: only "
          f"{int(same.sum())} of {BAND_CHAINS} chains keep their accept "
          f"counts")
    row = 100.0 / prob.test.shape[0]  # one test row's share of the accuracy
    d_acc = np.abs(a.traces["acc_test"][:, same] - b.traces["acc_test"][:, same])
    frac = float((d_acc <= 1.01 * row).mean())
    check(frac >= 0.999 and float(d_acc.max()) <= 3.01 * row,
          f"fused vs plain eval: acc_test differs by up to {d_acc.max():.3f}")
    d_ll = np.abs(a.traces["ll"][:, same] - b.traces["ll"][:, same])
    check(bool((d_ll <= ATOL + RTOL * np.abs(b.traces["ll"][:, same])).all()),
          f"fused vs plain eval: ll differs by up to {d_ll.max():.3g}")
    print(f"[4/6] end to end: digits CNN {BAND_CHAINS} x {CMP_STEPS}, seed 0, "
          f"fused eval against plain eval on the same noise: "
          f"{int(same.sum())} of {BAND_CHAINS} chains keep every accept count; on those acc_test agrees within one test row "
          f"({row:.3f}%) in {100 * frac:.2f}% of the entries (max "
          f"{d_acc.max():.3f}), ll within rtol {RTOL} (max |diff| "
          f"{d_ll.max():.3g})")
    # --- a deep MLP ----------------------------------------------------------
    cfg = dataclasses.replace(cnn_cfg(BAND_CHAINS, BAND_STEPS),
                              learn_rate=5e-5).validate()
    spec = mlp.spec((64, 32, 16, 10), task="classification", act="relu")
    res, _ = run_zoo_counted(cfg, prob, spec)
    st = zoo_stats(cfg, res)
    print(f"[4/6] end to end: digits MLP {spec.name} {BAND_CHAINS} chains x "
          f"{BAND_STEPS} samples in {res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} "
          f"chain-steps/s): mean accept {st['accept']:.2f}%, swap "
          f"{st['swap']:.2f}%, Langevin {st['langevin']:.2f}%, cold test "
          f"accuracy {st['cold_acc']:.2f}%, ladder mean "
          f"{st['ladder_acc']:.2f}%; no kernel launched (as planned)")
    check(LANGEVIN[0] <= st["langevin"] <= LANGEVIN[1],
          f"MLP Langevin share {st['langevin']:.2f}")
    check(0.0 < st["accept"] < 100.0, "MLP accepted all or nothing")
    # --- the command line, a subprocess since the phase began ---------------
    stdout = finished(cli, "cnn_digits")
    wall = time.perf_counter() - t0
    line = stdout.strip().splitlines()[-1]
    check(line.startswith(f"[digits] chains={CLI_CHAINS} test_acc mean="),
          line)
    run = out / "digits_0"
    with open(run / "config.json") as f:
        written = json.load(f)
    check(written["adapt_step_size"] and written["use_langevin_gradients"]
          and written["num_chains"] == CLI_CHAINS, "cnn_digits config.json")
    n_files = sum(1 for _ in run.rglob("*.txt"))
    check(n_files == 3 + 7 * CLI_CHAINS, f"cnn_digits wrote {n_files} text "
          f"files")
    acc = np.loadtxt(run / "predictions" / "acc_test_chain_1.0.txt")
    check(acc.shape == (CLI_STEPS,) and np.isfinite(acc).all()
          and (run / "metrics.jsonl").is_file(), "cnn_digits artifacts")
    print(f"[4/6] end to end: python -m ptnn_torch.experiments.cnn_digits "
          f"--chains {CLI_CHAINS} --steps {CLI_STEPS} --adapt exited 0 "
          f"(beside this phase's runs; collected after {wall:.1f} s): "
          f"{line.split(' -> ')[0]}; {n_files} text files, config.json and "
          f"metrics.jsonl under {run.relative_to(ROOT)}")
    return launches


# ---------------------------------------------------------------------------
# The per-step preconditioned family (precond_mala, hmc with and without
# ChEES) through ptnn_torch.sample: plain PyTorch around the eval kernels,
# fnn_eval for the FNN's test rows (grad mode) and conv1_relu_pool for the
# CNN's; the fused gate's fallback (Ionosphere); the fused twins beside
# their per-step runs (Sunspot).

# the digits CNN as scripts/cnn_convergence.py:68-95 samples it, at its
# budgets cut (MALA at 2000 with record_thin 2000 // 512 = 3, the script's
# thinning: its 4000 cut to keep the smoke inside its time since the
# surrogate and auto phase; ChEES at 1000, record_thin 1): ptnn's records
# (results/cnn_convergence.md, one pooled run each, hence bands): served
# accuracy, per-draw cold accuracy, pooled function-space R-hat
CNN_PC_CHAINS, CNN_PC_SEEDS = 128, (1, 2)
CNN_PC_STEPS = {"mala": 2000, "chees": 1000}
CNN_PC_REF = {"mala": (99.17, 93.59, 1.034), "chees": (98.24, 91.71, 1.042)}
# median served accuracy over the seeds, at least
CNN_PC_SERVED = {"mala": 97.0, "chees": 95.0}
CNN_PC_DRAW = {"mala": (90.0, 96.0), "chees": (86.0, 96.0)}
CNN_PC_RHAT = 1.15  # pooled function-space R-hat, at most
CNN_PC_SERVE_ROWS = 1000  # cold draws the served predictor pools, about
# Ionosphere: bench.py's _cls_variants(...)["mala_fused_16x4"] (64 chains,
# seeds 1-3; 4000 samples, cut from bench's 8000 to keep the smoke inside
# its time), which the fused gate refuses (w 1852): BENCH_r05.json
# classification.Ionosphere.mala_16x4 reads per-draw 73.72, 332.75 round
# trips per 1k steps over 16 ladders (20.8 each) and served 77.98, the last
# from replica 0 alone (bench.py:433 strides the pooled rows by a multiple
# of the replica count): printed, not gated
IONO_PC_SEEDS, IONO_PC_SAMPLES = (1, 2, 3), 4000
IONO_PC_DRAW = (68.0, 80.0)  # median per-draw cold accuracy
IONO_PC_TRIPS = (14.0, 28.0)  # median round trips per ladder per 1k steps
IONO_PC_REF = (73.72, 332.75 / 16, 77.98)
# Sunspot: bench.py's per-step mala, hmc, mala_16x4 and chees16_16x4 at 64 x
# 5000, seed 0; a fused twin's accept and swap within TWIN_POINTS of the
# per-step run's (ptnn/fused.py:37-42), the runs without a twin accepting
# PER_STEP_ACCEPT; the MALA runs' cold RMSE in MALA_RMSE (ptnn's MALA
# replicas 0.0203-0.0292), the HMC runs' in HMC_RMSE: ptnn's ChEES replicas
# land in 0.0092-0.0111 (results/mala_basins.md:17), under MALA_RMSE's
# floor; the band runs from about half the lowest replica to bench.py's
# flagship gate (FLAGSHIP_RMSE's ceiling)
TWIN_POINTS = 3.0
HMC_RMSE = (0.005, FLAGSHIP_RMSE[1])
PER_STEP_ACCEPT = (40.0, 75.0)
# samples of each per-step variant: hmc (4-7 ms a step) and chees16_16x4
# (about 10 ms, host-bound, and its fused twin with it) cut from 5000 to
# keep the smoke inside its time
PER_STEP_SAMPLES = {"mala": 5000, "hmc": 2000, "mala_16x4": 5000,
                    "chees16_16x4": 2000}
# phase 5's CNN throughput runs, steps a chain, and the Sunspot per-step
# ones (measurements only: short, to keep the smoke inside its time)
PC_THR_CNN_STEPS = 10
PC_THR_SUNSPOT_SAMPLES = 100
# phase 5's full-width CNN throughput run, steps a chain
ZOO_THR_STEPS = 50
# phase 5's lg_pallas throughput run, samples a chain
LG_THR_SAMPLES = 500


def sunspot_variant(name, chains=64, samples=5000):
    """bench.py's _variants (bench.py:160-224) per step (and its fused
    twins) at ``chains`` x ``samples``, replicas tracked."""
    common = dict(adapt_rate=0.1, swap_style="even_odd", swap_interval=10,
                  warmstart_frac=0.1, precond_start_frac=0.3,
                  track_replicas=True)
    if name == "mala":
        return rw_fused_cfg(chains, samples, proposal="precond_mala",
                            fused_step=False, **common)
    if name == "hmc":
        return rw_fused_cfg(chains, samples, proposal="hmc", hmc_leapfrog=8,
                            step_w=0.01, fused_step=False, **common)
    proposal = "hmc" if name.startswith("chees16") else "precond_mala"
    return precond_cfg(chains, samples, proposal, track_replicas=True,
                       fused_step="fused" in name)


def cnn_precond_cfg(sampler, chains=CNN_PC_CHAINS, steps=None, **kw):
    """scripts/cnn_convergence.py:68-95: the classification preset at
    maxtemp 5, 4-rung replicated ladders, DEO metropolis swaps of
    untempered energies every 10, warm start to 10 %, preconditioner from
    30 %, step 0.01, 16 cold rungs' w recorded every max(1, steps // 512)
    steps (record_thin), chunks of 150 steps (its --chunk default); ChEES
    with 8 leapfrog steps. ``steps``: CNN_PC_STEPS[sampler] by default."""
    from ptnn_torch import classification_preset

    steps = steps if steps is not None else CNN_PC_STEPS[sampler]
    base = classification_preset((64, 32, 10), num_samples=chains * steps,
                                 num_chains=chains, maxtemp=5.0)
    extra = (dict(hmc_leapfrog=8, hmc_adapt_traj=True) if sampler == "chees"
             else {})
    fields = dict(
        proposal="hmc" if sampler == "chees" else "precond_mala",
        n_ladders=chains // 4, adapt_rate=0.1, swap_style="even_odd",
        swap_interval=10, swap_rule="metropolis", swap_payload="untempered",
        warmstart_frac=0.1, precond_start_frac=0.3, step_w=0.01,
        record_w=True, record_w_chains=min(16, chains // 4),
        record_thin=max(1, steps // 512), chunk_steps=150, **extra)
    fields.update(kw)
    return dataclasses.replace(base, **fields).validate()


def run_precond_counted(cfg, prob, spec=None, seed=0, fallback=False):
    """One per-step run of the preconditioned family through
    ptnn_torch.sample with every launch count set to 0 just before it. The
    plan: one eval launch a step (the test rows under a gradient proposal,
    whose train ll comes from the value-and-grad; both row sets in one
    launch for precond_rw and pcn), plus init_state's and the temper
    switch's recompute; fnn_eval for the FNN, conv1_relu_pool (the
    fixed-shape kernel) for the CNN with the fused eval, every other kernel
    0. ``fallback``: the config is fused and must fall back with ptnn's
    warning."""
    import warnings

    import numpy as np

    import ptnn_torch
    from ptnn_torch.ops import conv_stage

    n = cfg.n_steps
    plan = n + 1 + int(0 < cfg.temper_switch_step < n)
    name = "fnn_eval" if spec is None else "conv1_relu_pool"
    reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                                device=DEVICE, model_spec=spec)
    fell = [str(w.message) for w in caught if "falling back" in
            str(w.message)]
    check(bool(fell) == fallback, f"fallback warnings {fell}, expected "
          f"{'one' if fallback else 'none'}")
    got = {k: launch_count(k) for k in KERNELS}
    want = dict({k: 0 for k in KERNELS}, **{name: plan})
    check(got == want, f"{cfg.proposal} per-step launches {got}, planned "
          f"{want}")
    if spec is not None:
        check(conv_stage.fixed_launches == plan, f"{conv_stage.fixed_launches}"
              f" of the {plan} conv launches took the fixed-shape kernel")
    for k in ("ll", "rmse_test", "acc_test", "accept_count"):
        check(np.isfinite(res.traces[k]).all(), f"trace {k} not finite")
    return res, plan, fell


def phase_per_step_precond_end_to_end(mala_twin):
    """The per-step preconditioned family on the card: Sunspot's four
    per-step variants beside their fused twins (``mala_twin``:
    phase_mala_end_to_end's mala_fused_16x4 statistics; chees16_fused_16x4
    runs here) and Ionosphere's fused MALA config falling back (the digits
    CNN's: ``phase_cnn_precond_end_to_end``); returns the launches of each
    path."""
    import numpy as np

    from ptnn_torch import data, predict

    out = {}
    # --- Sunspot: four per-step variants, two fused twins -------------------
    prob = sunspot()
    cfg = sunspot_variant("chees16_fused_16x4",
                          samples=PER_STEP_SAMPLES["chees16_16x4"])
    res, n_l, n_blocks = run_counted("hmc_block", cfg, prob)
    rmse, acc, _trips = cold_stats(res, cfg)
    stats = {"mala_fused_16x4": mala_twin,
             "chees16_fused_16x4": dict(rmse=rmse, accept=acc,
                                        swap=res.swap_percent)}
    print(f"[4/6] end to end: Sunspot chees16_fused_16x4 (fused twin) "
          f"{cfg.num_chains} chains x {cfg.samples_per_chain} samples in "
          f"{res.elapsed_s:.3f} s: cold test RMSE {rmse:.5f}, mean accept "
          f"{acc:.2f}%, swap {res.swap_percent:.2f}%; hmc_block launches "
          f"{n_l} for {n_blocks} planned blocks")
    for name, twin in (("mala", None), ("hmc", None),
                       ("mala_16x4", "mala_fused_16x4"),
                       ("chees16_16x4", "chees16_fused_16x4")):
        cfg = sunspot_variant(name, samples=PER_STEP_SAMPLES[name])
        res, plan, _ = run_precond_counted(cfg, prob)
        rmse, acc, _trips = cold_stats(res, cfg)
        out[name] = plan
        band = HMC_RMSE if cfg.proposal == "hmc" else MALA_RMSE
        line = (f"[4/6] end to end: Sunspot {name} per step, "
                f"{cfg.num_chains} chains x {cfg.samples_per_chain} samples "
                f"in {res.elapsed_s:.3f} s "
                f"({res.chain_steps_per_sec:.0f} chain-steps/s incl. trace "
                f"fetch): cold test RMSE {rmse:.5f} (band {band}), mean "
                f"accept {acc:.2f}%, swap {res.swap_percent:.2f}%")
        if cfg.hmc_adapt_traj:
            tl = res.traces["traj_len"][1:]
            line += f", traj_len {tl.min():.0f}-{tl.max():.0f}"
            check(tl.min() >= 1 and tl.max() <= 16 and len(np.unique(tl)) > 1,
                  f"{name} traj_len stays in [1, 16] and varies")
        if twin:
            t = stats[twin]
            line += (f"; fused twin accept {t['accept']:.2f}%, swap "
                     f"{t['swap']:.2f}% (within {TWIN_POINTS} points)")
            for what, v in (("accept", acc), ("swap", res.swap_percent)):
                check(abs(v - t[what]) <= TWIN_POINTS, f"{name} {what} "
                      f"{v:.2f} is {abs(v - t[what]):.2f} points from "
                      f"{twin}'s {t[what]:.2f}")
        else:
            check(PER_STEP_ACCEPT[0] <= acc <= PER_STEP_ACCEPT[1],
                  f"{name} mean accept {acc:.2f} outside {PER_STEP_ACCEPT}")
        print(line + f"; fnn_eval launches {plan} (as planned), every other "
              f"kernel 0")
        check(band[0] <= rmse <= band[1],
              f"{name} cold test RMSE {rmse:.4f} outside {band}")
    # --- Ionosphere: the fused MALA config falls back -----------------------
    prob = data.load_classification("Ionosphere")
    cfg = dataclasses.replace(iris_cfg(64, IONO_PC_SAMPLES, "precond_mala"),
                              topology=(34, 50, 2)).validate()
    rows = []
    nx = cfg.topology[0]
    y = prob.test[:, nx].astype(np.int64)
    for seed in IONO_PC_SEEDS:
        res, plan, fell = run_precond_counted(cfg, prob, seed=seed,
                                              fallback=True)
        draw, accept, trips = iris_stats(cfg, res)
        cold = res.traces["w"][cfg.samples_per_chain // 2:]
        step = max(1, cold.shape[0] // max(1, 2000 // cold.shape[1]))
        pred = predict.posterior_predict(
            cfg, cold[::step].reshape(-1, cold.shape[-1]), prob.test[:, :nx],
            device=DEVICE)
        served = float(np.mean(pred["label"] == y)) * 100.0
        rows.append((draw, trips, served))
        print(f"[4/6] end to end: Ionosphere mala_fused_16x4 seed {seed}, "
              f"{cfg.num_chains} chains x {cfg.samples_per_chain} samples per "
              f"step in {res.elapsed_s:.3f} s "
              f"(\"{fell[0]}\"): per-draw cold accuracy {draw:.2f}%, served "
              f"{served:.2f}%, mean accept {accept:.2f}%, swap "
              f"{res.swap_percent:.2f}%, round trips {trips:.2f} per ladder "
              f"per 1k steps; fnn_eval launches {plan} (as planned)")
        out["ionosphere"] = plan
    draw, trips, served = (statistics.median(r[i] for r in rows)
                           for i in range(3))
    print(f"[4/6] end to end: Ionosphere mala_fused_16x4 medians over seeds "
          f"1-3: per-draw {draw:.2f}% (band {IONO_PC_DRAW}; ptnn "
          f"{IONO_PC_REF[0]}), round trips {trips:.2f} (band "
          f"{IONO_PC_TRIPS}; ptnn {IONO_PC_REF[1]:.2f}), served {served:.2f}%"
          f" over the pooled replicas (not gated; ptnn {IONO_PC_REF[2]} from "
          f"replica 0 alone)")
    for what, v, (lo, hi) in (("per-draw accuracy", draw, IONO_PC_DRAW),
                              ("round trips per ladder", trips,
                               IONO_PC_TRIPS)):
        check(lo <= v <= hi, f"Ionosphere mala median {what} {v:.4f} "
              f"outside [{lo}, {hi}]")
    return out


def phase_cnn_precond_end_to_end():
    """The digits CNN with MALA and ChEES (``scripts/cnn_convergence.py``'s
    receipts) on the per-step preconditioned family: served accuracy,
    per-draw accuracy and the pooled function-space R-hat against ptnn's
    records, conv launches the plan; returns the launches of each path."""
    import numpy as np

    from ptnn_torch import predict
    from ptnn_torch.models import cnn
    from ptnn_torch.ops import ess

    out = {}
    # --- the digits CNN, MALA and ChEES --------------------------------------
    prob = digits()
    spec = cnn.digits_spec(fused_eval=True)
    nx = 64
    y = prob.test[:, nx].astype(np.int64)
    for sampler in ("mala", "chees"):
        cfg = cnn_precond_cfg(sampler)
        cold_idx = np.arange(0, cfg.num_chains, cfg.rungs_per_ladder)
        colds, rows = [], []
        for seed in CNN_PC_SEEDS:
            res, plan, _ = run_precond_counted(cfg, prob, spec, seed)
            b = int(res.traces["acc_test"].shape[0] * cfg.burn_in)
            cold = res.traces["w"][b:]  # (draws, 16, W)
            colds.append(cold)
            draw = float(np.mean(res.traces["acc_test"][b:, cold_idx]))
            # thin along the draw axis, then pool the replicas
            step = max(1, cold.shape[0]
                       // max(1, CNN_PC_SERVE_ROWS // cold.shape[1]))
            pool = cold[::step].reshape(-1, cold.shape[-1])
            pred = predict.posterior_predict(cfg, pool, prob.test[:, :nx],
                                             device=DEVICE, spec=spec)
            served = float(np.mean(pred["label"] == y)) * 100.0
            rows.append((served, draw))
            line = (f"[4/6] end to end: digits CNN {sampler} seed {seed}, "
                    f"{cfg.num_chains} chains x {cfg.samples_per_chain} steps in "
                    f"{res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} "
                    f"chain-steps/s incl. trace fetch): served {served:.2f}% "
                    f"over {pool.shape[0]} pooled cold draws, per-draw "
                    f"{draw:.2f}%, mean accept "
                    f"{float(np.mean(res.accept_ratio_per_chain)):.2f}%, swap "
                    f"{res.swap_percent:.2f}%")
            if sampler == "chees":
                tl = res.traces["traj_len"][1:]
                line += (f", traj_len {tl.min():.0f}-{tl.max():.0f} (mean "
                         f"{tl.mean():.2f})")
                check(tl.min() >= 1 and tl.max() <= 8
                      and len(np.unique(tl)) > 1,
                      "CNN ChEES traj_len stays in [1, 8] and varies")
            print(line + f"; conv1_relu_pool launches {plan} (as planned)")
            out[f"cnn_{sampler}"] = plan
        rhat = ess.function_space_rhat(colds, prob.test, cfg, spec=spec,
                                       device=DEVICE)
        served, draw = (statistics.median(r[i] for r in rows)
                        for i in range(2))
        ref = CNN_PC_REF[sampler]
        print(f"[4/6] end to end: digits CNN {sampler} {cfg.samples_per_chain}"
              f" steps (record_thin {cfg.record_thin}) medians over seeds "
              f"1-2: served {served:.2f}% (gate >= {CNN_PC_SERVED[sampler]}; "
              f"ptnn "
              f"{ref[0]}), per-draw {draw:.2f}% (band {CNN_PC_DRAW[sampler]};"
              f" ptnn {ref[1]}), pooled function-space R-hat {rhat:.3f} (gate "
              f"<= {CNN_PC_RHAT}; ptnn {ref[2]})")
        lo, hi = CNN_PC_DRAW[sampler]
        check(served >= CNN_PC_SERVED[sampler], f"CNN {sampler} served "
              f"{served:.2f}% under {CNN_PC_SERVED[sampler]}")
        check(lo <= draw <= hi, f"CNN {sampler} per-draw accuracy "
              f"{draw:.2f} outside [{lo}, {hi}]")
        check(rhat <= CNN_PC_RHAT, f"CNN {sampler} function-space R-hat "
              f"{rhat:.3f} over {CNN_PC_RHAT}")
    return out


def phase_per_step_precond_throughput():
    """Chain-steps/s of the per-step preconditioned family
    (throughput_runner, median of 2 reps after its warm-up): the digits CNN
    with MALA and ChEES at 128 chains x PC_THR_CNN_STEPS, Sunspot
    mala_16x4 and chees16_16x4 per step at 64 x PC_THR_SUNSPOT_SAMPLES;
    one value-and-grad of the CNN (the MALA step's one, ChEES's 8) beside
    one Langevin drift, at 128 and 256 chains."""
    import numpy as np
    import torch

    import ptnn_torch
    from ptnn_torch import kernel
    from ptnn_torch.models import cnn
    from ptnn_torch.ops import drift

    prob = digits()
    spec = cnn.digits_spec(fused_eval=True)
    for sampler in ("mala", "chees"):
        cfg = cnn_precond_cfg(sampler, steps=PC_THR_CNN_STEPS)
        runner = ptnn_torch.throughput_runner(cfg, prob.train, prob.test,
                                              device=DEVICE, model_spec=spec)
        reps = [runner() for _ in range(2)]
        rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
        print(f"[5/6] throughput: digits CNN {sampler} per step, "
              f"{cfg.num_chains} chains x {PC_THR_CNN_STEPS} steps: median "
              f"{rate:.0f} chain-steps/s over 2 reps "
              f"({1e3 * cfg.num_chains / rate:.2f} ms a step)")
    prob_s = sunspot()
    for name in ("mala_16x4", "chees16_16x4"):
        cfg = sunspot_variant(name, samples=PC_THR_SUNSPOT_SAMPLES)
        runner = ptnn_torch.throughput_runner(cfg, prob_s.train, prob_s.test,
                                              device=DEVICE)
        reps = [runner() for _ in range(2)]
        rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
        print(f"[5/6] throughput: Sunspot {name} per step, 64 chains x "
              f"{PC_THR_SUNSPOT_SAMPLES} samples: median {rate:.0f} "
              f"chain-steps/s over 2 reps ({1e3 * 64 / rate:.3f} ms a step)")
    rng = np.random.default_rng(43)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    x_tr, y_tr = f(prob.train[:, :64]), f(prob.train[:, 64])
    t_tr = drift.make_targets(y_tr, 10, "classification")
    parts = []
    for c in (128, 256):
        cfg = cnn_precond_cfg("mala", chains=c)
        data = kernel.Dataset(x_tr, y_tr, x_tr[:1], y_tr[:1])
        vg = kernel.like_value_and_grad(cfg, spec, data)
        w = f(rng.normal(size=(c, spec.w_size)) * 0.2)
        vg_ms = time_ms(lambda: vg(w), 5, warm=1)
        d_ms = time_ms(lambda: spec.drift(w, x_tr, t_tr, 5e-5), 5, warm=1)
        parts.append(f"{c} chains: value-and-grad {vg_ms:.2f} ms, drift "
                     f"{d_ms:.2f} ms")
    print("[5/6] throughput: CNN gradient passes on 1257 rows (autograd, "
          "full float32): " + "; ".join(parts))


def conv_ops(c, n, hw, in_ch, out_ch):
    """Arithmetic of conv1_relu_pool: per pre-pool value 9 * in_ch
    multiply-adds, the bias and the ReLU, and its share of the pool (three
    adds and the scaling for four values)."""
    return c * n * hw * hw * out_ch * (18 * in_ch + 3)


def phase_zoo_throughput():
    """The CNN's chain-steps/s (throughput_runner), the conv kernel's time
    against its plain version's, the library chain's and the bound, one
    drift and one eval of a full-width CNN step, and stage 2 (patches times
    taps) against the same stage as one grouped F.conv2d; returns the conv
    kernel's line entry at the main path's widths (256 chains x 1257
    images)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import ptnn_torch
    from ptnn_torch.models import cnn
    from ptnn_torch.ops import conv_stage, drift
    from ptnn_torch.ops.precision import full_float32

    prob = digits()
    fused = cnn.digits_spec(fused_eval=True)
    cfg = cnn_cfg(CNN_CHAINS, ZOO_THR_STEPS)
    runner = ptnn_torch.throughput_runner(cfg, prob.train, prob.test,
                                          device=DEVICE, model_spec=fused)
    reps = [runner() for _ in range(2)]
    rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
    print(f"[5/6] throughput: digits CNN {CNN_CHAINS} chains x {ZOO_THR_STEPS} "
          f"samples: "
          f"median {rate:.0f} chain-steps/s over 2 reps "
          f"({1e3 * CNN_CHAINS / rate:.2f} ms a step; accept "
          f"{reps[0]['accept_pct']:.1f}%, Langevin "
          f"{reps[0]['langevin_pct']:.1f}%)")
    out = {}
    for c, n, hw, in_ch, out_ch in CONV_SHAPES[:2]:
        x, w1, b1 = conv_inputs(c, n, hw, in_ch, out_ch)
        kern = lambda: conv_stage.conv1_relu_pool(x, w1, b1, hw, in_ch, out_ch)
        plain = lambda: conv_stage.conv1_relu_pool_reference(x, w1, b1, hw,
                                                             in_ch, out_ch)
        img = x.reshape(n, hw, hw, in_ch).permute(0, 3, 1, 2).contiguous()
        weight = w1.permute(0, 4, 3, 1, 2).reshape(c * out_ch, in_ch, 3,
                                                   3).contiguous()
        bias = b1.reshape(c * out_ch).contiguous()

        def library():
            # the C chains as C * out_ch output channels of one convolution
            # over the shared images, in its own layout (N, C * out_ch, ...)
            with full_float32():
                return F.avg_pool2d(torch.relu(
                    F.conv2d(img, weight, bias, padding=1)), 2)

        k_ms, p_ms = timing(kern, plain, 20, 5)
        l_ms = min(time_ms(library, 5), time_ms(library, 5))
        got = kern()
        nbytes = 4 * (x.numel() + w1.numel() + b1.numel() + got.numel())
        b_ms, b_by = bound(conv_ops(c, n, hw, in_ch, out_ch), nbytes)
        print(f"[5/6] throughput: conv1_relu_pool C={c} N={n} hw={hw} {in_ch}->"
              f"{out_ch}: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.0f} GB/s "
              f"of its {nbytes / 1e6:.1f} MB), plain version {p_ms:.3f} ms, "
              f"library F.conv2d + relu + F.avg_pool2d (TF32 off) "
              f"{l_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        if n == 1257:
            out["conv1_relu_pool"] = dict(ms=k_ms, plain_ms=p_ms,
                                          bound_ms=b_ms, bound_by=b_by,
                                          library_ms=l_ms)
    # one drift (forward and backward of the plain forward) and one eval of
    # the full-width step
    rng = np.random.default_rng(43)
    w = torch.as_tensor(rng.normal(size=(CNN_CHAINS, fused.w_size)) * 0.2,
                        dtype=torch.float32, device=DEVICE)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    x_tr, y_tr = f(prob.train[:, :64]), f(prob.train[:, 64])
    x_te = f(prob.test[:, :64])
    t_tr = drift.make_targets(y_tr, 10, "classification")
    torch.cuda.reset_peak_memory_stats()
    d = time_ms(lambda: fused.drift(w, x_tr, t_tr, 5e-5), 5, warm=1)
    fp = time_ms(lambda: fused.forward(w, x_tr), 5, warm=1)
    ftr = time_ms(lambda: fused.batched_forward(w, x_tr), 5, warm=1)
    fte = time_ms(lambda: fused.batched_forward(w, x_te), 5, warm=1)
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"[5/6] throughput: CNN step parts at {CNN_CHAINS} chains: one "
          f"drift (forward and backward, 1257 rows) {d:.2f} ms, plain forward "
          f"{fp:.2f} ms, fused-eval forward {ftr:.2f} ms (1257 rows) and "
          f"{fte:.2f} ms (540 rows); peak device memory {mem:.2f} GiB; a step "
          f"is 2 drifts and 2 evals: {2 * d + ftr + fte:.2f} ms")
    # stage 2 (8 -> 16 channels on 4x4 maps, per-chain taps): the port's
    # patches-times-taps product against one F.conv2d with groups = chains
    h = torch.as_tensor(rng.uniform(size=(CNN_CHAINS, 1257, 4, 4, 8)),
                        dtype=torch.float32, device=DEVICE).requires_grad_()
    cw = torch.as_tensor(rng.normal(size=(CNN_CHAINS, 3, 3, 8, 16)) * 0.2,
                         dtype=torch.float32, device=DEVICE).requires_grad_()
    cb = torch.zeros((CNN_CHAINS, 16), device=DEVICE).requires_grad_()

    def stage_grouped(h, cw, cb):
        c, k, _, ci, co = cw.shape
        _, n, hh, ww, _ = h.shape
        x = h.permute(1, 0, 4, 2, 3).reshape(n, c * ci, hh, ww)
        weight = cw.permute(0, 4, 3, 1, 2).reshape(c * co, ci, k, k)
        with full_float32():
            z = F.conv2d(x, weight, cb.reshape(c * co), padding=1, groups=c)
        z = z.reshape(n, c, co, hh, ww).permute(1, 0, 3, 4, 2)
        return cnn._pool(torch.relu(z))

    with torch.no_grad():
        diff = float((cnn._conv_stage(h, cw, cb)
                      - stage_grouped(h, cw, cb)).abs().max())
    check(diff <= F_ATOL, f"stage 2: product against grouped conv differ by "
          f"{diff:.3g}")
    stage_ms = {}
    for name, fn in (("patches x taps", cnn._conv_stage),
                     ("grouped conv", stage_grouped)):
        both = lambda: torch.autograd.grad(fn(h, cw, cb).sum(), (h, cw, cb))
        stage_ms[name] = (time_ms(lambda: fn(h, cw, cb), 5, warm=1),
                          time_ms(both, 5, warm=1))
    print(f"[5/6] throughput: CNN stage 2 at {CNN_CHAINS} chains x 1257 rows "
          f"(max |diff| {diff:.3g}): " + "; ".join(
              f"{name} forward {f_ms:.2f} ms, forward and backward "
              f"{fb_ms:.2f} ms" for name, (f_ms, fb_ms) in stage_ms.items()))
    return out


# ---------------------------------------------------------------------------
# The run lifecycle: the paper's command lines (python -m
# ptnn_torch.experiments.regression / classification) in subprocesses, the
# served runs (python -m ptnn_torch.predict), a checkpointed run killed and
# resumed, and record_thin on both samplers.

# ptnn's command lines at their defaults on the CPU, seeds 0-4 (my CPU run
# of ptnn: ``python tests/test_torch_experiments.py NAME 0 1 2 3 4``): each
# band is the mean +- 4 sample standard deviations of the five, rounded
# outward. test: the test RMSE / accuracy pooled over every chain after
# burn-in (the master row's test_mean); served: the RMSE of the posterior
# mean / the accuracy of the mean class probabilities over the cold chain's
# draws, as ptnn.predict serves the run. The fused RW runs take the bands
# of ptnn's per-step RW runs (the same sampler).
CLI_BANDS = {
    # regression --problem Sunspot: Langevin-gradient PT, 10 x 10,000
    "Sunspot LG": dict(test=(0.0177, 0.0277), swap=(49.5, 58.1),
                       accept=(8.3, 12.4), served=(0.0169, 0.0253)),
    # regression --problem Sunspot --no-langevin (and --fused)
    "Sunspot RW": dict(test=(0.0177, 0.0274), swap=(45.0, 65.5),
                       accept=(9.7, 13.1), served=(0.0163, 0.0258)),
    # classification --problem iris: the random walk, 10 x 5,000
    "iris RW": dict(test=(46.5, 73.7), swap=(59.9, 92.3),
                    accept=(94.0, 95.7), served=(71.4, 84.1)),
}
# each command line run, with the flags after --problem and its band; they
# run at once, five processes on one card
CLI_RUNS = (
    ("Sunspot LG", "Sunspot LG", "regression", ["--problem", "Sunspot"]),
    ("Sunspot RW fused roundtrip", "Sunspot RW", "regression",
     ["--problem", "Sunspot", "--no-langevin", "--fused", "--roundtrip"]),
    ("Sunspot RW fused replicate", "Sunspot RW", "regression",
     ["--problem", "Sunspot", "--no-langevin", "--fused", "--replicate",
      "2"]),
    ("iris RW", "iris RW", "classification", ["--problem", "iris"]),
    ("iris RW fused", "iris RW", "classification",
     ["--problem", "iris", "--fused"]),
)
# runs a module as ``python -m`` does, then prints the launch counts of the
# process on a line of its own
CLI_PROBE = """
import json, runpy, sys
from ptnn_torch.ops import (block_step, conv_stage, drift, fnn_eval,
                            precond_cls_step, precond_step)
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
print("launches " + json.dumps(dict(
    rw_block=block_step.launches, rw_cls_block=block_step.cls_launches,
    drift_epoch=drift.launches, fnn_eval=fnn_eval.launches,
    conv1_relu_pool=conv_stage.launches, **precond_step.launches,
    **precond_cls_step.launches)))
"""
# the checkpointed run: ptnn_torch.sample of a config (JSON) on Sunspot,
# seed 0, checkpoint path, checkpoint every N chunks
CKPT_PROBE = """
import json, os, sys
import ptnn_torch
from ptnn_torch.config import from_json_dict
from ptnn_torch.data import load_regression
cfg = from_json_dict(json.loads(sys.argv[1]))
prob = load_regression("Sunspot")
ptnn_torch.sample(cfg, prob.train, prob.test, seed=0,
                  device=os.environ.get("PTNN_DEVICE", "cuda"),
                  checkpoint_path=sys.argv[2], checkpoint_every=int(sys.argv[3]))
"""
CKPT_EVERY = 2  # chunks of 1000 / 1333 steps between checkpoints
CKPT_SAMPLES = 100_000  # the regression command line's default, 10 chains
CKPT_CNN = ("64", "100")  # cnn_digits --checkpoint: chains, steps
THIN_SHAPE = (64, 5000)  # chains, samples of the thinned runs
LIFE_OUT = ROOT / "build" / "chip_smoke_lifecycle"


def cli_plan(cfg, replicate, rounds=()):
    """The launches a command line run of ``cfg`` plans, for the run and
    each replication: per step, 2 drift epochs a step with Langevin
    gradients and one eval a step; fused, one block launch a block; both,
    one eval for init_state's ll and one for the temper switch's
    recompute. With ``rounds`` (the samples a chain of each VR round), the
    sum of that plan over the rounds' runs, each at its budget; the
    reference itself launches nothing."""
    from ptnn_torch import fused

    if rounds:
        plans = [cli_plan(dataclasses.replace(
            cfg, num_samples=s * cfg.num_chains), replicate) for s in rounds]
        return {k: sum(p[k] for p in plans) for k in plans[0]}
    n, runs = cfg.n_steps, 1 + replicate
    evals = 1 + int(0 < cfg.temper_switch_step < n)
    if cfg.fused_step:
        kern = "rw_cls_block" if cfg.task == "classification" else "rw_block"
        blocks = sum(len(seg) for seg in fused.block_plan(cfg))
        return {kern: blocks * runs, "fnn_eval": evals * runs}
    plan = {"fnn_eval": (n + evals) * runs}
    if cfg.use_langevin_gradients:
        plan["drift_epoch"] = 2 * n * runs
    return plan


def in_band(tag, what, value, band):
    lo, hi = band
    check(lo <= value <= hi, f"{tag}: {what} {value:.6g} outside [{lo}, "
          f"{hi}]")


def read_rounds(run):
    """``rounds_history.md``'s rows: samples a chain, swap %, barrier, regen
    % (as printed, a dash for round 0) and the test metric."""
    with open(run / "rounds_history.md") as f:
        table = f.read().splitlines()[2:]
    rows = [[c.strip() for c in r.strip("|").split("|")] for r in table]
    return [dict(samples=int(c[1]), swap=float(c[2]), barrier=float(c[3]),
                 regen=c[5], metric=float(c[6])) for c in rows]


def check_cli_run(phase, tag, band, module, args, out, stdout, stderr, rc,
                  wall):
    """One finished command line run: exit code, the artifact tree (the
    evidence and rounds files where the flags ask for them), the master
    row, the statistics against ``band`` (a VR run's regeneration at 100 %,
    a rounds run's every round), the launches against the plan; returns
    (run dir, statistics, the launch line's counts)."""
    import numpy as np

    from ptnn_torch.config import from_json_dict

    check(rc == 0, f"{tag}: exited with {rc}: {stderr[-2000:]}")
    lines = stdout.strip().splitlines()
    check(lines[-1].startswith("launches "), f"{tag}: no launch line")
    got = {k: v for k, v in json.loads(lines[-1][len("launches "):]).items()
           if v}
    summary = lines[-2]
    problem = args[1]
    check(summary.startswith(f"[{problem}] test_mean="), f"{tag}: {summary}")
    run = out / f"{problem}_0"
    with open(run / "config.json") as f:
        cfg = from_json_dict(json.load(f))
    replicate = int(args[args.index("--replicate") + 1]) \
        if "--replicate" in args else 0
    rounds = read_rounds(run) if "--vr-rounds" in args else []
    vr = "--vref" in args or bool(rounds)
    check(cfg.variational_reference == vr and cfg.vr_hot_infinite == vr,
          f"{tag}: variational reference {cfg.variational_reference}, T = "
          f"inf rung {cfg.vr_hot_infinite}")
    want = cli_plan(cfg, replicate, [r["samples"] for r in rounds])
    check(got == want, f"{tag}: launches {got}, planned {want}")
    files = ["config.json", "metrics.jsonl", "likelihood.txt",
             "accept_list.txt", "acceptpercent.txt"]
    files += ["roundtrip.txt"] if "--roundtrip" in args else []
    files += ["replication.txt"] if replicate else []
    files += ["evidence.txt"] if "--evidence" in args else []
    files += ["rounds_history.md"] if rounds else []
    for rel in files:
        check((run / rel).is_file(), f"{tag}: no {rel}")
    n_chain = {d: len(list((run / d).glob("*.txt"))) for d in (
        "posterior/pos_w", "posterior/pos_likelihood", "predictions")}
    # record_w_chains = k (the rounds set 1): the w of the first k cold rungs
    stride = cfg.rungs_per_ladder if cfg.n_ladders > 1 else 1
    n_w = min(cfg.record_w_chains, cfg.num_chains // stride) or cfg.num_chains
    check(n_chain == {"posterior/pos_w": n_w,
                      "posterior/pos_likelihood": cfg.num_chains,
                      "predictions": 4 * cfg.num_chains},
          f"{tag}: per-chain files {n_chain}")
    with open(run / "posterior" / "pos_w" / "chain_1.0.txt") as f:
        rows = f.read().splitlines()
    last = np.array(rows[-1].split(), dtype=np.float64)
    check(len(rows) == cfg.samples_per_chain and last.shape == (cfg.w_size,)
          and np.isfinite(last).all(), f"{tag}: cold pos_w has {len(rows)} "
          f"rows, the last {last.shape}")
    with open(out / "master_result_file.txt") as f:
        row = f.read().split()
    check(len(row) == 16 and row[-1] == f"{problem}_0", f"{tag}: master row "
          f"{row}")
    with open(run / "metrics.jsonl") as f:
        m = json.loads(f.read().splitlines()[-1])
    st = dict(test=m["test_mean"], swap=m["swap_percent"],
              accept=m["accept_per"], rate=m["chain_steps_per_sec"])
    extra = []
    if "--roundtrip" in args:
        with open(run / "roundtrip.txt") as f:
            n_lines = len(f.read().splitlines())
        trips = [x for x in lines if "replica transport: " in x]
        check(len(trips) == 1, f"{tag}: no transport line")
        st["trips"] = int(trips[0].split("transport: ")[1].split()[0])
        extra.append(f"roundtrip.txt {n_lines} lines, {st['trips']} round "
                     f"trips")
    if replicate:
        with open(run / "replication.txt") as f:
            rhat = [r for r in f.read().splitlines()
                    if r.startswith("rhat_cold_max")][0]
        extra.append(f"replication.txt {rhat}")
    if "--evidence" in args:
        keys = ("ti", "ss") + (("log_z0", "abs_ti", "abs_ss") if vr else ())
        with open(run / "evidence.txt") as f:
            ev = {k: float(v) for k, _, v in (
                r.partition(" ") for r in f.read().splitlines())
                if k in ("ti", "ss", "log_z0", "abs_ti", "abs_ss")}
        check(tuple(ev) == keys and all(np.isfinite(v) for v in ev.values()),
              f"{tag}: evidence.txt {ev}, wanted finite {keys}")
        st.update(ev)
        extra.append("evidence.txt " + " ".join(f"{k} {v:.2f}"
                                                for k, v in ev.items()))
    if vr:
        regen = [x for x in lines if "hot-rung regen" in x]
        check(len(regen) == 1 and "regen 100.0% accepted" in regen[0],
              f"{tag}: regeneration at beta = 0 not 100 %: {regen}")
        extra.append(regen[0].split("] ")[1])
    if rounds:
        check([r["regen"] for r in rounds] == ["—"] + ["100.0"] * (
            len(rounds) - 1), f"{tag}: regeneration by round {rounds}")
        check(f"w_size={cfg.w_size}" in stderr and "NEGATIVE" in stderr,
              f"{tag}: no w_size >= 40 warning")
        extra.append("rounds " + "; ".join(
            f"r{i} S={r['samples']} swap {r['swap']} barrier {r['barrier']} "
            f"regen {r['regen']} metric {r['metric']}"
            for i, r in enumerate(rounds)))
    shown = ", ".join(f"{k} {st[k]:.5g}" + (f" (band {band[k]})"
                                             if k in band else "")
                      for k in ("test", "swap", "accept"))
    print(f"{phase}: python -m ptnn_torch.experiments.{module} "
          f"{' '.join(args)} --no-plots exited 0 in {wall:.1f} s "
          f"({st['rate']:.0f} chain-steps/s sampling): {shown}; "
          + "; ".join(extra + [f"launches {got} (as planned)"]))
    for what, lim in band.items():
        if what in st:
            in_band(tag, what, st[what], lim)
    for i, r in enumerate(rounds):
        in_band(tag, f"round {i} swap", r["swap"], band["round_swap"][i])
        in_band(tag, f"round {i} barrier", r["barrier"],
                band["round_barrier"][i])
    if rounds:
        in_band(tag, "final round's RMSE", rounds[-1]["metric"],
                band["metric"])
    return run, st, got


def served_line(tag, proc, band, t0):
    """The predict command line's output on a run: exit code, the served
    RMSE / accuracy against the run's band, the calibration and the
    criteria lines."""
    import re

    import numpy as np

    stdout, stderr = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{tag} predict exited with "
          f"{proc.returncode}: {stderr[-2000:]}")
    lines = stdout.strip().splitlines()
    head = lines[0]
    m = re.search(r"RMSE\(mean\) ([0-9.]+)|accuracy\(mean probs\) ([0-9.]+)%",
                  head)
    check(m is not None, f"{tag}: {head}")
    served = float(m.group(1) or m.group(2))
    for key in ("calibration (test)", "WAIC: elpd", "PSIS-LOO: elpd",
                "test lppd"):
        check(any(x.startswith(key) for x in lines), f"{tag}: no {key!r} "
              f"line")
    numbers = [float(x) for x in re.findall(r"-?[0-9]+\.[0-9]+",
                                            " ".join(lines))]
    check(bool(np.isfinite(numbers).all()), f"{tag}: a served number is not "
          f"finite")
    print(f"[4/6] lifecycle: python -m ptnn_torch.predict --run {tag} "
          f"--calibrate --ic exited 0 in {wall:.1f} s: "
          + " | ".join(lines))
    lo, hi = band
    check(lo <= served <= hi, f"{tag}: served {served} outside [{lo}, {hi}]")
    return served


def kept_rows(cfg):
    """Trace rows (1-based) the thinned run keeps, as ptnn keeps them: per
    step, each chunk's local positions thin-1, 2 thin-1, ...; fused, each
    group of blocks' (fused.thin_groups)."""
    from ptnn_torch import fused, sampler

    thin, n = cfg.record_thin, cfg.n_steps
    if cfg.fused_step:
        plan = fused.block_plan(cfg)
        k_max = max(ln for seg in plan for (_s, ln, _f) in seg)
        group = max(1, -(-cfg.chunk_steps // k_max))
        groups = [[s + p for (s, ln, _f) in seg[gi:gi + group]
                   for p in range(ln)]
                  for seg in plan for gi in range(0, len(seg), group)]
    else:
        switch = cfg.temper_switch_step
        segments = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
        groups = []
        for a, b in segments:
            chunk = sampler._pick_chunk(b - a, max(1, min(cfg.chunk_steps, n)))
            groups += [list(range(lo, min(lo + chunk, b)))
                       for lo in range(a, b, chunk)]
    return [s + 1 for g in groups for s in g[thin - 1::thin]]


def thinned_pair(tag, cfg, thin, kern, full=None):
    """``cfg`` unthinned (or ``full``, its result and peak) and thinned by
    ``thin`` on the same seed; the kept rows must be the unthinned run's at
    ptnn's positions bit for bit, the final states equal, the launches
    the plan's."""
    import numpy as np
    import torch

    import ptnn_torch
    from ptnn_torch import fused

    prob = sunspot()
    plan = (sum(len(seg) for seg in fused.block_plan(cfg)) if cfg.fused_step
            else cfg.n_steps + 2)

    def run(c):
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the phases before
        res = ptnn_torch.sample(c, prob.train, prob.test, seed=0,
                                device=DEVICE)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        check(launch_count(kern) == plan, f"{tag} thin {c.record_thin}: "
              f"{launch_count(kern)} {kern} launches, planned {plan}")
        return res, peak

    out = [full if full is not None else run(cfg),
           run(dataclasses.replace(cfg, record_thin=thin).validate())]
    (a, peak_a), (b, peak_b) = out
    rows = kept_rows(b.config)
    check(b.traces["ll"].shape[0] == len(rows) + 1, f"{tag}: "
          f"{b.traces['ll'].shape[0]} rows, ptnn keeps {len(rows)} + 1")
    for k, v in b.traces.items():
        check(np.array_equal(v[1:], a.traces[k][rows]), f"{tag} thin {thin}: "
              f"trace {k} differs from the unthinned run's kept rows")
    for k in ("w", "n_accept", "n_swap_accepted", "ll"):
        check(torch.equal(getattr(a.final_state, k), getattr(b.final_state, k)),
              f"{tag} thin {thin}: final {k} differs")
    k_max = max(ln for seg in fused.block_plan(cfg) for (_s, ln, _f) in seg) \
        if cfg.fused_step else None
    regime = ("" if k_max is None else
              " (sparse: one row a block at most)" if thin >= k_max else
              " (gather)")
    print(f"[4/6] lifecycle: record_thin {thin}{regime}, {tag} "
          f"{cfg.num_chains} x {cfg.samples_per_chain}: {len(rows)} kept "
          f"rows equal the unthinned run's at ptnn's positions bit for bit, "
          f"final state equal; wall {b.elapsed_s:.3f} s (unthinned "
          f"{a.elapsed_s:.3f}), trace host copy {1e3 * b.fetch_s:.2f} ms "
          f"({1e3 * a.fetch_s:.2f}), peak device memory over what was held "
          f"before the run {peak_b:.1f} MiB ({peak_a:.1f}); {kern} launches "
          f"{plan} each (as planned)")
    return out[0]


def popen(cmd):
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finished(proc, what):
    """The output of a finished subprocess; fails unless it exited 0."""
    stdout, stderr = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"{what} exited with {proc.returncode}: "
          f"{stderr[-2000:]}")
    return stdout


def phase_run_lifecycle():
    """The paper's command lines on the card, serving their runs, a
    checkpointed run killed and resumed, cnn_digits --checkpoint, and
    record_thin on both samplers. The subprocesses run in two groups at
    once: the five command lines with the run to kill (this process runs
    the uninterrupted one meanwhile), then the two served runs, cnn_digits
    and the resumed run. Returns nothing: every kernel launched here also
    runs on a main path above."""
    import os
    import shutil
    import signal
    import threading

    import numpy as np

    import ptnn_torch
    from ptnn_torch import checkpoint, config, kernel
    from ptnn_torch.models import cnn

    shutil.rmtree(LIFE_OUT, ignore_errors=True)
    LIFE_OUT.mkdir(parents=True)
    # --- record_thin: fused (gather, sparse) and per step -----------------
    rw = rw_fused_cfg(*THIN_SHAPE, record_w=True)
    full = thinned_pair("rw_fused", rw, 3, "rw_block")
    k_max = max(ln for seg in ptnn_torch.fused.block_plan(rw)
                for (_s, ln, _f) in seg)
    thinned_pair("rw_fused", rw, k_max + 3, "rw_block", full)
    thinned_pair("lg_pallas", lg_cfg(*THIN_SHAPE, record_w=True), 7,
                 "fnn_eval")
    # --- group 1: the command lines and the run to kill ---------------------
    # the checkpointed run: the regression command line's default config
    cfg = dataclasses.replace(
        ptnn_torch.regression_preset(num_samples=CKPT_SAMPLES,
                                     num_chains=10),
        drift_mode="sequential", n_ladders=1).validate()
    ck = LIFE_OUT / "sunspot_lg.npz"
    ck_cmd = [sys.executable, "-c", CKPT_PROBE,
              json.dumps(config.to_json_dict(cfg)), str(ck), str(CKPT_EVERY)]
    t0 = time.perf_counter()
    procs, walls = {}, {}

    def wall_of(tag):  # each command line's wall from the common start
        procs[tag].wait()
        walls[tag] = time.perf_counter() - t0

    for tag, _band, module, args in CLI_RUNS:
        procs[tag] = popen([sys.executable, "-c", CLI_PROBE,
                            f"ptnn_torch.experiments.{module}", *args,
                            "--no-plots", "--out",
                            str(LIFE_OUT / tag.replace(" ", "_"))])
    victim = popen(ck_cmd)

    def kill_after_a_save():
        while victim.poll() is None and not ck.exists():
            time.sleep(0.01)
        victim.send_signal(signal.SIGKILL)

    threads = [threading.Thread(target=wall_of, args=(tag,))
               for tag in procs] + [threading.Thread(target=kill_after_a_save)]
    for t in threads:
        t.start()
    prob = sunspot()
    want = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0,
                             device=DEVICE)  # uninterrupted, meanwhile
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "a subprocess hangs")
    runs = {}
    for tag, band, module, args in CLI_RUNS:
        stdout, stderr = procs[tag].communicate()
        runs[tag] = check_cli_run("[4/6] lifecycle", tag, CLI_BANDS[band],
                                  module, args,
                                  LIFE_OUT / tag.replace(" ", "_"), stdout,
                                  stderr, procs[tag].returncode, walls[tag])
    victim.communicate(timeout=60)
    check(victim.returncode == -signal.SIGKILL, f"the run to kill ended "
          f"with {victim.returncode} before a checkpoint was seen")
    spec_name = kernel.default_spec(cfg).name
    killed_at = checkpoint.load(str(ck), cfg, 0, spec_name)[1]
    check(0 < killed_at < cfg.n_steps, f"killed at step {killed_at}")
    # --- group 2: serving, cnn_digits --checkpoint, the resumed run ---------
    cnn_out = LIFE_OUT / "cnn"
    cnn_ck = LIFE_OUT / "cnn_checkpoint.npz"
    t0 = time.perf_counter()
    served = [(tag, popen([sys.executable, "-m", "ptnn_torch.predict",
                           "--run", str(runs[tag][0]), "--problem", problem,
                           "--calibrate", "--ic"]))
              for tag, problem in (("Sunspot LG", "Sunspot"),
                                   ("iris RW", "iris"))]
    cnn_proc = popen([sys.executable, "-m",
                      "ptnn_torch.experiments.cnn_digits", "--chains",
                      CKPT_CNN[0], "--steps", CKPT_CNN[1], "--checkpoint",
                      str(cnn_ck), "--out", str(cnn_out)])
    resumed = popen(ck_cmd)
    for tag, proc in served:
        served_line(f"{runs[tag][0].relative_to(ROOT)}", proc,
                    CLI_BANDS[tag]["served"], t0)
    cnn_line = finished(cnn_proc, "cnn_digits --checkpoint")
    with open(cnn_out / "digits_0" / "config.json") as f:
        cnn_cfg_ = config.from_json_dict(json.load(f))
    loaded = checkpoint.load(str(cnn_ck), cnn_cfg_, 0,
                             cnn.digits_spec().name)
    check(loaded is not None and loaded[1] == cnn_cfg_.n_steps,
          "cnn_digits --checkpoint: no finished checkpoint")
    print(f"[4/6] lifecycle: python -m ptnn_torch.experiments.cnn_digits "
          f"--chains {CKPT_CNN[0]} --steps {CKPT_CNN[1]} --checkpoint exited "
          f"0 in {time.perf_counter() - t0:.1f} s: "
          f"{cnn_line.strip().splitlines()[-1].split(' -> ')[0]}; "
          f"checkpoint at step {loaded[1]} of {cnn_cfg_.n_steps}, "
          f"{os.path.getsize(cnn_ck) / 2**20:.2f} MiB")
    finished(resumed, "the resumed run")
    resume_wall = time.perf_counter() - t0
    state, done, traces = checkpoint.load(str(ck), cfg, 0, spec_name)
    check(done == cfg.n_steps, f"the resumed run's checkpoint at {done}")
    check(set(traces) == set(want.traces), f"traces {sorted(traces)}")
    for k, v in traces.items():
        check(np.array_equal(v, want.traces[k][1:]), f"resumed trace {k} "
              f"differs from the uninterrupted run's")
    fin = want.final_state
    for k, v in vars(state).items():
        ref = getattr(fin, k)
        check((v is None) == (ref is None) and (
            v is None or np.array_equal(v.cpu().numpy(), ref.numpy())),
            f"resumed state {k} differs")
    t0 = time.perf_counter()
    save_to = LIFE_OUT / "save_timing.npz"
    checkpoint.save(str(save_to), fin, cfg.n_steps,
                    {k: v[1:] for k, v in want.traces.items()}, cfg, 0,
                    spec_name)
    save_s = time.perf_counter() - t0
    print(f"[4/6] lifecycle: Sunspot LG per step {cfg.num_chains} x "
          f"{cfg.samples_per_chain}, checkpoint every {CKPT_EVERY} chunks: "
          f"SIGKILLed with its last checkpoint at step {killed_at}, resumed "
          f"in {resume_wall:.1f} s; every trace ({len(traces)}) and every "
          f"state tensor equal the uninterrupted run's bit for bit; a "
          f"checkpoint of the whole run "
          f"{os.path.getsize(save_to) / 2**20:.2f} MiB, saved in "
          f"{save_s:.3f} s")


# ---------------------------------------------------------------------------
# Phase 4, the variational-reference paths: the command lines'
# --vref, --vr-rounds and --evidence, the evidence model-selection
# procedure, the single-chain sampler, a VR run resumed from its checkpoint.

# each band is the mean +- 4 sample standard deviations of ptnn's own run on
# the CPU over seeds 0-19, rounded outward: the command
# lines by ``python tests/test_torch_experiments.py regression-vref|
# regression-rounds|classification-vref 0 1 ... 19``
VR_BANDS = {
    # regression --problem Sunspot --vref --evidence --roundtrip: Langevin
    # per step, 10 x 10,000, the T = inf rung; test: the master row's test
    # mean (every chain after burn-in). Round trips: 0 on all 20 seeds (the
    # d = 61 posterior's metastability, results/vref_transport.md)
    "Sunspot vref": dict(test=(0.0191, 0.0343), swap=(47.5, 72.6),
                         abs_ti=(-3020.0, 1870.0), abs_ss=(610.0, 741.0),
                         log_z0=(-40.2, -8.1), trips=(0, 0)),
    # regression --problem Sunspot --no-langevin --vr-rounds 3 --evidence:
    # per round (2500, 5000, 10,000 steps a chain) swap % and barrier; the
    # final round's post-burn-in cold test RMSE
    "Sunspot rounds": dict(round_swap=((41.0, 89.1), (0.0, 38.2),
                                       (1.1, 22.1)),
                           round_barrier=((0.86, 5.49), (5.6, 8.91),
                                          (7.07, 8.86)),
                           metric=(0.0072, 0.0297)),
    # classification --problem iris --vref --evidence: the canonical preset,
    # 10 x 5000; served: the accuracy of the mean class probabilities over
    # the cold chain's draws (ptnn_torch.predict; the band's top, 105.88,
    # clipped)
    "iris vref": dict(swap=(51.0, 73.9), served=(43.68, 100.0),
                      abs_ti=(-104.2, -69.3), abs_ss=(-107.5, -67.0)),
}
VR_CLI_RUNS = (
    ("Sunspot vref", "regression",
     ["--problem", "Sunspot", "--vref", "--evidence", "--roundtrip"]),
    ("Sunspot rounds", "regression",
     ["--problem", "Sunspot", "--no-langevin", "--vr-rounds", "3",
      "--evidence"]),
    ("iris vref", "classification",
     ["--problem", "iris", "--vref", "--evidence"]),
)
# scripts/evidence_model_selection.py:80-118: hidden sizes, seeds, steps a
# chain; bands per seed from ``python tests/test_torch_tuning.py H SEED ...``
# over 20 seeds (the script's 4, 14, 24, then 34 ... 194), the barrier's from
# the script's pilot seed 0 and ``... barrier H 1 ... 19`` (the port's
# pilots draw other noise than ptnn's)
MS_HIDDEN = (2, 6)
MS_SEEDS = (4, 14, 24)
MS_STEPS = 1600
MS_BANDS = {
    2: dict(log_z_ss=(365.0, 584.0), elpd_loo=(370.0, 617.0),
            rmse=(0.0207, 0.0549), barrier=(5.5, 9.4)),
    6: dict(log_z_ss=(422.0, 568.0), elpd_loo=(459.0, 624.0),
            rmse=(0.0212, 0.0453), barrier=(6.7, 10.3)),
}
# mcmc.single_chain_config("regression", (4, 10, 1), samples=SC_SAMPLES) on
# Sunspot, seeds 0-2 (ptnn's default depth 50,000 cut to keep the smoke's
# time); bands from ``python tests/test_torch_mcmc.py 0 ... 19``: accept %,
# post-burn-in mean test RMSE, % of test targets inside the 5-95 % band
# (the band is the network's epistemic spread alone, hence narrow)
SC_SAMPLES = 10_000
SC_SEEDS = (0, 1, 2)
SC_BANDS = dict(accept=(4.8, 12.5), rmse=(0.0133, 0.0309),
                inside=(5.5, 29.9))
SC_PROBE = """
import json, os, sys, time
import numpy as np
from ptnn_torch import mcmc
from ptnn_torch.data import load_regression
from ptnn_torch.ops import drift, fnn_eval
prob = load_regression("Sunspot")
y = prob.test[:, 4]
for seed in map(int, sys.argv[2:]):
    cfg = mcmc.single_chain_config("regression", (4, 10, 1),
                                   samples=int(sys.argv[1]))
    t0 = time.perf_counter()
    res = mcmc.run_single_chain(cfg, prob.train, prob.test, seed=seed,
                                device=os.environ.get("PTNN_DEVICE", "cuda"))
    b = mcmc.predictive_bands(res, "test")
    burn = int(cfg.samples_per_chain * cfg.burn_in)
    fx = res.traces["fx_test"]
    print("seed " + json.dumps(dict(
        seed=seed, wall=time.perf_counter() - t0,
        accept=float(res.accept_ratio_per_chain[0]),
        rmse=float(np.mean(res.traces["rmse_test"][burn:, 0])),
        inside=100.0 * float(np.mean((y >= b["low"]) & (y <= b["high"]))),
        fx=list(fx.shape), finite=bool(np.isfinite(fx).all()),
        n_steps=cfg.n_steps)))
print("launches " + json.dumps(dict(drift_epoch=drift.launches,
                                    fnn_eval=fnn_eval.launches)))
"""
# the VR run to kill and resume: the regression command line's --vref
# --evidence config at 10 x 2000, chunks of 250 steps
VR_CKPT_SAMPLES = 20_000
VR_CKPT_CHUNK = 250


def selection_cfg(hidden):
    """``scripts/evidence_model_selection.py``'s ``vr_cfg`` at MS_STEPS."""
    from ptnn_torch import PTConfig

    return PTConfig(
        task="regression", topology=(4, hidden, 1),
        num_samples=16 * MS_STEPS, num_chains=16, maxtemp=20.0,
        swap_interval=4, swap_offset=0, swap_style="even_odd",
        swap_payload="untempered", swap_rule="metropolis", pt_phase_frac=2.0,
        variational_reference=True, vr_hot_infinite=True, record_w=True,
        record_w_chains=1, record_ll_state=True, chunk_steps=200).validate()


def model_selection():
    """The procedure of ``scripts/evidence_model_selection.py:80-118`` on
    the card, per hidden size: the VR ladder tuned (``tuning.tune_ladder``,
    two rounds, pilots of MS_STEPS / 2 steps), a run a seed on the tuned
    ladder; each seed's absolute log Z (stepping stone), PSIS-LOO elpd of
    the cold draws and cold test RMSE, and the barrier, against ptnn's
    bands; one eval launch a step and one a run, nothing else; the ranking
    printed. Returns the eval launches."""
    import numpy as np

    import ptnn_torch
    from ptnn_torch import tuning
    from ptnn_torch.ops import evidence, ic

    prob = sunspot()
    x_tr, y_tr = prob.train[:, :4], prob.train[:, 4]
    rows, evals = [], 0
    for h in MS_HIDDEN:
        t0 = time.perf_counter()
        reset_launch_counts()
        cfg = selection_cfg(h)
        pilot = 16 * max(MS_STEPS // 2, 200)
        tuned = tuning.tune_ladder(cfg, prob.train, prob.test, rounds=2,
                                   pilot_samples=pilot, device=DEVICE)
        cfg_t = dataclasses.replace(cfg, custom_ladder=tuple(
            float(t) for t in tuned.temperatures)).validate()
        check(np.isinf(tuned.temperatures[-1]), f"h={h}: the tuned ladder "
              f"lost its T = inf rung")
        zs, loos, rmses = [], [], []
        for seed in MS_SEEDS:
            res = ptnn_torch.sample(cfg_t, prob.train, prob.test, seed=seed,
                                    device=DEVICE)
            est = evidence.from_result(res)
            check(est.anchored and np.isfinite(est.log_z_abs_ss),
                  f"h={h} seed {seed}: the evidence is not anchored")
            check(res.vr_regen_accept_pct == 100.0, f"h={h} seed {seed}: "
                  f"regeneration {res.vr_regen_accept_pct}")
            w_tr = np.asarray(res.traces["w"])[:, 0, :]
            start = max(int(w_tr.shape[0] * cfg_t.burn_in), 1)
            draws = w_tr[start::max((w_tr.shape[0] - start) // 1000, 1)]
            loo = ic.psis_loo(ic.pointwise_log_lik(cfg_t, draws, x_tr, y_tr,
                                                   device=DEVICE))
            zs.append(est.log_z_abs_ss)
            loos.append(float(loo["elpd_loo"]))
            rmses.append(float(res.traces["rmse_test"][-1, 0]))
        n_pilot, n_run = pilot // 16 - 1, MS_STEPS - 1
        want = 2 * (n_pilot + 1) + len(MS_SEEDS) * (n_run + 1)
        check(launch_count("fnn_eval") == want and launch_count(
            "drift_epoch") == 0, f"h={h}: {launch_count('fnn_eval')} eval "
            f"launches, planned {want}")
        evals += want
        band = MS_BANDS[h]
        print(f"[4/6] VR paths: evidence model selection h={h} (d={6 * h + 1})"
              f" in {time.perf_counter() - t0:.1f} s: barrier "
              f"{tuned.barrier:.3f} (band {band['barrier']}), tuned ladder "
              f"{np.round(tuned.temperatures[:-1], 3).tolist()} + inf; per "
              f"seed {MS_SEEDS}: abs log Z (SS) "
              f"{[round(z, 2) for z in zs]} (band {band['log_z_ss']}), "
              f"elpd_loo {[round(x, 2) for x in loos]} "
              f"(band {band['elpd_loo']}), cold test RMSE "
              f"{[round(x, 5) for x in rmses]} (band {band['rmse']}); "
              f"fnn_eval launches {want} (as planned)")
        tag = f"model selection h={h}"
        in_band(tag, "barrier", tuned.barrier, band["barrier"])
        for z, loo, rmse in zip(zs, loos, rmses):
            in_band(tag, "abs log Z", z, band["log_z_ss"])
            in_band(tag, "elpd_loo", loo, band["elpd_loo"])
            in_band(tag, "RMSE", rmse, band["rmse"])
        rows.append((h, float(np.mean(zs)), float(np.mean(loos)),
                     float(np.mean(rmses))))
    by_z = sorted(rows, key=lambda r: -r[1])
    print("[4/6] VR paths: evidence ranking (mean abs log Z, SS): "
          + " > ".join(f"h={h} ({z:.1f}; elpd_loo {loo:.1f}, RMSE "
                       f"{rmse:.4f})" for h, z, loo, rmse in by_z)
          + " (ptnn's results/evidence_model_selection.md: h=6 516.9, "
            "h=2 485.7)")
    return evals


def phase_vr_paths():
    """The variational-reference paths on the card, as subprocesses at
    once: the command lines' --vref --evidence --roundtrip (Sunspot,
    Langevin per step, 10 x 10,000), --no-langevin --vr-rounds 3 --evidence
    and iris --vref --evidence; the single-chain sampler (seeds 0-2); and a
    --vref run checkpointed every 2 chunks, SIGKILLed after its first
    checkpoint. Meanwhile this process runs the uninterrupted twin of the
    killed run and the evidence model selection. Then the iris tree served
    and the killed run resumed, bit for bit. Each run's launches are
    checked against its plan and the phase's total printed; the kernels
    line counts the main path's runs alone, as for the lifecycle phase."""
    import os
    import shutil
    import signal
    import threading
    import types

    import numpy as np

    import ptnn_torch
    from ptnn_torch import checkpoint, config, kernel
    from ptnn_torch.experiments.runner import vref_config

    out = LIFE_OUT.parent / "chip_smoke_vr"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t_phase = time.perf_counter()
    # the run to kill: --vref --evidence at 10 x 2000
    flags = types.SimpleNamespace(vref=True, vr_rounds=0)
    cfg = vref_config(dataclasses.replace(
        ptnn_torch.regression_preset(num_samples=VR_CKPT_SAMPLES,
                                     num_chains=10),
        drift_mode="sequential", n_ladders=1, record_ll_state=True,
        chunk_steps=VR_CKPT_CHUNK).validate(), flags, pt_phase_frac=2.0)
    ck = out / "sunspot_vref.npz"
    ck_cmd = [sys.executable, "-c", CKPT_PROBE,
              json.dumps(config.to_json_dict(cfg)), str(ck), str(CKPT_EVERY)]
    t0 = time.perf_counter()
    procs, walls = {}, {}

    def wall_of(tag):
        procs[tag].wait()
        walls[tag] = time.perf_counter() - t0

    for tag, module, args in VR_CLI_RUNS:
        procs[tag] = popen([sys.executable, "-c", CLI_PROBE,
                            f"ptnn_torch.experiments.{module}", *args,
                            "--no-plots", "--out",
                            str(out / tag.replace(" ", "_"))])
    procs["single chain"] = popen([sys.executable, "-c", SC_PROBE,
                                   str(SC_SAMPLES),
                                   *map(str, SC_SEEDS)])
    victim = popen(ck_cmd)

    def kill_after_a_save():
        while victim.poll() is None and not ck.exists():
            time.sleep(0.01)
        victim.send_signal(signal.SIGKILL)

    threads = [threading.Thread(target=wall_of, args=(tag,))
               for tag in procs] + [threading.Thread(target=kill_after_a_save)]
    for t in threads:
        t.start()
    prob = sunspot()
    reset_launch_counts()
    want = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0,
                             device=DEVICE)  # uninterrupted, meanwhile
    n = cfg.n_steps
    check(launch_count("drift_epoch") == 2 * n
          and launch_count("fnn_eval") == n + 1, f"the VR run: "
          f"{launch_count('drift_epoch')} drifts, {launch_count('fnn_eval')} "
          f"evals, planned {2 * n}, {n + 1}")
    launches = dict(drift_epoch=2 * n, fnn_eval=n + 1)
    launches["fnn_eval"] += model_selection()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "a subprocess hangs")
    runs = {}
    for tag, module, args in VR_CLI_RUNS:
        stdout, stderr = procs[tag].communicate()
        runs[tag] = check_cli_run("[4/6] VR paths", tag, VR_BANDS[tag],
                                  module, args, out / tag.replace(" ", "_"),
                                  stdout, stderr, procs[tag].returncode,
                                  walls[tag])
        for k, v in runs[tag][2].items():
            launches[k] += v
    sc = finished(procs["single chain"], "the single-chain runs")
    sc_lines = sc.strip().splitlines()
    got = json.loads(sc_lines[-1][len("launches "):])
    seeds = [json.loads(x[len("seed "):]) for x in sc_lines
             if x.startswith("seed ")]
    check(len(seeds) == len(SC_SEEDS), "single chain: a seed is missing")
    steps = seeds[0]["n_steps"]
    plan = dict(drift_epoch=2 * steps * len(SC_SEEDS),
                fnn_eval=(steps + 1) * len(SC_SEEDS))
    check(got == plan, f"single chain: launches {got}, planned {plan}")
    for k, v in got.items():
        launches[k] += v
    print(f"[4/6] VR paths: mcmc.single_chain_config('regression', (4, 10, "
          f"1), samples={SC_SAMPLES}) on Sunspot, seeds {SC_SEEDS} "
          f"(ptnn's default 50,000 cut): "
          + "; ".join(f"seed {s['seed']} {s['wall']:.1f} s, accept "
                      f"{s['accept']:.2f}%, test RMSE {s['rmse']:.5f}, "
                      f"{s['inside']:.1f}% of test targets in the 5-95% band,"
                      f" fx_test {s['fx']}" for s in seeds)
          + f" (bands {SC_BANDS}); launches {got} (as planned)")
    for s in seeds:
        check(s["finite"] and s["fx"] == [SC_SAMPLES, 1, 198],
              f"single chain seed {s['seed']}: fx_test {s['fx']}")
        for what in ("accept", "rmse", "inside"):
            in_band(f"single chain seed {s['seed']}", what, s[what],
                    SC_BANDS[what])
    victim.communicate(timeout=60)
    check(victim.returncode == -signal.SIGKILL, f"the VR run to kill ended "
          f"with {victim.returncode} before a checkpoint was seen")
    spec_name = kernel.default_spec(cfg).name
    killed_at = checkpoint.load(str(ck), cfg, 0, spec_name)[1]
    check(0 < killed_at < n, f"killed at step {killed_at}")
    # --- serving the iris tree, resuming the killed run -------------------
    t0 = time.perf_counter()
    served = popen([sys.executable, "-m", "ptnn_torch.predict", "--run",
                    str(runs["iris vref"][0]), "--problem", "iris",
                    "--calibrate", "--ic"])
    resumed = popen(ck_cmd)
    served_line(f"{runs['iris vref'][0].relative_to(ROOT)}", served,
                VR_BANDS["iris vref"]["served"], t0)
    finished(resumed, "the resumed VR run")
    state, done, traces = checkpoint.load(str(ck), cfg, 0, spec_name)
    check(done == n, f"the resumed run's checkpoint at {done}")
    check(set(traces) == set(want.traces) and "vr_corr_cur" in traces,
          f"traces {sorted(traces)}")
    for k, v in traces.items():
        check(np.array_equal(v, want.traces[k][1:]), f"resumed trace {k} "
              f"differs from the uninterrupted run's")
    fin = want.final_state
    for k, v in vars(state).items():
        ref = getattr(fin, k)
        check((v is None) == (ref is None) and (
            v is None or np.array_equal(v.cpu().numpy(), ref.numpy())),
            f"resumed state {k} differs")
    check(state.vr_mean is not None and int(state.n_regen_proposed) > 0,
          "the resumed run has no reference state")
    print(f"[4/6] VR paths: Sunspot --vref per step {cfg.num_chains} x "
          f"{cfg.samples_per_chain}, chunks of {VR_CKPT_CHUNK}, checkpoint "
          f"every {CKPT_EVERY} chunks: SIGKILLed with its last checkpoint at "
          f"step {killed_at}, resumed; every trace ({len(traces)}) and every "
          f"state tensor, vr_mean / vr_m2 / n_regen_* "
          f"({int(state.n_regen_accepted)} of {int(state.n_regen_proposed)}"
          f" regenerations accepted) included, equal the uninterrupted run's"
          f" bit for bit; {os.path.getsize(ck) / 2**20:.2f} MiB")
    print(f"[4/6] VR paths: phase in {time.perf_counter() - t_phase:.1f} s; "
          f"drift_epoch {launches['drift_epoch']} and fnn_eval "
          f"{launches['fnn_eval']} launches, each run as planned")


# ---------------------------------------------------------------------------
# Surrogate-assisted PT and ptnn_torch.auto (PR 14's phase).

# scripts/bench_modes.py:46-68's configuration: Sunspot (4, 10, 1), 64
# chains x 2000 samples, Langevin gradients, maxtemp 5, chunks of 250 (the
# refit interval), record_w off, seed 0; its delayed-acceptance knobs
SURR_SHAPE = (64, 2000)
SURR_KNOBS = dict(use_surrogate=True, surrogate_prob=0.5,
                  surrogate_warmup_frac=0.2, surrogate_buffer=4096,
                  surrogate_proj=64)
SURR_ARMS = {
    "plain": {},
    "anchored": dict(SURR_KNOBS, surrogate_mode="anchored"),
    "da_rw": dict(SURR_KNOBS, surrogate_mode="delayed_acceptance"),
    "da_mala": dict(SURR_KNOBS, surrogate_mode="delayed_acceptance",
                    surrogate_inner="mala"),
    # per-rung rings of 512 rows (the feature dimension is 189)
    "da_per_rung": dict(SURR_KNOBS, surrogate_mode="delayed_acceptance",
                        surrogate_scope="per_chain", surrogate_buffer=512),
    "da_mlp": dict(SURR_KNOBS, surrogate_mode="delayed_acceptance",
                   surrogate_family="mlp"),
}


def surrogate_cfg(arm, chains=SURR_SHAPE[0], samples=SURR_SHAPE[1], **kw):
    """bench_modes.py's base (regression_preset with Langevin gradients at
    maxtemp 5, chunks of 250, record_w off) with the arm's knobs."""
    from ptnn_torch import regression_preset

    base = regression_preset(num_samples=chains * samples, num_chains=chains,
                             use_langevin_gradients=True, maxtemp=5.0)
    fields = dict(chunk_steps=250, record_w=False, **SURR_ARMS[arm])
    fields.update(kw)
    return dataclasses.replace(base, **fields).validate()


def surrogate_stats(res):
    """A run's figures (ptnn's result or the port's): the cold rung's mean
    test RMSE after burn-in, mean and cold accept %, swap %, the segments
    opened and their mean closure acceptance (delayed acceptance)."""
    import numpy as np

    rm = np.asarray(res.traces["rmse_test"])
    b = int(rm.shape[0] * res.config.burn_in)
    acc = np.asarray(res.accept_ratio_per_chain)
    out = dict(rmse=float(rm[b:, 0].mean()), accept=float(acc.mean()),
               cold_accept=float(acc[0]), swap=float(res.swap_percent))
    if res.da_accept_per_chain is not None:
        out.update(segments=int(res.da_segments),
                   seg_accept=float(np.mean(res.da_accept_per_chain)))
    return out


# bands: the mean +- 4 sigma of ptnn's own runs of the arm on the CPU, seeds
# 0-19 (``python tests/test_torch_surrogate_step.py ARM SEED...``), rounded
# outward; PERF.md section 2 gives the means and sigmas
SURR_BANDS = {
    "plain": dict(rmse=(0.0230, 0.0395), accept=(19.9, 21.8),
                  cold_accept=(9.2, 18.5), swap=(58.6, 72.3)),
    "anchored": dict(rmse=(0.0143, 0.0644), accept=(18.4, 23.5),
                     cold_accept=(15.2, 26.1), swap=(67.4, 81.9)),
    "da_rw": dict(rmse=(0.0255, 0.0416), accept=(34.3, 38.2),
                  cold_accept=(26.3, 35.7), swap=(55.1, 72.1),
                  segments=(363, 442), seg_accept=(35.4, 41.3)),
    "da_mala": dict(rmse=(0.0274, 0.0403), accept=(35.4, 43.2),
                    cold_accept=(27.1, 40.3), swap=(53.1, 70.0),
                    segments=(349, 449), seg_accept=(20.9, 30.9)),
    "da_per_rung": dict(rmse=(0.0263, 0.0392), accept=(22.8, 33.8),
                        cold_accept=(13.8, 30.2), swap=(55.1, 72.1),
                        segments=(70, 355), seg_accept=(36.1, 46.7)),
    "da_mlp": dict(rmse=(0.0259, 0.0408), accept=(32.6, 37.1),
                   cold_accept=(23.7, 35.0), swap=(56.9, 71.7),
                   segments=(363, 442), seg_accept=(41.5, 46.2)),
}
SURR_CKPT_PROBE = """
import json, os, signal, sys
import ptnn_torch
from ptnn_torch import checkpoint
from ptnn_torch.config import from_json_dict
from ptnn_torch.data import load_regression
cfg = from_json_dict(json.loads(sys.argv[1]))
if sys.argv[3] == "kill":
    save = checkpoint.save

    def save_then_die(path, state, done, *a, **k):
        save(path, state, done, *a, **k)
        if bool(state.da.active) and done < cfg.n_steps:
            os.kill(os.getpid(), signal.SIGKILL)  # in the middle of a segment

    checkpoint.save = save_then_die
prob = load_regression("Sunspot")
ptnn_torch.sample(cfg, prob.train, prob.test, seed=0, device="cuda",
                  checkpoint_path=sys.argv[2], checkpoint_every=1)
"""
SURR_TILE = (1, 64)  # bench_modes.py --tile: the train rows repeated
# chains, samples, chunk_steps at tile 64: 200 samples in chunks of 50 is
# the shortest run whose delayed-acceptance arm still takes surrogate steps
# (at 100 its fit is not yet trusted)
SURR_TILE_SHAPE = (64, 200, 50)
# results/auto_study.md:5-6's command lines, two subprocesses at once
AUTO_RUNS = (("Sunspot", "quality"), ("iris", "speed"))
AUTO_ARGS = ["--chains", "64", "--steps", "8000", "--replicate", "3"]
AUTO_PILOT = (2, 2000)  # auto_config's pilot: rounds, samples a chain
# ptnn's records (results/auto_study.md, the TPU run): the cold metric
# (mean +- sd over 3 seeds) and the pilot's barrier; the bands widen them
# by the spread of ptnn's own pilot on the CPU, seeds 0-4 (``python
# tests/test_torch_auto.py DATASET TARGET SEED...``), PERF.md section 2
AUTO_REF = {"Sunspot": dict(metric=(0.0090, 0.0003), barrier=3.664),
            "iris": dict(metric=(88.39, 0.12), barrier=2.737)}
AUTO_BANDS = {
    # Sunspot: 0.0090 +- 4 x 0.0003, widened by the pilot's relative spread
    # (sd 0.06 of a 3.78 barrier), under bench's gate; ptnn's pilot, seeds
    # 0-4: 3.704-3.868, 7 x 9 each time
    "Sunspot": dict(metric=(0.0077, 0.0103), barrier=(3.5, 4.05),
                    ladders=(7, 7), rungs=(9, 9)),
    # iris: 88.39 +- 4 x 0.12, widened by 0.5; ptnn's pilot, seeds 0-4:
    # 2.653-2.774, 9 x 7 each time
    "iris": dict(metric=(87.4, 89.4), barrier=(2.5, 2.95), ladders=(9, 9),
                 rungs=(7, 7)),
}
# served from the last seed's tree: Sunspot's RMSE of the posterior mean
# under bench's gate; iris's accuracy of the mean class probabilities, at
# least 43 of the 45 test rows (one row ties, as for mala_fused_16x4)
AUTO_SERVED = {"Sunspot": (0.0, FLAGSHIP_RMSE[1]), "iris": (95.55, 100.0)}


def surrogate_plan(cfg, res):
    """The evals and drifts a surrogate run's host decisions give: one eval
    a true step, one a segment's closure (every segment opened is closed
    once), one a refit's re-anchor (every chunk but the first) and init's;
    two drifts a Langevin step, a true step under delayed acceptance."""
    from ptnn_torch import sampler

    n, switch = cfg.n_steps, cfg.temper_switch_step
    segs = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
    starts = [a + k for a, b in segs
              for k in range(0, b - a, sampler._pick_chunk(
                  b - a, max(1, min(cfg.chunk_steps, n))))]
    true = n - res.surrogate_steps
    if not cfg.use_surrogate:
        return dict(fnn_eval=n + 1 + int(0 < switch < n), drift_epoch=2 * n)
    da = cfg.surrogate_mode == "delayed_acceptance"
    return dict(fnn_eval=true + (res.da_segments if da else 0)
                + len(starts) - 1 + 1,
                drift_epoch=2 * (true if da else n))


def state_arrays(state):
    """A chain state's tensors as flat NumPy arrays (surr.* and da.*)."""
    from ptnn_torch import convert

    out = {}
    for k, v in convert.chain_state_to_numpy(state).items():
        if isinstance(v, dict):
            out |= {f"{k}.{f}": a for f, a in v.items()}
        elif v is not None:
            out[k] = v
    return out


def parse_auto(stdout):
    """The figures of ``python -m ptnn_torch.auto``'s report."""
    import re

    def find(pattern, cast=float):
        m = re.search(pattern, stdout)
        check(m is not None, f"auto: no {pattern!r} in its report")
        return cast(m.group(1).replace(",", ""))

    head = re.search(r"auto-configured PT: (\d+) chains = (\d+) ladder\(s\) "
                     r"x (\d+) rungs, proposal=(\S+)", stdout)
    check(head is not None, "auto: no header line")
    return dict(
        chains=int(head.group(1)), ladders=int(head.group(2)),
        rungs=int(head.group(3)), proposal=head.group(4).rstrip(","),
        fused="fused blocks" in stdout.splitlines()[0],
        metric=find(r"cold test (?:RMSE|acc %): ([0-9.]+)"),
        metric_sd=find(r"cold test (?:RMSE|acc %): [0-9.]+ \+- ([0-9.]+)"),
        rhat=find(r"cross-seed split-R-hat ([0-9.]+)"),
        verdict=find(r"cross-seed split-R-hat [0-9.]+ \((\w+)", str),
        rate=find(r"([0-9,]+) chain-steps/s"),
        barrier=find(r"measured barrier Lambda = ([0-9.]+)"),
        execution=find(r"execution: (.*)", str),
        wall=find(r"total wall-clock \(pilot \+ \d+ runs\): ([0-9.]+) s"),
        launches=json.loads(stdout.strip().splitlines()[-1][len("launches "):]))


def auto_plan(run_dir, got, seeds=None):
    """The launches of an auto run of ``seeds`` seeds (AUTO_ARGS' by
    default): the pilot's per-step MALA (one eval a step and init's, each
    round), then each seed's fused run (one block launch a block, init's
    eval; tempering held, no switch)."""
    from ptnn_torch import fused
    from ptnn_torch.config import from_json_dict

    cfg = from_json_dict(json.loads((run_dir / "config.json").read_text()))
    rounds, samples = AUTO_PILOT
    if seeds is None:
        seeds = int(AUTO_ARGS[AUTO_ARGS.index("--replicate") + 1])
    plan = dict(fnn_eval=rounds * samples + seeds)
    if cfg.fused_step:
        kern = ("mala_cls_block" if cfg.task == "classification"
                else "mala_block") if cfg.proposal == "precond_mala" else (
            "hmc_cls_block" if cfg.task == "classification" else "hmc_block")
        plan[kern] = seeds * sum(len(seg) for seg in fused.block_plan(cfg))
    got = {k: v for k, v in got.items() if v}
    return cfg, plan, got


def phase_surrogate_auto():
    """Surrogate-assisted PT and ptnn_torch.auto on the card. In this
    process: the six surrogate arms at scripts/bench_modes.py's
    configuration (plain, anchored, delayed acceptance with RW and MALA
    inner moves, per-rung fits, the MLP family), each against ptnn's bands
    with its launches held to the plan its host decisions give and, under
    delayed acceptance, its final carried ll to a true eval; chain-steps/s
    of plain, anchored and DA at the data tiled 1 and 64 times. At once, as
    subprocesses: auto's two command lines of results/auto_study.md, and a
    delayed-acceptance run that SIGKILLs itself after a checkpoint saved in
    the middle of a segment; then the auto trees served and the killed run
    resumed, bit for bit against the in-process DA arm. Returns the
    phase's launches for the kernels line."""
    import shutil

    from ptnn_torch import config

    out = LIFE_OUT.parent / "chip_smoke_surrogate"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t_phase = time.perf_counter()
    # the subprocesses: auto's command lines and the run to kill
    procs = {}
    for name, target in AUTO_RUNS:
        procs[name] = popen([sys.executable, "-c", CLI_PROBE,
                             "ptnn_torch.auto", name, "--target", target,
                             *AUTO_ARGS, "--out", str(out / name)])
    procs["Cancer"] = popen([sys.executable, "-c", CLI_PROBE,
                             "ptnn_torch.auto", "Cancer", *AUTO_CANCER_ARGS,
                             "--out", str(out / "Cancer")])
    da_cfg = surrogate_cfg("da_rw")
    ck = out / "da.npz"
    ck_cmd = [sys.executable, "-c", SURR_CKPT_PROBE,
              json.dumps(config.to_json_dict(da_cfg)), str(ck)]
    victim = popen(ck_cmd + ["kill"])
    try:
        return _surrogate_auto(out, procs, victim, da_cfg, ck, ck_cmd, t_phase)
    finally:  # a failed check leaves no subprocess behind
        for p in list(procs.values()) + [victim]:
            if p.poll() is None:
                p.kill()
                p.wait()


def _surrogate_auto(out, procs, victim, da_cfg, ck, ck_cmd, t_phase):
    """The body of ``phase_surrogate_auto`` once its subprocesses run."""
    import os
    import signal

    import numpy as np
    import torch

    import ptnn_torch
    from ptnn_torch import checkpoint, kernel

    # --- the arms, in this process ------------------------------------------
    prob = sunspot()
    launches = dict(drift_epoch=0, fnn_eval=0)
    results = {}
    for arm in SURR_ARMS:
        cfg = surrogate_cfg(arm)
        reset_launch_counts()
        res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0,
                                device=DEVICE)
        got = dict(fnn_eval=launch_count("fnn_eval"),
                   drift_epoch=launch_count("drift_epoch"))
        plan = surrogate_plan(cfg, res)
        check(got == plan, f"surrogate {arm}: launches {got}, planned {plan}")
        for k, v in got.items():
            launches[k] += v
        st = surrogate_stats(res)
        results[arm] = res
        share = 100.0 * res.surrogate_steps / cfg.n_steps
        extra = ""
        if cfg.use_surrogate and cfg.surrogate_mode == "delayed_acceptance":
            fin = res.final_state.to(DEVICE)
            data = ptnn_torch.make_dataset(cfg, prob.train, prob.test,
                                           DEVICE)
            true = kernel.train_loglik(cfg, fin.w, fin.eta, data).cpu()
            carried = res.final_state.ll
            err = float((carried - true).abs().max())
            check(bool(torch.allclose(carried, true, rtol=1e-4, atol=1e-3))
                  and not bool(res.final_state.da.active),
                  f"surrogate {arm}: carried ll off the true ll by {err}")
            extra = f", final carried ll = a true eval (max |diff| {err:.3g})"
        print(f"[4/6] surrogate: {arm} {cfg.num_chains} x "
              f"{cfg.samples_per_chain} (Langevin, chunks of "
              f"{cfg.chunk_steps}): cold test RMSE {st['rmse']:.5f}, accept "
              f"{st['accept']:.2f}% (cold {st['cold_accept']:.2f}%), swap "
              f"{st['swap']:.2f}%"
              + (f", {st['segments']} segments, closures accepted "
                 f"{st['seg_accept']:.2f}%" if "segments" in st else "")
              + f", {share:.1f}% of the steps on the surrogate; "
              f"{res.chain_steps_per_sec:,.0f} chain-steps/s "
              f"({res.elapsed_s:.2f} s); launches {got} (as planned){extra}")
        for what, band in SURR_BANDS.get(arm, {}).items():
            in_band(f"surrogate {arm}", what, st[what], band)
    # --- chain-steps/s with the data tiled ------------------------------------
    rates = {}
    for tile in SURR_TILE:
        if tile == 1:
            rates[tile] = {a: results[a].chain_steps_per_sec
                           for a in ("plain", "anchored", "da_rw")}
            continue
        c, samples, chunk = SURR_TILE_SHAPE
        train = np.tile(prob.train, (tile, 1))
        # a short run first: the kernels' first calls at these rows (plans,
        # shared-memory attributes) are not the arms' to pay
        ptnn_torch.sample(surrogate_cfg("plain", c, 20, chunk_steps=10),
                          train, prob.test, seed=0, device=DEVICE)
        rates[tile] = {}
        for arm in ("plain", "anchored", "da_rw"):
            cfg = surrogate_cfg(arm, c, samples, chunk_steps=chunk)
            res = ptnn_torch.sample(cfg, train, prob.test, seed=0,
                                    device=DEVICE)
            rates[tile][arm] = res.chain_steps_per_sec
            print(f"[4/6] surrogate: {arm} at tile {tile} ({train.shape[0]} "
                  f"train rows) {c} x {samples}, chunks of {chunk}: "
                  f"{res.chain_steps_per_sec:,.0f} chain-steps/s "
                  f"({res.elapsed_s:.2f} s), "
                  f"{100.0 * res.surrogate_steps / cfg.n_steps:.1f}% of the "
                  f"steps on the surrogate")
    print("[4/6] surrogate: chain-steps/s " + json.dumps(
        {f"tile {t}": {a: round(v, 1) for a, v in r.items()}
         for t, r in rates.items()}))
    # --- the killed run, the auto runs ---------------------------------------
    victim.communicate(timeout=600)
    check(victim.returncode == -signal.SIGKILL, f"the DA run to kill ended "
          f"with {victim.returncode}")
    spec_name = kernel.default_spec(da_cfg).name
    st_k, killed_at, _ = checkpoint.load(str(ck), da_cfg, 0, spec_name)
    check(0 < killed_at < da_cfg.n_steps and bool(st_k.da.active),
          f"the DA run was killed at {killed_at}, segment open "
          f"{bool(st_k.da.active)}")
    resumed = procs["resumed"] = popen(ck_cmd + ["resume"])
    auto = {}
    for name, target in AUTO_RUNS:
        stdout = finished(procs[name], f"ptnn_torch.auto {name}")
        fig = parse_auto(stdout)
        run_dir = out / name / f"{name}_0"
        cfg, plan, got = auto_plan(run_dir, fig["launches"])
        check(got == plan, f"auto {name}: launches {got}, planned {plan}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        ref = AUTO_REF[name]
        metric = "test RMSE" if cfg.task == "regression" else "test acc %"
        print(f"[4/6] auto: python -m ptnn_torch.auto {name} --target "
              f"{target} {' '.join(AUTO_ARGS)}: {fig['wall']:.1f} s; pilot "
              f"barrier {fig['barrier']:.3f} (ptnn {ref['barrier']}); "
              f"{fig['ladders']} x {fig['rungs']} = {fig['chains']} chains, "
              f"{fig['proposal']}, execution: {fig['execution']}; cold "
              f"{metric} {fig['metric']} +- {fig['metric_sd']} (ptnn "
              f"{ref['metric'][0]} +- {ref['metric'][1]}); R-hat "
              f"{fig['rhat']:.3f} ({fig['verdict']}); "
              f"{fig['rate']:,.0f} chain-steps/s; launches {got} (as "
              f"planned)")
        check(fig["fused"] and cfg.fused_step, f"auto {name} did not fuse: "
              f"{fig['execution']}")
        for what, band in AUTO_BANDS.get(name, {}).items():
            in_band(f"auto {name}", what, fig[what], band)
        auto[name] = (run_dir, fig)
    for k, v in check_auto_cancer(finished(procs["Cancer"],
                                           "ptnn_torch.auto Cancer"),
                                  out / "Cancer").items():
        launches[k] = launches.get(k, 0) + v
    # --- serving the auto trees, the resumed run ------------------------------
    t0 = time.perf_counter()
    served = {name: popen([sys.executable, "-m", "ptnn_torch.predict",
                           "--run", str(auto[name][0]), "--problem", name,
                           "--calibrate", "--ic"]) for name, _t in AUTO_RUNS}
    procs.update({f"served {k}": v for k, v in served.items()})
    for name, _t in AUTO_RUNS:
        served_line(f"{auto[name][0].relative_to(ROOT)}", served[name],
                    AUTO_SERVED[name], t0)
    finished(resumed, "the resumed DA run")
    state, done, traces = checkpoint.load(str(ck), da_cfg, 0, spec_name)
    want = results["da_rw"]
    check(done == da_cfg.n_steps, f"the resumed run's checkpoint at {done}")
    check(set(traces) == set(want.traces), f"traces {sorted(traces)}")
    for k, v in traces.items():
        check(np.array_equal(v, want.traces[k][1:]), f"resumed trace {k} "
              f"differs from the uninterrupted run's")
    a, b = state_arrays(state), state_arrays(want.final_state)
    check(set(a) == set(b), f"resumed state fields {sorted(set(a) ^ set(b))}")
    for k in a:
        check(np.array_equal(a[k], b[k]), f"resumed state {k} differs")
    print(f"[4/6] surrogate: da_rw {da_cfg.num_chains} x "
          f"{da_cfg.samples_per_chain}, checkpoint every chunk: SIGKILLed "
          f"after its checkpoint at step {killed_at} with a segment open, "
          f"resumed; every trace ({len(traces)}) and every state tensor "
          f"({len(a)}: the ring, the fit, the segment) equal the "
          f"uninterrupted arm's bit for bit; "
          f"{os.path.getsize(ck) / 2**20:.2f} MiB")
    print(f"[4/6] surrogate and auto: phase in "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches



# ---------------------------------------------------------------------------
# The grids of ptnn_torch.sweeps: the regression grid of
# scripts/grid_parity.py:49-59 (the seven series x RW, LG-0.01, LG-0.1, 10
# chains a cell, maxtemp 5, swap ratio 0.01: 210 chains) at 10,000 samples
# (cut from 100,000), the classification small bucket of
# scripts/cls_grid.py:38,64-73 (iris, Ionosphere, Cancer x seeds 0-4: 150
# chains in the (34, 50, 3) envelope) in RW and in legacy LG at 5,000
# samples (cut from 50,000), and the big bucket (bank-additional, PenDigit,
# chess) in batch drift mode for 500 steps, a shape check.
GRID_REG_NAMES = ("Lazer", "Sunspot", "Mackey", "Lorenz", "Rossler", "Henon",
                  "ACFinance")
GRID_REG_SAMPLES = 10_000
GRID_CLS_SMALL = ("iris", "Ionosphere", "Cancer")
GRID_CLS_BIG = ("bank-additional", "PenDigit", "chess")
GRID_CLS_SAMPLES = 5_000
GRID_BIG_STEPS = 500
GRID_SEEDS = (0, 1, 2, 3, 4)
# the grid routes' comparison with their plain versions (the issue's
# figures): floats within G_RTOL of each chain's scale and G_ATOL, ll within
# G_LL_RTOL of its terms, rmse within G_RTOL, acc exact
G_RTOL, G_ATOL, G_LL_RTOL = 2e-4, 2e-5, 1e-4
# the grids' bands: mean +- 4 sigma of ptnn's own run of the same call at
# the same depth on the CPU, by cell, over 20 seeds (python
# tests/test_torch_sweeps.py regression 0 ... 19; for the classification
# grids, cls-rw / cls-lg 0 ... 19: one run whose 20 seeds are each set's
# replicates, the band a set's), rounded outward to the digits printed:
# (lo, hi) of test_mean, accept_pct, swap_pct
GRID_BANDS = {
    ("reg", ("Lazer", "rw")): ((0.03302, 0.19538), (40.03, 46.41), (20.17, 59.73)),
    ("reg", ("Lazer", "lg001")): ((-0.01515, 0.24487), (31.77, 47.37), (19.76, 64.53)),
    ("reg", ("Lazer", "lg01")): ((0.00932, 0.29027), (20.21, 24.34), (5.46, 51.16)),
    ("reg", ("Sunspot", "rw")): ((-0.07989, 0.25225), (27.98, 43.37), (22.05, 63.15)),
    ("reg", ("Sunspot", "lg001")): ((-0.03865, 0.24552), (24.17, 30.84), (18.26, 61.32)),
    ("reg", ("Sunspot", "lg01")): ((0.0253, 0.32042), (19.91, 25.22), (3.9, 41.83)),
    ("reg", ("Mackey", "rw")): ((-0.04563, 0.16353), (21.29, 37.06), (31.8, 59.59)),
    ("reg", ("Mackey", "lg001")): ((-0.02208, 0.0984), (18.05, 30.47), (35.03, 59.24)),
    ("reg", ("Mackey", "lg01")): ((-0.06637, 0.19291), (15.2, 21.64), (19.29, 65.32)),
    ("reg", ("Lorenz", "rw")): ((-0.02327, 0.16099), (24.61, 41.93), (31.3, 55.51)),
    ("reg", ("Lorenz", "lg001")): ((-0.04465, 0.18125), (21.08, 28.92), (23.04, 62.29)),
    ("reg", ("Lorenz", "lg01")): ((-0.00919, 0.29341), (18.06, 24.43), (8.63, 47.91)),
    ("reg", ("Rossler", "rw")): ((-0.00037, 0.18681), (29.53, 38.57), (28.0, 56.78)),
    ("reg", ("Rossler", "lg001")): ((-0.0368, 0.20337), (24.13, 31.76), (26.74, 60.7)),
    ("reg", ("Rossler", "lg01")): ((0.0443, 0.29424), (18.19, 24.0), (2.84, 55.61)),
    ("reg", ("Henon", "rw")): ((0.13271, 0.20222), (37.0, 43.17), (38.99, 64.7)),
    ("reg", ("Henon", "lg001")): ((0.08265, 0.25044), (33.5, 45.71), (33.13, 74.87)),
    ("reg", ("Henon", "lg01")): ((0.10616, 0.2863), (18.99, 24.37), (26.42, 64.26)),
    ("reg", ("ACFinance", "rw")): ((-0.02204, 0.19038), (28.7, 45.29), (23.28, 57.16)),
    ("reg", ("ACFinance", "lg001")): ((-0.03039, 0.12454), (24.13, 34.11), (29.0, 60.58)),
    ("reg", ("ACFinance", "lg01")): ((0.03558, 0.24967), (19.47, 24.72), (11.36, 45.61)),
    ("cls-rw", "iris"): ((22.40324, 60.80699), (90.78, 95.04), (65.35, 83.4)),
    ("cls-rw", "Ionosphere"): ((7.26938, 110.78163), (85.12, 92.0), (62.87, 83.34)),
    ("cls-rw", "Cancer"): ((53.40099, 97.3206), (80.71, 90.61), (62.59, 77.91)),
    ("cls-lg", "iris"): ((77.823, 94.32438), (96.93, 98.52), (19.23, 61.86)),
    ("cls-lg", "Ionosphere"): ((69.17039, 101.70972), (93.2, 95.92), (26.0, 54.34)),
    ("cls-lg", "Cancer"): ((98.52962, 99.18272), (95.61, 98.01), (27.79, 63.27)),
}


def card_line():
    """nvidia-smi's "name, power.limit" line of the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def reg_grid_cfg(samples=GRID_REG_SAMPLES):
    import dataclasses

    import ptnn_torch

    return dataclasses.replace(
        ptnn_torch.regression_preset(num_samples=samples, maxtemp=5.0,
                                     num_chains=10, swap_ratio=0.01),
        chunk_steps=1000).validate()


def cls_grid_cfg(legacy, samples=GRID_CLS_SAMPLES, drift="sequential"):
    import dataclasses

    import ptnn_torch

    return dataclasses.replace(
        ptnn_torch.classification_preset((1, 1, 1), num_samples=samples,
                                         legacy_lg=legacy),
        chunk_steps=500, drift_mode=drift)


def grid_datasets():
    """The grids' rows on the card, as ``ptnn_torch.sweeps`` builds them:
    the regression grid's 21 cells (ACFinance's 238 rows padded to 298) and
    the small bucket's 15 in the (34, 50, 3) envelope."""
    import dataclasses

    from ptnn_torch import data, sampler, sweeps

    cfg = reg_grid_cfg()
    probs = {n: data.load_regression(n) for n in GRID_REG_NAMES}
    cells = [(n, m) for n in GRID_REG_NAMES for m in sweeps.REGRESSION_MODES]
    reg = sampler.make_grid_dataset(
        cfg, [(probs[n].train, probs[n].test, cfg.topology)
              for n, _m in cells], DEVICE)
    lr = [sweeps.REGRESSION_MODES[m][1] for _n, m in cells]
    cls_probs = {n: data.load_classification(n) for n in GRID_CLS_SMALL}
    env = tuple(max(p.topology[k] for p in cls_probs.values())
                for k in range(3))
    ccfg = dataclasses.replace(cls_grid_cfg(True), topology=env)
    cls = sampler.make_grid_dataset(
        ccfg, [(cls_probs[n].train, cls_probs[n].test, cls_probs[n].topology)
               for n in GRID_CLS_SMALL for _s in GRID_SEEDS], DEVICE,
        envelope=True)
    return (cfg, reg, lr), (ccfg, cls)


def grid_bound(topo, c, rows, nbytes, per_row):
    """(bound ms, by) of a grid route: this run's rows (the valid rows of
    each chain's cell) times ``per_row`` operations, its bytes."""
    ops = sum(c // len(rows) * r for r in rows) * per_row
    return bound(ops, nbytes)


def phase_grid_kernels():
    """The grid routes of the drift and eval kernels (a rate a chain, each
    cell's rows, row and class counts, the parameter mask) against their
    plain versions at the grids' shapes, and their device time (a CUDA
    graph) beside the one-dataset route's at the same chain count. Returns
    (drift err, eval err, times)."""
    import math

    import numpy as np
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import block_step, drift, fnn_eval

    (cfg, reg, lr_cells), (ccfg, cls) = grid_datasets()
    rng = np.random.default_rng(53)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    times = {}
    d_err = e_err = 0.0
    # the drift: (label, topology, w, x, t, rate, rows, w_mask, the
    # one-dataset route's x and t at the same chains)
    topo, env = cfg.topology, ccfg.topology
    c_reg = reg.cells * 10
    w_reg = f(rng.normal(size=(c_reg, fnn.w_size(topo))))
    lr = f(np.repeat(lr_cells, 10))
    wm = drift.per_chain(cls.w_mask, cls.cells * 10)
    w_cls = f(rng.normal(size=(cls.cells * 10, fnn.w_size(env))) * 0.5) * wm
    sun_x, sun_t = reg.x_train[1], reg.t_train[1]  # Sunspot's rows
    cases = [
        ("a rate a chain", topo, w_reg, sun_x, sun_t, lr, None, None,
         (sun_x, sun_t)),
        ("each cell's rows", topo, w_reg, reg.x_train, reg.t_train, lr,
         reg.rows_train, None, (sun_x, sun_t)),
        ("the envelope's mask", env, w_cls, cls.x_train, cls.t_train, 0.01,
         cls.rows_train, cls.w_mask,
         (cls.x_train[-1], cls.t_train[-1])),  # Cancer's 489 rows
    ]
    for label, net, w, x, t, rate, rows, mask, shared in cases:
        kind = drift.variant(net)[0]
        before = drift.launches
        got = drift.sgd_epoch(w, x, t, net, rate, rows=rows, w_mask=mask)
        check(drift.launches == before + 1,
              f"drift grid {label}: {drift.launches - before} launches")
        want = drift.sgd_epoch_sequential(w, x, t, net, rate, 1, rows, mask)
        torch.cuda.synchronize()
        scale = want.abs().amax(dim=-1, keepdim=True)
        diff = (got - want).abs()
        bad = int((diff > G_ATOL + G_RTOL * scale).sum())
        check(bad == 0, f"drift grid {label}: {bad} entries off, max |diff| "
              f"{float(diff.max()):.3g}")
        check(float((want - w).abs().max()) > 1e-3,
              f"drift grid {label}: the epoch did not move w")
        zeros = ""
        if mask is not None:
            off = drift.per_chain(mask, w.shape[0]) == 0
            check(bool((got[off] == 0).all()),
                  f"drift grid {label}: a masked parameter moved")
            zeros = f", its {int(off.sum())} masked entries exactly 0"
        d_err = max(d_err, float(diff.max()))
        grid_ms = graph_ms(lambda: drift.sgd_epoch(
            w, x, t, net, rate, rows=rows, w_mask=mask), calls=20)
        one_ms = graph_ms(lambda: drift.sgd_epoch(
            w, *shared, net, 0.01), calls=20)
        plain_ms = time_ms(lambda: drift.sgd_epoch_sequential(
            w, x, t, net, rate, 1, rows, mask), reps=1, warm=0)
        n_rows = ([x.shape[-2]] if rows is None else rows.tolist())
        nbytes = 4 * (2 * w.numel() + x.numel() + t.numel()
                      + (0 if mask is None else mask.numel()))
        b_ms, by = grid_bound(net, w.shape[0], n_rows, nbytes,
                              drift_ops(net, 1, 1, 1))
        times[f"drift {label}"] = (grid_ms, one_ms, plain_ms, b_ms, by)
        print(f"[3/6] kernel: drift_epoch grid route, {label}: {net} "
              f"({kind} kernel) C={w.shape[0]} rows {n_rows[:3]}"
              f"{'...' if len(n_rows) > 3 else ''}: w within rtol {G_RTOL} "
              f"of each chain's scale, atol {G_ATOL} (max |diff| "
              f"{float(diff.max()):.3g}){zeros}; device {grid_ms:.4f} ms a "
              f"launch (CUDA graph), the one-dataset route at the same "
              f"chains {one_ms:.4f} ms; plain version {plain_ms:.3f} ms; "
              f"bound {b_ms:.6f} ms ({by})")
    # the eval pair: each cell's train and test rows in one launch
    for label, net, task, data, c in (
            ("the regression grid", topo, "regression", reg, c_reg),
            ("the envelope", env, "classification", cls,
             cls.cells * 10)):
        w = (w_reg if task == "regression" else w_cls)
        tau = f(rng.uniform(0.01, 0.2, size=c))
        classes = data.classes if task == "classification" else None
        args = (w, data.x_train, data.y_train, data.x_test, data.y_test, tau,
                net, task, data.rows_train, data.rows_test, classes)
        before = fnn_eval.launches
        got = fnn_eval.fnn_eval_pair(*args)
        check(fnn_eval.launches == before + 1,
              f"fnn_eval grid {label}: {fnn_eval.launches - before} launches")
        want = fnn_eval.fnn_eval_pair_reference(*args)
        torch.cuda.synchronize()
        worst, n_fragile = 0.0, 0
        for (ll, rmse, acc), (r_ll, r_rmse, r_acc), x, rows in zip(
                got, want, (data.x_train, data.x_test),
                (data.rows_train, data.rows_test)):
            n = rows.repeat_interleave(c // data.cells).to(torch.float32)
            if task == "regression":
                terms = (0.5 * n * torch.log(2 * math.pi * tau).abs()
                         + 0.5 * n * r_rmse ** 2 / tau)
                check(not bool(acc.any()), f"{label}: acc not 0")
            else:
                terms = r_ll.abs()
                sure = torch.ones_like(acc, dtype=torch.bool)
                cpc = c // data.cells
                for k, r in enumerate(rows.tolist()):
                    sl = slice(k * cpc, (k + 1) * cpc)
                    sure[sl] = ~block_step.argmax_fragile(
                        w[sl], x[k, :r], net,
                        classes=int(data.classes[k]))
                n_fragile += int((~sure).sum())
                check(torch.equal(acc[sure], r_acc[sure]),
                      f"fnn_eval grid {label}: acc differs")
            check(bool(((rmse - r_rmse).abs()
                        <= G_ATOL + G_RTOL * r_rmse).all()),
                  f"fnn_eval grid {label}: rmse")
            diff = (ll - r_ll).abs()
            check(bool((diff <= G_ATOL + G_LL_RTOL * terms).all()),
                  f"fnn_eval grid {label}: ll off, max |diff| "
                  f"{float(diff.max()):.3g}")
            worst = max(worst, float(diff.max()))
        e_err = max(e_err, worst)
        grid_ms = graph_ms(lambda: fnn_eval.fnn_eval_pair(*args))
        plain_ms = time_ms(lambda: fnn_eval.fnn_eval_pair_reference(*args),
                           reps=3, warm=1)
        shared = (w, data.x_train[-1], data.y_train[-1], data.x_test[-1],
                  data.y_test[-1], tau, net, task)
        one_ms = graph_ms(lambda: fnn_eval.fnn_eval_pair(*shared))
        rows_all = [a + b for a, b in zip(data.rows_train.tolist(),
                                          data.rows_test.tolist())]
        nbytes = 4 * (w.numel() + c + 6 * c + data.x_train.numel()
                      + data.x_test.numel() + data.y_train.numel()
                      + data.y_test.numel())
        b_ms, by = grid_bound(net, c, rows_all, nbytes,
                              row_ops(net, task == "classification", False))
        times[f"eval {label}"] = (grid_ms, one_ms, plain_ms, b_ms, by)
        metrics = ("rmse within rtol 2e-4" if task == "regression" else
                   f"acc exact outside {n_fragile} chains with fragile "
                   f"argmaxes, rmse within rtol 2e-4")
        print(f"[3/6] kernel: fnn_eval grid route, {label} pair: {net} C={c} "
              f"in {data.cells} cells, rows {data.rows_train.tolist()[:3]}.../"
              f"{data.rows_test.tolist()[:3]}...: ll within rtol {G_LL_RTOL} "
              f"of its terms (max |diff| {worst:.3g}), {metrics}; device "
              f"{grid_ms:.4f} ms a launch (CUDA graph), the one-dataset route "
              f"at the same chains {one_ms:.4f} ms; plain version "
              f"{plain_ms:.3f} ms; bound {b_ms:.6f} ms ({by})")
    return d_err, e_err, times


# The wide networks (ROADMAP Queue 3, F1: the drift and eval kernels took at
# most 128 hidden units, 32 outputs and four chains' weights beside a 64 KB
# tile): (label, topology, task, chains, train rows, test rows; None:
# Sunspot's own). (784, 80, 10) passes a block with one chain's weights (the
# weights in device memory), (3000, 8, 3) stages its inputs a tile at a time.
WIDE_CASES = (("Sunspot", (4, 200, 1), "regression", 64, None, None),
              ("synthetic", (784, 16, 10), "classification", 64, 1000, 200),
              ("synthetic", (16, 20, 40), "classification", 64, 300, 100),
              ("synthetic", (784, 80, 10), "classification", 8, 200, 50),
              ("synthetic", (3000, 8, 3), "classification", 4, 100, 40))
WIDE_STEP = (64, 500)  # the per-step Langevin run at (4, 200, 1)


def wide_inputs(label, topo, task, c, n_tr, n_te, rng):
    """Weights (C, W), standard normal with W1 at 2 / sqrt(I) at most (the
    hidden sigmoids out of saturation, the epoch moves w, and the outputs
    apart), the delta-rule targets and both row sets on the card: Sunspot's
    rows or seeded rows in [0, 1) with seeded labels."""
    import numpy as np
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import drift

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                  device=DEVICE).contiguous()
    i, _h, o = topo
    if label == "Sunspot":
        prob = sunspot()
        tr, te = prob.train, prob.test
    else:
        def rows(n):
            y = rng.integers(0, o, size=n) if task == "classification" \
                else rng.uniform(size=n)
            return np.hstack([rng.uniform(size=(n, i)), y[:, None]])
        tr, te = rows(n_tr), rows(n_te)
    w = rng.normal(size=(c, fnn.w_size(topo)))
    w[:, :i * topo[1]] *= min(1.0, 2 / i ** 0.5)
    w = f(w)
    train, test = (f(tr[:, :i]), f(tr[:, i])), (f(te[:, :i]), f(te[:, i]))
    t = drift.make_targets(train[1], o, task).contiguous()
    return w, t, train, test


def phase_wide_kernels():
    """The drift and eval kernels on the wide networks (F1) against their
    plain versions on the card, with the route each call takes and its
    device time beside the plain version's and the bound; then the
    per-step Langevin run at (4, 200, 1). Returns (drift err, eval err,
    times)."""
    import math

    import numpy as np
    import torch

    from ptnn_torch.ops import block_step, drift, fnn_eval

    rng = np.random.default_rng(59)
    d_err = e_err = 0.0
    times = {}
    for label, topo, task, c, n_tr, n_te in WIDE_CASES:
        w, t, train, test = wide_inputs(label, topo, task, c, n_tr, n_te,
                                        rng)
        x = train[0]
        n = x.shape[0]
        # --- the drift epoch ---------------------------------------------
        lay = drift.plan(c, n, 1, topo)
        before = drift.launches, dict(drift.route_launches)
        got = drift.sgd_epoch(w, x, t, topo, 0.01, mode="pallas")
        check(drift.launches == before[0] + 1
              and drift.route_launches[lay.weights]
              == before[1][lay.weights] + 1,
              f"drift {topo}: not one launch by the {lay.weights} route")
        want = drift.sgd_epoch_sequential(w, x, t, topo, 0.01)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"drift {topo}: not finite")
        scale = want.abs().amax(dim=-1, keepdim=True)
        diff = (got - want).abs()
        bad = int((diff > G_ATOL + G_RTOL * scale).sum())
        check(bad == 0, f"drift {topo}: {bad} entries off, max |diff| "
              f"{float(diff.max()):.3g}")
        moved = float((want - w).abs().max())
        check(moved > 1e-4, f"drift {topo}: the epoch did not move w")
        d_err = max(d_err, float(diff.max()))
        d_ms = time_ms(lambda: drift.sgd_epoch(w, x, t, topo, 0.01,
                                               mode="pallas"), reps=5)
        d_plain = time_ms(lambda: drift.sgd_epoch_sequential(
            w, x, t, topo, 0.01), reps=1, warm=0)
        d_b, d_by = bound(drift_ops(topo, c, n, 1),
                          4 * (2 * w.numel() + x.numel() + t.numel()))
        times[f"drift {topo}"] = (d_ms, d_plain, d_b, d_by)
        print(f"[3/6] kernel: drift_epoch wide {label} {topo} C={c} N={n}: "
              f"the {lay.kind} kernel, {lay.chains_per_block} chains a "
              f"block, weights in {lay.weights} memory, tiles of "
              f"{lay.tile_rows} rows, {lay.smem} bytes of shared memory; w "
              f"within rtol {G_RTOL} of each chain's scale, atol {G_ATOL} "
              f"(max |diff| {float(diff.max()):.3g}; the epoch moved w by "
              f"up to {moved:.3g}); {d_ms:.4f} ms a launch, plain version "
              f"{d_plain:.2f} ms, bound {d_b:.6f} ms ({d_by})")
        # --- the eval pair ---------------------------------------------------
        tau = torch.as_tensor(rng.uniform(0.01, 0.2, size=c),
                              dtype=torch.float32, device=DEVICE)
        plan = fnn_eval.launch_plan(c, (n, test[0].shape[0]), topo)
        args = (w, *train, *test, tau, topo, task)
        before = fnn_eval.launches
        got = fnn_eval.fnn_eval_pair(*args)
        check(fnn_eval.launches == before + 1,
              f"fnn_eval {topo}: {fnn_eval.launches - before} launches")
        want = fnn_eval.fnn_eval_pair_reference(*args)
        torch.cuda.synchronize()
        worst, n_fragile = 0.0, 0
        for (ll, rmse, acc), (r_ll, r_rmse, r_acc), (xs, _y) in zip(
                got, want, (train, test)):
            m = xs.shape[0]
            if task == "regression":
                terms = (0.5 * m * torch.log(2 * math.pi * tau).abs()
                         + 0.5 * m * r_rmse ** 2 / tau)
                check(bool(((rmse - r_rmse).abs()
                            <= G_ATOL + G_RTOL * r_rmse).all()),
                      f"fnn_eval {topo}: rmse")
                check(not bool(acc.any()), f"fnn_eval {topo}: acc not 0")
            else:
                terms = r_ll.abs()
                sure = ~block_step.argmax_fragile(w, xs, topo)
                n_fragile += int((~sure).sum())
                check(int((~sure).sum()) <= max(1, 0.1 * c),
                      f"fnn_eval {topo}: {int((~sure).sum())} chains with "
                      f"fragile argmaxes")
                check(torch.equal(acc[sure], r_acc[sure])
                      and torch.equal(rmse[sure], r_rmse[sure]),
                      f"fnn_eval {topo}: acc or rmse differs")
            diff = (ll - r_ll).abs()
            check(bool((diff <= G_ATOL + G_LL_RTOL * terms).all()),
                  f"fnn_eval {topo}: ll off, max |diff| "
                  f"{float(diff.max()):.3g}")
            worst = max(worst, float(diff.max()))
        e_err = max(e_err, worst)
        e_ms = graph_ms(lambda: fnn_eval.fnn_eval_pair(*args), calls=20)
        e_plain = time_ms(lambda: fnn_eval.fnn_eval_pair_reference(*args),
                          reps=3, warm=1)
        rows = n + test[0].shape[0]
        e_b, e_by = bound(c * rows * row_ops(topo, task == "classification",
                                             False),
                          4 * (w.numel() + 7 * c + rows * (topo[0] + 1)))
        times[f"eval {topo}"] = (e_ms, e_plain, e_b, e_by)
        metrics = (f"rmse within rtol {G_RTOL}" if task == "regression" else
                   f"acc and rmse exact outside {n_fragile} chains with "
                   f"fragile argmaxes")
        chunks = -(-topo[2] // plan.out_chunk)
        print(f"[3/6] kernel: fnn_eval wide {label} {topo} C={c} N={n} + "
              f"{test[0].shape[0]}, one launch: clusters of {plan.cluster} "
              f"blocks, {plan.row_groups} x {plan.hid_groups} warps, weights "
              f"{'in device memory' if plan.w_global else 'staged'}, inputs "
              f"{plan.in_tile} of {topo[0]} a stage, {chunks} output "
              f"chunk(s) of {plan.out_chunk}, {plan.smem} bytes of shared "
              f"memory; ll within rtol {G_LL_RTOL} of its terms (max |diff| "
              f"{worst:.3g}), {metrics}; device {e_ms:.4f} ms a launch (CUDA "
              f"graph), plain version {e_plain:.3f} ms, bound {e_b:.6f} ms "
              f"({e_by})")
    # --- the per-step Langevin run at (4, 200, 1) -----------------------------
    c, samples = WIDE_STEP
    cfg = lg_cfg(c, samples, topology=(4, 200, 1))
    res, got = run_per_step_counted(cfg, sunspot())
    for name in ("ll", "rmse_train", "rmse_test", "accept_count"):
        check(np.isfinite(res.traces[name]).all(), f"(4, 200, 1) {name}")
    st = per_step_stats(cfg, res)
    check(0.0 < st["mean_accept"] < 100.0 and 0.0 < st["langevin"] < 100.0,
          "(4, 200, 1): accepted all or nothing")
    ms = 1e3 * res.elapsed_s / cfg.n_steps
    print(f"[3/6] kernel: per-step Langevin Sunspot (4, 200, 1) {c} x "
          f"{samples} ({card_line()}): {ms:.3f} ms a step, "
          f"{res.chain_steps_per_sec:,.0f} chain-steps/s incl. trace fetch; "
          f"cold test RMSE {st['cold_rmse']:.5f}, mean accept "
          f"{st['mean_accept']:.2f}%, swap {st['swap']:.2f}%, Langevin "
          f"{st['langevin']:.2f}%; launches drift_epoch "
          f"{got['drift_epoch']} (generic kernel, {drift.route_launches}), "
          f"fnn_eval {got['fnn_eval']} (as planned: 2 and 1 a step + 2)")
    return d_err, e_err, times


def grid_counted(fn, *args, **kw):
    """One grid through its entry point with every launch count set to 0
    just before it: (output, launches by kernel, wall s)."""
    import torch

    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, device=DEVICE, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {name: launch_count(name) for name in KERNELS}, wall


def grid_plan(cfg, got, batch=False):
    """The launches a grid of ``cfg`` plans: with Langevin gradients 2 drift
    epochs a step for every cell at once (none in batch mode: plain
    products), 1 eval pair a step for every cell, and init's and the temper
    switch's train-row evals."""
    n = cfg.n_steps
    want = {name: 0 for name in KERNELS}
    want["drift_epoch"] = 2 * n if cfg.use_langevin_gradients and \
        not batch else 0
    want["fnn_eval"] = n + 1 + int(0 < cfg.temper_switch_step < n)
    check(got == want, f"grid launches {got}, planned {want}")
    return want


def grid_in_bands(tag, out, bands_of):
    """Every cell's test_mean, accept_pct and swap_pct inside its band;
    one line a grid with each metric's worst cell."""
    import numpy as np

    worst = {}
    for k, cell in enumerate(out["cells"]):
        band = bands_of(cell)
        for m, (lo, hi) in zip(("test_mean", "accept_pct", "swap_pct"), band):
            v = float(out[m][k])
            check(lo <= v <= hi, f"{tag} {cell}: {m} {v:.5g} outside "
                  f"({lo}, {hi})")
            # the distance to the nearer edge as a share of the half-width
            edge = min(v - lo, hi - v) / max((hi - lo) / 2, 1e-12)
            if m not in worst or edge < worst[m][0]:
                worst[m] = (edge, cell, v, (lo, hi))
    return "; ".join(
        f"{m} closest to its band's edge: {cell} {v:.5g} in {band}"
        for m, (_e, cell, v, band) in worst.items()), np.mean(
            out["test_mean"])


# phase_sweeps' regression grid, which phase_grid_vref holds the parity
# runner against when both run in one process
SWEEPS_REG_OUT = []


def phase_sweeps():
    """The sweeps on the card through ``ptnn_torch.sweeps``: the regression
    grid, the small bucket in RW and legacy LG, each cell inside ptnn's
    band and launches exactly the plan; the Sunspot lg01 cell against the
    port's single per-step run of its stream (accept and swap counts
    equal, statistics within G_RTOL); the big bucket in batch drift mode,
    500 steps, finite and launches as planned. Returns the launches of the
    grids by kernel."""
    import numpy as np

    import ptnn_torch
    from ptnn_torch import data, sweeps
    from ptnn_torch.ops import drift

    t_phase = time.perf_counter()
    card = card_line()
    total = {name: 0 for name in KERNELS}
    cfg = reg_grid_cfg()
    out, got, wall = grid_counted(sweeps.dataset_grid, cfg,
                                  list(GRID_REG_NAMES), seed=0)
    SWEEPS_REG_OUT.append(out)
    grid_plan(cfg, got)
    check(drift.variant_launches["register"] == got["drift_epoch"],
          f"regression grid drift by kernel {drift.variant_launches}")
    verdict, _ = grid_in_bands("regression grid", out,
                               lambda cell: GRID_BANDS["reg", tuple(cell)])
    rate = len(out["cells"]) * cfg.num_chains * cfg.n_steps / wall
    for name, n in got.items():
        total[name] += n
    print(f"[4/6] sweeps: dataset_grid {len(out['cells'])} cells x "
          f"{cfg.num_chains} chains x {cfg.samples_per_chain} samples in "
          f"{wall:.2f} s ({rate:.0f} chain-steps/s; {card}): every cell's "
          f"test_mean, accept_pct, swap_pct inside ptnn's band ({verdict}); "
          f"launches {got} (as planned: one drift launch a drift and one "
          f"eval pair a step for the whole grid)")
    # the Sunspot lg01 cell against its own single run
    k = out["cells"].index(("Sunspot", "lg01"))
    seed = sweeps.cell_seeds(0, len(out["cells"]))[k]
    prob = data.load_regression("Sunspot")
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                            device=DEVICE)
    s = cfg.samples_per_chain
    n_acc = int(round(float(out["accept_pct"][k]) * s * cfg.num_chains
                      / 100.0))
    check(n_acc == int(res.final_state.n_accept.sum()),
          f"lg01 cell: {n_acc} accepts, its single run "
          f"{int(res.final_state.n_accept.sum())}")
    check(float(out["swap_pct"][k]) == res.swap_percent,
          f"lg01 cell: swap {out['swap_pct'][k]}, single {res.swap_percent}")
    burn = int(s * cfg.burn_in)
    kept = {"test": res.traces["rmse_test"][burn:],
            "train": res.traces["rmse_train"][burn:]}
    for part, v in kept.items():
        for stat, want in (("mean", v.mean(dtype=np.float64)),
                           ("best", v.min())):
            g = float(out[f"{part}_{stat}"][k])
            check(abs(g - want) <= G_ATOL + G_RTOL * abs(want),
                  f"lg01 cell {part}_{stat} {g} against its single run "
                  f"{want}")
    print(f"[4/6] sweeps: the Sunspot lg01 cell against the single "
          f"per-step run of its seed ({seed}, 10 chains x {s}): {n_acc} "
          f"accepts each, swap {res.swap_percent:.4f} % each, test mean "
          f"{float(out['test_mean'][k]):.6f} / "
          f"{float(kept['test'].mean()):.6f}, best "
          f"{float(out['test_best'][k]):.6f} / {float(kept['test'].min()):.6f}")
    for legacy in (False, True):
        mode = "lg" if legacy else "rw"
        ccfg = cls_grid_cfg(legacy)
        out, got, wall = grid_counted(sweeps.classification_grid, ccfg,
                                      list(GRID_CLS_SMALL), seeds=GRID_SEEDS)
        grid_plan(ccfg, got)
        verdict, _ = grid_in_bands(
            f"classification grid {mode}", out,
            lambda cell: GRID_BANDS["cls-" + mode, cell[0]])
        for name, n in got.items():
            total[name] += n
        rate = len(out["cells"]) * ccfg.num_chains * ccfg.n_steps / wall
        print(f"[4/6] sweeps: classification_grid small bucket "
              f"{'legacy LG' if legacy else 'RW'}, {len(out['cells'])} cells "
              f"x {ccfg.num_chains} chains x {ccfg.samples_per_chain} samples "
              f"in the (34, 50, 3) envelope in {wall:.2f} s ({rate:.0f} "
              f"chain-steps/s; {card}): inside ptnn's bands ({verdict}); "
              f"launches {got} (as planned)")
    ccfg = cls_grid_cfg(True, samples=10 * (GRID_BIG_STEPS + 1),
                        drift="batch")
    out, got, wall = grid_counted(sweeps.classification_grid, ccfg,
                                  list(GRID_CLS_BIG), seeds=GRID_SEEDS)
    grid_plan(ccfg, got, batch=True)
    for k in ("test_mean", "test_best", "train_mean", "accept_pct",
              "swap_pct"):
        check(bool(np.isfinite(out[k]).all()), f"big bucket {k} not finite")
    for name, n in got.items():
        total[name] += n
    rate = len(out["cells"]) * ccfg.num_chains * ccfg.n_steps / wall
    print(f"[4/6] sweeps: classification_grid big bucket legacy LG, batch "
          f"drift, {len(out['cells'])} cells x {ccfg.num_chains} chains x "
          f"{ccfg.n_steps} steps in {wall:.2f} s ({rate:.0f} chain-steps/s): "
          f"finite (test mean by cell {np.round(out['test_mean'], 2)}); "
          f"launches {got} (as planned: the batch drift is products)")
    print(f"[4/6] sweeps: phase in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return total


# ---------------------------------------------------------------------------
# Replica-exchange SGLD and the bfloat16 eval on the per-step sampler.

# scripts/sgld_lr_scale_study.py:38-47's configuration: Sunspot (4, 10, 1), 8
# chains x 4000 steps, maxtemp 5, B = 32, sg_step 2e-5, swaps every 10 steps
# (untempered metropolis, even/odd, no temper switch), corrected swaps with
# SVRG anchors every 20 steps, replicas tracked, chunks of 500; its two
# sg_lr_scale arms, and the exact swap (no anchors) beside them
SGLD_BASE = dict(task="regression", topology=(4, 10, 1),
                 num_samples=8 * 4000, num_chains=8, maxtemp=5.0,
                 swap_interval=10, swap_offset=0, swap_payload="untempered",
                 swap_rule="metropolis", swap_style="even_odd",
                 pt_phase_frac=2.0, proposal="sgld", sg_batch=32,
                 sg_step=2e-5, sg_swap="corrected", sg_vr=True,
                 sg_anchor_interval=20, track_replicas=True, chunk_steps=500)
SGLD_ARMS = {"none": dict(sg_lr_scale="none"),
             "temperature": dict(sg_lr_scale="temperature"),
             "exact": dict(sg_swap="exact", sg_vr=False,
                           sg_anchor_interval=0)}
SGLD_SEEDS = (0, 1, 2)
# python -m ptnn_torch.experiments.cnn_digits at 64 chains x 300 steps with
# minibatches of 32 (exact swaps every 100 steps, sg_step 1e-5)
SGLD_CNN_ARGS = ["--chains", "64", "--steps", "300", "--sgld-batch", "32"]
# scripts/bench_modes.py:91-95's two bfloat16 arms, on the surrogate arms'
# base (Sunspot, 64 x 2000, Langevin, maxtemp 5, chunks of 250)
BF16_ARMS = {"bf16_eval": dict(eval_dtype="bfloat16"),
             "da_mala_bf16": dict(SURR_ARMS["da_mala"],
                                  eval_dtype="bfloat16")}


# bands: the mean +- 4 sigma of ptnn's own runs on the CPU, rounded outward
# (``python tests/test_torch_sgld.py ARM 0 ... 19``, ``... cnn 0 1 2 3 4``,
# ``python tests/test_torch_bf16_eval.py ARM 0 ... 19``); PERF.md section 2
# gives the means and sigmas. The sgld arms are held on the medians of
# seeds 0-2; a swap band that reaches 0 is held above it too (every ptnn
# seed accepted swaps), and no seed of ptnn's made a round trip.
SGLD_BANDS = {
    "none": dict(swap=(0.0, 29.8), rmse=(0.0229, 0.0605), trips=(0.0, 0.0)),
    "temperature": dict(swap=(0.0, 36.6), rmse=(0.0216, 0.0605),
                        trips=(0.0, 0.0)),
    "exact": dict(swap=(0.0, 30.2), rmse=(0.0218, 0.0620), trips=(0.0, 0.0)),
}
# the cnn_digits line's test mean (every chain after burn-in), swap and
# accept (every move accepted: 298 of 300 rows counted, as ptnn prints it)
SGLD_CNN_BANDS = dict(test_mean=(32.4, 43.0), swap=(64.6, 99.6),
                      accept=(99.33, 99.33))
BF16_BANDS = {
    "bf16_eval": dict(rmse=(0.0245, 0.0391), accept=(19.0, 20.9),
                      cold_accept=(7.9, 16.9), swap=(57.5, 73.1)),
    "da_mala_bf16": dict(rmse=(0.0277, 0.0410), accept=(35.9, 42.0),
                         cold_accept=(25.8, 40.0), swap=(52.6, 70.9),
                         segments=(350, 451), seg_accept=(21.8, 29.6)),
}
# runs one sgld arm's seeds in a subprocess, each with its launch counts
# zeroed just before it, one line a run; with a path, seed 0 saves its
# finished run there (the uninterrupted twin of the killed run)
SGLD_ARM_PROBE = """
import json, os, sys
import numpy as np
import ptnn_torch
from chip_smoke import KERNELS, launch_count, reset_launch_counts, sgld_stats
from ptnn_torch.config import from_json_dict
from ptnn_torch.data import load_regression
cfg = from_json_dict(json.loads(sys.argv[1]))
prob = load_regression("Sunspot")
for seed in json.loads(sys.argv[2]):
    reset_launch_counts()
    ck = sys.argv[3] if seed == 0 and sys.argv[3] else None
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                            device=os.environ.get("PTNN_DEVICE", "cuda"),
                            checkpoint_path=ck, checkpoint_every=10**9)
    print("run " + json.dumps(dict(
        seed=seed, launches={n: launch_count(n) for n in KERNELS},
        stats=sgld_stats(res), elapsed=res.elapsed_s,
        rate=res.chain_steps_per_sec,
        finite=bool(np.isfinite(res.traces["ll"]).all()),
        accept_min=float(res.accept_ratio_per_chain.min()))), flush=True)
"""
SGLD_CKPT_PROBE = """
import json, os, signal, sys
import ptnn_torch
from ptnn_torch import checkpoint
from ptnn_torch.config import from_json_dict
from ptnn_torch.data import load_regression
cfg = from_json_dict(json.loads(sys.argv[1]))
if sys.argv[3] == "kill":
    save = checkpoint.save

    def save_then_die(path, state, done, *a, **k):
        save(path, state, done, *a, **k)
        if done < cfg.n_steps:
            os.kill(os.getpid(), signal.SIGKILL)

    checkpoint.save = save_then_die
prob = load_regression("Sunspot")
ptnn_torch.sample(cfg, prob.train, prob.test, seed=0,
                  device=os.environ.get("PTNN_DEVICE", "cuda"),
                  checkpoint_path=sys.argv[2], checkpoint_every=1)
"""


def sgld_cfg(arm, **kw):
    """The sgld study's configuration with the arm's swap and step knobs."""
    from ptnn_torch import PTConfig

    return PTConfig(**dict(SGLD_BASE, **SGLD_ARMS[arm], **kw)).validate()


def sgld_stats(res):
    """A sgld run's figures (ptnn's result or the port's): swap %, the cold
    rung's mean test RMSE over the second half (the study's), and round
    trips per 1k steps."""
    import numpy as np

    from ptnn_torch.ops.roundtrip import roundtrip_stats

    b = res.config.samples_per_chain // 2
    rt = roundtrip_stats(np.asarray(res.traces["replica"]))
    return dict(swap=float(res.swap_percent),
                rmse=float(np.mean(res.traces["rmse_test"][b:, 0])),
                trips=float(rt.rate_per_kstep))


def digits_line(line):
    """The figures of cnn_digits's last line, ``[digits] chains=C
    test_acc mean=M max=X accept%=A swap%=S (...)``."""
    words = dict(w.split("=", 1) for w in line.split(" (")[0].split()
                 if "=" in w)
    return dict(test_mean=float(words["mean"]), test_max=float(words["max"]),
                accept=float(words["accept%"]), swap=float(words["swap%"]))


def bf16_cfg(arm, **kw):
    """bench_modes.py's bfloat16 arm on the surrogate arms' base."""
    return surrogate_cfg("plain", **dict(BF16_ARMS[arm], **kw))


def sgld_plan(cfg, res=None):
    """The launches of a sgld run: the eval of init's ll; at each swap event
    one eval pair (exact swaps) or one eval of the test rows (corrected);
    under anchors one eval of the train rows a refresh; no drift. For the
    FNN the eval kernel (a pair is one launch), for the CNN's fused eval
    the conv stage (a pair is two)."""
    from ptnn_torch import kernel

    n = cfg.n_steps
    events = sum(kernel.swap_due(cfg, i) for i in range(n))
    refresh = (sum(i % cfg.sg_anchor_interval == 0 for i in range(n))
               if cfg.sg_vr else 0)
    return 1 + events + refresh, events


def phase_sgld_bf16():
    """Replica-exchange SGLD and the bfloat16 eval on the card. At once, as
    subprocesses: each sgld arm of scripts/sgld_lr_scale_study.py's
    configuration (both sg_lr_scale arms and the exact swap, seeds 0-2,
    launches exactly the plan; the "none" arm's seed 0 saves its finished
    run), the cnn_digits --sgld-batch 32 command line, and a sgld run that
    SIGKILLs itself after its first checkpoint. In this process meanwhile:
    the command line's configuration on the CNN with the fused eval (conv
    launches the plan) and bench_modes.py's two bfloat16 arms (no eval
    launch). Then the arms' medians against ptnn's bands, and the killed
    run resumed and held to the uninterrupted one bit for bit. Returns the
    phase's launches."""
    import shutil

    from ptnn_torch import config

    out = LIFE_OUT.parent / "chip_smoke_sgld"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t_phase = time.perf_counter()
    arms = {arm: popen([sys.executable, "-c", SGLD_ARM_PROBE,
                        json.dumps(config.to_json_dict(sgld_cfg(arm))),
                        json.dumps(SGLD_SEEDS),
                        str(out / "full.npz") if arm == "none" else ""])
            for arm in SGLD_ARMS}
    cnn_proc = popen([sys.executable, "-c", CLI_PROBE,
                      "ptnn_torch.experiments.cnn_digits", *SGLD_CNN_ARGS,
                      "--out", str(out / "cnn")])
    ck_cfg = sgld_cfg("none")
    ck = out / "sgld.npz"
    ck_cmd = [sys.executable, "-c", SGLD_CKPT_PROBE,
              json.dumps(config.to_json_dict(ck_cfg)), str(ck)]
    victim = popen(ck_cmd + ["kill"])
    procs = [*arms.values(), cnn_proc, victim]
    try:
        return _sgld_bf16(out, procs, arms, cnn_proc, victim, ck_cfg, ck,
                          ck_cmd, t_phase)
    finally:  # a failed check leaves no subprocess behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _sgld_bf16(out, procs, arms, cnn_proc, victim, ck_cfg, ck, ck_cmd,
               t_phase):
    """The body of ``phase_sgld_bf16`` once its subprocesses run."""
    import signal

    import numpy as np

    import ptnn_torch
    from ptnn_torch import checkpoint, config, kernel, results
    from ptnn_torch.data import load_digits
    from ptnn_torch.models import cnn

    prob = sunspot()
    launches = dict(fnn_eval=0, drift_epoch=0, conv1_relu_pool=0)
    card = card_line()
    # --- the bfloat16 arms -----------------------------------------------------
    for arm in BF16_ARMS:
        cfg = bf16_cfg(arm)
        reset_launch_counts()
        res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0,
                                device=DEVICE)
        got = dict(fnn_eval=launch_count("fnn_eval"),
                   drift_epoch=launch_count("drift_epoch"))
        plan = dict(surrogate_plan(cfg, res), fnn_eval=0)
        check(got == plan, f"bf16 {arm}: launches {got}, planned {plan}")
        launches["drift_epoch"] += got["drift_epoch"]
        st = surrogate_stats(res)
        print(f"[4/6] bf16: {arm} {cfg.num_chains} x {cfg.samples_per_chain} "
              f"(Langevin, bfloat16 evals, chunks of {cfg.chunk_steps}): cold "
              f"test RMSE {st['rmse']:.5f}, accept {st['accept']:.2f}% (cold "
              f"{st['cold_accept']:.2f}%), swap {st['swap']:.2f}%"
              + (f", {st['segments']} segments, closures accepted "
                 f"{st['seg_accept']:.2f}%" if "segments" in st else "")
              + f"; {1e3 * res.elapsed_s / cfg.n_steps:.3f} ms a step, "
              f"{res.chain_steps_per_sec:,.0f} chain-steps/s ({card}; beside "
              f"the phase's subprocesses); "
              f"launches {got} (no eval kernel: as planned)")
        for what, band in BF16_BANDS[arm].items():
            in_band(f"bf16 {arm}", what, st[what], band)
    # --- the killed sgld run, resumed ----------------------------------------
    victim.communicate(timeout=600)
    check(victim.returncode == -signal.SIGKILL, f"the sgld run to kill ended "
          f"with {victim.returncode}")
    spec_name = kernel.default_spec(ck_cfg).name
    _st, killed_at, _ = checkpoint.load(str(ck), ck_cfg, 0, spec_name)
    check(0 < killed_at < ck_cfg.n_steps, f"the sgld run was killed at "
          f"{killed_at}")
    resumed = popen(ck_cmd + ["resume"])
    procs.append(resumed)
    # --- the CNN on the fused eval, once the command line wrote its config --
    stdout = finished(cnn_proc, "cnn_digits --sgld-batch")
    lines = stdout.strip().splitlines()
    cli_launches = json.loads(lines[-1][len("launches "):])
    line = next(ln for ln in lines if ln.startswith("[digits]"))
    digits = digits_line(line)
    cli_cfg = config.from_json_dict(json.loads(
        (out / "cnn" / "digits_0" / "config.json").read_text()))
    check(cli_cfg.proposal == "sgld" and cli_cfg.sg_batch == 32,
          "cnn_digits --sgld-batch: config.json")
    check(all(v == 0 for v in cli_launches.values()),
          f"cnn_digits --sgld-batch (the plain CNN eval): launches "
          f"{cli_launches}, planned none")
    for what, band in SGLD_CNN_BANDS.items():
        in_band("cnn_digits --sgld-batch", what, digits[what], band)
    print(f"[4/6] sgld: python -m ptnn_torch.experiments.cnn_digits "
          f"{' '.join(SGLD_CNN_ARGS)}: {line.split(' -> ')[0]}; launches "
          f"none (the command line's CNN evaluates with the plain forward, as "
          f"ptnn's; as planned)")
    rows = load_digits(0)
    reset_launch_counts()
    res = ptnn_torch.sample(cli_cfg, rows.train, rows.test, seed=0,
                            device=DEVICE,
                            model_spec=cnn.digits_spec(fused_eval=True))
    got = {name: launch_count(name) for name in KERNELS}
    _evals, events = sgld_plan(cli_cfg)
    want = dict({name: 0 for name in KERNELS}, conv1_relu_pool=1 + 2 * events)
    check(got == want, f"sgld CNN fused eval: launches {got}, planned {want}")
    launches["conv1_relu_pool"] += want["conv1_relu_pool"]
    summ = results.summarize(res, "digits")
    fig = dict(test_mean=summ.test_mean, swap=summ.swap_perc,
               accept=round(summ.accept_per, 2))
    for what, band in SGLD_CNN_BANDS.items():
        in_band("sgld CNN fused eval", what, fig[what], band)
    print(f"[4/6] sgld: the same configuration on the CNN with the fused "
          f"eval, in this process: test mean {fig['test_mean']:.2f}%, swap "
          f"{fig['swap']:.2f}%, accept {fig['accept']:.2f}%; "
          f"{1e3 * res.elapsed_s / cli_cfg.n_steps:.3f} ms a step, "
          f"{res.chain_steps_per_sec:,.0f} chain-steps/s ({card}; beside the "
          f"sgld arms' subprocesses); launches "
          f"conv1_relu_pool {got['conv1_relu_pool']} (init + 2 x {events} "
          f"swap events, as planned)")
    # --- the sgld arms ---------------------------------------------------------
    for arm, proc in arms.items():
        cfg = sgld_cfg(arm)
        evals, events = sgld_plan(cfg)
        want = dict({name: 0 for name in KERNELS}, fnn_eval=evals)
        runs = [json.loads(ln[len("run "):]) for ln in
                finished(proc, f"sgld {arm}").splitlines()
                if ln.startswith("run ")]
        check([r["seed"] for r in runs] == list(SGLD_SEEDS),
              f"sgld {arm}: runs of seeds {[r['seed'] for r in runs]}")
        for r in runs:
            check(r["launches"] == want, f"sgld {arm} seed {r['seed']}: "
                  f"launches {r['launches']}, planned {want}")
            check(r["finite"] and r["accept_min"] > 99.0, f"sgld {arm} seed "
                  f"{r['seed']}: ll not finite or a move refused")
            launches["fnn_eval"] += evals
            st = r["stats"]
            print(f"[4/6] sgld: {arm} seed {r['seed']}, Sunspot 8 x "
                  f"{cfg.samples_per_chain} (B {cfg.sg_batch}, "
                  f"{cfg.sg_swap} swaps every {cfg.swap_interval}"
                  + (f", anchors every {cfg.sg_anchor_interval}"
                     if cfg.sg_vr else "")
                  + f"): swap {st['swap']:.2f}%, cold test RMSE "
                  f"{st['rmse']:.5f}, round trips {st['trips']:.2f} / 1k "
                  f"steps; {1e3 * r['elapsed'] / cfg.n_steps:.3f} ms a step, "
                  f"{r['rate']:,.0f} chain-steps/s (a subprocess beside two "
                  f"others; {card}); launches fnn_eval "
                  f"{r['launches']['fnn_eval']} (init + {events} swap events"
                  + (f" + {evals - 1 - events} anchor refreshes"
                     if cfg.sg_vr else "")
                  + "), drift_epoch 0 (as planned)")
        med = {k: float(np.median([r["stats"][k] for r in runs]))
               for k in runs[0]["stats"]}
        print(f"[4/6] sgld: {arm} medians over seeds {SGLD_SEEDS}: swap "
              f"{med['swap']:.2f}%, cold test RMSE {med['rmse']:.5f}, round "
              f"trips {med['trips']:.2f} (bands {SGLD_BANDS[arm]})")
        for what, band in SGLD_BANDS[arm].items():
            in_band(f"sgld {arm}", what, med[what], band)
        check(med["swap"] > 0.0, f"sgld {arm}: no swap accepted")
    # --- the resumed run against the uninterrupted one ------------------------
    finished(resumed, "the resumed sgld run")
    state, done, traces = checkpoint.load(str(ck), ck_cfg, 0, spec_name)
    w_state, w_done, w_traces = checkpoint.load(str(out / "full.npz"),
                                                ck_cfg, 0, spec_name)
    check(done == w_done == ck_cfg.n_steps, f"the resumed run's checkpoint "
          f"at {done}, the uninterrupted one's at {w_done}")
    check(set(traces) == set(w_traces), f"traces {sorted(traces)}")
    for k, v in traces.items():
        check(np.array_equal(v, w_traces[k]), f"resumed sgld trace {k} "
              f"differs from the uninterrupted run's")
    a, b = state_arrays(state), state_arrays(w_state)
    check(set(a) == set(b), f"resumed state fields {sorted(set(a) ^ set(b))}")
    for k in a:
        check(np.array_equal(a[k], b[k]), f"resumed sgld state {k} differs")
    check("sg_anchor_w" in a, "the resumed sgld state has no anchors")
    print(f"[4/6] sgld: none seed 0, checkpoint every chunk: SIGKILLed after "
          f"its checkpoint at step {killed_at}, resumed; every trace "
          f"({len(traces)}) and every state tensor ({len(a)}: the anchors "
          f"sg_anchor_w, sg_anchor_eta, sg_anchor_full included) equal the "
          f"uninterrupted run's bit for bit")
    print(f"[4/6] sgld and bf16: phase in {time.perf_counter() - t_phase:.1f} "
          f"s; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Grids of the preconditioned family, sgld and the bfloat16 eval: ptnn's
# vmapped sweeps of those proposals, each one per-step run on the card.

# arm -> (sweep, n): bench's per-step Sunspot MALA (64 x 2000) and
# chees16_16x4 (64 x 1000), the sgld study's "none" arm (8 x 4000), its
# "exact" arm at FAMILY_INTERVALS (the never-swapping 0 among them),
# bench_modes' bf16_eval (64 x 2000); a seed sweep's n cells are seeds 0 ..
# n-1, the interval arm's cells FAMILY_INTERVALS n times (one sweep, seed 0)
FAMILY_ARMS = {"mala": ("seed", 10), "chees16_16x4": ("seed", 10),
               "sgld_none": ("seed", 20),
               "sgld_exact_interval": ("swap_interval", 5),
               "bf16_eval": ("seed", 10)}
FAMILY_INTERVALS = (10, 20, 0)
FAMILY_METRICS = ("test_mean", "accept_pct", "swap_pct")
# ptnn's mean and sample sd of each metric over its 20 cells on the CPU (the
# seed sweeps of seeds 0-19; the interval arm FAMILY_INTERVALS 20 times, one
# sweep of seed 0, by interval): python tests/test_torch_grid_families.py ARM
# 0 ... 19. A cell's band is mean +- 4 sd, an arm's mean over its n cells
# (an interval's) mean +- 4 sd sqrt(1 / n + 1 / 20), rounded outward
FAMILY_REF_N = 20
FAMILY_REF = {
    "mala": dict(test_mean=(0.03400208, 0.00038912),
                 accept_pct=(46.51453125, 0.4438345),
                 swap_pct=(73.85290364, 1.0210318)),
    "chees16_16x4": dict(test_mean=(0.01586241, 0.00034617),
                         accept_pct=(55.79828125, 0.55217169),
                         swap_pct=(50.6566723, 0.53319682)),
    "sgld_none": dict(test_mean=(0.17763467, 0.04869705),
                      accept_pct=(99.975, 0.0),
                      swap_pct=(13.33810888, 4.09083261)),
    "sgld_exact_interval": {
        "10": dict(test_mean=(0.19172283, 0.05809676),
                   accept_pct=(99.975, 0.0),
                   swap_pct=(12.42120344, 5.02569966)),
        "20": dict(test_mean=(0.1768843, 0.02713787),
                   accept_pct=(99.975, 0.0),
                   swap_pct=(16.41522989, 7.07277547)),
        # never swaps: its energy and metrics are init's, as ptnn's
        "0": dict(test_mean=(0.0, 0.0), accept_pct=(99.975, 0.0),
                  swap_pct=(0.0, 0.0)),
    },
    "bf16_eval": dict(test_mean=(0.08205577, 0.01484132),
                      accept_pct=(19.98890625, 0.2237818),
                      swap_pct=(65.26054193, 1.93936983)),
}
# the single per-step run each grid arm is timed against: its steps
FAMILY_SINGLE_DIV = 10


def family_cfg(arm):
    """The configuration of a grid arm (FAMILY_ARMS)."""
    if arm == "mala":
        return sunspot_variant("mala", 64, 2000)
    if arm == "chees16_16x4":
        return sunspot_variant("chees16_16x4", 64, 1000)
    if arm == "sgld_none":
        return sgld_cfg("none")
    if arm == "sgld_exact_interval":
        return sgld_cfg("exact")
    return bf16_cfg("bf16_eval")


def family_cells(arm, n):
    """The cells of a grid arm of n: seeds, or swap intervals."""
    if FAMILY_ARMS[arm][0] == "seed":
        return list(range(n))
    return list(FAMILY_INTERVALS) * n


def family_run(arm, n, device=DEVICE):
    """A grid arm of n through ptnn_torch.sweeps: (per-cell output, cells)."""
    from ptnn_torch import sweeps

    cfg, prob, cells = family_cfg(arm), sunspot(), family_cells(arm, n)
    if FAMILY_ARMS[arm][0] == "seed":
        out = sweeps.seed_sweep(cfg, cells, prob.train, prob.test,
                                device=device)
    else:
        out = sweeps.swap_interval_sweep(cfg, cells, prob.train, prob.test,
                                         seed=0, device=device)
    return out, cells


def family_plan(cfg, cells, interval):
    """The launches a grid of ``cfg`` plans, one launch for every cell: the
    preconditioned family one eval of the test rows a step, init's and the
    temper switch's; sgld init's eval, one a swap event of any cell (the
    pair under exact swaps, the test rows under corrected ones) and one an
    anchor refresh; the bfloat16 eval none, and 2 drift epochs a step."""
    from ptnn_torch import kernel

    n = cfg.n_steps
    want = {name: 0 for name in KERNELS}
    if cfg.proposal == "sgld":
        sis = sorted(set(cells)) if interval else [cfg.swap_interval]
        events = sum(any(kernel.swap_due(cfg, i, si) for si in sis)
                     for i in range(n))
        refresh = (sum(i % cfg.sg_anchor_interval == 0 for i in range(n))
                   if cfg.sg_vr else 0)
        want["fnn_eval"] = 1 + events + refresh
    elif cfg.eval_dtype == "bfloat16":
        want["drift_epoch"] = 2 * n
    else:
        want["fnn_eval"] = n + 1 + int(0 < cfg.temper_switch_step < n)
    return want


def family_band(mean, sd, n=None):
    """mean +- 4 sd (an n-cell mean's: 4 sd sqrt(1 / n + 1 / FAMILY_REF_N)),
    rounded outward to the next multiple of 1e-6 (strictly outside: a
    metric every cell reads alike, sgld's accept %, has sd 0)."""
    import math

    half = 4.0 * sd * (1.0 if n is None
                       else math.sqrt(1.0 / n + 1.0 / FAMILY_REF_N))
    return ((math.ceil((mean - half) * 1e6) - 1) / 1e6,
            (math.floor((mean + half) * 1e6) + 1) / 1e6)


def family_check(arm, out, cells, ref=None):
    """Every cell's metrics in ptnn's cell band, and each group's mean (the
    arm's; the interval arm an interval's) in ptnn's band of an n-cell
    mean; ``ref`` (default ``FAMILY_REF[arm]``) holds ptnn's mean and sd of
    each metric over its 20 cells. Returns a line of the arm's means
    against their bands and the cell closest to its band's edge."""
    import numpy as np

    ref = FAMILY_REF[arm] if ref is None else ref
    groups = {}
    for k, cell in enumerate(cells):
        groups.setdefault(cell if arm == "sgld_exact_interval" else "all",
                          []).append(k)
    worst, parts = None, []
    for key, ks in groups.items():
        r = ref[str(key)] if key != "all" else ref
        for m in FAMILY_METRICS:
            mean, sd = r[m]
            lo, hi = family_band(mean, sd)
            for k in ks:
                v = float(out[m][k])
                check(lo <= v <= hi, f"grid {arm} cell {cells[k]}: {m} "
                      f"{v:.6g} outside ptnn's [{lo}, {hi}]")
                edge = (min(v - lo, hi - v) / ((hi - lo) / 2) if hi > lo
                        else 1.0)
                if worst is None or edge < worst[0]:
                    worst = (edge, k, m, v, (lo, hi))
            mu = float(np.mean([float(out[m][k]) for k in ks]))
            band = family_band(mean, sd, len(ks))
            check(band[0] <= mu <= band[1], f"grid {arm} {key}: mean {m} of "
                  f"{len(ks)} cells {mu:.6g} outside ptnn's [{band[0]}, "
                  f"{band[1]}] (ptnn {mean:.6g} +- {sd:.3g})")
            parts.append(f"{'' if key == 'all' else f'si {key} '}{m} "
                         f"{mu:.5g} in {band}")
    _e, k, m, v, band = worst
    what = (f"seed {cells[k]}"
            if FAMILY_ARMS.get(arm, ("seed",))[0] == "seed"
            else f"interval {cells[k]}")
    return (f"means over the cells {'; '.join(parts)}; closest to its cell "
            f"band's edge: cell {k} ({what}) {m} {v:.5g} in {band}")


def phase_grid_families():
    """Grids of the preconditioned family, sgld and the bfloat16 eval on
    the card through ``ptnn_torch.sweeps``: each FAMILY_ARMS arm as one
    per-step run, every cell's test mean, accept % and swap % inside the
    mean +- 4 sigma of ptnn's own sweep on the CPU (20 cells), each arm's
    mean over its cells inside ptnn's band of such a mean (the distribution
    a single seed cannot show), launches exactly the plan (one eval launch
    a step or a swap event for every cell at once); the grid's chain-steps
    / s beside a single per-step run's times the cells. Returns the
    launches by kernel."""
    import dataclasses as dc

    import ptnn_torch

    t_phase = time.perf_counter()
    card = card_line()
    prob = sunspot()
    total = {name: 0 for name in KERNELS}
    for arm, (sweep, n) in FAMILY_ARMS.items():
        cfg = family_cfg(arm)
        (out, cells), got, wall = grid_counted(family_run, arm, n)
        want = family_plan(cfg, cells, sweep == "swap_interval")
        check(got == want, f"grid {arm}: launches {got}, planned {want}")
        for name, k in got.items():
            total[name] += k
        verdict = family_check(arm, out, cells)
        chains = len(cells) * cfg.num_chains
        rate = chains * cfg.n_steps / wall
        steps = max(cfg.n_steps // FAMILY_SINGLE_DIV, 1)
        short = dc.replace(cfg, num_samples=cfg.num_chains * steps)
        one = ptnn_torch.sample(short.validate(), prob.train, prob.test,
                                seed=0, device=DEVICE)
        what = ("seeds 0-%d" % (len(cells) - 1) if sweep == "seed" else
                f"swap intervals {FAMILY_INTERVALS} x {n}")
        print(f"[4/6] grid families: {arm} {sweep}_sweep, {len(cells)} "
              f"cells ({what}) x {cfg.num_chains} chains x "
              f"{cfg.samples_per_chain} samples = {chains} chains in "
              f"{wall:.2f} s ({1e3 * wall / cfg.n_steps:.3f} ms a step, "
              f"{rate:,.0f} chain-steps/s; a single run of {cfg.num_chains} "
              f"chains x {steps} steps {one.chain_steps_per_sec:,.0f} "
              f"chain-steps/s, x {len(cells)} cells "
              f"{one.chain_steps_per_sec * len(cells):,.0f}; {card}): every "
              f"cell inside ptnn's band; {verdict}; launches {got} (as "
              f"planned: one launch for every cell)")
    print(f"[4/6] grid families: phase in {time.perf_counter() - t_phase:.1f}"
          f" s; launches {total}")
    return total


# ---------------------------------------------------------------------------
# Grids of the variational reference and of the surrogate modes, and the
# parity runner.

# arm -> cells (seeds 0 .. n-1): the regression command line's --vref
# (experiments.runner.vref_config on the Sunspot preset: Langevin, 10
# chains, maxtemp 2 with a T = inf rung, untempered metropolis even/odd
# swaps every 100 steps) at 2000 samples a chain (the command line's 10,000
# cut), and the classification one's on the canonical iris preset (10
# chains x 5000)
VREF_ARMS = {"reg": 20, "iris": 10}
VREF_REG_SAMPLES = 10 * 2000


def vref_grid_cfg(arm):
    """The configuration of a VR grid arm (VREF_ARMS), as the command lines
    build it with --vref."""
    import argparse

    import ptnn_torch
    from ptnn_torch.experiments import runner

    vref = argparse.Namespace(vref=True, vr_rounds=0)
    if arm == "reg":
        cfg = dataclasses.replace(ptnn_torch.regression_preset(),
                                  drift_mode="sequential").validate()
        cfg = runner.vref_config(cfg, vref, pt_phase_frac=2.0)
        return dataclasses.replace(cfg,
                                   num_samples=VREF_REG_SAMPLES).validate()
    cfg = dataclasses.replace(
        ptnn_torch.classification_preset(IRIS_TOPO, canonical=True),
        drift_mode="sequential").validate()
    return runner.vref_config(cfg, vref)


def vref_grid_problem(arm):
    """The arm's rows: Sunspot, or iris."""
    from ptnn_torch import data

    return sunspot() if arm == "reg" else data.load_classification("iris")


# ptnn's mean and sample sd of each metric over its 20 cells on the CPU
# (seed_sweep of seeds 0-19 at the arm's configuration: python
# tests/test_torch_grid_vref.py ARM 0 ... 19); bands as FAMILY_REF's
VREF_REF = {
    "reg": dict(test_mean=(0.04967842, 0.01276599),
                accept_pct=(24.33775, 0.71908106),
                swap_pct=(64.88235294, 4.42299911)),
    "iris": dict(test_mean=(55.54656506, 4.52366522),
                 accept_pct=(90.3296, 1.04247996),
                 swap_pct=(62.44343891, 2.85424878)),
}
# the surrogate grids: scripts/bench_modes.py:46-68's anchored and
# delayed-acceptance (RW inner) arms, 5 seeds x 64 chains x 500 samples,
# against the plain arm's grid of the same seeds
SURR_GRID = (5, 64, 500)
SURR_GRID_ARMS = ("anchored", "da_rw")
# the parity runner's full budget: grid_parity's 100,000 samples
PARITY_SAMPLES = 100_000
# the parity runners of many single runs (python -m
# ptnn_torch.experiments.parity singles / bands) cut to 10,000 regression
# samples (phase_sweeps' configuration, 1000 steps a chain) and 5000
# classification samples (500 steps a chain, swaps every 10), from 100,000
# and 50,000
PARITY_REG_SAMPLES = GRID_REG_SAMPLES
PARITY_CLS_SAMPLES = 5_000


def phase_grid_vref():
    """Grids of the variational reference and of the surrogate modes, and
    the parity runner, on the card through ``ptnn_torch.sweeps``:

    * each VREF_ARMS arm as one ``seed_sweep``: every cell's test mean,
      accept % and swap % inside ptnn's band (mean +- 4 sigma of ptnn's 20
      cells), the arm's mean inside ptnn's band of an n-cell mean, every
      cell's regeneration accepted every time after activation (beta = 0 at
      T = inf), launches exactly the plan; its ms a step and chain-steps/s
      beside a single VR run's rate x cells;
    * the anchored and delayed-acceptance surrogate grids equal to the
      plain grid of the same seeds, every statistic and counter, with the
      plain grid's launches (ptnn's grid never refits: no step takes the
      surrogate);
    * ``experiments.parity``'s regression tables at phase_sweeps'
      configuration equal to its dataset_grid, bit for bit, then at the
      full budget (21 cells x 10 chains x 10,000 steps), every cell finite.

    Returns the launches by kernel."""
    import numpy as np

    import ptnn_torch
    from ptnn_torch import sweeps
    from ptnn_torch.experiments import parity

    t_phase = time.perf_counter()
    card = card_line()
    total = {name: 0 for name in KERNELS}

    def count(got):
        for name, n in got.items():
            total[name] += n

    for arm, n in VREF_ARMS.items():
        cfg, prob, cells = vref_grid_cfg(arm), vref_grid_problem(arm), list(
            range(n))
        out, got, wall = grid_counted(sweeps.seed_sweep, cfg, cells,
                                      prob.train, prob.test)
        # the regenerations are plain forwards of the due cells' proposals
        # and launch nothing
        grid_plan(cfg, got)
        count(got)
        verdict = family_check(f"vref {arm}", out, cells, VREF_REF[arm])
        prop, pct = out["vr_regen_proposed"], out["vr_regen_accept_pct"]
        check(bool((prop > 0).all()) and bool((pct == 100.0).all()),
              f"VR grid {arm}: regenerations {prop.tolist()}, accepted "
              f"{pct.tolist()} % (beta = 0 at T = inf accepts every one)")
        chains = n * cfg.num_chains
        steps = max(cfg.n_steps // FAMILY_SINGLE_DIV, 1)
        short = dataclasses.replace(cfg, num_samples=cfg.num_chains * steps)
        one = ptnn_torch.sample(short.validate(), prob.train, prob.test,
                                seed=0, device=DEVICE)
        print(f"[4/6] VR grids: {arm} seed_sweep, {n} cells (seeds 0-{n - 1}"
              f") x {cfg.num_chains} chains x {cfg.samples_per_chain} samples"
              f" = {chains} chains in {wall:.2f} s ("
              f"{1e3 * wall / cfg.n_steps:.3f} ms a step, "
              f"{chains * cfg.n_steps / wall:,.0f} chain-steps/s; a single "
              f"VR run of {cfg.num_chains} chains x {steps} steps "
              f"{one.chain_steps_per_sec:,.0f} chain-steps/s, x {n} cells "
              f"{one.chain_steps_per_sec * n:,.0f}; {card}): every cell "
              f"inside ptnn's band; {verdict}; regenerations "
              f"{int(prop.min())}-{int(prop.max())} a cell, all accepted; "
              f"launches {got} (as planned: one launch for every cell)")
    seeds, chains, samples = SURR_GRID
    prob = sunspot()
    plain_cfg = surrogate_cfg("plain", chains, samples)
    plain, plain_got, plain_wall = grid_counted(
        sweeps.seed_sweep, plain_cfg, list(range(seeds)), prob.train,
        prob.test)
    count(plain_got)
    for arm in SURR_GRID_ARMS:
        cfg = surrogate_cfg(arm, chains, samples)
        out, got, wall = grid_counted(sweeps.seed_sweep, cfg,
                                      list(range(seeds)), prob.train,
                                      prob.test)
        count(got)
        for k, v in plain.items():
            check(np.array_equal(out[k], v), f"surrogate grid {arm}: {k} "
                  f"{out[k]} against the plain grid's {v}")
        check(got == plain_got, f"surrogate grid {arm}: launches {got}, the "
              f"plain grid's {plain_got}")
        print(f"[4/6] VR grids: surrogate {arm} seed_sweep, {seeds} cells x "
              f"{chains} chains x {samples} samples in {wall:.2f} s (the "
              f"plain grid {plain_wall:.2f} s; {card}): every statistic and "
              f"counter equal to the plain grid's (test mean "
              f"{np.round(out['test_mean'], 5).tolist()}), launches {got} "
              f"(the plain grid's): ptnn's grid never refits, so no step "
              f"takes the surrogate")
    base = (SWEEPS_REG_OUT[-1] if SWEEPS_REG_OUT else grid_counted(
        sweeps.dataset_grid, reg_grid_cfg(), list(GRID_REG_NAMES),
        seed=0)[0])
    reset_launch_counts()
    out, _lines, wall = parity.regression_tables(GRID_REG_SAMPLES, seed=0,
                                                 chunk_steps=1000,
                                                 device=DEVICE)
    got = {name: launch_count(name) for name in KERNELS}
    grid_plan(parity.regression_cfg(GRID_REG_SAMPLES), got)
    count(got)
    check(out["cells"] == base["cells"], "parity runner: cells")
    for k, v in base.items():
        if k != "cells":
            check(np.array_equal(out[k], v), f"parity runner {k} against "
                  f"phase_sweeps' grid")
    print(f"[4/6] VR grids: python -m ptnn_torch.experiments.parity "
          f"regression --samples {GRID_REG_SAMPLES}: every cell equal to "
          f"phase_sweeps' dataset_grid bit for bit ({wall:.2f} s)")
    reset_launch_counts()
    out, lines, wall = parity.regression_tables(PARITY_SAMPLES, seed=0,
                                                chunk_steps=1000,
                                                device=DEVICE)
    got = {name: launch_count(name) for name in KERNELS}
    cfg = parity.regression_cfg(PARITY_SAMPLES)
    grid_plan(cfg, got)
    count(got)
    for k in ("test_mean", "test_std", "test_best", "train_mean",
              "accept_pct", "swap_pct"):
        check(bool(np.isfinite(out[k]).all()), f"parity table {k} finite")
    print(f"[4/6] VR grids: python -m ptnn_torch.experiments.parity "
          f"regression (--samples {PARITY_SAMPLES}: 21 cells x 10 chains x "
          f"{cfg.n_steps} steps) in {wall:.2f} s ("
          f"{1e3 * wall / cfg.n_steps:.3f} ms a step, "
          f"{210 * cfg.n_steps / wall:,.0f} chain-steps/s; {card}), every "
          f"cell finite, launches {got} (as planned):")
    for line in lines:
        if line:
            print(f"[4/6] VR grids:   {line}")
    print(f"[4/6] VR grids: phase in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return total


# ptnn's mean and sample sd over its seed_sweep of seeds 0-19 on the CPU of
# each classification single run of the phase (parity.cls_single_cfg at
# PARITY_CLS_SAMPLES; printed by python
# tests/test_torch_parity_singles.py MODE SET 0 ... 19), by (mode, set):
# test_mean, accept_pct, swap_pct. A row or a bands cell's seed is held to
# mean +- 4 sd, a bands cell's mean over its five seeds to mean +- 4 sd
# sqrt(1 / 5 + 1 / 20) (family_band)
PARITY_REF = {
    ("rw", "iris"): dict(test_mean=(39.31, 4.3683736),
                         accept_pct=(92.893, 0.50555962),
                         swap_pct=(73.605442, 2.4237874)),
    ("rw", "Ionosphere"): dict(test_mean=(58.35642, 12.032389),
                               accept_pct=(88.875, 1.2867891),
                               swap_pct=(72.777778, 2.6612295)),
    ("rw", "Cancer"): dict(test_mean=(74.525684, 6.4675543),
                           accept_pct=(85.168, 1.2003578),
                           swap_pct=(70.589569, 2.1374529)),
    ("rw", "bank-additional"): dict(test_mean=(61.570384, 2.0869536),
                                    accept_pct=(60.707, 1.389741),
                                    swap_pct=(69.240363, 1.7100431)),
    ("rw", "PenDigit"): dict(test_mean=(17.681394, 3.5133503),
                             accept_pct=(53.042, 0.82742212),
                             swap_pct=(68.287982, 1.6021926)),
    ("rw", "chess"): dict(test_mean=(10.247287, 1.2733029),
                          accept_pct=(51.166, 0.5924472),
                          swap_pct=(67.970522, 1.3975843)),
    ("lg", "iris"): dict(test_mean=(86.402663, 1.0701839),
                         accept_pct=(97.707, 0.18618327),
                         swap_pct=(40.680272, 3.5901764)),
    ("lg", "Ionosphere"): dict(test_mean=(85.777324, 4.5635386),
                               accept_pct=(94.499, 0.38784017),
                               swap_pct=(38.854875, 4.158663)),
    ("lg", "Cancer"): dict(test_mean=(98.899084, 0.063101027),
                           accept_pct=(96.771, 0.23472044),
                           swap_pct=(46.473923, 4.1795647)),
    ("lg", "bank-additional"): dict(test_mean=(81.380649, 0.092285809),
                                    accept_pct=(63.075, 0.59622938),
                                    swap_pct=(30.634921, 4.7461934)),
    ("lg", "PenDigit"): dict(test_mean=(16.173823, 5.1153415),
                             accept_pct=(28.727, 2.2573135),
                             swap_pct=(12.165533, 3.1163348)),
    # chess's LG row on the batch drift, as parity.cls_single_cfg runs it
    ("lg", "chess"): dict(test_mean=(7.8575026, 1.1975455),
                          accept_pct=(25.811, 0.77401142),
                          swap_pct=(10.804989, 2.9613789)),
}
# the bands the phase runs: every set under RW, and under legacy LG the
# small sets' grids and two big sets' five single runs on the sequential
# drift (bank-additional's and chess's run in the full-budget record)
PARITY_BANDS = {"rw": ("iris", "Ionosphere", "Cancer", "bank-additional",
                       "PenDigit", "chess"),
                "lg": ("iris", "Ionosphere", "Cancer", "PenDigit")}
PARITY_OUT = ROOT / "build" / "chip_smoke_parity"


def by_register(want, tag):
    """Every drift epoch since the counts were zeroed by the register
    kernel."""
    from ptnn_torch.ops import drift

    check(drift.variant_launches["register"] == want["drift_epoch"],
          f"{tag} drift by kernel {drift.variant_launches}, planned "
          f"{want['drift_epoch']} by the register kernel")


def single_plan(cfg, got, runs=1):
    """The launches of ``runs`` single per-step runs: each 2 drift epochs a
    step with Langevin gradients on the per-row drift (none on the batch
    drift, plain products), 1 eval pair a step, init's and the temper
    switch's; the drift by the register kernel."""
    n = cfg.n_steps
    want = {name: 0 for name in KERNELS}
    want["drift_epoch"] = runs * (2 * n if cfg.use_langevin_gradients
                                  and cfg.drift_mode != "batch" else 0)
    want["fnn_eval"] = runs * (n + 1 + int(0 < cfg.temper_switch_step < n))
    check(got == want, f"single run launches {got}, planned {want}")
    by_register(want, "single run")


def drift_row_us(prob, chains=10, reps=5):
    """The register drift's epoch over a set's train rows at ``chains``
    chains, device time by CUDA events: (ms, us a row)."""
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import drift

    topo, i = prob.topology, prob.topology[0]
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=DEVICE).contiguous()
    x, y = f(prob.train[:, :i]), f(prob.train[:, i])
    t = drift.make_targets(y, topo[2], prob.task).contiguous()
    w = torch.randn((chains, fnn.w_size(topo)), device=DEVICE)
    drift.sgd_epoch(w, x, t, topo, 0.01, mode="pallas")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        drift.sgd_epoch(w, x, t, topo, 0.01, mode="pallas")
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    return ms, 1e3 * ms / x.shape[0]


def phase_parity_singles():
    """The parity runners of many single runs on the card (``python -m
    ptnn_torch.experiments.parity singles`` and ``bands``), at
    PARITY_REG_SAMPLES / PARITY_CLS_SAMPLES:

    * ``singles``, every section: each row's single run (seed 0) with
      launches exactly its plan (the drift by the register kernel), then
      the one-cell ``seed_sweep`` of its configuration, equal in accepts
      and swap % and within G_RTOL / G_ATOL in the mean and best of the
      train and test metric on the grid's window (``summarize``'s); the
      regression rows in GRID_BANDS, the classification rows in ptnn's
      PARITY_REF bands; the Langevin regression rows equal to the cells of
      a ``dataset_grid`` at phase_sweeps' configuration whose every cell
      replays seed 0's start and draws (the RW rows draw no Langevin
      choice, which the grid's cells draw: their streams part);
    * ``bands`` of PARITY_BANDS: a grid cell's launches the grid's plan, a
      five-run cell's each run's; every seed in ptnn's band and the cell's
      mean in ptnn's band of a five-seed mean; each five-run cell equal in
      accepts and swap % to the five-cell ``seed_sweep`` of its
      configuration, and its seed 0 run to the ``singles`` row of the set;
    * each run's wall and ms a step, and at the big sets' legacy-LG rows the
      register drift's us a row over their train rows, beside the card's
      name and power limit.

    Returns the launches by kernel."""
    import contextlib
    import io

    import numpy as np

    from ptnn_torch import data, kernel, sampler, sweeps
    from ptnn_torch.experiments import parity

    t_phase = time.perf_counter()
    card = card_line()
    PARITY_OUT.mkdir(parents=True, exist_ok=True)
    stdout = sys.stdout
    total = {name: 0 for name in KERNELS}
    lg_rows, lg_seed0 = {}, {}

    def counted():
        got = {name: launch_count(name) for name in KERNELS}
        for name, n in got.items():
            total[name] += n
        return got

    def load(name):
        return (data.load_regression(name) if name in parity.REF_RW
                else data.load_classification(name, seed=0))

    def same_counts(tag, accept_pct, swap_pct, cfg, accepts, swap):
        n = int(round(float(accept_pct) * cfg.samples_per_chain
                      * cfg.num_chains / 100.0))
        check(n == accepts and float(swap_pct) == float(swap),
              f"{tag}: {accepts} accepts, swap {swap} %; its grid {n}, "
              f"{float(swap_pct)} %")

    def on_row(table, key, cfg, s, res):
        wall = 60.0 * s.time_min
        single_plan(cfg, counted())
        prob = load(s.problem)
        reset_launch_counts()
        grid = sweeps.seed_sweep(cfg, [0], prob.train, prob.test,
                                 device=DEVICE)
        by_register(grid_plan(cfg, counted(),
                              batch=cfg.drift_mode == "batch"),
                    f"singles {table} {key}'s grid")
        tag = f"singles {table} {key}"
        accepts = int(res.final_state.n_accept.sum())
        same_counts(tag, grid["accept_pct"][0], grid["swap_pct"][0], cfg,
                    accepts, res.swap_percent)
        for stat in ("test_mean", "test_best", "train_mean", "train_best"):
            g, w = float(grid[stat][0]), getattr(s, stat)
            check(abs(g - w) <= G_ATOL + G_RTOL * abs(w),
                  f"{tag}: {stat} {w} against its one-cell grid's {g}")
        vals = dict(test_mean=s.test_mean, accept_pct=s.accept_per,
                    swap_pct=s.swap_perc)
        mode = dict(lprob="lg01").get(table, table[4:])
        if table.startswith("cls-"):
            band = family_check(f"singles {table}",
                                {m: [v] for m, v in vals.items()}, [0],
                                PARITY_REF[mode, key])
        elif table.startswith("reg-") or (table, key) == ("lprob", 0.5):
            lo_hi = GRID_BANDS["reg", (s.problem, mode)]
            for (lo, hi), (m, v) in zip(lo_hi, vals.items()):
                check(lo <= v <= hi, f"{tag}: {m} {v:.5g} outside ptnn's "
                      f"({lo}, {hi})")
            band = f"in GRID_BANDS {('reg', (s.problem, mode))}"
        else:
            check(all(np.isfinite(v) for v in vals.values()),
                  f"{tag}: not finite {vals}")
            band = "finite (no band)"
        if table.startswith("reg-lg"):
            lg_rows[s.problem, mode] = (accepts, res.swap_percent, s)
        if table == "cls-lg":
            lg_seed0[key] = (accepts, res.swap_percent)
        if table == "cls-lg" and key in parity.BAND_BIG:
            ms, us = drift_row_us(prob)
            band += (f"; the register drift {ms:.4f} ms an epoch at 10 "
                     f"chains x {prob.train.shape[0]} rows, {us:.4f} us a "
                     f"row at {prob.topology} ({card})")
        print(f"[4/6] parity singles: {table} {key} ({cfg.topology}, "
              f"{cfg.num_chains} x {cfg.samples_per_chain}, swaps every "
              f"{cfg.swap_interval}, drift {cfg.drift_mode}) {wall:.2f} s, "
              f"{1e3 * wall / cfg.n_steps:.3f} ms a step ({card}): test "
              f"{s.test_mean:.5g}, accept {s.accept_per:.4g}, swap "
              f"{s.swap_perc:.4g}; equal to its one-cell grid ({accepts} "
              f"accepts); {band}", file=stdout, flush=True)
        reset_launch_counts()

    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        lines = parity.singles(PARITY_REG_SAMPLES, PARITY_CLS_SAMPLES,
                               parity.SECTIONS,
                               str(PARITY_OUT / "singles.md"), DEVICE,
                               on_row=on_row)
    t_singles = time.perf_counter() - t_phase
    rows = sum(ln.startswith("| ") and not ln.startswith("|---")
               for ln in lines) - 8
    check(rows == 46, f"singles printed {rows} rows, not 46")
    # the Langevin regression rows against dataset_grid's cells, every cell
    # seed 0's start and stream
    cfg = parity.regression_cfg(PARITY_REG_SAMPLES)
    gcfg = sweeps._grid_cfg(cfg, use_langevin_gradients=True)
    cells = [(n, m) for n in GRID_REG_NAMES for m in sweeps.REGRESSION_MODES]
    probs = {n: data.load_regression(n) for n in GRID_REG_NAMES}
    grid_data = sampler.make_grid_dataset(
        gcfg, [(probs[n].train, probs[n].test, gcfg.topology)
               for n, _m in cells], DEVICE)
    seeds = [0] * len(cells)
    reset_launch_counts()
    out = sweeps.dataset_grid(
        cfg, list(GRID_REG_NAMES), seed=0, device=DEVICE,
        init_state=sampler.init_grid(gcfg, grid_data, seeds),
        noise_fn=sampler.grid_noise(seeds, DEVICE,
                                    kernel.step_noise_names(gcfg),
                                    gcfg.num_chains))
    by_register(grid_plan(gcfg, counted()), "singles' dataset_grid")
    for (name, mode), (accepts, swap, s) in sorted(lg_rows.items()):
        k = cells.index((name, mode))
        tag = f"singles reg-{mode} {name} against dataset_grid"
        same_counts(tag, out["accept_pct"][k], out["swap_pct"][k], cfg,
                    accepts, swap)
        for stat in ("test_mean", "test_best", "train_mean", "train_best"):
            g, w = float(out[stat][k]), getattr(s, stat)
            check(abs(g - w) <= G_ATOL + G_RTOL * abs(w),
                  f"{tag}: {stat} {w} against {g}")
    print(f"[4/6] parity singles: the {len(lg_rows)} Langevin regression "
          f"rows equal to their cells of dataset_grid at phase_sweeps' "
          f"configuration with every cell on seed 0's start and draws "
          f"(accepts and swap % exactly, statistics within rtol {G_RTOL})")
    print(f"[4/6] parity singles: python -m ptnn_torch.experiments.parity "
          f"singles --samples-reg {PARITY_REG_SAMPLES} --samples-cls "
          f"{PARITY_CLS_SAMPLES}: 46 runs in {t_singles:.1f} s with their "
          f"checks ({card}):")
    for line in lines:
        if line.startswith(("|", "#")):
            print(f"[4/6] parity singles:   {line}")
    for mode, names in PARITY_BANDS.items():
        legacy = mode == "lg"

        def on_cell(name, cell, wall):
            prob = load(name)
            cfg = parity.band_cfg(name, prob.topology, legacy,
                                  PARITY_CLS_SAMPLES)
            big = legacy and name in parity.BAND_BIG
            if big:
                single_plan(cfg, counted(), runs=len(parity.BAND_SEEDS))
            else:
                by_register(grid_plan(cfg, counted()),
                            f"bands {mode} {name}")
            verdict = family_check(f"bands {mode} {name}", cell,
                                   list(parity.BAND_SEEDS),
                                   PARITY_REF[mode, name])
            extra = ""
            if big:
                reset_launch_counts()
                grid = sweeps.seed_sweep(cfg, list(parity.BAND_SEEDS),
                                         prob.train, prob.test,
                                         device=DEVICE)
                by_register(grid_plan(cfg, counted()),
                            f"bands {mode} {name}'s seed_sweep")
                for k, seed in enumerate(parity.BAND_SEEDS):
                    same_counts(f"bands {name} seed {seed}",
                                grid["accept_pct"][k], grid["swap_pct"][k],
                                cfg, int(cell["accepts"][k]),
                                cell["swap_pct"][k])
                check((int(cell["accepts"][0]), float(cell["swap_pct"][0]))
                      == lg_seed0[name], f"bands {name} seed 0 against its "
                      f"singles row {lg_seed0[name]}")
                extra = ("; equal to the five-cell seed_sweep in accepts "
                         "and swap % and its seed 0 to the singles row")
            steps = cfg.n_steps * (5 if big else 1)
            how = (f"five single runs, drift {cfg.drift_mode}" if big
                   else "one seed_sweep of 5 cells")
            print(f"[4/6] parity bands: {mode} {name} ({how}, 10 x "
                  f"{cfg.samples_per_chain}) {wall:.2f} s, "
                  f"{1e3 * wall / steps:.3f} ms a step ({card}): "
                  f"{verdict}{extra}", file=stdout, flush=True)
            reset_launch_counts()

        reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            lines = parity.bands(list(names), mode, PARITY_CLS_SAMPLES,
                                 out=str(PARITY_OUT / f"bands_{mode}.md"),
                                 device=DEVICE, on_cell=on_cell)
        for line in lines:
            print(f"[4/6] parity bands:   {line}")
    print(f"[4/6] parity: phase in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return total


# phases run in subprocesses of their own, beside the phases of the main
# process (each run is deterministic in its seed, so only the walls move):
# the digits CNN's MALA / ChEES receipts, the card's heaviest work, beside
# the host-bound Sunspot and Ionosphere runs and the command lines that
# follow them; the grids beside the lifecycle, VR and surrogate phases,
# whose command lines' start-up leaves the card near idle; the parity
# runners' many host-bound single runs beside the CNN's receipts
BACKGROUND = {"cnn": ("phase_cnn_precond_end_to_end",),
              "parity": ("phase_parity_singles",),
              "grids": ("phase_sweeps", "phase_grid_families",
                        "phase_grid_vref")}
BACKGROUND_OUT = ROOT / "build" / "chip_smoke_background"


def run_phases(names):
    """``--phases``: the named phases in this process, each timed, then one
    line of their launches by kernel (read by ``finish_background``)."""
    total = {name: 0 for name in KERNELS}
    for name in names:
        with clock(name):
            for kern, n in (globals()[name]() or {}).items():
                if kern in total:
                    total[kern] += n
    print("launches " + json.dumps(total), flush=True)
    return 0


def start_background(tag):
    """``run_phases(BACKGROUND[tag])`` in a subprocess, its output to
    files under BACKGROUND_OUT."""
    BACKGROUND_OUT.mkdir(parents=True, exist_ok=True)
    out = open(BACKGROUND_OUT / f"{tag}.out", "w")
    err = open(BACKGROUND_OUT / f"{tag}.err", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--phases", *BACKGROUND[tag]], cwd=ROOT,
                            stdout=out, stderr=err, text=True)
    out.close()
    err.close()
    return proc


def finish_background(proc, tag):
    """Waits for a background subprocess, prints its lines and returns its
    phases' launches by kernel; fails unless it exited 0."""
    proc.wait(timeout=900)
    lines = (BACKGROUND_OUT / f"{tag}.out").read_text().splitlines()
    for line in lines[:-1]:
        print(line)
    stderr = (BACKGROUND_OUT / f"{tag}.err").read_text()
    check(proc.returncode == 0 and lines and lines[-1].startswith(
        "launches "), f"background phases {', '.join(BACKGROUND[tag])} "
        f"exited with {proc.returncode}: {stderr[-2000:]}")
    return json.loads(lines[-1][len("launches "):])


def stop(proc):
    """Kills a background subprocess still running."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


class clock:
    """``with clock(what):`` prints the block's wall time on a line of its
    own."""

    def __init__(self, what):
        self.what = what

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        print(f"[time] {self.what}: {time.perf_counter() - self.t0:.1f} s")


def main() -> int:
    with clock("phase_device"):
        phase_device()
    with clock("phase_build"):
        phase_build()
    with clock("phase_kernel"):
        errs = {"rw_block": phase_kernel()}
    with clock("phase_precond_kernels"):
        errs.update(phase_precond_kernels())
        phase_generic_rounding()
    with clock("phase_cls_kernels"):
        errs.update(phase_cls_kernels())
    with clock("phase_drift_kernel"):
        errs["drift_epoch"] = phase_drift_kernel()
    with clock("phase_eval_kernel"):
        errs["fnn_eval"] = phase_eval_kernel()
    with clock("phase_grid_kernels"):
        d_err, e_err, _grid_times = phase_grid_kernels()
    errs["drift_epoch"] = max(errs["drift_epoch"], d_err)
    errs["fnn_eval"] = max(errs["fnn_eval"], e_err)
    with clock("phase_wide_kernels"):
        d_err, e_err, _wide_times = phase_wide_kernels()
    errs["drift_epoch"] = max(errs["drift_epoch"], d_err)
    errs["fnn_eval"] = max(errs["fnn_eval"], e_err)
    with clock("phase_conv_kernel"):
        errs["conv1_relu_pool"] = phase_conv_kernel()
    with clock("phase_swap"):
        phase_swap()
    times = {"rw_block": time_block(64, 100, record_w=True)}
    with clock("phase_end_to_end, phase_flagship"):
        launches = {"rw_block": phase_end_to_end(),
                    "hmc_block": phase_flagship()}
    with clock("phase_mala_end_to_end"):
        launches["mala_block"], mala_twin = phase_mala_end_to_end()
    with clock("phase_iris_end_to_end"):
        launches.update(phase_iris_end_to_end())
    with clock("phase_cls_rw_end_to_end"):
        phase_cls_rw_end_to_end()
    with clock("phase_generic_end_to_end"):
        generic = phase_generic_end_to_end()
    for name, n in generic.items():
        launches[name] = launches.get(name, 0) + n
    with clock("phase_per_step_end_to_end"):
        lg = phase_per_step_end_to_end()
    launches.update(drift_epoch=lg["drift_epoch"], fnn_eval=lg["fnn_eval"])
    with clock("phase_zoo_end_to_end"):
        launches["conv1_relu_pool"] = phase_zoo_end_to_end()
    bgs = {}
    try:  # a failed check leaves no subprocess behind
        bgs["cnn"] = start_background("cnn")
        bgs["parity"] = start_background("parity")
        with clock("phase_per_step_precond_end_to_end"):
            phase_per_step_precond_end_to_end(mala_twin)
        bgs["grids"] = start_background("grids")
        with clock("phase_run_lifecycle"):
            phase_run_lifecycle()
        with clock("phase_vr_paths"):
            phase_vr_paths()
        with clock("phase_surrogate_auto"):
            for name, n in phase_surrogate_auto().items():
                launches[name] = launches.get(name, 0) + n
        with clock("background: " + ", ".join(BACKGROUND["grids"])):
            for name, n in finish_background(bgs["grids"], "grids").items():
                launches[name] = launches.get(name, 0) + n
        with clock("phase_sgld_bf16"):
            for name, n in phase_sgld_bf16().items():
                launches[name] = launches.get(name, 0) + n
        with clock("background: " + ", ".join(BACKGROUND["cnn"])):
            finish_background(bgs["cnn"], "cnn")
        with clock("background: " + ", ".join(BACKGROUND["parity"])):
            for name, n in finish_background(bgs["parity"],
                                             "parity").items():
                launches[name] = launches.get(name, 0) + n
    finally:
        for proc in bgs.values():
            stop(proc)
    with clock("phase_throughput"):
        phase_throughput()
    with clock("phase_precond_throughput"):
        times.update(phase_precond_throughput())
    with clock("phase_cls_throughput"):
        times.update(phase_cls_throughput())
    with clock("phase_generic_throughput"):
        for name, t in phase_generic_throughput().items():
            times[name] = dict(times[name], **t,
                               generic_launches=generic.get(name, 0))
    with clock("phase_per_step_throughput"):
        times.update(phase_per_step_throughput())
    with clock("phase_zoo_throughput"):
        times.update(phase_zoo_throughput())
    with clock("phase_per_step_precond_throughput"):
        phase_per_step_precond_throughput()
    import torch

    print(json.dumps({"kernels": [dict({
        "name": name,
        "route": "cuda",
        "source": f"ptnn_torch/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": errs[name],
        # no single PyTorch call computes a fused MH block, a drift epoch
        # or a fused eval; the conv stage has F.conv2d + relu + avg_pool2d
        "library_ms": None,
    }, **times[name]) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def precond_seeds(seeds):
    """The ChEES comparisons of phase 3 off their default inputs: Sunspot at
    256 chains (two panels), 100 and 52 (one panel, the last block half
    empty), and iris at 64, 256 and 52, each on the inputs of every seed in
    ``seeds``; one line each with the verdict, the excluded chains and the
    float64 witness's readings. Returns 1 if any failed."""
    from ptnn_torch.ops import _build

    phase_device()
    _build.build_all(["hmc_block", "hmc_cls_block"])
    phases = dict(warm_end=2, pc_start=4, burn_end=8)
    failed = 0
    for kernel, c in (("hmc_block", 256), ("hmc_block", 100),
                      ("hmc_block", 52), ("hmc_cls_block", 64),
                      ("hmc_cls_block", 256), ("hmc_cls_block", 52)):
        for seed in seeds:
            head = f"[seeds] {kernel} ChEES C={c} inputs of seed {seed}:"
            try:
                if kernel == "hmc_block":
                    n_close, n_groups, n_acc, err, wit = compare_precond(
                        precond_cfg(c, 100, "hmc"), 10, 0, phases, seed)
                else:
                    n_close, n_groups, n_acc, _f, err, _of, wit = compare_cls(
                        "hmc", iris_cfg(c, 100, "hmc", step_w=CLS_STEP_HMC),
                        10, 10, 0, phases, seed)
            except SmokeError as e:
                failed += 1
                print(f"{head} FAIL: {e}")
                continue
            print(f"{head} ok; {n_acc} accepts, {n_close} chains ({n_groups} "
                  f"ChEES groups) excluded, max |diff| {err:.3g}; "
                  f"{witness_text(wit)}")
    return int(failed > 0)


def walls(root):
    """Times for the checkout at ``root``, as one JSON line, so that two
    checkouts can be compared on one card by running this mode on each in
    turns (A, B, B, A, ...): the drift epoch at the per-step paths' widths
    (Sunspot (4, 10, 1) 64 chains x 298 rows, Ionosphere (34, 50, 2) 10 x
    245, PenDigit (16, 30, 10) 10 x 7494), one adapting 10-step ChEES-HMC
    block at 1024 chains (Sunspot) and at 64 (iris), and conv1_relu_pool at
    256 chains x 1257 images (CUDA events); one adapting 10-step MALA block
    (iris at 64 chains, Sunspot at 64 and 1024) and one 100-step Sunspot RW
    block at 64 and at 1024 chains (device time, a CUDA graph of 100 calls,
    and the host loop's time a call); the Sunspot rw_fused throughput at
    1024 chains x
    2000 samples (three reps of throughput_runner); the eval's device time
    (a CUDA graph of 100 calls)
    at Ionosphere's train rows and for a step's evals (the train and the
    test rows: the pair where the checkout has it, else two calls) at
    Sunspot 64 chains and Ionosphere 10; the default per-step noise of
    the 64 x 5000 runs, drawn chunk by chunk and sliced a step at a time as
    the sampler does (host clock around a synchronised loop); and the walls
    of ptnn_torch.sample for Sunspot rw_fused and mala_fused_16x4 64 x
    5000, lg_pallas 64 x 5000, rw per-step 64 x 5000,
    Ionosphere legacy LG 10 x 5000, chees16_fused_256x4 1024 x 8000, iris
    chees16_fused_16x4 and mala_fused_16x4 64 x 8000 (seed 1) and the
    digits CNN (fused eval) 256 x 300 (host clock around a synchronised
    run, trace fetch included),
    each run twice. Also the classification RW block (``rw_cls_walls``).
    Uses only what ``root``'s
    ptnn_torch has had since its model zoo was ported."""
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(root))
    import ptnn_torch
    from ptnn_torch.ops import _build

    check(Path(ptnn_torch.__file__).resolve().is_relative_to(root),
          f"ptnn_torch imported from {ptnn_torch.__file__}, not {root}")
    _build.build_all(list(KERNELS))
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "walls_s": {}}
    rw_cls_walls(out)
    other_walls(out)
    print(json.dumps(out))
    return 0


def rw_cls_walls(out):
    """The classification RW block's device time (a CUDA graph of 100
    calls) and host-loop time, K 100, no w trace, at 10 and 1024 chains:
    iris, and Cancer, TicTac and Ionosphere where the checkout's kernel
    takes them (``rw_cls_graph_ms``, ``rw_cls_ms``, keyed "set chains");
    and the walls of the iris and Cancer RW presets (10 x 5000, record_w),
    each run twice: Cancer runs per-step where the checkout has no fused
    kernel for it."""
    import ptnn_torch
    from ptnn_torch.ops import block_step

    sets = ["iris"]
    if hasattr(block_step, "cls_fixed_topologies"):
        sets += ["Cancer", "TicTac", "Ionosphere"]
    out["rw_cls_graph_ms"], out["rw_cls_ms"] = {}, {}
    for name in sets:
        for c in (10, 1024):
            cfg = rw_preset_cfg(name, 2000, c)
            state, noise, kdata, at, scal = cls_inputs(cfg, 100, 20,
                                                       dict(adapt=False),
                                                       name=name)
            kern = lambda: cls_call("rw", state, noise, 20, 100, kdata, at,
                                    scal, plain=False, record_w=False,
                                    topo=cfg.topology)
            out["rw_cls_ms"][f"{name} {c}"] = min(time_ms(kern, 20)
                                                  for _ in range(2))
            out["rw_cls_graph_ms"][f"{name} {c}"] = min(graph_ms(kern)
                                                        for _ in range(2))
    for name in ("iris", "Cancer"):
        prob = cls_set(name)
        cfg = rw_preset_cfg(name, record_w=True)
        out["walls_s"][f"{name} RW preset"] = [
            ptnn_torch.sample(cfg, prob.train, prob.test, seed=0,
                              device=DEVICE).elapsed_s for _ in range(2)]


def other_walls(out):
    """``walls``' measurements of the other kernels and paths."""
    import numpy as np
    import torch

    import ptnn_torch
    from ptnn_torch import data, kernel, sampler
    from ptnn_torch.models import fnn
    from ptnn_torch.ops import drift

    rng = np.random.default_rng(31)
    out.update(drift_ms={}, noise_ms={})
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=DEVICE).contiguous()
    for label, prob, c in (
            ("Sunspot", data.load_regression("Sunspot"), 64),
            ("Ionosphere", data.load_classification("Ionosphere"), 10),
            ("PenDigit", data.load_classification("PenDigit"), 10)):
        topo = prob.topology
        i = topo[0]
        x, y = f(prob.train[:, :i]), f(prob.train[:, i])
        t = drift.make_targets(y, topo[2], prob.task).contiguous()
        w = f(rng.normal(size=(c, fnn.w_size(topo))))
        reps = 3 if x.shape[0] > 1000 else 20
        out["drift_ms"][label] = min(
            time_ms(lambda: drift.sgd_epoch(w, x, t, topo, 0.01), reps)
            for _ in range(2))
    adapting = dict(warm_end=0, pc_start=0, burn_end=1000)
    out["hmc_ms"] = time_precond_block(precond_cfg(1024, 2000, "hmc"),
                                       adapting)["ms"]
    out["hmc_cls_ms"] = time_cls_block("hmc", iris_cfg(64, 2000, "hmc"), 10,
                                       adapting, False)["ms"]
    t = time_cls_block("mala", iris_cfg(64, 2000, "precond_mala"), 10,
                       adapting, False)
    out["mala_cls_ms"], out["mala_cls_graph_ms"] = t["ms"], t["graph_ms"]
    for key in ("mala_ms", "mala_graph_ms", "rw_ms", "rw_graph_ms"):
        out[key] = {}
    for c in (64, 1024):
        kern = precond_kernel_call(precond_cfg(c, 2000, "precond_mala"),
                                   adapting)[0]
        out["mala_ms"][str(c)] = min(time_ms(kern, 20) for _ in range(2))
        out["mala_graph_ms"][str(c)] = min(graph_ms(kern) for _ in range(2))
        kern = rw_kernel_call(c, 100, False)[0]
        out["rw_ms"][str(c)] = min(time_ms(kern, 20) for _ in range(2))
        out["rw_graph_ms"][str(c)] = min(graph_ms(kern) for _ in range(2))
    sunspot_prob = data.load_regression("Sunspot")
    runner = ptnn_torch.throughput_runner(rw_fused_cfg(1024, 2000),
                                          sunspot_prob.train,
                                          sunspot_prob.test, device=DEVICE)
    out["rw_fused_1024_rate"] = [runner()["chain_steps_per_sec"]
                                 for _ in range(3)]
    from ptnn_torch.ops import fnn_eval

    out["eval_ms"] = {}
    for label, prob, c in (
            ("Sunspot", data.load_regression("Sunspot"), 64),
            ("Ionosphere", data.load_classification("Ionosphere"), 10)):
        topo, task = prob.topology, prob.task
        i = topo[0]
        x, y = f(prob.train[:, :i]), f(prob.train[:, i])
        xt, yt = f(prob.test[:, :i]), f(prob.test[:, i])
        w = f(rng.normal(size=(c, fnn.w_size(topo))))
        tau = torch.full((c,), 0.05, dtype=torch.float32, device=DEVICE)
        if hasattr(fnn_eval, "fnn_eval_pair"):
            step = lambda: fnn_eval.fnn_eval_pair(w, x, y, xt, yt, tau, topo,
                                                  task)
        else:
            step = lambda: (fnn_eval.fnn_eval(w, x, y, tau, topo, task),
                            fnn_eval.fnn_eval(w, xt, yt, tau, topo, task))
        out["eval_ms"][f"{label} step"] = min(graph_ms(step)
                                              for _ in range(2))
        if label == "Ionosphere":
            out["eval_ms"]["Ionosphere train"] = min(
                graph_ms(lambda: fnn_eval.fnn_eval(w, x, y, tau, topo, task))
                for _ in range(2))
    from ptnn_torch.ops import conv_stage

    x, w1, b1 = conv_inputs(*CONV_SHAPES[0])
    out["conv_ms"] = min(time_ms(lambda: conv_stage.conv1_relu_pool(
        x, w1, b1, *CONV_SHAPES[0][2:]), 20) for _ in range(2))
    lg = lg_cfg(64, 5000)
    rw = rw_fused_cfg(64, 5000, fused_step=False)
    for tag, cfg in (("lg_pallas", lg), ("rw per-step", rw)):
        n, switch = cfg.n_steps, cfg.temper_switch_step
        segments = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
        target = max(1, min(cfg.chunk_steps, n))
        c, w_size = cfg.num_chains, fnn.w_size(cfg.topology)
        runs = []
        for _ in range(2):
            noise_fn = sampler.step_noise(0, torch.device(DEVICE),
                                          kernel.step_noise_names(cfg))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a, b in segments:
                chunk = sampler._pick_chunk(b - a, target)
                for done in range(a, b, chunk):
                    length = min(chunk, b - done)
                    noise = noise_fn(done, length, c, w_size)
                    for k in range(length):
                        {m: v[k] for m, v in noise.items()}
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        out["noise_ms"][tag] = runs
    from ptnn_torch.models import cnn

    iono = data.load_classification("Ionosphere")
    for tag, cfg, prob, seed, spec in (
            ("rw_fused", rw_fused_cfg(64, 5000, record_w=True,
                                      track_replicas=True), sunspot_prob, 0,
             None),
            ("mala_fused_16x4", precond_cfg(64, 5000, "precond_mala",
                                            track_replicas=True),
             sunspot_prob, 0, None),
            ("lg_pallas", lg, sunspot_prob, 0, None),
            ("rw per-step", rw, sunspot_prob, 0, None),
            ("ionosphere_lg", iono_cfg(), iono, 0, None),
            ("chees16_fused_256x4", precond_cfg(
                1024, 8000, "hmc", record_w=True, record_w_chains=256,
                track_replicas=True), sunspot_prob, 0, None),
            ("iris chees16_fused_16x4", iris_cfg(64, 8000, "hmc"), iris(), 1,
             None),
            ("iris mala_fused_16x4", iris_cfg(64, 8000, "precond_mala"),
             iris(), 1, None),
            ("digits CNN 256x300", cnn_cfg(CNN_CHAINS, BAND_STEPS), digits(),
             0, cnn.digits_spec(fused_eval=True))):
        out["walls_s"][tag] = [
            ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                              device=DEVICE, model_spec=spec).elapsed_s
            for _ in range(2)]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--walls", nargs="?", const=str(ROOT), metavar="DIR",
                      help="print the kernel times and walls of the checkout "
                           "at DIR (default: this one) as JSON, no smoke")
    mode.add_argument("--precond-seeds", nargs="+", type=int, metavar="SEED",
                      help="run the ChEES kernel comparisons on the inputs "
                           "of each SEED, no smoke")
    mode.add_argument("--phases", nargs="+", metavar="PHASE",
                      help="run only these phases of the smoke (the kernels "
                           "built), then print their launches")
    opts = ap.parse_args()
    try:
        if opts.walls is not None:
            sys.exit(walls(Path(opts.walls).resolve()))
        if opts.precond_seeds:
            sys.exit(precond_seeds(opts.precond_seeds))
        if opts.phases:
            sys.exit(run_phases(opts.phases))
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
