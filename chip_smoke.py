#!/usr/bin/env python3
"""Smoke test of ptnn_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Two other modes print measurements and run no smoke: ``--walls [DIR]`` (the
kernel times and walls of the checkout at DIR, to compare two checkouts on
one card: ``walls``), and ``--precond-seeds SEED ...`` (the ChEES kernel
comparisons, regression and iris, on other inputs: ``precond_seeds``).

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
     classification MALA variants (warps a chain), every fnn_eval
     instantiation and both conv kernels must spill nothing, and every
     classification RW instantiation (both kernels, each fixed-shape
     network at each warps a chain) must have no stack frame either; the
     regression MALA plan at 64, 130 and 1024 chains and the RW plan at 64
     and 1024, the regression HMC exchange route (cluster or cooperative
     grid) the card's occupancy gives the ChEES layouts at 1024, 256 and 52
     chains, the classification HMC launch plan (warps a chain, route) at
     64, 256, 52 and 1024 chains, the classification MALA plan at 64, 256
     and 1024, the classification RW plan at the four RW presets' widths
     and at 1000 chains, and the eval's plans (cluster, row tiles, warps) at the
     per-step paths' widths;
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
     block.) The per-step sampler's kernels: the drift epoch at Sunspot
     (4, 10, 1) 64 chains (depth 1 and 2), Ionosphere (34, 50, 2) 10 chains
     on 245 rows and PenDigit (16, 30, 10) 10 chains on all 7494 train
     rows, then every distinct bundled topology and one the generic kernel
     runs, 10 chains on 64 random rows, each checking which kernel ran; the
     FNN eval at Sunspot 64 chains, Ionosphere 10 and 64 and PenDigit 10
     (all 7494 / 3498 rows), on the train rows, on the test rows and on both
     in one launch (the pair). The
     CNN's fused stage 1, conv1_relu_pool, at the digits widths (256 and
     128 chains x 1257 and 540 images, the fixed-shape kernel), ragged shapes, three
     input channels and the MNIST side (the generic kernel), and the fused
     CNN forward against the plain one;
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
     then the per-step sampler: Sunspot lg_pallas (64 x 5000, Langevin
     gradients), Sunspot rw per-step (64 x 5000) and Ionosphere legacy LG
     (10 x 5000), each with its drift and eval launches held to the plan (one
     eval a step for the train and the test rows);
     then the model zoo on the digits images: the Bayesian CNN,
     cnn.digits_spec(fused_eval=True), at cnn_digits's default configuration,
     256 chains on all 1257 / 540 rows, with its conv launches held to the
     plan; the same at 64 chains x 300 held to bands around the JAX
     package's run on the CPU; the fused eval against the plain eval on the
     same noise; a deep MLP; and the cnn_digits command line as a
     subprocess, with its artifact tree;
     then the per-step preconditioned family, each path with one eval
     launch a step (the test rows under MALA and HMC) plus init_state's and
     the temper switch's, every other kernel 0: Sunspot's fused twin
     chees16_fused_16x4 (64 x 5000; mala_fused_16x4's run above is the
     other twin), then bench.py's per-step mala, hmc, mala_16x4 and
     chees16_16x4 (64 x 5000, seed 0), the MALA runs' cold RMSE in
     0.01-0.04 and the HMC runs' in 0.005-0.0239, the twinned runs' mean
     accept and swap within 3 points of their twin's, the others' accept in
     40-75 %;
     Ionosphere's mala_fused_16x4 (bench.py's _cls_variants, 64 x 8000,
     seeds 1-3), which must fall back with ptnn's warning (w 1852 does not
     fit the fused block) and run per step, medians per-draw cold accuracy
     68-80 % and 14-28 round trips per ladder per 1k steps (BENCH_r05.json:
     73.72, 20.8), served accuracy printed; the digits CNN with
     digits_spec(fused_eval=True) at scripts/cnn_convergence.py's
     configuration, 128 chains = 32 ladders x 4 rungs x 1000 steps, seeds 1
     and 2, 16 cold rungs' w recorded, MALA and ChEES (8 leapfrog steps):
     medians served accuracy >= 95 % (the cold draws thinned along the draw
     axis, then pooled), per-draw 80-92 % (MALA) / 86-96 % (ChEES), pooled
     function-space R-hat <= 1.15 (ptnn's 1k rows: 96.76 / 98.24, 86.63 /
     91.71, 1.067 / 1.042), ChEES traj_len in [1, 8] and varying;
  5. throughput: throughput_runner at 2000 samples per chain (Sunspot
     rw_fused at 64 and 1024 chains, mala_fused_16x4, chees16_fused_256x4;
     iris chees16_fused_16x4 and chees16_fused_64x4; lg_pallas), and each
     kernel's time against its plain version's for one block (one epoch,
     one eval) at its path's widths (the RW and MALA blocks, both tasks,
     also as device time, a CUDA graph of 100 calls; the RW blocks also at
     1024 chains, the classification one also at the Cancer, TicTac and
     Ionosphere presets' widths;
     the eval at Sunspot, Ionosphere and
     PenDigit, one set and the pair; the iris MALA block also at 256 and
     1024 chains at 4 and at 1 warp a chain); the CNN's chain-steps/s, the conv
     kernel's time against its plain version's and the library's
     (F.conv2d + relu + F.avg_pool2d), one drift and one eval of a CNN
     step, and stage 2 as the port multiplies it against one grouped
     F.conv2d; the per-step preconditioned family's chain-steps/s (the CNN
     with MALA and ChEES at 128 chains x 50 steps, Sunspot mala_16x4 and
     chees16_16x4 at 64 x 500) and one CNN value-and-grad beside one
     Langevin drift at 128 and 256 chains;
  6. one JSON line listing the kernels (time, device time where measured,
     plain time, bound, launches,
     largest difference from the plain version), then the device line
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
# the classification RW presets the fixed-shape kernel runs: (topology, all
# rows, train + test)
CLS_RW_SETS = {"iris": (IRIS_TOPO, 150), "Cancer": ((9, 12, 2), 699),
               "TicTac": ((9, 25, 2), 958), "Ionosphere": ((34, 50, 2), 354)}
CLS_ROWS = {name: rows for name, (_t, rows) in CLS_RW_SETS.items()}
# the bundled sets whose networks the generic kernel runs
GENERIC_SETS = {"winequality-red": (11, 50, 10), "abalone": (8, 30, 29)}
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
    from ptnn_torch.ops import fnn_eval

    for label, c, rows, topo in EVAL_PLANS:
        plan = fnn_eval.launch_plan(c, rows, topo)
        print(f"[2/6] build: fnn_eval {label} {topo} C={c} rows {rows}: "
              f"clusters of {plan.cluster} blocks, {plan.tile_rows} rows a "
              f"block, {plan.row_groups} x {plan.hid_groups} warps (HPW "
              f"{plan.hid_per_warp}), {plan.blocks} blocks, {plan.smem} bytes "
              f"of shared memory")


def demangle(name):
    """``drift_reg_kernel<4, 10, 1, 4>`` from its mangled entry name."""
    import re

    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    ident = name[m.end():m.end() + int(m.group(1))]
    rest = name[m.end() + int(m.group(1)):]
    args = re.findall(r"Li(\d+)E", rest) if rest.startswith("I") else []
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

    rng = np.random.default_rng(seed)
    prob = sunspot()
    c = cfg.num_chains
    ds = make_dataset(cfg, prob.train, prob.test, DEVICE)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    st = kernel.init_state(cfg, ds, init_w=f(rng.normal(size=(c, 61))))
    state = fused._to_kernel_state(st, cfg)
    state["log_step_w"] = f(np.log(cfg.step_w) + 0.3 * rng.normal(size=c))
    noise = dict(w=f(rng.normal(size=(k, c, 61))),
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
    )
    from ptnn_torch.ops import precond_step

    for name, cfg, k, start, phases in cases:
        routes = dict(precond_step.hmc_routes)
        wpcs = dict(precond_step.mala_wpcs)
        n_close, n_groups, n_acc, err, wit = compare_precond(cfg, k, start,
                                                             phases)
        route = [r for r in routes if precond_step.hmc_routes[r] > routes[r]]
        out[name] = max(out.get(name, 0.0), err)
        what = ("ChEES, " if cfg.hmc_adapt_traj and name == "hmc_block"
                else "") + (f"leapfrog {cfg.hmc_leapfrog}, route "
                            f"{'/'.join(route)}, "
                            if name == "hmc_block" else "")
        if name == "mala_block":
            plan = precond_step.card_mala_plan(DEVICE, cfg.num_chains, 496)
            taken = [w for w in wpcs if precond_step.mala_wpcs[w] > wpcs[w]]
            check(taken == [plan.wpc], f"mala_block took WPC {taken}, "
                  f"planned {plan.wpc}")
            what = f"WPC {plan.wpc}, {plan.blocks} blocks, "
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


def time_precond_block(cfg, phases):
    """Times of one 10-step Sunspot MALA or HMC block at cfg's widths and of
    its plain version, and the block's bound; for the MALA kernel, whose
    call the host issues about as fast as the card runs it, also its device
    time (``graph_ms``, a CUDA graph of 100 calls)."""
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
    if not hmc:
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
    of its plain version; MALA and HMC are built for iris's network."""
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
    return fn(state, noise, start, length, kdata, at, IRIS_TOPO, scal,
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
    from ptnn_torch.ops import block_step

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
    if kind == "hmc":  # the float64 witness: the same inputs in float64
        new_d, tr_d = cls_call(kind, upcast(state), upcast(noise), start,
                               length, upcast(kdata), at.double(), scal,
                               plain=True)
        same = new_d["n_accept"] == new_r["n_accept"]
        for n in ("accept_count", "traj_len"):
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
                                        kdata["yi_tr"], IRIS_TOPO)[1]
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
             ("hmc", hmc(1024, **plain), 10, 10, 0, phases, "iris")]
    for kind, cfg, k, length, start, phases, set_name in cases:
        routes = dict(precond_cls_step.hmc_cls_routes)
        wpcs = dict(precond_cls_step.mala_cls_wpcs)
        kinds = dict(block_step.cls_variant_launches)
        warps = dict(block_step.rw_cls_warps)
        n_close, n_groups, n_acc, excluded, err, err_of, wit = compare_cls(
            kind, cfg, k, length, start, phases, name=set_name)
        name = KERNEL_OF[kind]
        out[name] = max(out.get(name, 0.0), err)
        what, wit_txt = "", ""
        if kind == "hmc":
            c = cfg.num_chains
            panel = min(c, 128) if cfg.hmc_adapt_traj else 0
            plan = precond_cls_step.card_plan(DEVICE, c, panel, 150)
            taken = [r for r in routes
                     if precond_cls_step.hmc_cls_routes[r] > routes[r]]
            check(taken == [plan.route], f"hmc_cls_block took {taken}, "
                  f"planned {plan.route}")
            what = (f"ChEES ({c // panel} panels), " if panel else "")
            what += (f"leapfrog {cfg.hmc_leapfrog}, WPC {plan.wpc}, "
                     f"{plan.blocks} blocks, route {plan.route}, ")
            wit_txt = f"; {witness_text(wit)}"
        if kind == "mala":
            plan = precond_cls_step.card_mala_plan(DEVICE, cfg.num_chains, 150)
            taken = [w for w in wpcs
                     if precond_cls_step.mala_cls_wpcs[w] > wpcs[w]]
            check(taken == [plan.wpc], f"mala_cls_block took WPC {taken}, "
                  f"planned {plan.wpc}")
            what = f"WPC {plan.wpc}, {plan.blocks} blocks, "
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
                   block_step.rw_cls_warps, drift.variant_launches):
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


def time_cls_block(kind, cfg, k, phases, record_w, name="iris"):
    """Times of one block of a classification kernel on the rows of the
    bundled set ``name`` (from the host loop) and its plain version, and
    the block's bound; for the MALA and RW kernels, whose calls the host
    may issue more slowly than the card runs them, also the device time
    (``graph_ms``, a CUDA graph of 100 calls)."""
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
    if kind in ("mala", "rw"):
        out["graph_ms"] = min(graph_ms(kern), graph_ms(kern))
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
        t = time_cls_block("rw", rw_preset_cfg(name, 2000, c), 100,
                           dict(adapt=False), False, name=name)
        print(f"[5/6] throughput: rw_cls_block {name} {topo} at {c} chains "
              f"({plan.warps} warps a chain), K 100, no w trace: kernel "
              f"{t['graph_ms']:.4f} ms of device time (a CUDA graph of 100 "
              f"calls), {t['ms']:.4f} ms a call from the host loop, plain "
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
    runs."""
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
    returns the largest |diff| and each case's numbers for the report."""
    import numpy as np
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import drift

    rng = np.random.default_rng(23)
    err, rows = 0.0, {}
    for label, topo, _task, c, x, t, depth, main in drift_cases():
        # on random rows, weights of half the scale keep the sigmoids of the
        # wider nets out of saturation, so the epoch moves w
        w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo)))
                            * (1.0 if main else 0.5),
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
        rows[(label, depth)] = (float(diff.max()), rel)
        how = f"register kernel, G={group}" if kind == "register" else kind
        print(f"[3/6] kernel: drift_epoch {label} {topo} ({how}) C={c} "
              f"N={x.shape[0]} depth {depth}: w within rtol {D_RTOL} of each "
              f"chain's scale, atol {D_ATOL} (max |diff| "
              f"{float(diff.max()):.3g}, {rel:.3g} of the chain's scale; the "
              f"epoch moved w by up to {moved:.3g})")
    return err, rows


def eval_cases():
    """(label, topology, task, chains, (x_tr, y_tr), (x_te, y_te)) at the
    per-step paths' widths: Sunspot 64 chains, Ionosphere 10 and 64 (the
    fused MALA config's fallback) and PenDigit 10 (the drift's third
    width), train and test rows."""
    import torch

    from ptnn_torch import data

    out = []
    for label, prob, c in (
            ("Sunspot", sunspot(), 64),
            ("Ionosphere", data.load_classification("Ionosphere"), 10),
            ("Ionosphere", data.load_classification("Ionosphere"), 64),
            ("PenDigit", data.load_classification("PenDigit"), 10)):
        topo = prob.topology if prob.task == "classification" else (4, 10, 1)
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
    from ptnn_torch.ops import block_step, fnn_eval

    rng = np.random.default_rng(29)
    err = 0.0
    for label, topo, task, c, train, test in eval_cases():
        w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo))),
                            dtype=torch.float32, device=DEVICE)
        tau = torch.as_tensor(rng.uniform(0.01, 0.2, size=c),
                              dtype=torch.float32, device=DEVICE)
        for what, kern, plain, sets in eval_calls(label, topo, task, train,
                                                  test):
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
            print(f"[3/6] kernel: fnn_eval {what} {topo} C={c} N={rows}, one "
                  f"launch: ll within rtol {RTOL} of its terms (max |diff| "
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
    """lg_pallas chain-steps/s (throughput_runner, 2000 samples), and one
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
    runner = ptnn_torch.throughput_runner(lg_cfg(64, 2000), prob.train,
                                          prob.test, device=DEVICE)
    reps = [runner() for _ in range(3)]
    rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
    print(f"[5/6] throughput: lg_pallas 64 chains x 2000 samples: median "
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
            if what == "Sunspot train":
                out["fnn_eval"] = dict(ms=dev_ms, issue_ms=issue_ms,
                                       plain_ms=p_ms, bound_ms=b_ms,
                                       bound_by=b_by)
            if what == "Sunspot pair":  # what lg_pallas launches every step
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
CNN_CHAINS, CNN_STEPS = 256, 2000  # the full-width run (cnn_digits's default)
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
    """The model zoo through ptnn_torch.sample on the card; returns the conv
    kernel's launches in the full-width run."""
    import shutil

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
    # --- the command line, as a subprocess -----------------------------------
    out = ROOT / "build" / "chip_smoke_cnn"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "ptnn_torch.experiments.cnn_digits",
           "--chains", str(CLI_CHAINS), "--steps", str(CLI_STEPS), "--adapt",
           "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cnn_digits exited with {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
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
          f"--chains {CLI_CHAINS} --steps {CLI_STEPS} --adapt exited 0 in {wall:.1f} s: "
          f"{line.split(' -> ')[0]}; {n_files} text files, config.json and "
          f"metrics.jsonl under {run.relative_to(ROOT)}")
    return launches


# ---------------------------------------------------------------------------
# The per-step preconditioned family (precond_mala, hmc with and without
# ChEES) through ptnn_torch.sample: plain PyTorch around the eval kernels,
# fnn_eval for the FNN's test rows (grad mode) and conv1_relu_pool for the
# CNN's; the fused gate's fallback (Ionosphere); the fused twins beside
# their per-step runs (Sunspot).

# the digits CNN as scripts/cnn_convergence.py:68-95 samples it at 1000
# steps a chain: ptnn's records (results/cnn_convergence.md, the 1k rows):
# served accuracy, per-draw cold accuracy, pooled function-space R-hat
CNN_PC_CHAINS, CNN_PC_STEPS, CNN_PC_SEEDS = 128, 1000, (1, 2)
CNN_PC_REF = {"mala": (96.76, 86.63, 1.067), "chees": (98.24, 91.71, 1.042)}
CNN_PC_SERVED = 95.0  # median served accuracy over the seeds, at least
CNN_PC_DRAW = {"mala": (80.0, 92.0), "chees": (86.0, 96.0)}
CNN_PC_RHAT = 1.15  # pooled function-space R-hat, at most
CNN_PC_SERVE_ROWS = 1000  # cold draws the served predictor pools, about
# Ionosphere: bench.py's _cls_variants(...)["mala_fused_16x4"] (64 x 8000,
# seeds 1-3), which the fused gate refuses (w 1852): BENCH_r05.json
# classification.Ionosphere.mala_16x4 reads per-draw 73.72, 332.75 round
# trips per 1k steps over 16 ladders (20.8 each) and served 77.98, the last
# from replica 0 alone (bench.py:433 strides the pooled rows by a multiple
# of the replica count): printed, not gated
IONO_PC_SEEDS = (1, 2, 3)
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
PC_THR_CNN_STEPS = 50  # phase 5's CNN throughput runs, steps a chain
PC_THR_SUNSPOT_SAMPLES = 500  # and the Sunspot per-step ones


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


def cnn_precond_cfg(sampler, chains=CNN_PC_CHAINS, steps=CNN_PC_STEPS, **kw):
    """scripts/cnn_convergence.py:68-95: the classification preset at
    maxtemp 5, 4-rung replicated ladders, DEO metropolis swaps of
    untempered energies every 10, warm start to 10 %, preconditioner from
    30 %, step 0.01, 16 cold rungs' w recorded (record_thin 1 at 1000
    steps); ChEES with 8 leapfrog steps."""
    from ptnn_torch import classification_preset

    base = classification_preset((64, 32, 10), num_samples=chains * steps,
                                 num_chains=chains, maxtemp=5.0)
    extra = (dict(hmc_leapfrog=8, hmc_adapt_traj=True) if sampler == "chees"
             else {})
    fields = dict(
        proposal="hmc" if sampler == "chees" else "precond_mala",
        n_ladders=chains // 4, adapt_rate=0.1, swap_style="even_odd",
        swap_interval=10, swap_rule="metropolis", swap_payload="untempered",
        warmstart_frac=0.1, precond_start_frac=0.3, step_w=0.01,
        record_w=True, record_w_chains=min(16, chains // 4), chunk_steps=150,
        **extra)
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
    runs here), Ionosphere's fused MALA config falling back, the digits CNN
    with MALA and ChEES; returns the launches of each path."""
    import numpy as np

    from ptnn_torch import data, predict
    from ptnn_torch.models import cnn
    from ptnn_torch.ops import ess

    out = {}
    # --- Sunspot: four per-step variants, two fused twins -------------------
    prob = sunspot()
    cfg = sunspot_variant("chees16_fused_16x4")
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
        cfg = sunspot_variant(name)
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
    cfg = dataclasses.replace(iris_cfg(64, 8000, "precond_mala"),
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
        print(f"[4/6] end to end: digits CNN {sampler} medians over seeds "
              f"1-2: served {served:.2f}% (gate >= {CNN_PC_SERVED}; ptnn "
              f"{ref[0]}), per-draw {draw:.2f}% (band {CNN_PC_DRAW[sampler]};"
              f" ptnn {ref[1]}), pooled function-space R-hat {rhat:.3f} (gate "
              f"<= {CNN_PC_RHAT}; ptnn {ref[2]})")
        lo, hi = CNN_PC_DRAW[sampler]
        check(served >= CNN_PC_SERVED, f"CNN {sampler} served {served:.2f}% "
              f"under {CNN_PC_SERVED}")
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
    cfg = cnn_cfg(CNN_CHAINS, BAND_STEPS)
    runner = ptnn_torch.throughput_runner(cfg, prob.train, prob.test,
                                          device=DEVICE, model_spec=fused)
    reps = [runner() for _ in range(2)]
    rate = statistics.median(r["chain_steps_per_sec"] for r in reps)
    print(f"[5/6] throughput: digits CNN {CNN_CHAINS} chains x {BAND_STEPS} "
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


def main() -> int:
    phase_device()
    phase_build()
    errs = {"rw_block": phase_kernel()}
    errs.update(phase_precond_kernels())
    errs.update(phase_cls_kernels())
    errs["drift_epoch"] = phase_drift_kernel()[0]
    errs["fnn_eval"] = phase_eval_kernel()
    errs["conv1_relu_pool"] = phase_conv_kernel()
    phase_swap()
    times = {"rw_block": time_block(64, 100, record_w=True)}
    launches = {"rw_block": phase_end_to_end(),
                "hmc_block": phase_flagship()}
    launches["mala_block"], mala_twin = phase_mala_end_to_end()
    launches.update(phase_iris_end_to_end())
    phase_cls_rw_end_to_end()
    lg = phase_per_step_end_to_end()
    launches.update(drift_epoch=lg["drift_epoch"], fnn_eval=lg["fnn_eval"])
    launches["conv1_relu_pool"] = phase_zoo_end_to_end()
    phase_per_step_precond_end_to_end(mala_twin)
    phase_throughput()
    times.update(phase_precond_throughput())
    times.update(phase_cls_throughput())
    times.update(phase_per_step_throughput())
    times.update(phase_zoo_throughput())
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
    opts = ap.parse_args()
    try:
        if opts.walls is not None:
            sys.exit(walls(Path(opts.walls).resolve()))
        if opts.precond_seeds:
            sys.exit(precond_seeds(opts.precond_seeds))
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
