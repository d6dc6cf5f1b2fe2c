#!/usr/bin/env python3
"""Smoke test of ptnn_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each or more (a failing phase raises and the exit code is
not 0):
  1. device: needs torch.cuda; prints nvidia-smi's "name, power.limit" line
     and the toolchain's versions;
  2. build: compiles the six ptnn_torch/csrc/*_block.cu with nvcc into
     build/, one nvcc per source, all at once, with ptxas' register report;
  3. kernel: each CUDA block kernel against its plain PyTorch version on the
     same CUDA tensors at the main paths' widths. Sunspot: RW at 1000 chains
     x 100 steps, adapt off and on; MALA at 1024 chains x 10 steps across
     the warm start, the preconditioner's start and the end of adaptation;
     HMC with ChEES at 1024 chains (8 panels), leapfrog 16; HMC without
     ChEES at leapfrog 8; and the swap sweep against the CPU's. Iris: the
     RW classification branch at 1000 x 100, adapt off and on; MALA at 1024
     x 10 across the phases; HMC with ChEES at 64 chains (one panel) and
     256 (two), leapfrog 16; HMC without ChEES at leapfrog 8;
  4. end to end, each path with its launch counts set to 0 just before it,
     through ptnn_torch.sample, each checked against the bands of the JAX
     package's records: the Sunspot rw_fused sampler (64 chains x 5000),
     the quality flagship chees16_fused_256x4 (1024 x 8000) and
     mala_fused_16x4 (64 x 5000); the iris RW preset (10 x 5000); the iris
     quality flagship chees16_fused_16x4 (64 x 8000, seeds 1-3) against the
     served-accuracy gate of 96.76; iris mala_fused_16x4 (64 x 8000);
  5. throughput: throughput_runner at 2000 samples per chain (Sunspot
     rw_fused at 64 and 1024 chains, mala_fused_16x4, chees16_fused_256x4;
     iris chees16_fused_16x4 and chees16_fused_64x4), and each kernel's time
     against its plain version's for one block at its path's widths;
  6. one JSON line listing the kernels (time, plain time, bound, launches,
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
TRAJ_MARGIN = 1e-5  # distance of tau_traj / eps to a leapfrog-count boundary
KERNELS = ("rw_block", "mala_block", "hmc_block", "rw_cls_block",
           "mala_cls_block", "hmc_cls_block")
# what each kernel replaces: the TPU kernel of ptnn (file:line)
REPLACES = {
    "rw_block": "ptnn/ops/pallas_step.py:307 (_rw_block_kernel, regression)",
    "mala_block": "ptnn/ops/pallas_step.py:596",
    "hmc_block": "ptnn/ops/pallas_step.py:903",
    "rw_cls_block":
        "ptnn/ops/pallas_step.py:307 (_rw_block_kernel, classification)",
    "mala_cls_block": "ptnn/ops/pallas_step.py:1339",
    "hmc_cls_block": "ptnn/ops/pallas_step.py:1589",
}
# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores and
# HBM3 bandwidth; a kernel's bound is the larger of its operations over the
# one and its bytes (inputs read once, outputs written once) over the other
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SIGMOID_OPS = 4  # negate, exp, add, divide
# iris (ptnn's CLS_GATE, bench.py:288-294) and its end-to-end bands
IRIS_TOPO = (4, 12, 3)
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
    from ptnn_torch.ops import _build

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


def sunspot():
    from ptnn_torch import data

    return data.load_regression("Sunspot")


def block_inputs(c, k, device, adapt, seed=7):
    """Random state (with its true ll and prior), noise and uniforms for one
    block of ``k`` steps over ``c`` chains on Sunspot, made with numpy."""
    import numpy as np
    import torch

    from ptnn_torch import PTConfig, kernel
    from ptnn_torch.models import fnn
    from ptnn_torch.ops import block_step
    from ptnn_torch.sampler import make_dataset

    rng = np.random.default_rng(seed)
    prob = sunspot()
    cfg = PTConfig(task="regression", topology=(4, 10, 1),
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


def compare_block(c, k, length, adapt):
    import torch

    from ptnn_torch.ops import block_step

    state, noise, kdata, at, topo, scal = block_inputs(c, k, DEVICE, adapt)
    args = (state, *noise, 0, length, kdata, at, topo, scal)
    new_k, tr_k = block_step.fused_rw_block(*args, record_w=True)
    new_r, tr_r = block_step.rw_block_reference(*args, record_w=True,
                                                diagnostics=True)
    torch.cuda.synchronize()
    ok = tr_r["margin"] > MARGIN
    n_close = int((~ok).sum())
    check(n_close <= 0.01 * c, f"{n_close} of {c} chains within {MARGIN} of "
          f"a decision boundary")
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
    return n_close, int(na.sum()), err


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


def time_block(c, k, record_w):
    """Times of one k-step Sunspot RW block at c chains and of its plain
    version, both on the card, and the block's bound."""
    from ptnn_torch.ops import block_step

    state, noise, kdata, at, topo, scal = block_inputs(c, k, DEVICE, False)
    args = (state, *noise, 0, k, kdata, at, topo, scal)
    kern = lambda: block_step.fused_rw_block(*args, record_w=record_w)
    plain = lambda: block_step.rw_block_reference(*args, record_w=record_w)
    k_ms, p_ms = timing(kern, plain, 20, 3)
    new, tr = kern()
    ops = block_ops("rw", topo, c, k, kdata["n_tr"], kdata["n_te"])
    b_ms, b_by = bound(ops, tensor_bytes(state, noise, kdata["rows"], at,
                                         new, tr))
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def phase_kernel():
    c, k, length = 1000, 100, 90
    errs = []
    for adapt in (False, True):
        n_close, n_acc, err = compare_block(c, k, length, adapt)
        errs.append(err)
        print(f"[3/6] kernel: adapt={adapt} C={c} K={k} length={length}: "
              f"{n_acc} accepts, accept counters exact, {n_close} chains "
              f"under the {MARGIN} margin, floats within rtol {RTOL} atol "
              f"{ATOL}, ll's rtol on its terms (max |diff| {err:.3g})")
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

    cfg = rw_fused_cfg(64, 5000, record_w=True, track_replicas=True)
    res, launches, n_blocks = run_counted("rw_block", cfg)
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
          f"for {n_blocks} planned blocks")
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
              f"one 100-step block: kernel {t['ms']:.3f} ms, plain version "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")


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


def compare_precond(cfg, k, start, phases):
    """One block of the MALA or HMC kernel against its plain version on the
    same CUDA tensors. A chain whose decision (|u - a|) or leapfrog count
    (tau_traj / eps at an integer) fell within the margin may differ; under
    ChEES it feeds its rung's sums, so every replica of its (panel, rung)
    is left out. Returns (excluded chains, excluded groups, accepts,
    max |diff| of the floats)."""
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops import precond_step

    hmc = cfg.proposal == "hmc"
    state, noise, kdata, at, scal = precond_inputs(cfg, k, start, phases)
    args = (state, noise, start, k, kdata, at, cfg.topology, scal)
    kern = precond_step.fused_hmc_block if hmc else precond_step.fused_mala_block
    plain = (precond_step.hmc_block_reference if hmc
             else precond_step.mala_block_reference)
    name = "hmc_block" if hmc else "mala_block"
    before = precond_step.launches[name]
    new_k, tr_k = kern(*args, record_w=True)
    check(precond_step.launches[name] == before + 1, f"{name} did not launch")
    new_r, tr_r = plain(*args, record_w=True, diagnostics=True)
    torch.cuda.synchronize()
    c = cfg.num_chains
    close = (tr_r["margin"] <= P_MARGIN) | (tr_r["traj_margin"] <= TRAJ_MARGIN)
    n_groups = 0
    if hmc and scal["chees"]:
        panel = scal["rungs"] * scal["n_ladders"]
        idx = torch.arange(c, device=DEVICE)
        group = (idx // panel) * scal["rungs"] + idx % scal["rungs"]
        tainted = torch.zeros(int(group.max()) + 1, dtype=torch.bool,
                              device=DEVICE)
        tainted[group[close]] = True
        n_groups = int(tainted.sum())
        close = tainted[group]
    ok = ~close
    n_close = int(close.sum())
    check(n_close <= 0.01 * c, f"{name}: {n_close} of {c} chains within the "
          f"decision margins ({n_groups} ChEES groups)")
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
    pairs = []
    for n, v in new_r.items():
        if n in ("n_accept", "ll"):
            continue
        scale = vec_scale(v[ok]) if v.dim() == 2 else v[ok]
        if n == "chees_m1":
            scale = v[ok].abs() + new_r["chees_v2"][ok].abs().sqrt()
        if n == "g_like":
            v = fnn.neg_half_sse_grad(new_k["w"], kdata["x_tr"], kdata["y_tr"],
                                      cfg.topology)[1]
            scale = vec_scale(v[ok])
        pairs.append((new_k[n][ok], v[ok], scale, n))
    pairs += [(tr_k[n][:, ok], tr_r[n][:, ok], tr_r[n][:, ok], "trace " + n)
              for n in ("rmse_train", "rmse_test")]
    pairs.append((tr_k["w"][:, ok], tr_r["w"][:, ok],
                  vec_scale(tr_r["w"][:, ok]), "trace w"))
    pairs += [(new_k["ll"][ok], new_r["ll"][ok], tr_r["ll_scale_final"][ok],
               "ll"),
              (tr_k["ll"][:, ok], tr_r["ll"][:, ok], tr_r["ll_scale"][:, ok],
               "trace ll")]
    err = 0.0
    for a, b, scale, what in pairs:
        check(bool(torch.isfinite(a).all()), f"{name}: {what} not finite")
        diff = (a - b).abs()
        bad = int((diff > P_ATOL + P_RTOL * scale.abs()).sum())
        check(bad == 0, f"{name}: {what}: {bad} entries off, max |diff| "
              f"{float(diff.max()):.3g}")
        err = max(err, float(diff.max()))
    return n_close, n_groups, int(na.sum()), err


def phase_precond_kernels():
    """The MALA and HMC kernels against their plain versions; returns the
    largest float difference of each."""
    out = {}
    cases = (
        ("mala_block", precond_cfg(1024, 100, "precond_mala"), 10, 0,
         dict(warm_end=2, pc_start=5, burn_end=8)),
        ("hmc_block", precond_cfg(1024, 100, "hmc"), 10, 0,
         dict(warm_end=2, pc_start=4, burn_end=8)),
        ("hmc_block", precond_cfg(1024, 100, "hmc", hmc_leapfrog=8,
                                  hmc_adapt_traj=False), 10, 0,
         dict(warm_end=2, pc_start=4, burn_end=8)),
    )
    for name, cfg, k, start, phases in cases:
        n_close, n_groups, n_acc, err = compare_precond(cfg, k, start, phases)
        out[name] = max(out.get(name, 0.0), err)
        what = ("ChEES, " if cfg.hmc_adapt_traj and name == "hmc_block"
                else "") + (f"leapfrog {cfg.hmc_leapfrog}, "
                            if name == "hmc_block" else "")
        print(f"[3/6] kernel: {name} {what}C={cfg.num_chains} K={k} steps "
              f"{start}-{start + k - 1} across {phases}: {n_acc} accepts, "
              f"counters{' and traj_len' if name == 'hmc_block' else ''} "
              f"exact; {n_close} chains ({n_groups} ChEES groups) excluded "
              f"under the {P_MARGIN} / {TRAJ_MARGIN} margins; floats within "
              f"rtol {P_RTOL} atol {P_ATOL}, ll's rtol on its terms (max "
              f"|diff| {err:.3g})")
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

    cfg = precond_cfg(1024, 8000, "hmc", record_w=True, record_w_chains=256,
                      track_replicas=True)
    res, launches, n_blocks = run_counted("hmc_block", cfg)
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
          f"{lt0:.3f}; kernel launches {launches} for {n_blocks} planned blocks")
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
    cfg = precond_cfg(64, 5000, "precond_mala", track_replicas=True)
    res, launches, n_blocks = run_counted("mala_block", cfg)
    rmse, acc, trips = cold_stats(res, cfg)
    print(f"[4/6] end to end: mala_fused_16x4 64 chains x 5000 samples in "
          f"{res.elapsed_s:.3f} s ({res.chain_steps_per_sec:.0f} "
          f"chain-steps/s); cold test RMSE {rmse:.5f}, mean accept "
          f"{acc:.2f}%, swap {res.swap_percent:.2f}%, round trips "
          f"{trips:.2f} per ladder per 1k steps; kernel launches {launches} "
          f"for {n_blocks} planned blocks")
    check(MALA_RMSE[0] <= rmse <= MALA_RMSE[1],
          f"mala cold test RMSE {rmse:.4f} outside {MALA_RMSE}")
    return launches


def time_precond_block(cfg, phases):
    """Times of one 10-step Sunspot MALA or HMC block at cfg's widths and of
    its plain version, and the block's bound."""
    from ptnn_torch.ops import precond_step

    state, noise, kdata, at, scal = precond_inputs(cfg, 10, 20, phases)
    args = (state, noise, 20, 10, kdata, at, cfg.topology, scal)
    hmc = cfg.proposal == "hmc"
    kern = precond_step.fused_hmc_block if hmc else precond_step.fused_mala_block
    plain = (precond_step.hmc_block_reference if hmc
             else precond_step.mala_block_reference)
    k_ms, p_ms = timing(lambda: kern(*args, record_w=False),
                        lambda: plain(*args, record_w=False), 10, 2)
    new, tr = kern(*args, record_w=False)
    evals = float(tr["traj_len"].sum()) if hmc else None
    ops = block_ops("hmc" if hmc else "mala", cfg.topology, cfg.num_chains,
                    10, kdata["n_tr"], kdata["n_te"], evals)
    b_ms, b_by = bound(ops, tensor_bytes(state, noise, kdata["rows"], at,
                                         new, tr))
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


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
        print(f"[5/6] throughput: {tag} {cfg.num_chains} chains x 2000 "
              f"samples: median {rate:.0f} chain-steps/s over 3 reps (accept "
              f"{reps[0]['accept_pct']:.1f}%, swap {reps[0]['swap_pct']:.1f}%);"
              f" one adapting 10-step block: kernel {t['ms']:.3f} ms, plain "
              f"version {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
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
    extra.update(kw)
    return dataclasses.replace(
        base, proposal=proposal, n_ladders=chains // 4, adapt_rate=0.1,
        swap_style="even_odd", swap_interval=10, swap_rule="metropolis",
        swap_payload="untempered", warmstart_frac=0.1,
        precond_start_frac=0.3, record_w=True, record_w_chains=chains // 4,
        track_replicas=True, chunk_steps=1000, fused_step=True,
        **extra).validate()


def iris_rw_cfg(samples=5000, chains=10, **kw):
    """The iris RW preset, classification_preset((4, 12, 3), 50_000): 10
    chains, maxtemp 10, swap every 100 (after steps 99, 199, ...), fused."""
    from ptnn_torch import classification_preset

    cfg = classification_preset(IRIS_TOPO, num_samples=chains * samples,
                                num_chains=chains)
    return dataclasses.replace(cfg, fused_step=True, **kw).validate()


def cls_inputs(cfg, k, start, phases=None, seed=CLS_SEED):
    """Random state at cfg's widths on iris (init_state at N(0, 1) weights,
    so ll, prior and g_like are exact), per-chain jittered scales, noise and
    uniforms for one block of ``k`` steps from ``start``, made with numpy;
    ``phases`` overrides the block scalars."""
    import numpy as np
    import torch

    from ptnn_torch import fused, kernel
    from ptnn_torch.ops import block_step
    from ptnn_torch.sampler import make_dataset

    rng = np.random.default_rng(seed)
    prob = iris()
    c = cfg.num_chains
    ds = make_dataset(cfg, prob.train, prob.test, DEVICE)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    st = kernel.init_state(cfg, ds, init_w=f(rng.normal(size=(c, 99))))
    state = fused._to_kernel_state(st, cfg)
    state["log_step_w"] = f(np.log(cfg.step_w) + 0.3 * rng.normal(size=c))
    noise = dict(w=f(rng.normal(size=(k, c, 99))),
                 u=f(rng.uniform(size=(k, c))))
    if cfg.proposal == "hmc":
        noise["u_jit"] = f(rng.uniform(size=(k, c)))
        noise["u_traj"] = kernel.vdc_u(torch.arange(start, start + k,
                                                    device=DEVICE))
    scal = dict(fused._scalars(cfg), **(phases or {}))
    kdata = block_step.prep_data(ds.x_train, ds.y_train, ds.x_test,
                                 ds.y_test, n_classes=3)
    temps = np.geomspace(1.0, 5.0, cfg.rungs_per_ladder)
    at = f(np.tile(temps, cfg.n_ladders))
    return state, noise, kdata, at, scal


def cls_call(kind, state, noise, start, length, kdata, at, scal, plain,
             record_w=True, diagnostics=False):
    """One block of the iris kernel ``kind`` (rw, mala, hmc), or of its plain
    version."""
    from ptnn_torch.ops import block_step, precond_cls_step

    extra = dict(diagnostics=True) if diagnostics else {}
    if kind == "rw":
        fn = block_step.rw_block_reference if plain else block_step.fused_rw_block
        return fn(state, noise["w"], None, noise["u"], start, length, kdata,
                  at, IRIS_TOPO, scal, record_w=record_w, **extra)
    if kind == "hmc":
        fn = (precond_cls_step.hmc_cls_block_reference if plain
              else precond_cls_step.fused_hmc_cls_block)
    else:
        fn = (precond_cls_step.mala_cls_block_reference if plain
              else precond_cls_step.fused_mala_cls_block)
    return fn(state, noise, start, length, kdata, at, IRIS_TOPO, scal,
              record_w=record_w, **extra)


def compare_cls(kind, cfg, k, length, start, phases):
    """One block of an iris kernel against its plain version on the same
    CUDA tensors. Chains within a decision margin (|u - a|, or the leapfrog
    count's boundary; under ChEES their whole (panel, rung) group) are left
    out, at most 1 %. acc and rmse are exact functions of the argmax: they
    must match exactly wherever their source proposal's every row keeps its
    argmax through a 1e-5 move of the logits (block_step.argmax_fragile), at
    most 1 % of the entries may not. Returns (excluded chains, excluded
    groups, accepts, fragile entries, max |diff| of the floats)."""
    import torch

    from ptnn_torch.models import fnn

    state, noise, kdata, at, scal = cls_inputs(cfg, k, start, phases)
    name = KERNEL_OF[kind]
    before = launch_count(name)
    new_k, tr_k = cls_call(kind, state, noise, start, length, kdata, at,
                           scal, plain=False)
    check(launch_count(name) == before + 1, f"{name} did not launch")
    new_r, tr_r = cls_call(kind, state, noise, start, length, kdata, at,
                           scal, plain=True, diagnostics=True)
    torch.cuda.synchronize()
    c = cfg.num_chains
    close = tr_r["margin"] <= P_MARGIN
    if "traj_margin" in tr_r:
        close |= tr_r["traj_margin"] <= TRAJ_MARGIN
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
    ok = ~close
    n_close = int(close.sum())
    check(n_close <= 0.01 * c, f"{name}: {n_close} of {c} chains within the "
          f"decision margins ({n_groups} ChEES groups)")
    na = new_r["n_accept"]
    check(0 < int(na.sum()) < length * c, f"{name}: accepted all or nothing")
    exact = [(new_k["n_accept"][ok], na[ok], "n_accept")]
    exact += [(tr_k[n][:, ok], tr_r[n][:, ok], "trace " + n)
              for n in ("accept_count", "traj_len") if n in tr_r]
    sure = ok & ~tr_r["argmax_fragile_final"]
    t_sure = ok[None, :] & ~tr_r["argmax_fragile"]
    n_fragile = int((~t_sure[:, ok]).sum())
    check(n_fragile <= 0.01 * t_sure[:, ok].numel(),
          f"{name}: {n_fragile} trace entries from fragile argmaxes")
    for n in ("acc_train", "acc_test", "rmse_train", "rmse_test"):
        exact.append((new_k[n][sure], new_r[n][sure], n))
        exact.append((tr_k[n][t_sure], tr_r[n][t_sure], "trace " + n))
    for a, b, what in exact:
        bad = int((a != b).sum())
        check(bad == 0, f"{name}: {what} differs in {bad} entries")
    vec_scale = lambda v: v.abs().amax(dim=-1, keepdim=True).expand_as(v)
    rtol, atol = (RTOL, ATOL) if kind == "rw" else (P_RTOL, P_ATOL)
    pairs = []
    for n, v in new_r.items():
        if n in ("n_accept", "acc_train", "acc_test", "rmse_train",
                 "rmse_test"):
            continue
        scale = vec_scale(v[ok]) if v.dim() == 2 else v[ok]
        if n == "chees_m1":
            scale = v[ok].abs() + new_r["chees_v2"][ok].abs().sqrt()
        if n == "g_like":  # the gradient at the kernel's own w
            v = fnn.multinomial_ll_grad(new_k["w"], kdata["x_tr"],
                                        kdata["yi_tr"], IRIS_TOPO)[1]
            scale = vec_scale(v[ok])
        pairs.append((new_k[n][ok], v[ok], scale, n))
    # the multinomial ll is a sum of negative terms: held on its own size
    pairs.append((tr_k["ll"][:, ok], tr_r["ll"][:, ok], tr_r["ll"][:, ok],
                  "trace ll"))
    pairs.append((tr_k["w"][:, ok], tr_r["w"][:, ok],
                  vec_scale(tr_r["w"][:, ok]), "trace w"))
    err, err_of = 0.0, ""
    for a, b, scale, what in pairs:
        check(bool(torch.isfinite(a).all()), f"{name}: {what} not finite")
        diff = (a - b).abs()
        bad = int((diff > atol + rtol * scale.abs()).sum())
        check(bad == 0, f"{name}: {what}: {bad} entries off, max |diff| "
              f"{float(diff.max()):.3g}")
        if float(diff.max()) > err:
            err, err_of = float(diff.max()), (
                f"{what}, of size {float(b.abs().max()):.3g}")
    return n_close, n_groups, int(na.sum()), n_fragile, err, err_of


KERNEL_OF = {"rw": "rw_cls_block", "mala": "mala_cls_block",
             "hmc": "hmc_cls_block"}


def phase_cls_kernels():
    """The three iris kernels against their plain versions; returns the
    largest float difference of each."""
    out = {}
    phases = dict(warm_end=2, pc_start=4, burn_end=8)
    cases = [("rw", iris_rw_cfg(1000, 1000), 100, 90, 0, dict(adapt=False)),
             ("rw", iris_rw_cfg(1000, 1000, adapt_step_size=True), 100, 90, 0,
              dict(adapt=True, burn_end=60)),
             ("mala", iris_cfg(1024, 100, "precond_mala",
                               step_w=CLS_STEP_MALA), 10, 10, 0,
              dict(warm_end=2, pc_start=5, burn_end=8)),
             ("hmc", iris_cfg(64, 100, "hmc", step_w=CLS_STEP_HMC), 10, 10, 0,
              phases),
             ("hmc", iris_cfg(256, 100, "hmc", step_w=CLS_STEP_HMC), 10, 10, 0,
              phases),
             ("hmc", iris_cfg(1024, 100, "hmc", hmc_leapfrog=8,
                              hmc_adapt_traj=False, step_w=CLS_STEP_HMC), 10,
              10, 0, phases)]
    for kind, cfg, k, length, start, phases in cases:
        n_close, n_groups, n_acc, n_frag, err, err_of = compare_cls(
            kind, cfg, k, length, start, phases)
        name = KERNEL_OF[kind]
        out[name] = max(out.get(name, 0.0), err)
        what = ""
        if kind == "hmc":
            what = (f"ChEES ({cfg.num_chains // min(cfg.num_chains, 128)} "
                    "panels), " if cfg.hmc_adapt_traj else "")
            what += f"leapfrog {cfg.hmc_leapfrog}, "
        print(f"[3/6] kernel: {name} {what}C={cfg.num_chains} K={k} "
              f"length={length} {phases}: {n_acc} accepts, counters"
              f"{' and traj_len' if kind == 'hmc' else ''} exact; {n_close} "
              f"chains ({n_groups} ChEES groups) excluded under the margins; "
              f"acc and rmse exact outside {n_frag} trace entries with "
              f"fragile argmaxes; floats within rtol "
              f"{RTOL if kind == 'rw' else P_RTOL}, ll on its own size (max "
              f"|diff| {err:.3g}: {err_of})")
    return out


def launch_count(name):
    from ptnn_torch.ops import block_step, precond_cls_step, precond_step

    if name == "rw_block":
        return block_step.launches
    if name == "rw_cls_block":
        return block_step.cls_launches
    if name in precond_cls_step.launches:
        return precond_cls_step.launches[name]
    return precond_step.launches[name]


def reset_launch_counts():
    from ptnn_torch.ops import block_step, precond_cls_step, precond_step

    block_step.launches = 0
    block_step.cls_launches = 0
    for counts in (precond_step.launches, precond_cls_step.launches):
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

    from ptnn_torch.ops import ess

    prob = iris()
    launches = {}
    # --- the RW preset ------------------------------------------------------
    cfg = iris_rw_cfg(record_w=True, track_replicas=True)
    res, n, n_blocks = run_counted("rw_cls_block", cfg, prob)
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
          f"{n_blocks} planned blocks")
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
              f"for {n_blocks} planned blocks")
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
    res, n, n_blocks = run_counted("mala_cls_block", cfg, prob, seed=1)
    launches["mala_cls_block"] = n
    acc_s, _thin, _cold, _wrong = served_accuracy(cfg, res, prob)
    draw, accept, trips = iris_stats(cfg, res)
    check(np.isfinite(res.traces["ll"]).all(), "mala trace ll not finite")
    print(f"[4/6] end to end: iris mala_fused_16x4 seed 1, 64 chains x 8000 "
          f"samples in {res.elapsed_s:.3f} s: served cold accuracy "
          f"{acc_s:.2f}% (ptnn {PTNN_MALA_SERVED}), per-draw {draw:.2f}%, "
          f"mean accept {accept:.2f}%, swap {res.swap_percent:.2f}%, round "
          f"trips {trips:.2f} per ladder per 1k steps ({PTNN_MALA_TRIPS:.2f}); "
          f"kernel launches {n} for {n_blocks} planned blocks")
    return launches


def time_cls_block(kind, cfg, k, phases, record_w):
    """Times of one block of an iris kernel and its plain version, and the
    block's bound."""
    state, noise, kdata, at, scal = cls_inputs(cfg, k, 20, phases)
    args = (kind, state, noise, 20, k, kdata, at, scal)
    kern = lambda: cls_call(*args, plain=False, record_w=record_w)
    plain = lambda: cls_call(*args, plain=True, record_w=record_w)
    k_ms, p_ms = timing(kern, plain, 10, 2)
    new, tr = kern()
    evals = float(tr["traj_len"].sum()) if kind == "hmc" else None
    ops = block_ops(kind, IRIS_TOPO, cfg.num_chains, k, kdata["n_tr"],
                    kdata["n_te"], evals)
    b_ms, b_by = bound(ops, tensor_bytes(state, noise, kdata["rows"], at,
                                         new, tr))
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def phase_cls_throughput():
    import ptnn_torch

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
        "rw_cls_block": time_cls_block("rw", iris_rw_cfg(), 100,
                                       dict(adapt=False), True),
        "mala_cls_block": time_cls_block(
            "mala", iris_cfg(64, 2000, "precond_mala"), 10, adapting, False),
        "hmc_cls_block": time_cls_block("hmc", iris_cfg(64, 2000, "hmc"), 10,
                                        adapting, False),
    }
    for name, t in out.items():
        print(f"[5/6] throughput: {name}, one block at its path's widths: "
              f"kernel {t['ms']:.3f} ms, plain version {t['plain_ms']:.3f} "
              f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def main() -> int:
    phase_device()
    phase_build()
    errs = {"rw_block": phase_kernel()}
    errs.update(phase_precond_kernels())
    errs.update(phase_cls_kernels())
    phase_swap()
    times = {"rw_block": time_block(64, 100, record_w=True)}
    launches = {"rw_block": phase_end_to_end(),
                "hmc_block": phase_flagship(),
                "mala_block": phase_mala_end_to_end()}
    launches.update(phase_iris_end_to_end())
    phase_throughput()
    times.update(phase_precond_throughput())
    times.update(phase_cls_throughput())
    import torch

    print(json.dumps({"kernels": [dict({
        "name": name,
        "route": "cuda",
        "source": f"ptnn_torch/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": errs[name],
        "library_ms": None,  # no single PyTorch call computes a fused MH block
    }, **times[name]) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
