#!/usr/bin/env python3
"""Smoke test of ptnn_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each or more (a failing phase raises and the exit code is
not 0):
  1. device: needs torch.cuda; prints nvidia-smi's "name, power.limit" line
     and the toolchain's versions;
  2. build: compiles ptnn_torch/csrc/{rw,mala,hmc}_block.cu with nvcc into
     build/, one nvcc per source, all at once, with ptxas' register report;
  3. kernel: each CUDA block kernel against its plain PyTorch version on the
     same CUDA tensors at the main path's widths (Sunspot): RW at 1000
     chains x 100 steps, adapt off and on; MALA at 1024 chains x 10 steps
     across the warm start, the preconditioner's start and the end of
     adaptation; HMC with ChEES at 1024 chains (8 panels), leapfrog 16; HMC
     without ChEES at leapfrog 8; and the swap sweep against the CPU's;
  4. end to end, each path with its launch counts set to 0 just before it:
     the Sunspot rw_fused sampler (64 chains x 5000), the quality flagship
     chees16_fused_256x4 (1024 chains x 8000, bench.py's quality run) and
     mala_fused_16x4 (64 x 5000), through ptnn_torch.sample, each checked
     against the bands of the JAX package's records;
  5. throughput: throughput_runner for the three configs at 2000 samples
     per chain, and each kernel's time against its plain version's for one
     block at those widths;
  6. one JSON line listing the kernels, then the device line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

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
KERNELS = ("rw_block", "mala_block", "hmc_block")


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
    """(kernel ms, plain-version ms) of one k-step block at c chains, both on
    the card, alternated plain, kernel, kernel, plain."""
    from ptnn_torch.ops import block_step

    state, noise, kdata, at, topo, scal = block_inputs(c, k, DEVICE, False)
    args = (state, *noise, 0, k, kdata, at, topo, scal)
    kern = lambda: block_step.fused_rw_block(*args, record_w=record_w)
    plain = lambda: block_step.rw_block_reference(*args, record_w=record_w)
    p1 = time_ms(plain, 3)
    k1 = time_ms(kern, 20)
    k2 = time_ms(kern, 20)
    p2 = time_ms(plain, 3)
    return min(k1, k2), min(p1, p2)


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
        k_ms, p_ms = time_block(c, 100, record_w=False)
        print(f"[5/6] throughput: {c} chains x 2000 samples: median "
              f"{rate:.0f} chain-steps/s over 3 reps (accept "
              f"{reps[0]['accept_pct']:.1f}%, swap {reps[0]['swap_pct']:.1f}%); "
              f"one 100-step block: kernel {k_ms:.3f} ms, plain version "
              f"{p_ms:.3f} ms")


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


def run_counted(name, cfg):
    """One run of ``cfg`` through ptnn_torch.sample with ``name``'s launch
    count set to 0 just before it; returns (result, launches, blocks)."""
    import ptnn_torch
    from ptnn_torch import fused
    from ptnn_torch.ops import block_step, precond_step

    prob = sunspot()
    n_blocks = sum(len(seg) for seg in fused.block_plan(cfg))
    block_step.launches = 0
    for key in precond_step.launches:
        precond_step.launches[key] = 0
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0, device=DEVICE)
    launches = (block_step.launches if name == "rw_block"
                else precond_step.launches[name])
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
    """(kernel ms, plain-version ms) of one 10-step block at cfg's widths."""
    from ptnn_torch.ops import precond_step

    state, noise, kdata, at, scal = precond_inputs(cfg, 10, 20, phases)
    args = (state, noise, 20, 10, kdata, at, cfg.topology, scal)
    hmc = cfg.proposal == "hmc"
    kern = precond_step.fused_hmc_block if hmc else precond_step.fused_mala_block
    plain = (precond_step.hmc_block_reference if hmc
             else precond_step.mala_block_reference)
    kfn = lambda: kern(*args, record_w=False)
    pfn = lambda: plain(*args, record_w=False)
    p1 = time_ms(pfn, 2, warm=1)
    k1 = time_ms(kfn, 10)
    k2 = time_ms(kfn, 10)
    p2 = time_ms(pfn, 2, warm=1)
    return min(k1, k2), min(p1, p2)


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
        k_ms, p_ms = time_precond_block(cfg, adapting)
        out[name] = (k_ms, p_ms)
        tag = "chees16_fused_256x4" if name == "hmc_block" else "mala_fused_16x4"
        print(f"[5/6] throughput: {tag} {cfg.num_chains} chains x 2000 "
              f"samples: median {rate:.0f} chain-steps/s over 3 reps (accept "
              f"{reps[0]['accept_pct']:.1f}%, swap {reps[0]['swap_pct']:.1f}%);"
              f" one adapting 10-step block: kernel {k_ms:.3f} ms, plain "
              f"version {p_ms:.3f} ms")
    return out


def main() -> int:
    phase_device()
    phase_build()
    errs = {"rw_block": phase_kernel()}
    errs.update(phase_precond_kernels())
    phase_swap()
    times = {"rw_block": time_block(64, 100, record_w=True)}
    launches = {"rw_block": phase_end_to_end(),
                "hmc_block": phase_flagship(),
                "mala_block": phase_mala_end_to_end()}
    phase_throughput()
    times.update(phase_precond_throughput())
    import torch

    replaces = {"rw_block": "ptnn/ops/pallas_step.py:307",
                "mala_block": "ptnn/ops/pallas_step.py:596",
                "hmc_block": "ptnn/ops/pallas_step.py:903"}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"ptnn_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
    } for name in KERNELS]}))
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
