#!/usr/bin/env python3
"""Smoke test of ptnn_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the exit code is not 0):
  1. device: needs torch.cuda; prints nvidia-smi's "name, power.limit" line
     and the toolchain's versions;
  2. build: compiles ptnn_torch/csrc/rw_block.cu with nvcc into build/;
  3. kernel: the CUDA block kernel against its plain PyTorch version on the
     same CUDA tensors (1000 chains, 100 steps, Sunspot), adapt off and on;
  4. end to end: the Sunspot rw_fused sampler (64 chains x 5000 samples)
     through ptnn_torch.sample, checked against the statistical bands of the
     JAX package's records (the swap sweep is first checked on the card
     against the same sweep on the CPU);
  5. throughput: throughput_runner at 64 and 1024 chains, and the kernel's
     time against the plain version's at those widths;
  6. one JSON line per kernel, then the device line
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
DEVICE = "cuda"
MARGIN = 1e-5  # decisions closer than this may flip with rounding
# summation order and expf rounding differ. ll is the difference of two
# terms of size 1e2-1e3 that cancel, so its rtol applies to the size of
# those terms (the plain version's ``ll_scale``), not to ll itself.
RTOL, ATOL = 1e-4, 1e-5


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
    built = _build.build("rw_block")
    wall = time.perf_counter() - t0
    ptxas = [ln.split("ptxas info    :")[-1].strip()
             for ln in built.log.splitlines() if "registers" in ln]
    print(f"[2/6] build: rw_block.cu -> {built.path.relative_to(ROOT)} in "
          f"{wall:.2f} s (nvcc {built.seconds:.2f} s); ptxas: {'; '.join(ptxas)}")


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

    import ptnn_torch
    from ptnn_torch import fused
    from ptnn_torch.ops import block_step, roundtrip

    prob = sunspot()
    cfg = rw_fused_cfg(64, 5000, record_w=True, track_replicas=True)
    n_blocks = sum(len(seg) for seg in fused.block_plan(cfg))
    block_step.launches = 0
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0, device=DEVICE)
    launches = block_step.launches
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
    check(launches == n_blocks, f"{launches} launches for {n_blocks} blocks")
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


def main() -> int:
    phase_device()
    phase_build()
    max_err = phase_kernel()
    phase_swap()
    k64, p64 = time_block(64, 100, record_w=True)
    launches = phase_end_to_end()
    phase_throughput()
    import torch

    print(json.dumps({"kernels": [{
        "name": "rw_block",
        "route": "cuda",
        "source": "ptnn_torch/csrc/rw_block.cu",
        "replaces": "ptnn/ops/pallas_step.py:307",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k64,
        "plain_ms": p64,
    }]}))
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
