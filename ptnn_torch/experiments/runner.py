"""Shared experiment runner: dataset -> config -> sample -> artifacts (port
of ``ptnn/experiments/runner.py``).

``run_problem`` samples, writes ptnn's artifact tree into an auto-versioned
``<outdir>/<name>_<n>`` directory and appends the master row; with
``evidence`` it records the per-rung state likelihood and writes the ladder
evidence (``ops.evidence``) to ``evidence.txt``, with ``vr_rounds=R`` it
runs R rounds of variational-reference adaptation (``rounds``) and writes
``rounds_history.md``, with ``roundtrip`` it tracks replica identities and
writes ``roundtrip.txt``, with ``replicate=S`` it runs S seeds more and
writes ``replication.txt`` (the cross-seed function-space and w-space split
R-hat). ptnn's mesh option raises ``NotImplementedError`` naming the
ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np

from ptnn_torch import results as results_mod
from ptnn_torch.config import PTConfig
from ptnn_torch.data import Problem
from ptnn_torch.sampler import sample

# ptnn's options the port does not run yet, with the ROADMAP item (Queue 1)
# that brings each
NOT_PORTED = {
    "use_mesh": "use_mesh (chain-sharded runs): ROADMAP Queue 1 item 14, the "
                "multi-GPU mesh",
}


def refuse(name: str) -> None:
    raise NotImplementedError(f"ptnn_torch does not run {NOT_PORTED[name]}")


def refuse_unported(args) -> None:
    """Raise for a command-line flag (``--mesh``) whose feature is not
    ported."""
    if args.mesh:
        refuse("use_mesh")


def vref_config(cfg: PTConfig, args, **extra) -> PTConfig:
    """The command lines' variational-reference config (``--vref``, and
    ``--vr-rounds`` which implies it): the exact swap machinery (metropolis
    rule, untempered payloads, even-odd sweeps), the T = inf rung and
    ``extra``; the rounds' static reference of ``--vr-family``. ``cfg``
    unchanged otherwise."""
    if not (args.vref or args.vr_rounds > 0):
        return cfg
    cfg = dataclasses.replace(
        cfg, swap_payload="untempered", swap_rule="metropolis",
        swap_style="even_odd", variational_reference=True,
        vr_hot_infinite=True, **extra).validate()
    if args.vr_rounds > 0:
        cfg = dataclasses.replace(cfg, vr_mode="static",
                                  vr_family=args.vr_family).validate()
    return cfg


def write_evidence(res, path: str, name: str) -> None:
    """``evidence.txt`` of a run recorded with ``record_ll_state`` (ptnn's
    file) and ptnn's line: the absolute log evidence of an anchored
    corrected path, else the ladder's difference."""
    from ptnn_torch.ops import evidence as ev_mod

    est = ev_mod.from_result(res)
    with open(os.path.join(path, "evidence.txt"), "w") as f:
        f.write(
            "# ladder evidence difference log Z(beta_max) - log Z(beta_min)\n"
            f"ti {est.log_z_ti:.6f}\nss {est.log_z_ss:.6f}\n"
            + (f"log_z0 {est.log_z0:.6f}\n"
               f"abs_ti {est.log_z_abs_ti:.6f}\n"
               f"abs_ss {est.log_z_abs_ss:.6f}\n" if est.anchored else "")
            + f"window {est.window[0]} {est.window[1]}\n"
            "# beta  mean_integrand\n"
            + "".join(f"{b:.6f} {m:.6f}\n"
                      for b, m in zip(est.betas, est.mean_ll)))
    if est.anchored:
        print(f"[{name}] ABSOLUTE log-evidence (corrected path, "
              f"analytic beta=0 anchor {est.log_z0:.2f}): "
              f"TI {est.log_z_abs_ti:.2f} SS {est.log_z_abs_ss:.2f} "
              f"({est.n_samples} frozen-path draws/rung)")
    else:
        print(f"[{name}] ladder log-evidence diff: TI {est.log_z_ti:.2f} "
              f"SS {est.log_z_ss:.2f} over beta [{est.betas[0]:.3f}, "
              f"{est.betas[-1]:.3f}] ({est.n_samples} tempered draws/rung)")


def _replication(prob: Problem, cfg: PTConfig, path: str, seed: int,
                 replicate: int, device: Any) -> None:
    """S independently seeded runs of ``cfg`` with the cold rungs' w
    recorded; ``replication.txt`` with the function-space and w-space
    split R-hat across the seeds and the test metric's band."""
    from ptnn_torch.ops import ess as ess_mod

    rep_cfg = dataclasses.replace(
        cfg, record_w=True, record_w_chains=max(1, cfg.n_ladders),
        record_fx=False).validate()
    b = int(rep_cfg.samples_per_chain * rep_cfg.burn_in)
    colds, pooled, cold_m = [], [], []
    for s in range(replicate):
        r = sample(rep_cfg, prob.train, prob.test, seed=seed + s,
                   device=device)
        colds.append(np.asarray(r.traces["w"][b:, :, :]))
        pooled.append(float(np.mean(r.traces["rmse_test"][b:, :])))
        cold_m.append(float(np.mean(r.traces["rmse_test"][b:, 0])))
    # worst rank-normalized split R-hat over sampled parameters, the seed
    # runs stacked as chains of the same cold posterior
    pidx = np.linspace(0, colds[0].shape[-1] - 1, 8).astype(int)
    rhat_w = max(
        ess_mod.split_rhat(np.stack(
            [c.reshape(-1, c.shape[-1])[:, j] for c in colds], axis=1))
        for j in pidx)
    # the gate is function-space: w-space R-hat conflates weight symmetries
    # with predictive disagreement
    rhat = ess_mod.function_space_rhat(colds, prob.test, cfg, 16,
                                       device=device)
    with open(os.path.join(path, "replication.txt"), "w") as f:
        f.write(
            f"# {replicate} independent replications, seeds "
            f"{seed}..{seed + replicate - 1}; post-burn-in rows {b}..\n"
            "# rhat_cold_max is the FUNCTION-SPACE gate (predictions at "
            "16 test inputs);\n# rhat_w_max is the raw-parameter R-hat, "
            "kept as a symmetry/metastability diagnostic\n"
            f"rhat_cold_max {rhat:.4f}\n"
            f"rhat_fn_max {rhat:.4f}\n"
            f"rhat_w_max {rhat_w:.4f}\n"
            f"test_pooled_mean {np.mean(pooled):.6f}\n"
            f"test_pooled_std {np.std(pooled):.6f}\n"
            f"test_cold_mean {np.mean(cold_m):.6f}\n"
            f"test_cold_std {np.std(cold_m):.6f}\n"
            "# per-seed: seed pooled cold\n"
            + "".join(f"{seed + s} {pooled[s]:.6f} {cold_m[s]:.6f}\n"
                      for s in range(replicate))
        )
    verdict = ("mixed" if rhat < 1.01
               else ("marginal" if rhat < 1.1 else "metastable"))
    print(f"[{prob.name}] replication x{replicate}: cross-seed "
          f"split-R-hat {rhat:.3f} ({verdict}; <1.01 = mixed, "
          f"results/convergence.md), test {np.mean(pooled):.4f} "
          f"+- {np.std(pooled):.4f}")


def run_problem(
    prob: Problem,
    cfg: PTConfig,
    outdir: str,
    seed: int = 0,
    plots: bool = True,
    use_mesh: bool = False,
    master_fmt: str = "%1.4f",
    truepos: bool = False,
    evidence: bool = False,
    roundtrip: bool = False,
    replicate: int = 0,
    vr_rounds: int = 0,
    device: Any = "cuda",
) -> results_mod.Summary:
    """One full experiment: sample on ``device``, write the artifact tree
    into an auto-versioned ``<outdir>/<name>_<n>`` directory, append the
    master row (its ``time_min`` the wall time, artifact IO included).
    ``truepos``: the summary of the cold chains alone. ``evidence``: the
    state likelihood recorded, ``evidence.txt``. ``vr_rounds=R``: R rounds
    of reference-and-ladder adaptation, the last one's run written, and
    ``rounds_history.md``. ``roundtrip``: replica identities tracked,
    ``roundtrip.txt``. ``replicate=S`` (S >= 2): ``replication.txt`` from
    S more seeded runs."""
    if use_mesh:
        refuse("use_mesh")
    os.makedirs(outdir, exist_ok=True)
    if evidence:
        cfg = dataclasses.replace(cfg, record_ll_state=True).validate()
    if roundtrip:
        cfg = dataclasses.replace(cfg, track_replicas=True).validate()
    if vr_rounds > 0 and replicate >= 2:
        raise ValueError(
            "--replicate with --vr-rounds is not wired: the replication "
            "loop re-samples without the adapted reference. Run S rounds "
            "invocations with different --seed instead.")
    t0 = time.time()
    rr = None
    if vr_rounds > 0:
        # the final round's run, exactly Markov under its constant reference
        from ptnn_torch import rounds as rounds_mod

        rr = rounds_mod.run_rounds(cfg, prob.train, prob.test, seed=seed,
                                   n_rounds=vr_rounds, verbose=True,
                                   device=device)
        res, cfg = rr.result, rr.config
    else:
        res = sample(cfg, prob.train, prob.test, seed=seed, device=device)
    path = results_mod.versioned_dir(outdir, prob.name)
    if rr is not None:
        with open(os.path.join(path, "rounds_history.md"), "w") as f:
            f.write(rounds_mod.format_history(rr.history) + "\n")
    summary = results_mod.write_artifacts(res, path, prob.name, plots=plots)
    if truepos:
        # the reference's "true posterior" reporting: cold chains only
        summary = results_mod.summarize(res, prob.name, cold_only=True)
    summary.time_min = (time.time() - t0) / 60.0
    run_name = os.path.basename(path)
    results_mod.append_master_row(
        os.path.join(outdir, "master_result_file.txt"), summary, run_name,
        master_fmt)
    if evidence:
        write_evidence(res, path, prob.name)
    if roundtrip:
        from ptnn_torch.ops import roundtrip as rt_mod

        stats = rt_mod.roundtrip_stats(res.traces["replica"],
                                       n_ladders=cfg.n_ladders)
        with open(os.path.join(path, "roundtrip.txt"), "w") as f:
            f.write(rt_mod.format_report(stats, temps=res.temperatures)
                    + "\n")
        print(f"[{prob.name}] replica transport: "
              f"{int(stats.round_trips.sum())} round trips "
              f"({stats.rate_per_kstep:.2f}/1k steps), swap% alone would say "
              f"{summary.swap_perc:.1f}")
    if res.vr_regen_accept_pct is not None:
        print(f"[{prob.name}] variational reference: hot-rung regen "
              f"{res.vr_regen_accept_pct:.1f}% accepted "
              f"({res.vr_regen_proposed} proposed)")
    if replicate >= 2:
        _replication(prob, cfg, path, seed, replicate, device)
    print(f"[{prob.name}] test_mean={summary.test_mean:.4f} "
          f"test_best={summary.test_best:.4f} swap%={summary.swap_perc:.2f} "
          f"accept%={summary.accept_per:.2f} "
          f"({res.chain_steps_per_sec:,.0f} chain-steps/s) -> {path}")
    return summary
