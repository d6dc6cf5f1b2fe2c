"""Shared experiment runner: dataset -> config -> sample -> artifacts (port
of ``ptnn/experiments/runner.py``).

``run_problem`` samples, writes ptnn's artifact tree into an auto-versioned
``<outdir>/<name>_<n>`` directory and appends the master row; with
``roundtrip`` it tracks replica identities and writes ``roundtrip.txt``,
with ``replicate=S`` it runs S seeds more and writes ``replication.txt``
(the cross-seed function-space and w-space split R-hat). ptnn's
``evidence``, ``vr_rounds`` and mesh options raise ``NotImplementedError``
naming the ROADMAP item that brings them.
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
    "evidence": "evidence (ladder marginal-likelihood estimates, "
                "ops/evidence.py): ROADMAP Queue 1 item 13, the extensions",
    "vr_rounds": "vr_rounds (round-based variational-reference adaptation, "
                 "rounds.py): ROADMAP Queue 1 item 13, the extensions",
    "vref": "--vref (variational-reference tempering, ops/vref.py): ROADMAP "
            "Queue 1 item 13, the extensions",
    "use_mesh": "use_mesh (chain-sharded runs): ROADMAP Queue 1 item 14, the "
                "multi-GPU mesh",
}


def refuse(name: str) -> None:
    raise NotImplementedError(f"ptnn_torch does not run {NOT_PORTED[name]}")


def refuse_unported(args) -> None:
    """Raise for the first command-line flag (``--evidence``, ``--vref``,
    ``--vr-rounds``, ``--mesh``) whose feature is not ported."""
    for flag, name in (("evidence", "evidence"), ("vref", "vref"),
                       ("vr_rounds", "vr_rounds"), ("mesh", "use_mesh")):
        if getattr(args, flag):
            refuse(name)


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
    ``truepos``: the summary of the cold chains alone. ``roundtrip``:
    replica identities tracked, ``roundtrip.txt``. ``replicate=S`` (S >= 2):
    ``replication.txt`` from S more seeded runs."""
    for name, value in (("evidence", evidence), ("vr_rounds", vr_rounds),
                        ("use_mesh", use_mesh)):
        if value:
            refuse(name)
    os.makedirs(outdir, exist_ok=True)
    if roundtrip:
        cfg = dataclasses.replace(cfg, track_replicas=True).validate()
    t0 = time.time()
    res = sample(cfg, prob.train, prob.test, seed=seed, device=device)
    path = results_mod.versioned_dir(outdir, prob.name)
    summary = results_mod.write_artifacts(res, path, prob.name, plots=plots)
    if truepos:
        # the reference's "true posterior" reporting: cold chains only
        summary = results_mod.summarize(res, prob.name, cold_only=True)
    summary.time_min = (time.time() - t0) / 60.0
    run_name = os.path.basename(path)
    results_mod.append_master_row(
        os.path.join(outdir, "master_result_file.txt"), summary, run_name,
        master_fmt)
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
    if replicate >= 2:
        _replication(prob, cfg, path, seed, replicate, device)
    print(f"[{prob.name}] test_mean={summary.test_mean:.4f} "
          f"test_best={summary.test_best:.4f} swap%={summary.swap_perc:.2f} "
          f"accept%={summary.accept_per:.2f} "
          f"({res.chain_steps_per_sec:,.0f} chain-steps/s) -> {path}")
    return summary
