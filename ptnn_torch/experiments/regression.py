"""Time-series regression experiment driver.

Port of ``ptnn/experiments/regression.py``, with its flags and defaults: the
reference's hyperparameter block as defaults (Langevin-gradient PT, 10
chains, 100,000 samples), ``--lprob-sweep`` the reference's outer loop over
``l_prob = i/10``, ``--proposal`` the preconditioned family, ``--fused`` the
fused CUDA block kernels, ``--vref`` / ``--vr-rounds`` the
variational-reference path, ``--evidence`` the ladder evidence. Runs on the
GPU (``PTNN_DEVICE=cpu`` runs the plain versions on the CPU). ``--mesh``
parses as in ptnn and raises ``NotImplementedError`` naming the ROADMAP
item that brings it.

Examples:
    python -m ptnn_torch.experiments.regression --problem Sunspot
    python -m ptnn_torch.experiments.regression --problem all --no-langevin
    python -m ptnn_torch.experiments.regression --problem Lazer --lprob-sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ptnn_torch.config import regression_preset
from ptnn_torch.data import REGRESSION_SETS, load_regression
from ptnn_torch.experiments.runner import (refuse_unported, run_problem,
                                           vref_config)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--problem", default="Sunspot", help="dataset name or 'all'")
    p.add_argument("--samples", type=int, default=100_000, help="total samples")
    p.add_argument("--chains", type=int, default=10)
    p.add_argument("--maxtemp", type=float, default=2.0)
    p.add_argument("--swap-ratio", type=float, default=0.01)
    p.add_argument("--lr", type=float, default=0.1)
    langevin = p.add_mutually_exclusive_group()
    langevin.add_argument("--langevin", dest="langevin", action="store_true")
    langevin.add_argument("--no-langevin", dest="langevin", action="store_false")
    p.set_defaults(langevin=True)
    p.add_argument("--l-prob", type=float, default=0.5)
    p.add_argument(
        "--lprob-sweep",
        action="store_true",
        help="sweep l_prob over 0.1..0.8 (reference outer loop)",
    )
    p.add_argument("--drift-mode", choices=("sequential", "batch"), default="sequential")
    p.add_argument(
        "--proposal",
        choices=("reference", "precond_rw", "precond_mala", "hmc", "pcn"),
        default="reference",
        help="proposal family (PTConfig.proposal): 'reference' keeps the "
        "reference RW/Langevin machinery (--langevin & friends); the "
        "precond_*/hmc flagship modes replace it (adapted per-chain scales "
        "+ Welford diagonal preconditioner, DEO swaps every 10 steps)",
    )
    p.add_argument(
        "--leapfrog",
        type=int,
        default=8,
        help="leapfrog steps per hmc proposal (PTConfig.hmc_leapfrog)",
    )
    p.add_argument(
        "--ladders",
        type=int,
        default=1,
        help="replicated tempering ensembles (PTConfig.n_ladders): run R "
        "independent (chains/R)-rung ladders in one program; the R cold "
        "chains' ESS adds (results/ladder_ensembles.md)",
    )
    p.add_argument(
        "--fused",
        action="store_true",
        help="execute inter-swap intervals as fused CUDA block kernels "
        "(PTConfig.fused_step); unsupported configs fall back to the "
        "per-step sampler with a warning (ptnn_torch/fused.py)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="results/regression")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--mesh", action="store_true", help="shard chains over devices")
    p.add_argument(
        "--truepos",
        action="store_true",
        help="aggregate the cold chain only (reference truepos variant)",
    )
    p.add_argument(
        "--evidence",
        action="store_true",
        help="estimate the ladder marginal-likelihood difference "
        "(TI + stepping-stone, ops/evidence.py) and write evidence.txt",
    )
    p.add_argument(
        "--roundtrip",
        action="store_true",
        help="track replica identities and write ladder transport "
        "diagnostics (round-trip rate + up-flow f(k), ops/roundtrip.py)",
    )
    p.add_argument(
        "--vref",
        action="store_true",
        help="variational-reference tempering (stabilized PT, ops/vref.py): "
        "anneal toward a cold-chain-fitted Gaussian with a beta=0 reference "
        "leg refreshed IID at swap events. Implies the exact swap machinery "
        "(metropolis rule, untempered payloads, DEO sweeps) and the "
        "canonical (no temper-switch) schedule; pair with --roundtrip to "
        "see the transport effect (results/vref_transport.md)",
    )
    p.add_argument(
        "--vr-rounds",
        type=int,
        default=0,
        metavar="R",
        help="round-based VR adaptation (ptnn/rounds.py, implies --vref): "
        "R rounds of doubling budgets, each refitting the reference on the "
        "previous round's cold draws and re-spacing the ladder at equal "
        "communication-barrier increments (Surjanovic et al. 2022 + Syed "
        "et al. 2021); the final round carries the full --samples budget "
        "and is exactly Markov under its constant reference",
    )
    p.add_argument(
        "--vr-family",
        choices=("diag", "full_cov"),
        default="full_cov",
        help="reference family for --vr-rounds: mean-field diagonal or "
        "full-covariance Gaussian (fit between rounds on the host)",
    )
    p.add_argument(
        "--replicate",
        type=int,
        default=0,
        metavar="S",
        help="run S independently-seeded replications (one compile, S "
        "executions) and report the cross-seed split-R-hat convergence "
        "gate + test-metric band (replication.txt) -- the honest mixing "
        "check; within-run ESS cannot see metastability "
        "(results/convergence.md)",
    )
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = os.environ.get("PTNN_DEVICE", "cuda")
    problems = list(REGRESSION_SETS) if args.problem == "all" else [args.problem]
    lprobs = [i / 10 for i in range(1, 9)] if args.lprob_sweep else [args.l_prob]
    for name in problems:
        prob = load_regression(name)
        for lp in lprobs:
            cfg = regression_preset(
                num_samples=args.samples,
                num_chains=args.chains,
                maxtemp=args.maxtemp,
                swap_ratio=args.swap_ratio,
                use_langevin_gradients=args.langevin,
                langevin_prob=lp,
                learn_rate=args.lr,
            )
            cfg = dataclasses.replace(
                cfg, drift_mode=args.drift_mode, n_ladders=args.ladders
            ).validate()
            if args.proposal != "reference":
                cfg = dataclasses.replace(
                    cfg,
                    proposal=args.proposal,
                    hmc_leapfrog=args.leapfrog,
                    use_langevin_gradients=False,
                    swap_style="even_odd",
                    swap_interval=10,
                    step_w=0.01,
                    adapt_rate=0.1,
                    precond_start_frac=0.3,
                ).validate()
            # --vref --evidence composes: the corrected-path estimators with
            # the analytic beta=0 anchor (absolute log marginal likelihood)
            cfg = vref_config(cfg, args, pt_phase_frac=2.0)
            if args.fused:
                # applied last: fused_step validation depends on the final
                # proposal/task configuration
                cfg = dataclasses.replace(cfg, fused_step=True).validate()
            run_problem(
                prob,
                cfg,
                args.out,
                seed=args.seed,
                plots=not args.no_plots,
                truepos=args.truepos,
                evidence=args.evidence,
                roundtrip=args.roundtrip,
                replicate=args.replicate,
                vr_rounds=args.vr_rounds,
                master_fmt="%1.4f",
                device=device,
            )


if __name__ == "__main__":
    main()
