"""Single-chain MCMC driver with uncertainty plots (port of
``ptnn/experiments/single_chain.py``, ldmcmc.py's equivalent).

    python -m ptnn_torch.experiments.single_chain --problem Sunspot --samples 50000

Runs on the GPU (``PTNN_DEVICE=cpu`` runs the plain versions on the CPU);
the plots are written when matplotlib is installed.
"""

from __future__ import annotations

import argparse
import os

from ptnn_torch import mcmc
from ptnn_torch.data import load


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--problem", default="Sunspot")
    p.add_argument("--samples", type=int, default=50_000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--no-langevin", dest="langevin", action="store_false")
    p.set_defaults(langevin=True)
    p.add_argument("--l-prob", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="results/single_chain")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = os.environ.get("PTNN_DEVICE", "cuda")
    prob = load(args.problem)
    cfg = mcmc.single_chain_config(
        prob.task, prob.topology, samples=args.samples,
        use_langevin_gradients=args.langevin, langevin_prob=args.l_prob,
        learn_rate=args.lr)
    res = mcmc.run_single_chain(cfg, prob.train, prob.test, seed=args.seed,
                                device=device)
    outdir = os.path.join(args.out, prob.name)
    i = prob.topology[0]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        os.makedirs(outdir, exist_ok=True)
    else:
        mcmc.plot_uncertainty(res, prob.train[:, i], prob.test[:, i], outdir)
    burnin = cfg.samples_per_chain // 2
    key = "rmse" if prob.task == "regression" else "acc"
    te = res.traces[f"{key}_test"][burnin:]
    print(
        f"[{prob.name}] single-chain accept%={res.accept_ratio_per_chain[0]:.2f} "
        f"test {key} mean={te.mean():.4f} best="
        f"{(te.min() if key == 'rmse' else te.max()):.4f} "
        f"({res.chain_steps_per_sec:,.0f} steps/s) -> {outdir}"
    )


if __name__ == "__main__":
    main()
