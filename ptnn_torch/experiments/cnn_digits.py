"""Bayesian CNN image classification with a large tempered ladder.

Port of ``ptnn/experiments/cnn_digits.py``, with its flags: a convolutional
network sampled by the same parallel-tempering sampler as the reference FNN,
with hundreds of chains on one GPU. Ships with the bundled 8x8 digits set;
pass ``--mnist-dir`` with local ``train-images-idx3-ubyte``-style files for
full MNIST. Runs on the GPU (``PTNN_DEVICE=cpu`` runs the plain versions on
the CPU).

    python -m ptnn_torch.experiments.cnn_digits --chains 256 --steps 2000

The default run is the reference proposal with Langevin gradients (``--adapt``
ties the drift rate to each chain's adapted step); ``--mala`` runs
preconditioned MALA and ``--hmc L`` preconditioned HMC with L leapfrog steps,
both per step (Langevin and ``--adapt`` off, as in ptnn). ``--sgld-batch B``
runs replica-exchange SGLD on minibatches of B rows (``--sgld-step``,
``--sgld-swap``, ``--sgld-vr``, ``--sgld-lr-scale``: ptnn's flags and
settings). ``--checkpoint FILE`` saves the run every few chunks and resumes
it from FILE after a crash, bit-identically. ``--mesh`` parses as in ptnn
and raises ``NotImplementedError`` naming the ROADMAP item that brings it.
The plots are written when matplotlib is installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

import ptnn_torch
from ptnn_torch import results as results_mod
from ptnn_torch.data import Problem, load_digits
from ptnn_torch.models import cnn

# the flags whose samplers are not ported yet, with the ROADMAP item (Queue 1)
# that brings each
_NOT_PORTED = {
    "mesh": "--mesh (chain-sharded runs): ROADMAP Queue 1 item 14, the "
            "multi-GPU mesh",
}


def load_mnist(mnist_dir: str) -> Problem:
    """Plain IDX-format MNIST loader (files must exist locally)."""
    import gzip
    import struct

    def read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic = struct.unpack(">HBB", f.read(4))
            _z, dtype, ndim = magic
            dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

    def find(stem):
        for cand in (stem, stem + ".gz"):
            p = os.path.join(mnist_dir, cand)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"{stem}[.gz] not in {mnist_dir}")

    xtr = read_idx(find("train-images-idx3-ubyte")).reshape(-1, 28 * 28) / 255.0
    ytr = read_idx(find("train-labels-idx1-ubyte")).astype(np.float64)
    xte = read_idx(find("t10k-images-idx3-ubyte")).reshape(-1, 28 * 28) / 255.0
    yte = read_idx(find("t10k-labels-idx1-ubyte")).astype(np.float64)
    return Problem(
        "mnist",
        "classification",
        (28 * 28, 64, 10),
        np.hstack([xtr, ytr[:, None]]),
        np.hstack([xte, yte[:, None]]),
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chains", type=int, default=256)
    p.add_argument("--steps", type=int, default=2000, help="steps per chain")
    p.add_argument("--maxtemp", type=float, default=5.0)
    # default drift scale is the MALA-consistent step_w^2/2 (drift =
    # (sigma^2/2) grad log-posterior), which keeps the q-ratio from rejecting
    # every gradient proposal; measured on digits: max test acc 83% vs 47%
    # with an arbitrary large lr at the same budget
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--step-w", type=float, default=0.01)
    p.add_argument("--swap-interval", type=int, default=100)
    p.add_argument("--mnist-dir", default=None)
    p.add_argument(
        "--chunk-steps", type=int, default=500,
        help="steps per device chunk (the traces are fetched chunk by chunk)",
    )
    p.add_argument(
        "--drift-microbatch", type=int, default=0,
        help="split the grad drift into N sequential chain chunks to bound "
        "activation memory (0 = auto: 4 at >=1024 chains, else 1)",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="checkpoint file path: resume transparently after a crash; "
        "identical results to an uninterrupted run",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="results/cnn")
    p.add_argument("--mesh", action="store_true")
    p.add_argument(
        "--adapt",
        action="store_true",
        help="adapt per-chain step sizes toward 23.4%% acceptance in burn-in",
    )
    p.add_argument(
        "--mala",
        action="store_true",
        help="preconditioned MALA proposals (PTConfig.proposal="
        "'precond_mala'): per-chain adapted scales + Welford diagonal "
        "preconditioner, the flagship gradient mode — supersedes "
        "--adapt/--lr (the epoch-drift machinery is bypassed entirely)",
    )
    p.add_argument(
        "--hmc", type=int, default=0, metavar="L",
        help="preconditioned HMC-within-PT with L leapfrog steps "
        "(PTConfig.proposal='hmc'); supersedes --mala/--adapt/--lr",
    )
    p.add_argument(
        "--sgld-batch", type=int, default=0, metavar="B",
        help="replica-exchange stochastic-gradient Langevin dynamics "
        "(PTConfig.proposal='sgld'): per-step minibatch of B rows instead "
        "of full-batch passes — the scaling mode for MNIST-sized data "
        "(approximate within chains; swaps refresh exact energies at swap "
        "cadence). Supersedes --mala/--adapt/--lr",
    )
    p.add_argument(
        "--sgld-step", type=float, default=1e-5,
        help="sgld Euler-Maruyama step eps (PTConfig.sg_step)",
    )
    p.add_argument(
        "--sgld-swap", choices=("exact", "corrected"), default="exact",
        help="sgld swap energies: full-data refresh at swap cadence vs "
        "minibatch estimates under the variance-corrected exchange test "
        "(PTConfig.sg_swap)",
    )
    p.add_argument(
        "--sgld-vr", type=int, default=0, metavar="M",
        help="SVRG control variates for the corrected swap test: anchor "
        "refresh (one full-data pass) every M steps (PTConfig.sg_vr + "
        "sg_anchor_interval; arxiv 2010.01084). Requires "
        "--sgld-swap corrected",
    )
    p.add_argument(
        "--sgld-lr-scale", choices=("none", "temperature"), default="none",
        help="per-rung sgld step scaling (PTConfig.sg_lr_scale): "
        "'temperature' runs rung k at eps = sg_step * T_k — the reSGLD "
        "accelerated-exploration recipe (hot rungs take big biased steps, "
        "the cold rung keeps sg_step)",
    )
    p.add_argument(
        "--warmstart-frac", type=float, default=0.0,
        help="fraction of the run spent on normalized-gradient warm start "
        "before MALA sampling begins (PTConfig.warmstart_frac; ends inside "
        "burn-in, so posterior draws are unaffected)",
    )
    p.add_argument("--warmstart-step", type=float, default=0.01)
    p.add_argument(
        "--precond-start", type=float, default=0.125,
        help="PTConfig.precond_start_frac (must exceed --warmstart-frac)",
    )
    p.add_argument(
        "--precond-power", type=float, default=1.0,
        help="shrinkage exponent on the MALA diagonal preconditioner "
        "(PTConfig.precond_power); 0 disables the empirical M",
    )
    p.add_argument(
        "--swap-style", default=None, choices=("bubbling", "even_odd"),
        help="replica-exchange sweep structure (default: bubbling; "
        "even_odd is the vectorized DEO scheme, recommended with --mala "
        "and small --swap-interval)",
    )
    p.add_argument(
        "--ladders", type=int, default=1,
        help="replicated tempering ensembles (PTConfig.n_ladders): spend "
        "the chain budget as R independent (chains/R)-rung ladders; the R "
        "cold chains pool in the cold-only summary "
        "(results/ladder_ensembles.md)",
    )
    args = p.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(f"ptnn_torch does not run {item}")

    if args.lr is None:
        args.lr = args.step_w * args.step_w / 2.0
    if args.mnist_dir:
        prob = load_mnist(args.mnist_dir)
        spec = cnn.mnist_spec()
    else:
        prob = load_digits(args.seed)
        spec = cnn.digits_spec()

    cfg = dataclasses.replace(
        ptnn_torch.classification_preset(
            prob.topology,
            num_samples=args.chains * args.steps,
            num_chains=args.chains,
            maxtemp=args.maxtemp,
            use_langevin_gradients=not (args.mala or args.hmc),
            learn_rate=args.lr,
        ),
        swap_interval=args.swap_interval,
        step_w=args.step_w,
        n_ladders=args.ladders,
        drift_chain_microbatch=(
            args.drift_microbatch
            if args.drift_microbatch
            # auto: largest divisor of the chain count <= 4, only at the
            # scale where the vmapped grad drift/eval-grad overruns memory
            else next(
                m for m in (4, 2, 1)
                if args.chains >= 1024 and args.chains % m == 0
            ) if args.chains >= 1024 else 1
        ),
        adapt_step_size=args.adapt
        and not (args.mala or args.hmc or args.sgld_batch),
        proposal=("sgld" if args.sgld_batch
                  else "hmc" if args.hmc
                  else "precond_mala" if args.mala else "reference"),
        hmc_leapfrog=args.hmc or 8,
        precond_power=args.precond_power,
        precond_start_frac=args.precond_start,
        warmstart_frac=0.0 if args.sgld_batch else args.warmstart_frac,
        warmstart_step=args.warmstart_step,
        record_w=False,  # 3.7k-3M params x chains x steps: keep scalars only
        chunk_steps=min(args.chunk_steps, args.steps),
        **(
            {"swap_style": args.swap_style} if args.swap_style else {}
        ),
        **(
            # sgld requires the metropolis/untempered swap machinery and
            # the canonical (no temper-switch) schedule
            {
                "sg_batch": args.sgld_batch,
                "sg_step": args.sgld_step,
                "sg_swap": args.sgld_swap,
                "sg_vr": args.sgld_vr > 0,
                "sg_anchor_interval": args.sgld_vr,
                "sg_lr_scale": args.sgld_lr_scale,
                "swap_payload": "untempered",
                "swap_rule": "metropolis",
                "pt_phase_frac": 2.0,
                "use_langevin_gradients": False,
            }
            if args.sgld_batch
            else {}
        ),
    )
    res = ptnn_torch.sample(
        cfg, prob.train, prob.test, seed=args.seed, model_spec=spec,
        device=os.environ.get("PTNN_DEVICE", "cuda"),
        checkpoint_path=args.checkpoint,
    )
    os.makedirs(args.out, exist_ok=True)
    path = results_mod.versioned_dir(args.out, prob.name)
    try:
        import matplotlib  # noqa: F401

        plots = True
    except ImportError:
        plots = False
    summary = results_mod.write_artifacts(res, path, prob.name, plots=plots)
    print(
        f"[{prob.name}] chains={args.chains} test_acc mean={summary.test_mean:.2f} "
        f"max={summary.test_best:.2f} accept%={summary.accept_per:.2f} "
        f"swap%={summary.swap_perc:.2f} "
        f"({res.chain_steps_per_sec:,.0f} chain-steps/s) -> {path}"
    )
    if args.ladders > 1:
        # the statistically meaningful posterior summary: the R independent
        # cold (T=1) chains pooled, vs the whole-ladder pool above
        cold = results_mod.summarize(res, prob.name, cold_only=True)
        line = (
            f"[{prob.name}] cold chains x{args.ladders}: "
            f"test_acc mean={cold.test_mean:.2f} max={cold.test_best:.2f}"
        )
        print(line)
        # the receipt of the cold-pooled headline
        with open(os.path.join(path, "cold_summary.txt"), "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
