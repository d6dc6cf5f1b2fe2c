"""Single-chain Langevin / random-walk MCMC with uncertainty quantification
(port of ``ptnn/mcmc.py``).

The reference's standalone samplers (the Langevin MCMC of
Misc/Misc_code/ldmcmc.py and the random walk of misc_code/mcmc.py) are the
PT kernel with one chain, no swaps and T = 1 throughout. ldmcmc's
every-step Langevin proposals carry a misplaced parenthesis in their
q-ratio; with the correct ratio every-step Langevin from a cold start
rejects nearly everything, so the default mixes random-walk and Langevin
proposals 50/50 (``langevin_prob=1.0`` gives ldmcmc's schedule with the
correct ratio). ``record_fx`` traces the posterior-predictive outputs, and
``predictive_bands`` gives ldmcmc's 5-95 % uncertainty bands.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from ptnn_torch.config import PTConfig
from ptnn_torch.sampler import SampleResult, sample


def single_chain_config(
    task: str,
    topology: Tuple[int, int, int],
    samples: int = 50_000,
    use_langevin_gradients: bool = True,
    langevin_prob: float = 0.5,  # see the module docstring on ldmcmc's 1.0
    learn_rate: float = 0.01,
    drift_mode: str = "sequential",
    record_fx: bool = True,
) -> PTConfig:
    return PTConfig(
        task=task,
        topology=topology,
        num_samples=samples,
        num_chains=1,
        maxtemp=2.0,  # unused: one chain, the ladder is [1.0]
        swap_interval=0,  # no swaps
        use_langevin_gradients=use_langevin_gradients,
        langevin_prob=langevin_prob,
        learn_rate=learn_rate,
        drift_mode=drift_mode,
        pt_phase_frac=2.0,  # no tempered phase: T = 1 throughout
        record_fx=record_fx,
    ).validate()


def run_single_chain(cfg: PTConfig, train: np.ndarray, test: np.ndarray,
                     seed: int = 0, device: Any = "cuda") -> SampleResult:
    """The single-chain sampler on ``device`` (its ladder is [1.0])."""
    assert cfg.num_chains == 1 and not cfg.swaps_enabled
    return sample(cfg, train, test, seed=seed, device=device)


def predictive_bands(res: SampleResult, split: str = "test",
                     lo: float = 5.0, hi: float = 95.0
                     ) -> Dict[str, np.ndarray]:
    """Posterior-predictive mean and ``lo``-``hi`` percentile bands over the
    post-burn-in draws (ldmcmc.py:463-476)."""
    cfg = res.config
    burnin = int(cfg.samples_per_chain * cfg.burn_in)
    fx = res.traces[f"fx_{split}"][burnin:, 0]  # (S-b, N)
    return {"mean": fx.mean(axis=0),
            "low": np.percentile(fx, lo, axis=0),
            "high": np.percentile(fx, hi, axis=0)}


def plot_uncertainty(res: SampleResult, y_train: np.ndarray,
                     y_test: np.ndarray, outdir: str) -> None:
    """ldmcmc.py's artifacts: the posterior-predictive band plots of both
    splits and the first 10 parameters' posterior histogram and trace.
    Needs matplotlib."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    for split, y in (("train", y_train), ("test", y_test)):
        if f"fx_{split}" not in res.traces:
            continue
        b = predictive_bands(res, split)
        x = np.linspace(0, 1, num=len(y))
        plt.plot(x, y, label="actual")
        plt.plot(x, b["mean"], label="pred. (mean)")
        plt.fill_between(x, b["low"], b["high"], alpha=0.35, label="5%-95%")
        plt.legend(loc="upper right")
        plt.title(f"Posterior predictive — {split}")
        plt.savefig(os.path.join(outdir, f"mcmcres_{split}.png"))
        plt.clf()
    if "w" in res.traces:
        cfg = res.config
        burnin = int(cfg.samples_per_chain * cfg.burn_in)
        pos = res.traces["w"][burnin:, 0, :]  # (S-b, W)
        for p in range(min(10, pos.shape[1])):
            fig, (a0, a1) = plt.subplots(2, 1)
            a0.hist(pos[:, p], bins=40, density=True)
            a0.set_title(f"posterior θ[{p}]")
            a1.plot(pos[:, p])
            a1.set_title("trace")
            fig.tight_layout()
            fig.savefig(os.path.join(outdir, f"param_{p}.png"))
            plt.close(fig)
    plt.close("all")
