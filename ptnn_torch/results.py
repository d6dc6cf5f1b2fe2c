"""Result aggregation and artifact persistence.

The port's own copy of ``ptnn/results.py``: the same functions and the same
files, byte for byte, from a ``ptnn_torch.SampleResult``. Text files are
written with ``np.savetxt`` in ptnn's formats (ptnn's C++ writer is a drop-in
for it); matplotlib is imported only by ``write_plots``.

Reproduces the reference's artifact surface (SURVEY.md §5 "Metrics"): the
per-chain trace files written at chain exit (multicore-pt-classification/
pt_classification.py:465-492), the pooled aggregation of ``show_results``
(:780-893), the 15-column ``master_result_file.txt`` row (:1138; regression
variant pt_timeseries_regression.py:1052), and the diagnostic plots
(:1149-1199). One deliberate improvement: aggregation happens in memory from
the streamed traces — the reference round-trips every trace through text
files on disk and re-loads them (:802-839); the files here are written for
parity/inspection, not as the aggregation medium.

Known reference quirks kept so downstream tooling sees identical semantics:

* classification's "max" columns use ``np.amax`` but regression's use
  ``np.amin`` (best RMSE) — pt_timeseries_regression.py:1038,1042;
* ``accept_per`` is the cross-chain mean of the final cumulative accept count
  over samples (pt_classification.py:1098-1100);
* pos_w row 0 is the untouched ``np.ones`` init row.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from ptnn_torch import config as config_mod
from ptnn_torch.config import PTConfig
from ptnn_torch.sampler import SampleResult


@dataclass
class Summary:
    """The 15-column master row, named."""

    problem: str
    num_samples: int
    maxtemp: float
    swap_interval: int
    proposal_col: float  # use_langevin (classification) / langevin_prob (regr.)
    learn_rate: float
    train_mean: float
    train_std: float
    train_best: float
    test_mean: float
    test_std: float
    test_best: float
    swap_perc: float
    accept_per: float
    time_min: float

    def row(self) -> np.ndarray:
        return np.asarray(
            [
                0.0,  # problem index slot; name carried separately
                self.num_samples,
                self.maxtemp,
                self.swap_interval,
                self.proposal_col,
                self.learn_rate,
                self.train_mean,
                self.train_std,
                self.train_best,
                self.test_mean,
                self.test_std,
                self.test_best,
                self.swap_perc,
                self.accept_per,
                self.time_min,
            ]
        )


def summarize(res: SampleResult, problem: str, cold_only: bool = False) -> Summary:
    """Pool post-burn-in traces across chains (show_results semantics).

    ``cold_only=True`` is the reference's "truepos" reporting mode: aggregate
    only chain 0 (T = 1) instead of pooling the whole ladder
    (Misc_code/pt_classifier_truepos.py:742-768 vs pt_classifier.py) — the
    statistically meaningful posterior. With replicated ladders
    (``cfg.n_ladders > 1``) the cold set is every ladder's T=1 rung,
    indices {0, K, 2K, ...} — R independent cold chains pooled.
    """
    cfg: PTConfig = res.config
    is_reg = cfg.task == "regression"
    key = "rmse" if is_reg else "acc"
    # burn-in from the ACTUAL trace row count, not samples_per_chain:
    # record_thin > 1 strides the recorded rows device-side, so indexing
    # with int(samples_per_chain * burn_in) would slice past the end
    # (empty post-burn rows -> NaN means) on any thinned run
    rows = res.traces[f"{key}_train"].shape[0]
    burnin = int(rows * cfg.burn_in)
    if cold_only:
        sel = np.arange(0, cfg.num_chains, cfg.rungs_per_ladder)
    else:
        sel = slice(None)
    tr = res.traces[f"{key}_train"][burnin:, sel]  # (S-b, C or 1)
    te = res.traces[f"{key}_test"][burnin:, sel]
    best = np.amin if is_reg else np.amax  # reference quirk (see module doc)
    # accept_per: mean over chains of final cumulative count / samples
    # (pt_classification.py:1098-1100 with accept_list[-1] ≈ total accepted).
    accept_per = float(
        np.mean(res.traces["accept_count"][-1] / cfg.samples_per_chain) * 100.0
    )
    return Summary(
        problem=problem,
        num_samples=cfg.num_samples,
        maxtemp=cfg.maxtemp,
        swap_interval=cfg.swap_interval,
        proposal_col=(
            cfg.langevin_prob if is_reg else float(cfg.use_langevin_gradients)
        ),
        learn_rate=cfg.learn_rate,
        train_mean=float(np.mean(tr)),
        train_std=float(np.std(tr)),
        train_best=float(best(tr)),
        test_mean=float(np.mean(te)),
        test_std=float(np.std(te)),
        test_best=float(best(te)),
        swap_perc=float(res.swap_percent),
        accept_per=accept_per,
        time_min=res.elapsed_s / 60.0,
    )


def pooled_posterior(res: SampleResult) -> np.ndarray:
    """(num_param, chains * (samples - burnin)) pooled posterior
    (pt_classification.py:847)."""
    cfg = res.config
    # burn-in from actual recorded rows (record_thin strides them)
    burnin = int(res.traces["w"].shape[0] * cfg.burn_in)
    pos = res.traces["w"][burnin:]  # (S-b, C, W)
    return pos.transpose(2, 1, 0).reshape(pos.shape[2], -1)


def versioned_dir(base: str, name: str) -> str:
    """Auto-versioned output directory ``<base>/<name>_<n>``
    (pt_classification.py:1057-1071)."""
    n = 0
    while os.path.exists(os.path.join(base, f"{name}_{n}")):
        n += 1
    path = os.path.join(base, f"{name}_{n}")
    os.makedirs(path)
    return path


def write_artifacts(
    res: SampleResult,
    path: str,
    problem: str,
    plots: bool = True,
) -> Summary:
    """Write the full reference artifact tree under ``path``."""
    cfg: PTConfig = res.config
    for d in (
        "predictions",
        "posterior/pos_w",
        "posterior/pos_likelihood",
        "posterior/accept_list",
        "results",
    ):
        os.makedirs(os.path.join(path, d), exist_ok=True)

    # recorded rows, not samples_per_chain: record_thin strides the traces
    samples = res.traces["ll"].shape[0]
    temps = res.temperatures
    likeh = np.zeros((samples, 2))

    def _w_col(ci: int) -> int | None:
        # cfg.record_w_chains: the w trace holds only the first k COLD rungs
        # (stride rungs_per_ladder under replicated ladders — kernel.recorded_chains)
        # — map chain index -> recorded column, None when not recorded
        if "w" not in res.traces:
            return None
        k = cfg.record_w_chains
        if k <= 0:
            return ci
        stride = cfg.rungs_per_ladder if cfg.n_ladders > 1 else 1
        j, r = divmod(ci, stride)
        return j if r == 0 and j < k else None

    for ci in range(cfg.num_chains):
        t_str = str(float(temps[ci]))
        if cfg.n_ladders > 1:
            # replicated ladders duplicate every temperature — qualify the
            # reference's chain_<T>.txt naming with the ladder index so the
            # R artifact sets don't overwrite each other
            t_str = f"{t_str}_l{ci // cfg.rungs_per_ladder}"
        wc = _w_col(ci)
        if wc is not None:
            np.savetxt(
                os.path.join(path, "posterior", "pos_w", f"chain_{t_str}.txt"),
                res.traces["w"][:, wc, :],
            )
        likeh[:, 0] = res.traces["ll"][:, ci]
        likeh[0, :] = [-100.0, -100.0]
        np.savetxt(
            os.path.join(path, "posterior", "pos_likelihood", f"chain_{t_str}.txt"),
            likeh,
            "%1.4f",
        )
        np.savetxt(
            os.path.join(path, "posterior", "accept_list", f"chain_{t_str}.txt"),
            res.traces["accept_count"][:, ci],
            "%1.4f",
        )
        np.savetxt(
            os.path.join(
                path, "posterior", "accept_list", f"chain_{t_str}_accept.txt"
            ),
            np.asarray([res.accept_ratio_per_chain[ci]]),
            "%1.4f",
        )
        for metric in ("rmse_test", "rmse_train", "acc_test", "acc_train"):
            np.savetxt(
                os.path.join(path, "predictions", f"{metric}_chain_{t_str}.txt"),
                res.traces[metric][:, ci],
                "%1.2f",
            )

    burnin = int(samples * cfg.burn_in)
    lik_vec = res.traces["ll"][burnin:].T.reshape(-1)  # (C*(S-b),)
    np.savetxt(
        os.path.join(path, "likelihood.txt"),
        np.stack([lik_vec, np.zeros_like(lik_vec)], axis=1),
        "%1.5f",
    )
    np.savetxt(
        os.path.join(path, "accept_list.txt"),
        res.traces["accept_count"].T,
        "%1.2f",
    )
    summary = summarize(res, problem)
    np.savetxt(
        os.path.join(path, "acceptpercent.txt"), [summary.accept_per], fmt="%1.2f"
    )

    # Self-describing run config (new capability): lets a predictor reload
    # the posterior without the caller re-specifying topology/task, and makes
    # every artifact dir reproducible. Additive file — the reference artifact
    # parity surface is untouched.
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_mod.to_json_dict(cfg), f, indent=1)

    # Structured metrics (new capability — JSONL, SURVEY.md §5 observability).
    with open(os.path.join(path, "metrics.jsonl"), "a") as f:
        f.write(
            json.dumps(
                {
                    "ts": time.time(),
                    "problem": problem,
                    "task": cfg.task,
                    "chains": cfg.num_chains,
                    "samples_per_chain": samples,
                    "swap_percent": res.swap_percent,
                    "accept_per": summary.accept_per,
                    "test_mean": summary.test_mean,
                    "test_best": summary.test_best,
                    "elapsed_s": res.elapsed_s,
                    "chain_steps_per_sec": res.chain_steps_per_sec,
                }
            )
            + "\n"
        )

    if plots:
        write_plots(res, path)
    return summary


def append_master_row(
    master_path: str, summary: Summary, run_name: str, fmt: str = "%1.4f"
) -> None:
    """Append the 15-column row + run tag (pt_classification.py:1138-1147)."""
    os.makedirs(os.path.dirname(master_path) or ".", exist_ok=True)
    with open(master_path, "a+") as f:
        np.savetxt(f, summary.row(), fmt=fmt, newline=" ")
        np.savetxt(f, [run_name], fmt="%s", newline=" \n")


def write_plots(res: SampleResult, path: str) -> None:
    """Diagnostic figures (pt_classification.py:1149-1199)."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    cfg = res.config
    is_reg = cfg.task == "regression"
    key = "rmse" if is_reg else "acc"
    tr = res.traces[f"{key}_train"].reshape(-1)
    te = res.traces[f"{key}_test"].reshape(-1)

    plt.plot(tr, ".", label="Train")
    plt.plot(te, ".", label="Test")
    plt.legend(loc="upper right")
    plt.title(f"{'RMSE' if is_reg else 'Classification Acc.'} over samples")
    plt.savefig(os.path.join(path, f"{key}_samples.png"))
    plt.clf()

    plt.plot(res.traces["ll"])  # (S, C): one line per chain
    plt.title("Proposal log-likelihood per chain")
    plt.savefig(os.path.join(path, "likelihood.png"))
    plt.clf()

    plt.plot(res.traces["accept_count"])
    plt.title("Cumulative accepts per chain")
    plt.savefig(os.path.join(path, "accept.png"))
    plt.clf()
    plt.close("all")
