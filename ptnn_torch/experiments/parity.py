"""The parity tables on the port: from one grid each (``scripts/
grid_parity.py`` and ``scripts/cls_grid.py``, run through
``ptnn_torch.sweeps``), and from many single runs (``scripts/parity.py``
and ``scripts/cls_bands.py``).

``regression``: the three Compare_Benchmark regression tables (the seven
bundled series x {RW, LG-0.01, LG-0.1}, 10 chains, maxtemp 5, swap ratio
0.01, ``--samples`` in all over a cell's chains) from one ``dataset_grid``
of 21 cells, beside the committed reference columns
(multicore-pt-regression/Res_{RW,LG001,LG01}/master_result_file.txt, via
BASELINE.md), and the grid's wall.

``classification``: the RW or LG parity table (PT_EvalSwapRW /
PT_EvalSwapLG master_result_file.txt) from ``classification_grid``: the
small sets (iris, Ionosphere, Cancer; the sequential drift) and the big
ones (bank-additional, PenDigit, chess; under LG the batch drift), each
bucket one grid in its topology envelope, ``--seeds`` replicates a set.

``singles``: PARITY.md's document, every row one single run of seed 0
(``run_reg``, ``run_cls``) reduced by ``results.summarize``: the regression
tables (RW, LG lr 0.01, LG lr 0.1; maxtemp 5, 10 chains), the
classification RW and legacy-LG tables, each set on its own network (chess
under LG on the batch drift, every other set on the sequential one), and
the sweeps (Lazer's maxtemp, Sunspot's swap interval at maxtemp 4, Lazer's
Langevin probability). ``--quick`` divides the budgets by 5.

``bands``: five seeds a (dataset, mode) cell beside the committed
reference row, flagged where the reference lies outside the mean +- 2
sigma. A cell is one ``seed_sweep`` on the set's own network, except the
big sets (Cancer, bank-additional, PenDigit, chess) under legacy LG: five
single runs on the sequential drift (``drift_mode="pallas"``, 250-step
chunks), each reduced on the window cls_bands.py reads, the trace rows
from ``int(samples_per_chain * burn_in) - 1`` on (one row more than the
grid's window, which starts a row later, as ``summarize``'s does).

The tables print as ptnn's scripts print them; ``--out`` also writes them
to a file, ``singles`` and ``bands`` after every row, so a run that raises
leaves the rows before it on disk (and exits non-zero); ``singles`` prints
each run's wall on stderr. The run takes the
card unless ``PTNN_DEVICE`` names another device ("cpu": the kernels'
plain versions).

    python -m ptnn_torch.experiments.parity regression [--samples 100000]
        [--seed 0] [--chunk-steps 1000] [--out FILE]
    python -m ptnn_torch.experiments.parity classification [--mode rw|lg]
        [--bucket small|big|all] [--seeds 5] [--samples 50000]
        [--chunk-steps 500] [--out FILE]
    python -m ptnn_torch.experiments.parity singles [--quick]
        [--samples-reg 100000] [--samples-cls 50000]
        [--sections reg,cls,sweeps] [--out FILE]
    python -m ptnn_torch.experiments.parity bands [DATASET ...]
        [--mode rw|lg] [--samples 50000] [--chunk N] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ptnn_torch import results, sweeps
from ptnn_torch.config import PTConfig, classification_preset, regression_preset
from ptnn_torch.data import load_classification, load_regression
from ptnn_torch.sampler import SampleResult, sample

# BASELINE.md's committed rows: name -> (test_mean, test_best, swap%,
# accept%)
REF_RW = {
    "Lazer": (0.0565, 0.0270, 42.26, 35.32),
    "Sunspot": (0.0239, 0.0161, 44.46, 18.31),
    "Mackey": (0.0061, 0.0051, 42.11, 8.20),
    "Lorenz": (0.0171, 0.0094, 39.49, 14.48),
    "Rossler": (0.0175, 0.0148, 48.12, 12.53),
    "Henon": (0.1198, 0.0161, 48.59, 38.09),
    "ACFinance": (0.0144, 0.0130, 49.04, 17.58),
}
REF_LG001 = {
    "Lazer": 0.0414, "Sunspot": 0.0204, "Mackey": 0.0065, "Lorenz": 0.0147,
    "Rossler": 0.0173, "Henon": 0.0963, "ACFinance": 0.0146,
}
REF_LG01 = {
    "Lazer": 0.0353, "Sunspot": 0.0192, "Mackey": 0.0062, "Lorenz": 0.0157,
    "Rossler": 0.0175, "Henon": 0.0190, "ACFinance": 0.0146,
}
# the reference's wall minutes of each RW row (BASELINE.md)
REF_TIMES_RW = {"Lazer": 4.54, "Sunspot": 4.83, "Mackey": 4.60,
                "Lorenz": 4.45, "Rossler": 4.22, "Henon": 4.21,
                "ACFinance": 3.60}
REG_NAMES = tuple(REF_RW)
REG_MODES = ("rw", "lg001", "lg01")

SMALL = ("iris", "Ionosphere", "Cancer")
BIG = ("bank-additional", "PenDigit", "chess")
# PT_EvalSwapRW / PT_EvalSwapLG committed rows: name -> (test mean, max)
REF_CLS = {
    "rw": {
        "iris": (50.18, 100.0), "Ionosphere": (51.29, 91.74),
        "Cancer": (83.55, 99.52), "bank-additional": (77.49, 79.45),
        "PenDigit": (71.93, 90.62), "chess": (90.06, 100.0),
    },
    "lg": {
        "iris": (96.76, 99.10), "Ionosphere": (92.19, 98.17),
        "Cancer": (98.77, 99.52), "bank-additional": (79.96, 82.61),
        "PenDigit": (81.24, 91.25), "chess": (100.0, 100.0),
    },
}


def ref_flag(ref: float, mean: float, sd: float) -> str:
    """cls_bands.py's flag: the reference outside mean +- 2 sd (sd at least
    1e-9)."""
    return "" if abs(ref - mean) <= 2 * max(sd, 1e-9) else " **ref outside ±2σ**"


def regression_cfg(samples: int = 100_000, chunk_steps: int = 1000):
    """grid_parity's configuration: the regression preset at 10 chains,
    maxtemp 5, swap ratio 0.01 (swaps every 100 steps at 100,000
    samples)."""
    return dataclasses.replace(
        regression_preset(num_samples=samples, maxtemp=5.0, num_chains=10,
                          swap_ratio=0.01),
        chunk_steps=chunk_steps).validate()


def regression_tables(samples: int = 100_000, seed: int = 0,
                      chunk_steps: int = 1000, device: Any = "cuda"
                      ) -> Tuple[Dict[str, Any], List[str], float]:
    """The regression grid and its three tables: (the grid's per-cell
    output, the lines printed, wall s)."""
    cfg = regression_cfg(samples, chunk_steps)
    t0 = time.perf_counter()
    out = sweeps.dataset_grid(cfg, list(REG_NAMES), modes=REG_MODES,
                              seed=seed, device=device)
    wall = time.perf_counter() - t0
    cell = {c: i for i, c in enumerate(out["cells"])}
    si = cfg.swap_interval
    lines = [f"# one grid, {len(out['cells'])} cells, wall "
             f"{wall / 60:.2f} min", "",
             f"## Regression — RW (maxtemp 5, swap {si})", "",
             "| dataset | test RMSE ours/ref | best ours/ref | swap% ours/ref "
             "| accept% ours/ref |", "|---|---|---|---|---|"]
    for n in REG_NAMES:
        i, r = cell[(n, "rw")], REF_RW[n]
        lines.append(
            f"| {n} | {out['test_mean'][i]:.4f} / {r[0]:.4f} | "
            f"{out['test_best'][i]:.4f} / {r[1]:.4f} | "
            f"{out['swap_pct'][i]:.1f} / {r[2]:.1f} | "
            f"{out['accept_pct'][i]:.1f} / {r[3]:.1f} |")
    for mode, refs, lr in (("lg001", REF_LG001, 0.01),
                           ("lg01", REF_LG01, 0.1)):
        lines += ["", f"## Regression — Langevin LG lr={lr} (maxtemp 5, "
                  f"swap {si}, l_prob 0.5)", "",
                  "| dataset | test RMSE ours/ref | std | accept% |",
                  "|---|---|---|---|"]
        for n in REG_NAMES:
            i = cell[(n, mode)]
            lines.append(
                f"| {n} | {out['test_mean'][i]:.4f} / {refs[n]:.4f} | "
                f"{out['test_std'][i]:.4f} | {out['accept_pct'][i]:.1f} |")
    return out, lines, wall


def classification_cfg(mode: str, samples: int, chunk_steps: int,
                       drift: str):
    """cls_grid's configuration: the classification preset (legacy LG
    under "lg"), the topology replaced by each grid's envelope."""
    return dataclasses.replace(
        classification_preset((1, 1, 1), num_samples=samples,
                              legacy_lg=mode == "lg"),
        chunk_steps=chunk_steps, drift_mode=drift)


def classification_bucket(names, mode: str, seeds, samples: int,
                          chunk_steps: int, drift: str, device: Any = "cuda"
                          ) -> Tuple[Dict[str, Any], List[str], float]:
    """One bucket's grid and its table rows: (output, rows, wall s)."""
    cfg = classification_cfg(mode, samples, chunk_steps, drift)
    t0 = time.perf_counter()
    out = sweeps.classification_grid(cfg, list(names), seeds=list(seeds),
                                     device=device)
    wall = time.perf_counter() - t0
    rows = []
    for name in names:
        idx = [i for i, (n, _s) in enumerate(out["cells"]) if n == name]
        mean, best = out["test_mean"][idx], out["test_best"][idx]
        ref_m, ref_b = REF_CLS[mode][name]
        mm, ms = float(np.mean(mean)), float(np.std(mean))
        bm, bs = float(np.mean(best)), float(np.std(best))
        rows.append(
            f"| {name} | {mm:.2f}±{ms:.2f} / {ref_m:.2f}"
            f"{ref_flag(ref_m, mm, ms)} | {bm:.2f}±{bs:.2f} / {ref_b:.2f}"
            f"{ref_flag(ref_b, bm, bs)} | "
            f"{np.mean(out['swap_pct'][idx]):.1f} | "
            f"{np.mean(out['accept_pct'][idx]):.1f} | {drift} |")
    return out, rows, wall


def classification_table(mode: str = "rw", bucket: str = "all",
                         seeds=range(5), samples: int = 50_000,
                         chunk_steps: int = 500, device: Any = "cuda"
                         ) -> Tuple[List[Dict[str, Any]], List[str], float]:
    """The RW or LG table: (each bucket's output, the lines printed, wall
    s). RW runs every bucket's sets with the sequential drift; LG the big
    sets with the batch drift, as cls_grid does."""
    buckets = {"small": [SMALL], "big": [BIG], "all": [SMALL, BIG]}[bucket]
    if mode == "rw" and bucket == "all":
        buckets = [SMALL + BIG]
    lines = [f"# classification grid mode={mode} bucket={bucket} "
             f"seeds={len(list(seeds))} samples={samples}",
             "| dataset | test acc mean ours±σ / ref | max ours±σ / ref "
             "| swap% | accept% | drift |", "|---|---|---|---|---|---|"]
    outs, total = [], 0.0
    for names in buckets:
        drift = "batch" if mode == "lg" and names == BIG else "sequential"
        out, rows, wall = classification_bucket(names, mode, seeds, samples,
                                                chunk_steps, drift, device)
        outs.append(out)
        lines += rows
        lines.append(f"# {len(out['cells'])} cells in one grid, "
                     f"{wall / 60:.2f} min")
        total += wall
    lines.append(f"# total {total / 60:.2f} min")
    return outs, lines, total


# ---------------------------------------------------------------------------
# PARITY.md from single runs (scripts/parity.py) and the seed bands
# (scripts/cls_bands.py)

SECTIONS = ("reg", "cls", "sweeps")
MAXTEMPS = (2, 4, 6, 8, 10)
SWAP_INTERVALS = (100, 200, 400, 800)
LPROBS = (0.1, 0.3, 0.5, 0.8)
BAND_SEEDS = (0, 1, 2, 3, 4)
# cls_bands.py's big sets: under legacy LG five single runs each on the
# sequential drift
BAND_BIG = ("Cancer", "bank-additional", "PenDigit", "chess")
LEGACY_LG_TEXT = (
    "The committed PT_EvalSwapLG* tables were generated by the older",
    "every-step-Langevin variants whose MH q-ratio has a misplaced",
    "parenthesis (Misc_code/ldpt_classifier_multi.py:244 — ",
    "``log(pdf1 - log(pdf2))``), making them effectively always-accept",
    "noisy SGD. ptnn reproduces them with",
    "``classification_preset(legacy_lg=True)``; the current entry-point",
    "math (correct MALA ratio) is the default and gives ~50% acceptance",
    "with the cold chain at the same max accuracy.",
)


def device_text(device: Any) -> str:
    """What a table ran on: the card's count and name with nvidia-smi's
    "name, power.limit" line, or "the CPU"."""
    if torch.device(device).type != "cuda":
        return "the CPU"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi gave no line"
    return (f"{torch.cuda.device_count()}x {torch.cuda.get_device_name(0)} "
            f"(nvidia-smi: {smi})")


def reg_single_cfg(lg: bool, lr: float, lprob: float = 0.5,
                   maxtemp: float = 5.0, samples: int = 100_000,
                   swap_int: Optional[int] = None) -> PTConfig:
    """scripts/parity.py's regression run: the regression preset (10
    chains, swap ratio 0.01), maxtemp, Langevin gradients, probability and
    rate, the swap interval where given, no weight traces."""
    cfg = regression_preset(num_samples=samples, maxtemp=maxtemp,
                            use_langevin_gradients=lg, langevin_prob=lprob,
                            learn_rate=lr)
    if swap_int is not None:
        cfg = dataclasses.replace(cfg, swap_interval=swap_int)
    return dataclasses.replace(cfg, record_w=False).validate()


def cls_single_cfg(name: str, topology, lg: bool, lr: float = 0.01,
                   samples: int = 50_000, legacy: bool = False) -> PTConfig:
    """scripts/parity.py's classification run: the preset on the set's own
    network, no weight traces; under Langevin gradients chess on the batch
    drift (as ptnn's script runs it), every other set on the sequential
    one."""
    return dataclasses.replace(
        classification_preset(topology, num_samples=samples,
                              use_langevin_gradients=lg, learn_rate=lr,
                              legacy_lg=legacy),
        record_w=False,
        drift_mode="batch" if (lg and name == "chess") else "sequential",
    ).validate()


def run_single(cfg: PTConfig, name: str, prob, device: Any = "cuda",
               **kw) -> Tuple[results.Summary, SampleResult]:
    """One run of seed 0 through ``sample`` and its ``summarize`` row,
    ``time_min`` the wall to the card's last op. ``kw`` goes to ``sample``
    (``init_state``, ``noise_fn``)."""
    t0 = time.perf_counter()
    res = sample(cfg, prob.train, prob.test, seed=0, device=device, **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    s = results.summarize(res, name)
    s.time_min = (time.perf_counter() - t0) / 60.0
    return s, res


def run_reg(name: str, lg: bool, lr: float, lprob: float = 0.5,
            maxtemp: float = 5.0, samples: int = 100_000,
            swap_int: Optional[int] = None, device: Any = "cuda", **kw):
    """scripts/parity.py's ``run_reg`` on the port: (summary, result)."""
    cfg = reg_single_cfg(lg, lr, lprob, maxtemp, samples, swap_int)
    return run_single(cfg, name, load_regression(name), device, **kw)


def run_cls(name: str, lg: bool, lr: float = 0.01, samples: int = 50_000,
            legacy: bool = False, device: Any = "cuda", **kw):
    """scripts/parity.py's ``run_cls`` on the port: (summary, result)."""
    prob = load_classification(name, seed=0)
    cfg = cls_single_cfg(name, prob.topology, lg, lr, samples, legacy)
    return run_single(cfg, name, prob, device, **kw)


class Doc:
    """A table's lines, printed as they come and, with a path, the whole
    file rewritten after each (scripts/parity.py's ``_flush``)."""

    def __init__(self, path: Optional[str] = None):
        self.path, self.lines = path, []

    def add(self, *lines: str) -> None:
        self.lines += lines
        for line in lines:
            print(line, flush=True)
        if self.path:
            with open(self.path, "w") as f:
                f.write("\n".join(self.lines) + "\n")


# a row's hook: (table, dataset or swept value, config, summary, result)
RowHook = Callable[[str, Any, PTConfig, results.Summary, SampleResult], None]


def singles(reg_samples: int = 100_000, cls_samples: int = 50_000,
            sections: Sequence[str] = SECTIONS, out: Optional[str] = None,
            device: Any = "cuda", on_row: Optional[RowHook] = None
            ) -> List[str]:
    """scripts/parity.py's document, one single run a row, each row added
    as its run ends (and a line with its wall on stderr); ``on_row`` sees
    every run after its row. Returns the lines."""
    sections = set(sections)
    doc = Doc(out)

    def row(run, samples, table, key, name, **kw):
        s, res = run(name, samples=samples, device=device, **kw)
        print(f"done {table} {key}: {60.0 * s.time_min:.2f} s",
              file=sys.stderr, flush=True)
        if on_row is not None:
            on_row(table, key, res.config, s, res)
        return s

    def reg(table, key, name, **kw):
        return row(run_reg, reg_samples, table, key, name, **kw)

    def cls(table, name, **kw):
        return row(run_cls, cls_samples, table, name, name, **kw)

    doc.add("# PARITY — ptnn_torch vs reference committed baselines", "",
            f"Full-budget runs ({reg_samples} regression / {cls_samples} "
            "classification samples, 10 chains) on "
            f"{device_text(device)}. "
            "Reference numbers from BASELINE.md (multi-core CPU, 10 "
            "processes). Parity is distributional (seeds differ; SURVEY.md "
            "§7 hard-part 4).", "")
    if "reg" in sections:
        doc.add("## Regression — RW (maxtemp 5, swap 100)", "",
                "| dataset | test RMSE ours/ref | best ours/ref | swap% "
                "ours/ref | accept% ours/ref | time min ours/ref |",
                "|---|---|---|---|---|---|")
        for name, (rm, rb, rs, ra) in REF_RW.items():
            s = reg("reg-rw", name, name, lg=False, lr=0.1)
            doc.add(f"| {name} | {s.test_mean:.4f} / {rm:.4f} | "
                    f"{s.test_best:.4f} / {rb:.4f} | {s.swap_perc:.1f} / "
                    f"{rs:.1f} | {s.accept_per:.1f} / {ra:.1f} | "
                    f"{s.time_min:.2f} / {REF_TIMES_RW[name]:.2f} |")
        for mode, tag, lr, ref in (("lg001", "LG lr=0.01", 0.01, REF_LG001),
                                   ("lg01", "LG lr=0.1", 0.1, REF_LG01)):
            doc.add("", f"## Regression — Langevin {tag} (maxtemp 5, swap "
                    "100, l_prob 0.5)", "",
                    "| dataset | test RMSE ours/ref | accept% | time min |",
                    "|---|---|---|---|")
            for name, rm in ref.items():
                s = reg("reg-" + mode, name, name, lg=True, lr=lr)
                doc.add(f"| {name} | {s.test_mean:.4f} / {rm:.4f} | "
                        f"{s.accept_per:.1f} | {s.time_min:.2f} |")
    cls_cols = ("| dataset | test acc mean ours/ref | max ours/ref | swap% | "
                "accept% | time min |", "|---|---|---|---|---|---|")
    if "cls" in sections:
        for mode in ("rw", "lg"):
            if mode == "rw":
                doc.add("", f"## Classification — RW ({cls_samples} samples,"
                        " maxtemp 10, swap 100, lr 0.01)", "", *cls_cols)
            else:
                doc.add("", "## Classification — Langevin (lr 0.01, legacy "
                        "mode)", "", *LEGACY_LG_TEXT, "", *cls_cols)
            for name, (rm, rb) in REF_CLS[mode].items():
                s = cls("cls-" + mode, name, lg=mode == "lg",
                        legacy=mode == "lg")
                doc.add(f"| {name} | {s.test_mean:.2f} / {rm:.2f} | "
                        f"{s.test_best:.2f} / {rb:.2f} | {s.swap_perc:.1f} | "
                        f"{s.accept_per:.1f} | {s.time_min:.2f} |")
    if "sweeps" in sections:
        doc.add("", "## Sweeps", "",
                "Maxtemp sweep (Lazer, RW; reference best 0.0523 @ maxtemp 4,"
                " swap% 32->44):", "",
                "| maxtemp | test RMSE | swap% | accept% |", "|---|---|---|---|")
        for mt in MAXTEMPS:
            s = reg("maxtemp", mt, "Lazer", lg=False, lr=0.1,
                    maxtemp=float(mt))
            doc.add(f"| {mt} | {s.test_mean:.4f} | {s.swap_perc:.1f} | "
                    f"{s.accept_per:.1f} |")
        doc.add("", "Swap-interval sweep (Sunspot, RW, maxtemp 4; reference "
                "RMSE flat 0.0224-0.0238, swap% 38-51):", "",
                "| swap interval | test RMSE | swap% |", "|---|---|---|")
        for si in SWAP_INTERVALS:
            s = reg("swap-interval", si, "Sunspot", lg=False, lr=0.1,
                    maxtemp=4.0, swap_int=si)
            doc.add(f"| {si} | {s.test_mean:.4f} | {s.swap_perc:.1f} |")
        doc.add("", "Langevin-probability sweep (Lazer, maxtemp 5, lr 0.1; "
                "reference RMSE 0.0500 -> 0.0331 over l_prob 0.1 -> 0.8, best"
                " 0.0318 @ 0.3):", "",
                "| l_prob | test RMSE | accept% | time min |",
                "|---|---|---|---|")
        for lp in LPROBS:
            s = reg("lprob", lp, "Lazer", lg=True, lr=0.1, lprob=lp)
            doc.add(f"| {lp} | {s.test_mean:.4f} | {s.accept_per:.1f} | "
                    f"{s.time_min:.2f} |")
    return doc.lines


def band_cfg(name: str, topology, legacy: bool, samples: int = 50_000,
             chunk: Optional[int] = None) -> PTConfig:
    """cls_bands.py's configuration of a cell: the preset on the set's own
    network (legacy LG under "lg"), no weight traces; a big set under
    legacy LG on the sequential drift in chunks of 250, any other cell in
    chunks of 3000 (``chunk`` replaces either)."""
    big = legacy and name in BAND_BIG
    return dataclasses.replace(
        classification_preset(topology, num_samples=samples,
                              legacy_lg=legacy),
        record_w=False, chunk_steps=chunk or (250 if big else 3000),
        drift_mode="pallas" if big else "sequential").validate()


def band_runs(runs: Sequence[SampleResult], cfg: PTConfig
              ) -> Dict[str, np.ndarray]:
    """cls_bands.py's reduction of single runs, one a seed: test accuracy
    mean and max over every chain from trace row ``int(samples_per_chain
    * burn_in) - 1`` on, swap %, mean accept %, and each run's accepts."""
    cold = int(cfg.samples_per_chain * cfg.burn_in) - 1
    post = [r.traces["acc_test"][cold:, :] for r in runs]
    return dict(
        test_mean=np.asarray([float(np.mean(p)) for p in post]),
        test_best=np.asarray([float(np.max(p)) for p in post]),
        swap_pct=np.asarray([r.swap_percent for r in runs]),
        accept_pct=np.asarray([float(np.mean(r.accept_ratio_per_chain))
                               for r in runs]),
        accepts=np.asarray([int(r.final_state.n_accept.sum()) for r in runs]))


def band_row(name: str, legacy: bool, out: Dict[str, np.ndarray],
             wall_min: float) -> str:
    """cls_bands.py's row of a cell."""
    ref_m, ref_b = REF_CLS["lg" if legacy else "rw"][name]
    mm, ms = float(np.mean(out["test_mean"])), float(np.std(out["test_mean"]))
    bm, bs = float(np.mean(out["test_best"])), float(np.std(out["test_best"]))
    return (f"| {name} | {mm:.2f}±{ms:.2f} / {ref_m:.2f}"
            f"{ref_flag(ref_m, mm, ms)} | {bm:.2f}±{bs:.2f} / {ref_b:.2f}"
            f"{ref_flag(ref_b, bm, bs)} | {np.mean(out['swap_pct']):.1f} | "
            f"{np.mean(out['accept_pct']):.1f} | {wall_min:.2f} |")


def band(name: str, legacy: bool, samples: int = 50_000,
         chunk: Optional[int] = None, device: Any = "cuda"
         ) -> Tuple[str, Dict[str, np.ndarray], float]:
    """One cell of cls_bands.py: (row, per-seed output, wall s)."""
    prob = load_classification(name, seed=0)
    cfg = band_cfg(name, prob.topology, legacy, samples, chunk)
    t0 = time.perf_counter()
    if legacy and name in BAND_BIG:
        out = band_runs([sample(cfg, prob.train, prob.test, seed=s,
                                device=device) for s in BAND_SEEDS], cfg)
    else:
        out = sweeps.seed_sweep(cfg, list(BAND_SEEDS), prob.train, prob.test,
                                device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return band_row(name, legacy, out, wall / 60.0), out, wall


def bands(names: Sequence[str], mode: str = "rw", samples: int = 50_000,
          chunk: Optional[int] = None, out: Optional[str] = None,
          device: Any = "cuda",
          on_cell: Optional[Callable[[str, Dict[str, np.ndarray], float],
                                     None]] = None) -> List[str]:
    """cls_bands.py's table: a header and a row a set, each added as its
    cell ends; ``on_cell`` sees (set, per-seed output, wall s). Returns
    the lines."""
    doc = Doc(out)
    doc.add(f"## mode={mode} ({len(BAND_SEEDS)} seeds per cell) on "
            f"{device_text(device)}",
            "| dataset | test acc mean ours±σ / ref | max ours±σ / ref | "
            "swap% | accept% | wall min |", "|---|---|---|---|---|---|")
    for name in names:
        row, cell, wall = band(name, mode == "lg", samples, chunk,
                               device=device)
        if on_cell is not None:
            on_cell(name, cell, wall)
        doc.add(row)
    return doc.lines


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="The parity tables on the port, from one grid each or "
                    "from many single runs.",
        epilog="Runs on the card; PTNN_DEVICE=cpu runs the plain versions "
               "on the CPU.")
    sub = p.add_subparsers(dest="table", required=True)

    def table(name, text):
        return sub.add_parser(
            name, help=text, description=text,
            formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    out = dict(default=None, help="also write the table to this file")
    r = table("regression", "the three regression tables from one "
              "dataset_grid of 21 cells")
    r.add_argument("--samples", type=int, default=100_000,
                   help="samples in all over a cell's 10 chains")
    r.add_argument("--seed", type=int, default=0, help="the grid's seed")
    r.add_argument("--chunk-steps", type=int, default=1000, help="steps a "
                   "chunk")
    r.add_argument("--out", **out)
    c = table("classification", "the RW or legacy-LG table from one "
              "classification_grid a bucket (topology envelope)")
    c.add_argument("--mode", choices=("rw", "lg"), default="rw",
                   help="the table")
    c.add_argument("--bucket", choices=("small", "big", "all"),
                   default="all", help="the sets")
    c.add_argument("--seeds", type=int, default=5, help="seeds a set")
    c.add_argument("--samples", type=int, default=50_000,
                   help="samples in all over a cell's 10 chains")
    c.add_argument("--chunk-steps", type=int, default=500, help="steps a "
                   "chunk")
    c.add_argument("--out", **out)
    g = table("singles", "scripts/parity.py's document: one single run of "
              "seed 0 a row, each set on its own network")
    g.add_argument("--quick", action="store_true",
                   help="divide both budgets by 5")
    g.add_argument("--samples-reg", type=int, default=100_000,
                   help="samples of a regression run (10 chains)")
    g.add_argument("--samples-cls", type=int, default=50_000,
                   help="samples of a classification run (10 chains)")
    g.add_argument("--sections", default=",".join(SECTIONS),
                   help="comma-separated, of " + ", ".join(SECTIONS))
    g.add_argument("--out", default=None,
                   help="write the document to this file after every row")
    b = table("bands", "scripts/cls_bands.py's rows: five seeds a set, "
              "mean +- sd beside the reference")
    b.add_argument("datasets", nargs="*", metavar="DATASET",
                   help="of " + ", ".join(REF_CLS["rw"]) + " (none: all)")
    b.add_argument("--mode", choices=("rw", "lg"), default="rw",
                   help="random walk, or legacy Langevin")
    b.add_argument("--samples", type=int, default=50_000,
                   help="samples of a run (10 chains)")
    b.add_argument("--chunk", type=int, default=None,
                   help="steps a chunk (none: 250 on the five-run cells, "
                        "3000 on the others)")
    b.add_argument("--out", default=None,
                   help="write the table to this file after every row")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = os.environ.get("PTNN_DEVICE", "cuda")
    if args.table == "singles":
        div = 5 if args.quick else 1
        sections = args.sections.split(",")
        bad = set(sections) - set(SECTIONS)
        if bad:
            raise SystemExit(f"unknown sections {sorted(bad)}; have "
                             f"{SECTIONS}")
        singles(args.samples_reg // div, args.samples_cls // div, sections,
                args.out, device)
        return
    if args.table == "bands":
        bad = set(args.datasets) - set(REF_CLS["rw"])
        if bad:
            raise SystemExit(f"unknown sets {sorted(bad)}; have "
                             f"{list(REF_CLS['rw'])}")
        bands(args.datasets or list(REF_CLS["rw"]), args.mode, args.samples,
              args.chunk, args.out, device)
        return
    if args.table == "regression":
        _out, lines, _wall = regression_tables(args.samples, args.seed,
                                               args.chunk_steps, device)
    else:
        _outs, lines, _wall = classification_table(
            args.mode, args.bucket, range(args.seeds), args.samples,
            args.chunk_steps, device)
    text = "\n".join(lines) + "\n"
    sys.stdout.write(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
