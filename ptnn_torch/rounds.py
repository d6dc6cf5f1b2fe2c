"""Round-based variational-reference adaptation (port of
``ptnn/rounds.py``).

An in-run Welford reference frozen at burn-in goes stale once the cold chain
moves past it, and a diagonal family leaves an energy cliff at the hot end.
This module runs the schedule of Surjanovic, Syed, Bouchard-Côté & Campbell
(NeurIPS 2022) with the NRPT ladder adaptation of Syed et al. (2021):

    round 0:  plain prior-anchored PT (a pilot);
    round r:  fit the reference q (diagonal or full-covariance Gaussian,
              ``ops.vref.fit_gaussian``) to round r-1's post-burn-in cold
              draws, re-space the ladder at equal increments of round r-1's
              communication barrier, and run PT with q held constant
              (``vr_mode="static"``): each round is exactly Markov;

budgets doubling each round, the last carrying the caller's
``num_samples``. Configurations warm-start across rounds
(``kernel.init_state(init_w=, init_eta=)``), round r seeded ``seed + r``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ptnn_torch import kernel
from ptnn_torch import sampler as sampler_mod
from ptnn_torch.config import PTConfig
from ptnn_torch.ops import ladder as ladder_mod
from ptnn_torch.ops import roundtrip as rt_mod
from ptnn_torch.ops import vref


class RoundRecord(NamedTuple):
    """Diagnostics of one adaptation round."""

    round_index: int
    samples_per_chain: int
    temperatures: np.ndarray  # (C,) the ladder this round ran on
    swap_percent: float
    pair_reject: np.ndarray  # (C-1,) mean expected rejection per pair
    barrier: float  # the sum of the pair rejections
    round_trips_per_kstep: float
    regen_accept_percent: float  # nan for the prior-anchored round 0
    test_metric: float  # post-burn-in cold mean test RMSE / accuracy
    fit_draws: int  # cold draws the next round's reference was fit on


class RoundsResult(NamedTuple):
    result: Any  # sampler.SampleResult of the final round
    config: PTConfig  # the final round's config
    mu: np.ndarray  # (Z,) the reference mean the final round used
    var: np.ndarray  # (Z,) its marginal variances
    chol: Optional[np.ndarray]  # (Z, Z) lower Cholesky (full_cov) or None
    history: List[RoundRecord]


def _z_draws(res, cfg: PTConfig) -> np.ndarray:
    """(n, Z) post-burn-in cold-chain reference coordinates of a round."""
    w = np.asarray(res.traces["w"], np.float64)  # (S, k, W)
    lo = max(1, int(cfg.burn_in * w.shape[0]))  # row 0 is the init row
    w = w[lo:, 0, :]
    if cfg.task == "regression":
        eta = np.asarray(res.traces["eta"], np.float64)[lo:, 0]
        return np.concatenate([w, eta[:, None]], axis=1)
    return w


def _round_record(r: int, res, cfg: PTConfig, fit_draws: int) -> RoundRecord:
    rej = np.clip(1.0 - np.asarray(res.pair_swap_accept, np.float64), 0.0,
                  1.0)
    rt = rt_mod.roundtrip_stats(np.asarray(res.traces["replica"]),
                                cfg.n_ladders)
    st = res.final_state
    if st.n_regen_proposed is not None and int(st.n_regen_proposed) > 0:
        regen = 100.0 * float(st.n_regen_accepted) / float(
            st.n_regen_proposed)
    else:
        regen = float("nan")
    key = "rmse_test" if cfg.task == "regression" else "acc_test"
    m = np.asarray(res.traces[key], np.float64)
    lo = max(1, int(cfg.burn_in * m.shape[0]))
    return RoundRecord(
        round_index=r, samples_per_chain=cfg.samples_per_chain,
        temperatures=np.asarray(res.temperatures, np.float64),
        swap_percent=float(res.swap_percent), pair_reject=rej,
        barrier=float(np.sum(rej)),
        round_trips_per_kstep=float(rt.rate_per_kstep),
        regen_accept_percent=regen, test_metric=float(np.mean(m[lo:, 0])),
        fit_draws=fit_draws)


def round_budgets(final_samples_per_chain: int, n_rounds: int,
                  min_samples: int = 256) -> List[int]:
    """NRPT doubling: the last round carries the full budget, each earlier
    one half the next one's, floored at ``min_samples``."""
    if n_rounds < 1:
        raise ValueError("n_rounds must be >= 1")
    return [max(min(min_samples, final_samples_per_chain),
                final_samples_per_chain >> (n_rounds - 1 - r))
            for r in range(n_rounds)]


def run_rounds(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    n_rounds: int = 4,
    min_round_samples: int = 256,
    shrinkage: float = 0.1,
    inflation: float = 1.0,
    retune_ladder: bool = True,
    warm_start: bool = True,
    mesh=None,
    model_spec=None,
    verbose: bool = False,
    device: Any = "cuda",
) -> RoundsResult:
    """``n_rounds`` of reference-and-ladder adaptation on ``device``; the
    final round (exactly Markov under its constant reference) and the
    per-round history. ``cfg`` is the final round's: ``variational_reference
    =True``, ``vr_mode="static"``, the full ``num_samples``; round 0 drops
    the reference, re-spacing keeps the beta = 0 rung of ``vr_hot_infinite``
    as an endpoint."""
    if mesh is not None:
        raise NotImplementedError("run_rounds(mesh=...): the port runs on "
                                  "one device (ROADMAP Queue 1 item 14)")
    cfg.validate()
    if not (cfg.variational_reference and cfg.vr_mode == "static"):
        raise ValueError(
            "run_rounds drives the static-reference path: pass a final-round "
            "config with variational_reference=True, vr_mode='static'")
    if cfg.fused_step:
        raise ValueError(
            "fused_step does not support the VR path (fused.runtime_reason)")
    if cfg.w_size >= 40:
        # measured on the d = 61 reference net (results/vref_rounds.md): the
        # Gaussian families transport no round trips at 16, 32 and 64 rungs
        warnings.warn(
            f"rounds-VR with a Gaussian reference at w_size={cfg.w_size}: "
            "measured transport value is NEGATIVE on d>=40 neural "
            "posteriors (zero round trips, huge reference staleness — "
            "results/vref_rounds.md); prefer plain prior-anchored PT here"
        )
    budgets = round_budgets(cfg.samples_per_chain, n_rounds,
                            min_round_samples)
    reg = cfg.task == "regression"
    # round 0: the prior-anchored pilot, the reference off
    base = dataclasses.replace(
        cfg, variational_reference=False, vr_hot_infinite=False,
        vr_mode="welford", vr_family="diag", record_w=True,
        record_w_chains=max(1, cfg.record_w_chains), record_eta=reg,
        track_replicas=True, record_fx=False)
    history: List[RoundRecord] = []
    mu = var = chol = None
    temps: Optional[np.ndarray] = None
    prev_w = prev_eta = None
    res = cur = None
    dev = torch.device(device)
    for r in range(n_rounds):
        last = r == n_rounds - 1
        cur = base if r == 0 else dataclasses.replace(
            cfg, record_w=True, record_w_chains=max(1, cfg.record_w_chains),
            record_eta=reg and (not last or cfg.record_eta),
            track_replicas=True, record_fx=cfg.record_fx if last else False)
        cur = dataclasses.replace(cur, num_samples=budgets[r] * cfg.num_chains)
        if temps is not None:
            # the re-spaced ladder; build_temperatures re-pins an inf hot rung
            cur = dataclasses.replace(
                cur, custom_ladder=tuple(float(t) for t in temps))
        cur = cur.validate()
        # init, fresh or warm-started, with the fitted reference injected
        data = sampler_mod.make_dataset(cur, train, test, dev)
        spec = model_spec or kernel.default_spec(cur)
        if prev_w is None:
            state = sampler_mod.init_chains(cur, data, seed + r, spec)
        else:
            state = kernel.init_state(
                cur, data, init_w=torch.from_numpy(prev_w),
                init_eta=(None if prev_eta is None
                          else torch.from_numpy(prev_eta)), spec=spec)
        if r > 0:
            state = kernel.set_static_reference(state, cur, mu, var, chol)
        res = sampler_mod.sample(cur, train, test, seed=seed + r,
                                 device=device, init_state=state,
                                 model_spec=model_spec)
        fit_draws = 0
        if not last:
            draws = _z_draws(res, cur)
            fit_draws = draws.shape[0]
            mu, var, chol = vref.fit_gaussian(draws, family=cfg.vr_family,
                                              shrinkage=shrinkage,
                                              inflation=inflation)
            if retune_ladder:
                rej = np.clip(1.0 - np.asarray(res.pair_swap_accept,
                                               np.float64), 0.0, 1.0)
                temps = ladder_mod.barrier_tuned_temperatures(
                    np.asarray(res.temperatures, np.float64), rej)
            if warm_start:
                prev_w = res.final_state.w.numpy().astype(np.float32)
                prev_eta = (res.final_state.eta.numpy().astype(np.float32)
                            if reg else None)
        history.append(_round_record(r, res, cur, fit_draws))
        if verbose:
            h = history[-1]
            print(f"[rounds] r={r} S={h.samples_per_chain} "
                  f"swap%={h.swap_percent:.1f} barrier={h.barrier:.2f} "
                  f"rt/kstep={h.round_trips_per_kstep:.1f} "
                  f"regen%={h.regen_accept_percent:.1f} "
                  f"metric={h.test_metric:.4f}")
    return RoundsResult(
        result=res, config=cur,
        mu=np.asarray(mu) if mu is not None else None,
        var=np.asarray(var) if var is not None else None,
        chol=np.asarray(chol) if chol is not None else None,
        history=history)


def format_history(history: Sequence[RoundRecord]) -> str:
    """Markdown table of the adaptation trajectory (ptnn's, byte for
    byte)."""
    lines = [
        "| round | samples/chain | swap % | barrier | round trips/kstep "
        "| regen % | test metric | fit draws |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for h in history:
        regen = ("—" if np.isnan(h.regen_accept_percent)
                 else f"{h.regen_accept_percent:.1f}")
        lines.append(
            f"| {h.round_index} | {h.samples_per_chain} | "
            f"{h.swap_percent:.1f} | {h.barrier:.2f} | "
            f"{h.round_trips_per_kstep:.1f} | {regen} | "
            f"{h.test_metric:.4f} | {h.fit_draws} |")
    return "\n".join(lines)
