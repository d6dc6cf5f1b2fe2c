"""Temperature ladder construction (host-side, NumPy).

The port's own copy of ``ptnn/ops/ladder.py``, whole and with the same names.

Reproduces the reference's geometric beta ladder adapted from ptemcee
(reference: multicore-pt-classification/pt_classification.py:537-645). When
both ``ntemps`` and a finite ``Tmax`` are given — as in every reference config
— the ladder reduces to ``betas = logspace(0, -log10(Tmax), ntemps)`` and the
``tstep``/``ndim`` machinery is dead; it is kept (including its input
validation and the ``Tmax = inf`` path) so sweeps over those arguments behave
identically.

Temperatures are ``1 / beta`` with chain 0 at T = 1 (``assign_temperatures``,
pt_classification.py:624-645). A linear-spacing alternative mirrors the
reference's (dead) linear branch.
"""

from __future__ import annotations

import numpy as np


def default_beta_ladder(ndim: int, ntemps: int | None, Tmax: float | None) -> np.ndarray:
    """Geometric ladder of beta = 1/T (pt_classification.py:537-622)."""
    if type(ndim) != int or ndim < 1:
        raise ValueError("Invalid number of dimensions specified.")
    if ntemps is None and Tmax is None:
        raise ValueError("Must specify one of ``ntemps`` and ``Tmax``.")
    if Tmax is not None and Tmax <= 1:
        raise ValueError("``Tmax`` must be greater than 1.")
    if ntemps is not None and (type(ntemps) != int or ntemps < 1):
        raise ValueError("Invalid number of temperatures specified.")

    # Per-dimension temperature step, consulted only when ntemps or Tmax is
    # missing. The reference derives it from a geometric descent off Tmax
    # (pt_classification.py:580-596) — but its own aux paths crash as written
    # (``range(Tmax)`` with Tmax None/inf), so for those inputs we use
    # ptemcee's large-dimension approximation instead of replicating the
    # crash; the standard both-given path never reads tstep.
    if Tmax is not None and np.isfinite(Tmax) and ntemps is not None:
        steps = [float(Tmax)]
        last = float(Tmax)
        for _ in range(int(Tmax)):
            last = last * (ntemps ** (-1.0 / (ntemps - 1)))
            steps.append(last)
        tsteps = np.array(steps)
        if ndim > tsteps.shape[0]:
            tstep = 1.0 + 2.0 * np.sqrt(np.log(4.0)) / np.sqrt(ndim)
        else:
            tstep = tsteps[ndim - 1]
    else:
        tstep = 1.0 + 2.0 * np.sqrt(np.log(4.0)) / np.sqrt(ndim)

    append_inf = False
    if Tmax == np.inf:
        append_inf = True
        Tmax = None
        ntemps = ntemps - 1

    if ntemps is not None:
        if Tmax is None:
            Tmax = tstep ** (ntemps - 1)
    else:
        ntemps = int(np.log(Tmax) / np.log(tstep) + 2)

    betas = np.logspace(0, -np.log10(Tmax), ntemps)
    if append_inf:
        betas = np.concatenate((betas, [0.0]))
    return betas


def assign_temperatures(
    num_chains: int, maxtemp: float, geometric: bool = True
) -> np.ndarray:
    """Temperatures for the ladder, chain 0 coldest at T = 1
    (pt_classification.py:624-645)."""
    if num_chains == 1:
        return np.asarray([1.0])  # single-chain MCMC: T = 1
    if geometric:
        betas = default_beta_ladder(2, ntemps=num_chains, Tmax=maxtemp)
        temps = np.where(betas == 0.0, np.inf, 1.0 / np.where(betas == 0.0, 1.0, betas))
        return temps
    # Linear spacing (reference's dead alternative, pt_classification.py:639-645):
    # starts at 1 and increments by maxtemp / num_chains.
    rate = maxtemp / num_chains
    return 1.0 + rate * np.arange(num_chains)


def communication_barrier(
    temps: np.ndarray, pair_reject: np.ndarray
) -> tuple[np.ndarray, float]:
    """Cumulative communication barrier Lambda(beta) from pair rejection rates.

    ``pair_reject[k]`` is the mean rejection probability of the swap between
    rungs k and k+1 (``1 - SampleResult.pair_swap_accept``). Following Syed
    et al. 2021 (JRSS-B, "Non-reversible parallel tempering"), the barrier is
    the piecewise-linear-in-beta function through the cumulative rejections:
    Lambda(beta_0)=0, Lambda(beta_{k+1}) = Lambda(beta_k) + r_k. Returns the
    per-rung cumulative values and the total barrier. The reference has no
    notion of this — its ladder is a fixed geometric grid regardless of how
    the posterior actually resists exchange (pt_classification.py:537-622).
    """
    temps = np.asarray(temps, np.float64)
    r = np.clip(np.asarray(pair_reject, np.float64), 0.0, 1.0)
    if r.shape[0] != temps.shape[0] - 1:
        raise ValueError(f"{r.shape[0]} pair rates for {temps.shape[0]} rungs")
    cum = np.concatenate([[0.0], np.cumsum(r)])
    return cum, float(cum[-1])


def barrier_tuned_temperatures(
    temps: np.ndarray, pair_reject: np.ndarray, n_out: int | None = None
) -> np.ndarray:
    """Re-space the ladder so every adjacent pair carries an equal share of
    the measured communication barrier (the round-trip-optimal schedule of
    Syed et al. 2021, §5.1: place the new betas at equal increments of the
    monotone interpolant of Lambda(beta)).

    Endpoints (T=1 and T=maxtemp) are preserved; only interior rungs move.
    With uniform measured rejection the ladder is returned unchanged; with a
    barrier concentrated between two rungs the tuned ladder concentrates
    rungs there, which raises the bottleneck pair's acceptance and therefore
    the replica round-trip rate (measure with ops/roundtrip.py).

    ``n_out`` re-spaces onto a DIFFERENT rung count (same barrier-equalizing
    inversion, ``n_out`` equal increments of Lambda): the barrier total
    prescribes how many rungs a ladder needs (tuning.suggest_num_chains), and
    this places them — the piece ptnn.auto uses to turn a pilot ladder's
    measured profile into the production schedule.
    """
    temps = np.asarray(temps, np.float64)
    c = temps.shape[0]
    n = c if n_out is None else int(n_out)
    if n < 2:
        raise ValueError("a ladder needs at least 2 rungs")
    cum, total = communication_barrier(temps, pair_reject)
    if c < 3 and n == c:
        return temps.copy()  # nothing interior to move
    # beta=0 reference rungs (T=inf, PTConfig.vr_hot_infinite) map cleanly
    # through the inversion: 1/inf = 0 is an interpolation endpoint and
    # 1/0 = inf restores the rung — silence the expected divide warnings
    with np.errstate(divide="ignore"):
        betas = 1.0 / temps  # descending from 1
    if total <= 0.0:
        if n == c:
            return temps.copy()  # no measured resistance anywhere
        # resize with no profile information: geometric in beta
        with np.errstate(divide="ignore"):
            return 1.0 / np.interp(
                np.arange(n) / (n - 1), np.arange(c) / (c - 1), betas
            )
    # Make Lambda strictly increasing so the inverse is well defined even
    # when some pairs measured zero rejection (flat segments).
    eps = total * 1e-9 + 1e-12
    cum = cum + eps * np.arange(c)
    targets = cum[-1] * np.arange(n) / (n - 1)
    # Lambda is increasing as beta DESCENDS: interpolate beta against cum.
    new_betas = np.interp(targets, cum, betas)
    new_betas[0], new_betas[-1] = betas[0], betas[-1]
    # np.interp on a strictly increasing grid keeps monotonicity; guard
    # against float ties by nudging toward geometric order.
    for k in range(1, n):
        if new_betas[k] >= new_betas[k - 1]:
            new_betas[k] = new_betas[k - 1] * (1.0 - 1e-9)
    with np.errstate(divide="ignore"):
        return 1.0 / new_betas


def build_temperatures(cfg) -> np.ndarray:
    """The (num_chains,) host-side temperature array for a PTConfig.

    float64 — also the artifact filename source (chain_<T>.txt). One ladder
    by default; with ``cfg.n_ladders = R`` the K-rung schedule (K =
    rungs_per_ladder, from maxtemp/geometric_ladder or a K-long
    custom_ladder) is tiled R times — swap pairs crossing ladder boundaries
    are masked in the kernel (parallel/swap.py pair_mask). Duck-typed on the
    config to keep this module import-light.
    """
    if cfg.custom_ladder is not None:
        temps = np.asarray(cfg.custom_ladder, np.float64)
    else:
        temps = np.asarray(
            assign_temperatures(
                cfg.rungs_per_ladder, cfg.maxtemp, cfg.geometric_ladder
            ),
            np.float64,
        )
    if cfg.vr_hot_infinite:
        # beta=0 reference leg (stabilized PT): the hottest rung targets the
        # fitted q itself, which vr_regen refreshes IID (ops/vref.py)
        temps = temps.copy()
        temps[-1] = np.inf
    if cfg.n_ladders > 1:
        temps = np.tile(temps, cfg.n_ladders)
    return temps
