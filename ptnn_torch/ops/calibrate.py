"""Predictive calibration metrics for the serving path.

The port's own copy of ``ptnn/ops/calibrate.py`` (NumPy, the same functions
and the same numbers): ``coverage`` of a central predictive interval,
``crps`` from predictive samples (Gneiting & Raftery 2007 eq. 21, by order
statistics), ``ece`` of classification confidences (Naeini et al. 2015,
equal-width bins), ``brier`` and ``ppc`` (Bayesian p-values of dataset-level
statistics, Gelman, Meng & Stern 1996).

Regression metrics should be fed the full posterior predictive, epistemic
and observation noise: ``predict.posterior_predict(..., noise="conditional")``
draws tau^2 per weight draw from its conditional InvGamma posterior
(``ops.ic``), so the served band is p(y*|D) and not the epistemic-only band
of the network outputs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def coverage(
    y: np.ndarray, low: np.ndarray, high: np.ndarray
) -> float:
    """Fraction of targets inside [low, high]."""
    y = np.asarray(y, np.float64)
    return float(np.mean((y >= np.asarray(low)) & (y <= np.asarray(high))))


def crps(samples: np.ndarray, y: np.ndarray) -> Dict[str, np.ndarray]:
    """Sample-based CRPS. ``samples``: (M, N) predictive draws; ``y``: (N,).

    CRPS_i = mean_m |s_mi - y_i| - 0.5 mean_{m,m'} |s_mi - s_m'i|, with the
    pairwise term computed from order statistics:
    ``mean|Y-Y'| = 2/M^2 sum_j (2j - M - 1) s_(j)`` (j 1-based ascending).
    Returns pointwise scores and the mean (lower is better; reduces to MAE
    for a point forecast).
    """
    s = np.sort(np.asarray(samples, np.float64), axis=0)
    y = np.asarray(y, np.float64)
    m = s.shape[0]
    term1 = np.mean(np.abs(s - y[None, :]), axis=0)
    j = np.arange(1, m + 1, dtype=np.float64)[:, None]
    term2 = np.sum((2.0 * j - m - 1.0) * s, axis=0) / (m * m)
    pointwise = term1 - term2
    return {"pointwise": pointwise, "mean": float(np.mean(pointwise))}


def ece(
    probs: np.ndarray, labels: np.ndarray, n_bins: int = 10
) -> Dict[str, np.ndarray]:
    """Expected calibration error on max-prob confidence, equal-width bins.

    Returns the scalar ``ece`` plus per-bin (confidence, accuracy, count)
    arrays for reliability-diagram plotting.
    """
    p = np.asarray(probs, np.float64)
    yl = np.asarray(labels, np.int64)
    conf = p.max(axis=-1)
    pred = p.argmax(axis=-1)
    correct = (pred == yl).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(conf, edges[1:-1]), 0, n_bins - 1)
    bin_conf = np.zeros(n_bins)
    bin_acc = np.zeros(n_bins)
    bin_n = np.zeros(n_bins)
    for b in range(n_bins):
        sel = idx == b
        bin_n[b] = sel.sum()
        if bin_n[b] > 0:
            bin_conf[b] = conf[sel].mean()
            bin_acc[b] = correct[sel].mean()
    n = conf.shape[0]
    e = float(np.sum(bin_n / n * np.abs(bin_acc - bin_conf)))
    return {
        "ece": e,
        "bin_confidence": bin_conf,
        "bin_accuracy": bin_acc,
        "bin_count": bin_n,
    }


def ppc(samples: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    """Posterior-predictive checks: Bayesian p-values for dataset-level
    statistics (Gelman, Meng & Stern 1996).

    ``samples``: (M, N) predictive replicate draws (one replicate = one row
    across the N data points); ``y``: (N,) observed targets. For each
    statistic T, the p-value is ``P(T(y_rep) >= T(y))`` over replicates —
    values near 0 or 1 flag an aspect of the data the posterior predictive
    cannot reproduce (~0.5 is healthy). Statistics: mean, std, min, max,
    and lag-1 autocorrelation (the time-series regression sets are ordered,
    so acf1 is the sharpest misfit detector for them).
    """
    s = np.asarray(samples, np.float64)
    y = np.asarray(y, np.float64)

    def _acf1(a: np.ndarray) -> np.ndarray:
        d = a - a.mean(axis=-1, keepdims=True)
        num = np.sum(d[..., :-1] * d[..., 1:], axis=-1)
        den = np.sum(d * d, axis=-1)
        return num / np.maximum(den, 1e-30)

    stats = {
        "mean": (s.mean(axis=1), float(y.mean())),
        "std": (s.std(axis=1), float(y.std())),
        "min": (s.min(axis=1), float(y.min())),
        "max": (s.max(axis=1), float(y.max())),
        "acf1": (_acf1(s), float(_acf1(y[None, :])[0])),
    }
    return {
        f"p_{k}": float(np.mean(rep >= obs)) for k, (rep, obs) in stats.items()
    }


def brier(probs: np.ndarray, labels: np.ndarray) -> float:
    """Multiclass Brier score: mean_i sum_k (p_ik - 1[y_i=k])^2."""
    p = np.asarray(probs, np.float64)
    yl = np.asarray(labels, np.int64)
    onehot = np.zeros_like(p)
    onehot[np.arange(p.shape[0]), yl] = 1.0
    return float(np.mean(np.sum(np.square(p - onehot), axis=-1)))
