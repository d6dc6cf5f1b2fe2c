"""Effective sample size — the quality-per-second numerator.

The port's own copy of ``ptnn/ops/ess.py`` (same names), without
``function_space_rhat``, which runs the network in JAX there.

BASELINE.json names "chain-steps/sec/chip and ESS/sec" as the benchmark
metrics; the reference computes neither. Standard autocorrelation-based ESS
with Geyer's initial positive sequence truncation (Geyer 1992), computed on
the cold chain's post-burn-in scalar trace (likelihood or a parameter).
NumPy host-side — runs on trace arrays after sampling.
"""

from __future__ import annotations

import numpy as np


def autocorr(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation of a 1-D series via FFT."""
    x = np.asarray(x, np.float64)
    n = len(x)
    x = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n].real
    if acov[0] == 0:
        return np.ones(n)
    return acov / acov[0]


def ess(x: np.ndarray) -> float:
    """ESS of a 1-D chain trace (initial positive sequence truncation)."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n < 4 or np.allclose(x, x[0]):
        return 1.0
    rho = autocorr(x)
    # sum consecutive pairs rho[2k]+rho[2k+1] while positive
    pair_sums = rho[1 : n - (n - 1) % 2 - 1 : 2] + rho[2 : n - (n - 1) % 2 : 2]
    pos = np.where(pair_sums <= 0)[0]
    cutoff = pos[0] if len(pos) else len(pair_sums)
    tau = 1.0 + 2.0 * np.sum(pair_sums[:cutoff]) if cutoff else 1.0
    return float(np.clip(n / max(tau, 1e-12), 1.0, n))


def split_rhat(x: np.ndarray, rank_normalize: bool = True) -> float:
    """Rank-normalized split-R-hat (Vehtari, Gelman, Simpson, Carpenter &
    Bürkner 2021): the standard potential-scale-reduction convergence gate
    the reference's eyeball-the-trace-plots workflow lacks (SURVEY.md §4).

    ``x``: (S,) one chain, or (S, K) K independent chains of the same
    target (e.g. cold-chain traces from a ``sweeps.seed_sweep``). Each
    chain is split in half (catching within-chain drift), draws are
    rank-normalized across the pool (robust to heavy tails), and the
    result is the max of the location and the folded (scale) statistics.
    R-hat ≈ 1.00 at convergence; > 1.01 is the usual alarm threshold.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    s = (x.shape[0] // 2) * 2
    if s < 4:
        return float("nan")
    # split each chain's halves into separate chains: (s//2, 2K)
    halves = np.concatenate([x[: s // 2], x[s // 2 : s]], axis=1)
    if np.allclose(halves, halves.reshape(-1)[0]):
        return 1.0

    def _rhat(z: np.ndarray) -> float:
        n, m = z.shape
        mean_c = z.mean(axis=0)
        b = n * mean_c.var(ddof=1)
        w = z.var(axis=0, ddof=1).mean()
        if w <= 0:
            return 1.0
        var_plus = (n - 1) / n * w + b / n
        return float(np.sqrt(var_plus / w))

    if not rank_normalize:
        return _rhat(halves)

    def _zscale(v: np.ndarray) -> np.ndarray:
        from scipy.special import ndtri

        r = np.argsort(np.argsort(v, axis=None)).reshape(v.shape) + 1.0
        return ndtri((r - 0.375) / (v.size + 0.25))

    bulk = _rhat(_zscale(halves))
    folded = _rhat(_zscale(np.abs(halves - np.median(halves))))
    return max(bulk, folded)


def multi_ess(samples: np.ndarray, max_params: int = 64) -> float:
    """Mean ESS across (a subset of) parameter traces.

    ``samples``: (S, P) post-burn-in draws of one chain.
    """
    s = np.asarray(samples)
    p = min(max_params, s.shape[1])
    idx = np.linspace(0, s.shape[1] - 1, p).astype(int)
    return float(np.mean([ess(s[:, j]) for j in idx]))


def pooled_multi_ess(samples: np.ndarray, max_params: int = 64) -> float:
    """Total ESS over R independent chains of the same target.

    ``samples``: (S, R, P) post-burn-in draws — e.g. the R cold rungs of a
    replicated-ladder run (``PTConfig.n_ladders``), chain axis second as in
    ``traces["w"][burnin:, cold_idx, :]``. The R chains share no RNG and
    never exchange configurations (swap pairs are masked at ladder
    boundaries), so their effective sample sizes add: returns
    sum_r multi_ess(samples[:, r, :]). Deliberately NOT the
    between/within-variance multichain estimator — unmixed replicas should
    read as R small ESSs summed, not be rewarded for disagreeing.
    """
    s = np.asarray(samples)
    if s.ndim != 3:
        raise ValueError(f"expected (S, R, P) draws, got {s.shape}")
    return float(sum(multi_ess(s[:, r, :], max_params) for r in range(s.shape[1])))
