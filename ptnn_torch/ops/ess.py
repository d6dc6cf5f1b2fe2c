"""Effective sample size — the quality-per-second numerator.

The port's own copy of ``ptnn/ops/ess.py`` (same names); its
``function_space_rhat`` runs the network's forward in PyTorch, where ptnn's
runs it in JAX.

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


FS_BATCH = 2048  # draws a forward of function_space_rhat takes at a time


def function_space_rhat(colds, test: np.ndarray, cfg, n_points: int = 16,
                        spec=None, device="cuda") -> float:
    """Worst rank-normalized split R-hat over posterior-PREDICTIVE
    coordinates (ptnn/ops/ess.py:90-160): every recorded cold draw's
    forward at ``n_points`` test inputs, the seed runs stacked as chains,
    the max over points x outputs. W-space R-hat conflates weight-symmetry
    multimodality with predictive disagreement; this is the replication
    gate.

    ``colds``: one array per seed run, (draws, W) or (draws, R, W): the R
    cold replicas of a replicated-ladder run are thinned along the DRAW
    axis first (at least 32 draws a replica, about 2000 rows) and then
    pooled time-major, so split halves are early against late draws.
    ``test``: the test matrix, inputs its first ``cfg.topology[0]``
    columns. ``spec``: a ``ModelSpec`` (the CNN, an MLP): its class
    probabilities (classification) or outputs; None: the reference FNN's
    sigmoid outputs. The forward runs on ``device`` in full float32,
    ``FS_BATCH`` draws at a time."""
    import torch

    from ptnn_torch.models import fnn
    from ptnn_torch.ops.precision import full_float32

    i_dim = cfg.topology[0]
    test = np.asarray(test)
    xi = np.linspace(0, test.shape[0] - 1, n_points).astype(int)
    x_pts = torch.as_tensor(np.ascontiguousarray(test[xi, :i_dim]),
                            dtype=torch.float32, device=device)

    def fwd(w):
        with torch.no_grad(), full_float32():
            if spec is None:
                out = fnn.batched_forward(w, x_pts, cfg.topology)
            elif cfg.task == "classification":
                out = torch.exp(spec.log_probs(spec.forward(w, x_pts)))
            else:
                out = spec.forward(w, x_pts)
        return out.reshape(w.shape[0], -1).cpu().numpy()

    preds = []
    for c in colds:
        c = np.asarray(c)
        if c.ndim == 3:
            target = max(2000, 32 * c.shape[1])
            step = max(1, c.shape[0] // max(1, target // c.shape[1]))
            c = c[::step].reshape(-1, c.shape[-1])
        else:
            c = c[:: max(1, c.shape[0] // 2000)]
        w = torch.as_tensor(np.ascontiguousarray(c), dtype=torch.float32,
                            device=device)
        preds.append(np.concatenate([fwd(w[a:a + FS_BATCH]) for a in
                                     range(0, w.shape[0], FS_BATCH)]))
    n = min(p.shape[0] for p in preds)
    stack = np.stack([p[:n] for p in preds], axis=1)  # (n, seeds, pts*out)
    return max(split_rhat(stack[:, :, j]) for j in range(stack.shape[2]))


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
