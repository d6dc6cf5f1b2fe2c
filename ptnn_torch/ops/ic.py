"""Predictive information criteria: WAIC and PSIS-LOO from recorded
posteriors (port of ``ptnn/ops/ic.py``).

* ``pointwise_log_lik`` builds the ``(draws, points)`` log predictive
  density matrix from weight draws (``predict.load_posterior``): the
  network's forward for a batch of draws at once in PyTorch on ``device``
  ("cuda" unless the caller asks for the CPU), in full float32, then the
  density in NumPy float64 as ptnn computes it.
* ``waic`` (Watanabe 2010; Gelman, Hwang & Vehtari 2014), ``gpdfit``,
  ``psis_loo`` (Vehtari, Gelman & Gabry 2017; Zhang & Stephens 2009) and
  ``compare`` are NumPy, copied from ptnn: the same numbers on the same
  matrices.

Regression: the artifact tree records weight draws only, so the noise
variance tau^2 is integrated out under its conditional posterior
``InvGamma(a = nu1 + N/2, b = nu2 + SSE(w)/2)`` given the training
residuals (``cond``), and the pointwise predictive is the Student-t
``t_{2a}(y | f(w), sqrt(b/a))``; ``eta="sample"`` draws tau^2 per weight
draw and uses the Gaussian density instead.
"""

from __future__ import annotations

from math import lgamma
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ptnn_torch.ops.precision import full_float32


def _logsumexp(a: np.ndarray, axis=None) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    out = np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True)) + m
    return np.squeeze(out, axis=axis) if axis is not None else out.reshape(())


_LOG_2PI = float(np.log(2.0 * np.pi))


def _batched(draws: np.ndarray, batch: int, device, fn) -> np.ndarray:
    """``fn(w)`` on every batch of ``batch`` draws on ``device``, with the
    results concatenated along the draw axis on the host."""
    out = []
    with torch.no_grad(), full_float32():
        for i in range(0, draws.shape[0], max(batch, 1)):
            w = torch.as_tensor(draws[i:i + batch], device=device)
            out.append(fn(w).cpu().numpy())
    return np.concatenate(out, axis=0)


def pointwise_log_lik(
    cfg,
    draws: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    spec=None,
    eta: str | np.ndarray = "conditional",
    cond: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    batch: int = 512,
    seed: int = 0,
    device: Any = "cuda",
) -> np.ndarray:
    """Pointwise log predictive density matrix ``(M draws, N points)``.

    Classification: ``log_softmax(f(w, x))[y]`` per draw, the sampler's
    multinomial likelihood. Regression, with ``eta``: "conditional" (the
    default) the Rao-Blackwellized Student-t; "sample" tau^2_m drawn from
    ``InvGamma(a_m, b_m)`` (NumPy generator seeded ``seed``, as ptnn) and the
    Gaussian density; an ``(M,)`` array of log-variance draws used directly.
    ``cond``: the ``(x_train, y_train)`` the conditional is formed from,
    ``(x, y)`` by default (the WAIC/LOO use); pass the training split when
    scoring held-out rows. ``spec``: a model of the zoo (default the
    reference FNN of ``cfg.topology``)."""
    from ptnn_torch import kernel

    spec = spec if spec is not None else kernel.default_spec(cfg)
    draws = np.ascontiguousarray(draws, np.float32)
    if draws.ndim != 2 or draws.shape[1] != spec.w_size:
        raise ValueError(
            f"draws must be (M, {spec.w_size}); got {draws.shape}"
        )
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)

    if cfg.task == "classification":
        yi = torch.as_tensor(np.asarray(y, np.int64), device=device)

        def ll(w):
            lp = spec.log_probs(spec.forward(w, xt))  # (m, N, K)
            idx = yi[None, :, None].expand(lp.shape[0], -1, 1)
            return torch.gather(lp, -1, idx)[..., 0]

        return _batched(draws, batch, device, ll)

    # regression
    yf = np.asarray(y, np.float32)

    def outputs(xs):
        return lambda w: spec.forward(w, xs)[..., 0]

    f = _batched(draws, batch, device, outputs(xt)).astype(np.float64)

    if isinstance(eta, np.ndarray):
        tau_sq = np.exp(np.asarray(eta, np.float64))[:, None]
        return (
            -0.5 * (_LOG_2PI + np.log(tau_sq))
            - 0.5 * np.square(yf[None, :] - f) / tau_sq
        )

    # conditional InvGamma(a, b) from the training residuals per draw
    if cond is None:
        yc, fc = np.asarray(y, np.float64), f
    else:
        xc = torch.as_tensor(np.asarray(cond[0], np.float32), device=device)
        yc = np.asarray(cond[1], np.float64)
        fc = _batched(draws, batch, device, outputs(xc)).astype(np.float64)
    n_c = yc.shape[0]
    sse = np.sum(np.square(yc[None, :] - fc), axis=1)  # (M,)
    a = cfg.nu_1 + 0.5 * n_c
    b = cfg.nu_2 + 0.5 * sse  # (M,)
    if eta == "sample":
        rng = np.random.default_rng(seed)
        # tau^2 ~ InvGamma(a, b)  <=>  tau^2 = b / Gamma(a, 1)
        tau_sq = (b / rng.gamma(a, 1.0, size=b.shape))[:, None]
        return (
            -0.5 * (_LOG_2PI + np.log(tau_sq))
            - 0.5 * np.square(yf[None, :] - f) / tau_sq
        )
    if eta != "conditional":
        raise ValueError("eta must be 'conditional', 'sample', or an array")
    # Student-t_{2a}(f, sqrt(b/a)) log density
    nu = 2.0 * a
    s_sq = (b / a)[:, None]  # (M, 1)
    z_sq = np.square(yf[None, :] - f) / s_sq
    const = lgamma((nu + 1.0) / 2.0) - lgamma(nu / 2.0) - 0.5 * np.log(
        nu * np.pi
    )
    return const - 0.5 * np.log(s_sq) - ((nu + 1.0) / 2.0) * np.log1p(
        z_sq / nu
    )


def waic(log_lik: np.ndarray) -> Dict[str, np.ndarray]:
    """WAIC from a ``(M, N)`` pointwise log-likelihood matrix.

    Gelman, Hwang & Vehtari (2014) eqs. 11-13: ``lppd_i = log mean_m
    exp(ll_mi)``, ``p_waic_i = var_m(ll_mi)`` (the variance form),
    ``elpd_i = lppd_i - p_waic_i``; SE is ``sqrt(N var_i(elpd_i))``.
    """
    ll = np.asarray(log_lik, np.float64)
    m, n = ll.shape
    lppd_i = _logsumexp(ll, axis=0) - np.log(m)
    p_i = np.var(ll, axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    return {
        "elpd_waic": float(np.sum(elpd_i)),
        "p_waic": float(np.sum(p_i)),
        "lppd": float(np.sum(lppd_i)),
        "waic": float(-2.0 * np.sum(elpd_i)),
        "se": float(np.sqrt(n * np.var(elpd_i, ddof=1))) if n > 1 else 0.0,
        "pointwise": elpd_i,
    }


def gpdfit(z: np.ndarray) -> Tuple[float, float]:
    """Generalized-Pareto (k, sigma) fit to exceedances ``z > 0``.

    Zhang & Stephens (2009) quadrature over the profile likelihood of
    ``b = k/sigma`` (the estimator the loo package uses), with the
    weakly-informative k-prior regularization of Vehtari et al. (2017)
    appendix C: ``k <- (n k + 5) / (n + 10)``.
    """
    z = np.sort(np.asarray(z, np.float64))
    n = z.shape[0]
    if n < 5 or z[-1] <= 0.0:
        return np.inf, np.nan
    m = 30 + int(np.floor(np.sqrt(n)))
    j = np.arange(1, m + 1, dtype=np.float64)
    q1 = z[int(np.floor(n / 4.0 + 0.5)) - 1]
    b = 1.0 / z[-1] + (1.0 - np.sqrt(m / (j - 0.5))) / (3.0 * max(q1, 1e-12))
    # profile log-likelihood over theta=b in the Zhang-Stephens
    # parametrization, whose shape k_ZS(b) = -mean log1p(-b z) is the
    # NEGATIVE of the Vehtari-convention k returned below
    kb = -np.mean(np.log1p(-b[:, None] * z[None, :]), axis=1)
    lb = n * (np.log(b / kb) + kb - 1.0)
    wts = np.exp(lb - _logsumexp(lb))
    b_hat = float(np.sum(wts * b))
    k_hat = float(np.mean(np.log1p(-b_hat * z)))
    sigma = -k_hat / b_hat if b_hat != 0.0 else np.nan
    # shrink k toward 0.5 with 10 pseudo-observations (loo 2.0 convention)
    k_hat = (n * k_hat + 10.0 * 0.5) / (n + 10.0)
    return k_hat, sigma


def _psis_weights(log_ratios: np.ndarray) -> Tuple[np.ndarray, float]:
    """Pareto-smooth one point's ``(M,)`` log importance ratios.

    Returns stabilized log weights (normalized to max 0) and k-hat.
    Tail size ``ceil(min(0.2 M, 3 sqrt(M)))`` per Vehtari et al. 2017.
    """
    lr = np.asarray(log_ratios, np.float64)
    mth = lr.max()
    lw = lr - mth
    m = lw.shape[0]
    tail = int(np.ceil(min(0.2 * m, 3.0 * np.sqrt(m))))
    if tail < 5:
        return lw, -np.inf
    order = np.argsort(lw)
    tail_idx = order[-tail:]
    cutoff = lw[order[-tail - 1]]
    exc = np.exp(lw[tail_idx]) - np.exp(cutoff)
    k, sigma = gpdfit(exc)
    if np.isfinite(k) and np.isfinite(sigma) and sigma > 0:
        # replace tail weights by expected order statistics of the fitted GPD
        p = (np.arange(1, tail + 1) - 0.5) / tail
        if abs(k) < 1e-12:
            q = -sigma * np.log1p(-p)
        else:
            q = sigma / k * (np.power(1.0 - p, -k) - 1.0)
        smoothed = np.log(q + np.exp(cutoff))
        # assign in ascending order to the sorted tail positions
        lw[tail_idx] = np.minimum(smoothed, 0.0)
    return lw, k


def psis_loo(log_lik: np.ndarray) -> Dict[str, np.ndarray]:
    """PSIS-LOO from a ``(M, N)`` pointwise log-likelihood matrix.

    ``elpd_loo_i = log [ sum_m w_mi exp(ll_mi) / sum_m w_mi ]`` with raw
    ratios ``log w_mi = -ll_mi`` Pareto-smoothed per point;
    ``p_loo = lppd - elpd_loo``. ``pareto_k[i] > 0.7`` flags unreliable
    points (Vehtari, Gelman & Gabry 2017 threshold).
    """
    ll = np.asarray(log_lik, np.float64)
    m, n = ll.shape
    elpd_i = np.empty(n)
    ks = np.empty(n)
    for i in range(n):
        lw, k = _psis_weights(-ll[:, i])
        lw = lw - _logsumexp(lw)
        elpd_i[i] = _logsumexp(lw + ll[:, i])
        ks[i] = k
    lppd_i = _logsumexp(ll, axis=0) - np.log(m)
    return {
        "elpd_loo": float(np.sum(elpd_i)),
        "p_loo": float(np.sum(lppd_i - elpd_i)),
        "looic": float(-2.0 * np.sum(elpd_i)),
        "se": float(np.sqrt(n * np.var(elpd_i, ddof=1))) if n > 1 else 0.0,
        "pareto_k": ks,
        "pointwise": elpd_i,
    }


def compare(results: Dict[str, Dict[str, np.ndarray]]) -> str:
    """Rank models by elpd (WAIC or LOO dicts) with pairwise-difference SEs.

    ``results``: name -> dict from ``waic``/``psis_loo`` (must share the
    same N pointwise axis). Returns a formatted table, best model first;
    the difference SE uses the PAIRED pointwise elpds (Vehtari et al. 2017
    §5.2), which is much tighter than the individual SEs.
    """
    key = (
        "elpd_loo" if "elpd_loo" in next(iter(results.values())) else "elpd_waic"
    )
    ranked = sorted(results.items(), key=lambda kv: -kv[1][key])
    best = ranked[0][1]["pointwise"]
    lines = [f"{'model':<20} {'elpd':>10} {'d_elpd':>10} {'d_se':>8}"]
    for name, r in ranked:
        d = r["pointwise"] - best
        d_se = float(np.sqrt(d.shape[0] * np.var(d, ddof=1))) if d.shape[0] > 1 else 0.0
        lines.append(
            f"{name:<20} {r[key]:>10.2f} {float(np.sum(d)):>10.2f} {d_se:>8.2f}"
        )
    return "\n".join(lines)
