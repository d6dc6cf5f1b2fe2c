"""Marginal-likelihood (model evidence) estimation from the tempered ladder
(port of ``ptnn/ops/evidence.py``; host-side NumPy).

A PT run samples the path of power posteriors ``p_beta(w) ∝ L(w)^beta
p(w)``, and the log marginal likelihood is the thermodynamic integral
``log Z(beta_hi) - log Z(beta_lo) = ∫ E_beta[log L] dbeta``. The per-rung
post-MH, post-swap untempered log-likelihood (``record_ll_state`` ->
``traces["ll_cur"]``) feeds two estimators: thermodynamic integration
(trapezoid over beta) and stepping stone (log-mean-exp of each rung's
importance ratio toward the next).

* Prior-anchored ladders span beta in [1/maxtemp, 1]: the estimates are the
  evidence difference across the ladder.
* Corrected-path mode (``variational_reference``): the run samples ``exp(
  prior + beta LL + (1 - beta) corr)``, whose integrand is ``E_beta[LL -
  corr]`` (``traces["vr_corr_cur"]``); with the beta = 0 rung
  (``vr_hot_infinite``) the path's cold end has the closed-form normalizer
  ``vref.log_z0``, and the estimates are the absolute log marginal
  likelihood under the committed prior convention. The window floors at the
  reference's freeze step, where the path becomes fixed.
* Two-phase tempering collapses every rung to T = 1 at the temper switch:
  ``window=None`` takes the second half of the tempered phase (canonical
  runs: of the whole run).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np


class EvidenceEstimate(NamedTuple):
    """Both estimators for one run, and what they were computed from."""

    log_z_ti: float  # trapezoid TI: log Z(beta_max) - log Z(beta_min)
    log_z_ss: float  # stepping stone, the same difference
    betas: np.ndarray  # (R,) ascending inverse temperatures
    mean_ll: np.ndarray  # (R,) per-rung window mean of the integrand
    n_samples: int  # draws a rung
    window: Tuple[int, int]
    # the closed-form log Z(0) of a corrected path with its beta = 0 rung
    # (nan otherwise): log_z0 + log_z_ti is the absolute log evidence
    log_z0: float = float("nan")

    @property
    def anchored(self) -> bool:
        return bool(np.isfinite(self.log_z0))

    @property
    def log_z_abs_ti(self) -> float:
        return self.log_z0 + self.log_z_ti

    @property
    def log_z_abs_ss(self) -> float:
        return self.log_z0 + self.log_z_ss


def _window(cfg, n_rows: int, window: Optional[Tuple[int, int]]):
    if window is not None:
        a, b = window
        if not (0 < a < b <= n_rows):
            raise ValueError(f"bad window {window} for {n_rows} trace rows")
        return a, b
    # trace row 0 is the init row; rows 1..S-1 are steps 0..S-2
    switch = min(cfg.temper_switch_step, n_rows - 1)
    if switch <= 0:  # canonical run: the whole run is tempered
        switch = n_rows - 1
    a = max(1, switch // 2)
    return a, switch + 1  # rows a..switch hold tempered-phase states


def from_traces(
    traces: Dict[str, np.ndarray],
    temperatures: np.ndarray,
    cfg,
    window: Optional[Tuple[int, int]] = None,
    log_z0: float = float("nan"),
) -> EvidenceEstimate:
    """The ladder evidence of a recorded run (needs ``record_ll_state``'s
    "ll_cur"). ``window``: (start_row, end_row), half open; default the
    second half of the tempered phase, floored at the reference's freeze
    step for corrected-path runs, whose integrand is ``ll - corr``."""
    if "ll_cur" not in traces:
        raise ValueError(
            "evidence needs the state-likelihood trace: run with "
            "PTConfig(record_ll_state=True)")
    ll = np.asarray(traces["ll_cur"], np.float64)  # (S, R)
    if "vr_corr_cur" in traces:
        ll = ll - np.asarray(traces["vr_corr_cur"], np.float64)
        if window is None:
            from ptnn_torch.ops import vref

            if cfg.vr_mode == "static":
                freeze = 0  # the reference is fixed for the whole run
            else:
                _, _, freeze = vref.schedule(
                    cfg.samples_per_chain, cfg.vr_start_frac, cfg.burn_in,
                    cfg.warmstart_frac)
            a, b = _window(cfg, ll.shape[0], None)
            window = (max(a, min(freeze, ll.shape[0] - 2)), b)
    a, b = _window(cfg, ll.shape[0], window)
    return from_samples(ll[a:b], np.asarray(temperatures), window=(a, b),
                        log_z0=log_z0)


def from_result(res, window: Optional[Tuple[int, int]] = None
                ) -> EvidenceEstimate:
    """``from_traces`` of a ``ptnn_torch.sample`` result; a corrected-path
    run with the beta = 0 rung is anchored by ``vref.log_z0`` (or
    ``log_z0_chol``) of its frozen reference."""
    cfg = res.config
    log_z0 = float("nan")
    if ("vr_corr_cur" in res.traces
            and np.isinf(np.asarray(res.temperatures, np.float64)).any()):
        from ptnn_torch import kernel
        from ptnn_torch.ops import vref

        spec = kernel.default_spec(cfg)
        prior_dim = (spec.prior_dim_regression if cfg.task == "regression"
                     else spec.prior_dim_classification)
        st = res.final_state
        if cfg.vr_family == "full_cov":
            log_z0 = vref.log_z0_chol(np.asarray(st.vr_chol, np.float64),
                                      prior_dim, cfg.sigma_sq)
        else:
            m2 = np.asarray(st.vr_m2, np.float64)
            if cfg.vr_mode == "static":
                # vr_m2 is the variance (inflation applied at fit time)
                var = np.maximum(m2, vref.VAR_FLOOR)
            else:
                cnt = vref.frozen_count(cfg.samples_per_chain,
                                        cfg.vr_start_frac, cfg.burn_in,
                                        cfg.warmstart_frac)
                var = np.maximum(m2 / max(cnt, 1.0) * cfg.vr_var_inflation,
                                 vref.VAR_FLOOR)
            log_z0 = vref.log_z0(var, prior_dim, cfg.sigma_sq)
    return from_traces(res.traces, res.temperatures, cfg, window, log_z0)


def from_samples(
    ll: np.ndarray,
    temperatures: np.ndarray,
    window: Tuple[int, int] = (0, 0),
    log_z0: float = float("nan"),
) -> EvidenceEstimate:
    """Both estimators from (n_samples, R) integrand draws, column r drawn
    under rung r's path member; columns of one beta (replicated ladders)
    pool."""
    ll = np.asarray(ll, np.float64)
    betas = 1.0 / np.asarray(temperatures, np.float64)
    ub = np.unique(betas)  # ascending
    if len(ub) < 2:
        raise ValueError("evidence integration needs at least 2 rungs")
    cols = [ll[:, betas == b].T.reshape(-1) for b in ub]
    mean_ll = np.asarray([c.mean() for c in cols])
    # trapezoid is numpy 2's name of trapz
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    ti = float(trapezoid(mean_ll, ub))
    # stepping stone: rung k's own draws estimate the ratio toward k + 1
    db = np.diff(ub)
    ss = 0.0
    for k in range(len(db)):
        z = db[k] * cols[k]
        zmax = z.max()
        ss += float(zmax + np.log(np.mean(np.exp(z - zmax))))
    return EvidenceEstimate(log_z_ti=ti, log_z_ss=ss, betas=ub,
                            mean_ll=mean_ll, n_samples=len(cols[0]),
                            window=window, log_z0=log_z0)
