"""Variational reference for the tempering path (port of ``ptnn/ops/vref.py``).

Classic PT tempers the likelihood only, so the hot end of the ladder anneals
toward the prior, far from the posterior bulk of a Bayesian network. With a
Gaussian ``q`` moment-matched to the cold chain (Surjanovic, Syed,
Bouchard-Cote & Campbell, "Parallel tempering with a variational reference",
NeurIPS 2022) the path becomes

    log pi_beta(w) = log prior(w) + beta * LL(w)
                     + (1 - beta) * [log q(w) - log p_w(w)]

with ``p_w`` the Gaussian w-part of the prior: at beta = 1 the posterior, at
beta = 0 exactly ``q``, which the sampler draws IID (the hot rung's
regeneration, ``kernel.VRef.regen``). The MH test gains ``(1 - beta)
(corr(w') - corr(w))``, the swap energy becomes ``E = LL - corr``, the
tempered gradient gains ``(1 - beta) grad corr``.

Everything here is up to additive constants that cancel: every consumer
differences the same function at two states under the same reference.
Tensor functions run in torch (a draw takes an explicit generator);
``schedule``, ``frozen_count``, ``log_z0``, ``log_z0_chol`` and
``fit_gaussian`` are host-side NumPy, as in ptnn.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# floor on the fitted per-parameter variance: a cold chain that has not
# moved in a coordinate would otherwise give s^2 = 0
VAR_FLOOR = 1e-8


def welford_variance(m2: torch.Tensor, count: float,
                     inflation: float = 1.0) -> torch.Tensor:
    """Per-parameter variance from a Welford M2 accumulator of ``count``
    samples (a host number: no copy to the device), inflated by
    ``inflation`` and floored at ``VAR_FLOOR``."""
    var = m2 / max(float(count), 1.0)
    return torch.clamp(var * inflation, min=VAR_FLOOR)


def log_q_quad(w: torch.Tensor, mu: torch.Tensor,
               var: torch.Tensor) -> torch.Tensor:
    """``log q(w)`` up to its normalizer; ``w`` (..., W), ``mu``/``var``
    (W,); returns (...,)."""
    return -0.5 * torch.sum(torch.square(w - mu) / var, dim=-1)


def correction(w: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
               sigma_sq: float) -> torch.Tensor:
    """The path correction ``corr(w) = log q(w) - log p_w(w)`` up to
    constants, ``p_w = N(0, sigma_sq I)``."""
    return log_q_quad(w, mu, var) + 0.5 * torch.sum(torch.square(w),
                                                    dim=-1) / sigma_sq


def grad_correction(w: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                    sigma_sq: float) -> torch.Tensor:
    """``d corr / d w``."""
    return -(w - mu) / var + w / sigma_sq


def sample_q(mu: torch.Tensor, var: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One IID draw from ``q = N(mu, diag(var))``: from ``generator``, or
    from the standard normal ``z`` (W,) given."""
    if z is None:
        z = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                        device=mu.device)
    return mu + torch.sqrt(var) * z


def schedule(samples_per_chain: int, vr_start_frac: float, burn_in: float,
             warmstart_frac: float) -> Tuple[int, int, int]:
    """(vr_start, vr_accum_start, vr_burn_end): the step the correction
    activates, the step Welford accumulation begins (half the activation
    point, never inside a warm start) and the step it stops; the statistics
    are frozen for every step ``i >= vr_burn_end``."""
    vr_start = int(samples_per_chain * vr_start_frac)
    vr_burn_end = int(samples_per_chain * burn_in) - 1
    vr_accum_start = max(int(samples_per_chain * warmstart_frac),
                         vr_start // 2)
    return vr_start, vr_accum_start, vr_burn_end


def frozen_count(samples_per_chain: int, vr_start_frac: float,
                 burn_in: float, warmstart_frac: float) -> float:
    """The Welford sample count after the freeze."""
    _, accum_start, burn_end = schedule(samples_per_chain, vr_start_frac,
                                        burn_in, warmstart_frac)
    return float(max(burn_end - accum_start, 1))


def log_z0(var, prior_dim: int, sigma_sq: float) -> float:
    """Closed-form log normalizer of the beta = 0 end of the corrected path
    under the committed prior convention: ``sigma_sq^(-prior_dim/2) prod_i
    sqrt(2 pi var_i)``."""
    var = np.asarray(var, np.float64)
    return float(-0.5 * prior_dim * np.log(sigma_sq)
                 + 0.5 * np.sum(np.log(2.0 * np.pi * var)))


def welford_update(mean: torch.Tensor, m2: torch.Tensor, x: torch.Tensor,
                   count_new: float, live: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One masked Welford step: fold ``x`` in when ``live``; ``count_new``
    is the count including ``x`` (host values)."""
    upd = 1.0 if live else 0.0
    delta = x - mean
    mean_new = mean + upd * delta / max(float(count_new), 1.0)
    m2_new = m2 + upd * delta * (x - mean_new)
    return mean_new, m2_new


# ---------------------------------------------------------------------------
# The full-covariance family (vr_family="full_cov", static mode only: the
# rounds interface, ptnn_torch/rounds.py). The triangular solves run in
# float32, as ptnn's do.


def _solve_lower(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(chol, b, upper=False)


def log_q_chol(z: torch.Tensor, mu: torch.Tensor,
               chol: torch.Tensor) -> torch.Tensor:
    """``log q(z)`` for ``q = N(mu, L L^T)`` up to its normalizer, by one
    triangular solve; ``z`` (..., Z), ``chol`` (Z, Z) lower; returns
    (...,)."""
    dz = z - mu
    r = _solve_lower(chol, torch.movedim(dz, -1, 0).reshape(chol.shape[0],
                                                            -1))
    return -0.5 * torch.sum(torch.square(r), dim=0).reshape(dz.shape[:-1])


def grad_logq_chol(z: torch.Tensor, mu: torch.Tensor,
                   chol: torch.Tensor) -> torch.Tensor:
    """``d log q / d z = -Sigma^{-1} (z - mu)`` by two triangular solves;
    returns (..., Z)."""
    dz = z - mu
    flat = torch.movedim(dz, -1, 0).reshape(chol.shape[0], -1)
    r = _solve_lower(chol, flat)
    s = torch.linalg.solve_triangular(chol.T, r, upper=True)
    return -torch.movedim(s.reshape((chol.shape[0],) + dz.shape[:-1]), 0, -1)


def sample_q_chol(mu: torch.Tensor, chol: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One IID draw from ``q = N(mu, L L^T)``: from ``generator``, or from
    the standard normal ``z`` given."""
    if z is None:
        z = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                        device=mu.device)
    return mu + chol @ z


def log_z0_chol(chol, prior_dim: int, sigma_sq: float) -> float:
    """The full-covariance ``log_z0``: ``sigma_sq^(-prior_dim/2) (2
    pi)^(Z/2) |L|``."""
    d = np.asarray(chol, np.float64).diagonal()
    return float(-0.5 * prior_dim * np.log(sigma_sq)
                 + 0.5 * d.shape[0] * np.log(2.0 * np.pi)
                 + np.sum(np.log(np.abs(d))))


def fit_gaussian(draws, family: str = "full_cov", shrinkage: float = 0.1,
                 inflation: float = 1.0, var_floor: float = VAR_FLOOR):
    """Host-side moment fit of the static reference to (n, Z) draws: ``(mu,
    var, chol)`` as float32, ``chol`` None for "diag". The full covariance
    is shrunk toward its diagonal, ``S <- (1 - shrinkage) S + shrinkage
    diag(S)``, then inflated and floored."""
    draws = np.asarray(draws, np.float64)
    if draws.ndim != 2 or draws.shape[0] < 2:
        raise ValueError(f"need (n>=2, Z) draws, got {draws.shape}")
    mu = draws.mean(axis=0)
    var = np.maximum(draws.var(axis=0) * inflation, var_floor)
    if family == "diag":
        return mu.astype(np.float32), var.astype(np.float32), None
    if family != "full_cov":
        raise ValueError(f"unknown reference family {family!r}")
    s = np.atleast_2d(np.cov(draws, rowvar=False))
    s = (1.0 - shrinkage) * s + shrinkage * np.diag(np.diag(s))
    s = s * inflation + var_floor * np.eye(s.shape[0])
    chol = np.linalg.cholesky(s)
    return (mu.astype(np.float32),
            np.maximum(np.diag(s), var_floor).astype(np.float32),
            chol.astype(np.float32))
