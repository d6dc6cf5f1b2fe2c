"""Regression log-likelihood and prior (port of ``ptnn/ops/likelihood.py``).

Untempered values, batched over any leading dimensions: the sampler divides
by the chain's temperature at decision time. The regression prior's dimension
term is the reference's ``(I*H + H + 2)/2``, not the parameter count.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ptnn_torch.models.fnn import Topology

_LOG_2PI = math.log(2.0 * math.pi)


class RegEval(NamedTuple):
    loglik: torch.Tensor  # (...,) untempered
    rmse: torch.Tensor  # (...,)
    fx: torch.Tensor  # (..., N) predictions


def regression_eval_from_fx(
    fx: torch.Tensor, y: torch.Tensor, tau_sq: torch.Tensor
) -> RegEval:
    """Gaussian log-likelihood ``sum_i [-log(2 pi tau^2)/2 - (y_i - fx_i)^2 /
    (2 tau^2)]`` from predictions fx (..., N), targets y (N,), tau_sq (...)."""
    n = fx.shape[-1]
    sse = torch.sum(torch.square(y - fx), dim=-1)
    rmse = torch.sqrt(torch.mean(torch.square(fx - y), dim=-1))
    loglik = -0.5 * n * (_LOG_2PI + torch.log(tau_sq)) - 0.5 * sse / tau_sq
    return RegEval(loglik=loglik, rmse=rmse, fx=fx)


def prior_dim_regression(topo: Topology) -> int:
    i, h, _o = topo
    return i * h + h + 2


def regression_log_prior_dim(
    w: torch.Tensor,
    tau_sq: torch.Tensor,
    dim: int,
    sigma_sq: float = 25.0,
    nu_1: float = 0.0,
    nu_2: float = 0.0,
) -> torch.Tensor:
    """Gaussian weight prior with an explicit dimension constant plus the
    inverse-gamma terms on tau^2; w (..., W), tau_sq (...)."""
    part1 = -0.5 * dim * math.log(sigma_sq)
    part2 = torch.sum(torch.square(w), dim=-1) / (2.0 * sigma_sq)
    return part1 - part2 - (1.0 + nu_1) * torch.log(tau_sq) - nu_2 / tau_sq


def regression_log_prior(
    w: torch.Tensor,
    tau_sq: torch.Tensor,
    topo: Topology,
    sigma_sq: float = 25.0,
    nu_1: float = 0.0,
    nu_2: float = 0.0,
) -> torch.Tensor:
    return regression_log_prior_dim(
        w, tau_sq, prior_dim_regression(topo), sigma_sq, nu_1, nu_2
    )
