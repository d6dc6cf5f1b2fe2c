"""Log-likelihoods, priors and metrics (port of ``ptnn/ops/likelihood.py``).

Untempered values, batched over any leading dimensions: the sampler divides
by the chain's temperature at decision time. The regression prior's dimension
term is the reference's ``(I*H + H + 2)/2``, not the parameter count; the
classification prior's is ``w_size``. Classification's rmse is taken over the
predicted class INDEX (a quirk of the reference kept for parity) and its
accuracy is a percentage.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ptnn_torch.models import fnn
from ptnn_torch.models.fnn import Topology

_LOG_2PI = math.log(2.0 * math.pi)


class ClassEval(NamedTuple):
    loglik: torch.Tensor  # (...,) untempered
    rmse: torch.Tensor  # (...,) of the predicted class index against y
    acc: torch.Tensor  # (...,) percent
    fx: torch.Tensor  # (..., N) predicted class indices


def rmse(pred: torch.Tensor, actual: torch.Tensor) -> torch.Tensor:
    """Root mean squared error over the last axis."""
    return torch.sqrt(torch.mean(torch.square(pred - actual), dim=-1))


def accuracy(pred: torch.Tensor, actual: torch.Tensor) -> torch.Tensor:
    """Percentage of exact matches over the last axis."""
    return 100.0 * torch.mean((pred == actual).to(pred.dtype), dim=-1)


def classification_eval_from_logp(
    logp: torch.Tensor, out: torch.Tensor, y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> ClassEval:
    """Multinomial log-likelihood ``sum_i logp[..., i, y_i]`` and the
    metrics from log class probabilities ``logp`` (..., N, O), the raw
    outputs ``out`` for the first-argmax prediction and integer-valued
    labels ``y`` (N,). ``mask``: optional (N,) {0, 1} row validity; a
    padded row adds nothing, and the metrics divide by ``mask.sum()`` (a
    true division, as ptnn's traced row count makes it)."""
    yi = y.to(torch.int64)
    idx = yi.expand(logp.shape[:-1])[..., None]
    gathered = torch.gather(logp, -1, idx)[..., 0]
    pred = fnn.predict_class(out).to(logp.dtype)
    yf = y.to(logp.dtype)
    if mask is None:
        return ClassEval(loglik=torch.sum(gathered, dim=-1),
                         rmse=rmse(pred, yf), acc=accuracy(pred, yf), fx=pred)
    n = torch.sum(mask)
    return ClassEval(
        loglik=torch.sum(mask * gathered, dim=-1),
        rmse=torch.sqrt(torch.sum(mask * torch.square(pred - yf), dim=-1)
                        / n),
        acc=100.0 * torch.sum(mask * (pred == yf).to(pred.dtype), dim=-1)
        / n,
        fx=pred)


def classification_eval(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        topo: Topology) -> ClassEval:
    """Every chain at once: w (C, W), x (N, I), y (N,) -> (C,) values."""
    out = fnn.batched_forward(w, x, topo)
    return classification_eval_from_logp(fnn.log_class_probs(out), out, y)


def classification_log_prior_dim(w: torch.Tensor, dim: int,
                                 sigma_sq: float = 25.0) -> torch.Tensor:
    """Gaussian weight prior with an explicit dimension constant."""
    part1 = -0.5 * dim * math.log(sigma_sq)
    return part1 - torch.sum(torch.square(w), dim=-1) / (2.0 * sigma_sq)


def classification_log_prior(w: torch.Tensor, topo: Topology,
                             sigma_sq: float = 25.0) -> torch.Tensor:
    """``-(w_size/2) log(sigma^2) - sum(w^2) / (2 sigma^2)``: the
    reference's dimension term ``d*h + h + o + h*o`` is ``w_size``."""
    return classification_log_prior_dim(w, fnn.w_size(topo), sigma_sq)


class RegEval(NamedTuple):
    loglik: torch.Tensor  # (...,) untempered
    rmse: torch.Tensor  # (...,)
    fx: torch.Tensor  # (..., N) predictions


def regression_eval_from_fx(
    fx: torch.Tensor, y: torch.Tensor, tau_sq: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> RegEval:
    """Gaussian log-likelihood ``sum_i [-log(2 pi tau^2)/2 - (y_i - fx_i)^2 /
    (2 tau^2)]`` from predictions fx (..., N), targets y (N,), tau_sq (...).
    ``mask``: optional (N,) {0, 1} row validity; a padded row adds nothing
    and N is ``mask.sum()``."""
    if mask is None:
        n = fx.shape[-1]
        sse = torch.sum(torch.square(y - fx), dim=-1)
        rmse = torch.sqrt(torch.mean(torch.square(fx - y), dim=-1))
    else:
        n = torch.sum(mask)
        sse = torch.sum(mask * torch.square(y - fx), dim=-1)
        rmse = torch.sqrt(sse / n)
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
