"""Model specification for the sampler (port of ``ptnn/models/api.py``).

A ``ModelSpec`` carries what the per-step sampler needs of a model: the
chain-batched forward, the log class probabilities, the Langevin drift and
the prior's dimension constants. Only the reference FNN (``fnn_spec``) is
ported; ``grad_drift`` and the CNN wait for the model zoo. Every function
takes chains-major flat weights (C, W).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import torch

from ptnn_torch.models import fnn
from ptnn_torch.ops import drift as drift_mod


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    w_size: int
    # forward(w (C, W), x (N, I)) -> (C, N, O) raw outputs (sigmoid
    # activations for the reference FNN)
    forward: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # log_probs(out) -> log class probabilities over the last axis
    log_probs: Callable[[torch.Tensor], torch.Tensor]
    # drift(w (C, W), x, t, lrate) -> (C, W): one Langevin drift of every
    # chain (an SGD epoch for the reference FNN)
    drift: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float],
                    torch.Tensor]
    # the reference prior's dimension constants
    prior_dim_classification: int
    prior_dim_regression: int


def fnn_spec(topo: Tuple[int, int, int],
             drift_mode: str = "sequential") -> ModelSpec:
    """The reference two-layer sigmoid FNN with the delta-rule drift of
    ``drift_mode`` ("sequential" and "pallas" launch the drift kernel on
    the card; "batch" is the summed update)."""
    if drift_mode not in drift_mod.MODES:
        raise ValueError(f"unknown drift mode {drift_mode!r}")
    i, h, o = topo
    return ModelSpec(
        name=f"fnn{tuple(topo)}-{drift_mode}",
        w_size=fnn.w_size(topo),
        forward=functools.partial(fnn.batched_forward, topo=topo),
        log_probs=fnn.log_class_probs,
        drift=lambda w, x, t, lrate: drift_mod.sgd_epoch(
            w, x, t, topo, lrate, mode=drift_mode),
        # pt_classification.py:227: d*h + h + o + h*o (== w_size)
        prior_dim_classification=i * h + h + o + h * o,
        # pt_timeseries_regression.py:218: d*h + h + 2
        prior_dim_regression=i * h + h + 2,
    )
