"""Model specification for the sampler (port of ``ptnn/models/api.py``).

A ``ModelSpec`` carries what the per-step sampler needs of a model: the
chain-batched forward, the log class probabilities, the Langevin drift and
the prior's dimension constants. ``fnn_spec`` is the reference FNN (its eval
and its drift are the hand-written kernels); ``models.mlp.spec`` and
``models.cnn.spec`` build the model zoo on ``grad_drift``. Every function
takes chains-major flat weights (C, W): where ``ptnn`` writes one chain and
lets ``jax.vmap`` batch it, the port writes the chain axis out.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple, Union

import torch

from ptnn_torch.models import fnn
from ptnn_torch.ops import drift as drift_mod
from ptnn_torch.ops.precision import full_float32

Rate = Union[float, torch.Tensor]  # one learning rate, or one per chain (C,)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    w_size: int
    # forward(w (C, W), x (N, I)) -> (C, N, O) raw outputs (sigmoid
    # activations for the reference FNN, logits for the MLP and the CNN)
    forward: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # log_probs(out) -> log class probabilities over the last axis
    log_probs: Callable[[torch.Tensor], torch.Tensor]
    # drift(w (C, W), x, t, lrate) -> (C, W): one Langevin drift of every
    # chain (an SGD epoch for the reference FNN, one full-batch gradient
    # step for ``grad_drift`` models)
    drift: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Rate],
                    torch.Tensor]
    # the reference prior's dimension constants
    prior_dim_classification: int
    prior_dim_regression: int
    # optional second chain-batched forward, (C, W), (N, I) -> (C, N, O):
    # takes precedence over ``forward`` in the sampler's evals (a spec with
    # a hand-written eval stage, ``cnn.digits_spec(fused_eval=True)``). The
    # drift is unaffected: its gradient flows through ``forward``.
    batched_forward: Optional[Callable] = None
    # whether ``drift`` takes a per-chain (C,) rate: what adapt_step_size
    # with Langevin gradients needs (``grad_drift`` does, the FNN's drift
    # kernel takes one float)
    drift_per_chain_rate: bool = False
    # the reference FNN's topology: its evals go through ``ops.fnn_eval``
    # (the eval kernel on the card). None for every other model.
    fnn_topology: Optional[Tuple[int, int, int]] = None


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
        fnn_topology=tuple(topo),
    )


def grad_drift(loss_fn: Callable, lrate_scale: float = 1.0):
    """Langevin drift for differentiable models: one full-batch
    gradient-descent step on ``loss_fn(w (C, W), x, t) -> (C,)``, each
    chain's own loss. The chains are independent, so the gradient of the
    summed loss with respect to (C, W) is every chain's own gradient: one
    backward pass for all. ``lrate`` is one float or a per-chain (C,)
    tensor. The MH q-ratio correction in the sampler keeps it exact for any
    deterministic drift."""

    def drift(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
              lrate: Rate) -> torch.Tensor:
        with torch.enable_grad(), full_float32():
            wg = w.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(wg, x, t).sum(), wg)
        if isinstance(lrate, torch.Tensor):
            lrate = lrate[:, None]
        return w - lrate * lrate_scale * g

    return drift
