"""Deep MLP model family (any hidden stack) for the tempered sampler.

Port of ``ptnn/models/mlp.py``: a hidden-layer stack of any depth with a
selectable activation, a flat weight vector ``[W1, b1, W2, b2, ...]`` and the
gradient Langevin drift (``api.grad_drift``). The two-layer sigmoid member of
this family is NOT the reference model (the reference subtracts its biases
and softmaxes sigmoid outputs: ``api.fnn_spec``); this is the conventional
formulation. ``forward`` is chain-batched: w (C, W), x (N, I) -> (C, N, O).
Products run in full float32 (``ops.precision.full_float32``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ptnn_torch.models import api
from ptnn_torch.ops.precision import full_float32

_ACTS = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
}


def _shapes(sizes: Sequence[int]) -> List[Tuple[int, ...]]:
    out = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        out.append((a, b))
        out.append((b,))
    return out


def w_size(sizes: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def unflatten(w: torch.Tensor, shapes) -> List[torch.Tensor]:
    """Split flat weights (..., W) into tensors of ``shapes`` (in order),
    each with w's leading dimensions."""
    lead = w.shape[:-1]
    params, idx = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        params.append(w[..., idx:idx + n].reshape(lead + tuple(shape)))
        idx += n
    return params


def unpack(w: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    return unflatten(w, _shapes(sizes))


def forward(w: torch.Tensor, x: torch.Tensor, sizes: Tuple[int, ...],
            act: str) -> torch.Tensor:
    """w (C, W), x (N, I) -> raw logits / regression outputs (C, N, O)."""
    p = unpack(w, sizes)
    f = _ACTS[act]
    n_layers = len(sizes) - 1
    h = x
    with full_float32():
        for li in range(n_layers):
            h = torch.matmul(h, p[2 * li]) + p[2 * li + 1][:, None, :]
            if li < n_layers - 1:
                h = f(h)
    return h


def spec(sizes: Sequence[int], task: str = "classification",
         act: str = "relu") -> api.ModelSpec:
    sizes = tuple(sizes)
    ws = w_size(sizes)

    def fwd(w, x):
        return forward(w, x, sizes, act)

    def log_probs(out):
        return torch.log_softmax(out, dim=-1)

    if task == "classification":

        def loss(w, x, t):
            return -torch.sum(t * torch.log_softmax(fwd(w, x), dim=-1),
                              dim=(-2, -1))

    else:

        def loss(w, x, t):
            return 0.5 * torch.sum(torch.square(fwd(w, x) - t), dim=(-2, -1))

    return api.ModelSpec(
        name=f"mlp{sizes}-{act}",
        w_size=ws,
        forward=fwd,
        log_probs=log_probs,
        drift=api.grad_drift(loss),
        prior_dim_classification=ws,
        prior_dim_regression=ws,
        drift_per_chain_rate=True,
    )
