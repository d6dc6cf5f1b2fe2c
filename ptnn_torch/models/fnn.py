"""Two-layer sigmoid feed-forward network on tensors.

Port of ``ptnn/models/fnn.py``.

The flat weight codec is ``[W1.ravel(), W2.ravel(), B1, B2]`` and the forward
pass SUBTRACTS the biases, ``sigmoid(sigmoid(x @ W1 - B1) @ W2 - B2)``, as in
the reference network and in ``ptnn``. ``unpack`` takes any number of
leading batch dimensions on ``w``.

Float32 matrix products run in full float32: TF32 would keep about three
decimal digits and move the log-likelihoods the MH test compares, so it is
switched off here (PyTorch's default, set explicitly).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Topology = Tuple[int, int, int]  # (n_in, n_hidden, n_out)

torch.backends.cuda.matmul.allow_tf32 = False


class FnnParams(NamedTuple):
    w1: torch.Tensor  # (..., n_in, n_hidden)
    b1: torch.Tensor  # (..., n_hidden)
    w2: torch.Tensor  # (..., n_hidden, n_out)
    b2: torch.Tensor  # (..., n_out)


def w_size(topo: Topology) -> int:
    i, h, o = topo
    return i * h + h * o + h + o


def unpack(w: torch.Tensor, topo: Topology) -> FnnParams:
    """Split flat weights (..., W) into layer weights."""
    i, h, o = topo
    s1 = i * h
    s2 = s1 + h * o
    lead = w.shape[:-1]
    return FnnParams(
        w1=w[..., :s1].reshape(lead + (i, h)),
        b1=w[..., s2 : s2 + h],
        w2=w[..., s1:s2].reshape(lead + (h, o)),
        b2=w[..., s2 + h : s2 + h + o],
    )


def forward(w: torch.Tensor, x: torch.Tensor, topo: Topology) -> torch.Tensor:
    """One network: w (W,), x (N, n_in) -> sigmoid outputs (N, n_out)."""
    p = unpack(w, topo)
    hid = torch.sigmoid(x @ p.w1 - p.b1)
    return torch.sigmoid(hid @ p.w2 - p.b2)


def batched_forward(
    w: torch.Tensor, x: torch.Tensor, topo: Topology
) -> torch.Tensor:
    """Every chain at once: w (C, W), x (N, n_in) -> (C, N, n_out)."""
    p = unpack(w, topo)
    hid = torch.sigmoid(torch.matmul(x, p.w1) - p.b1[:, None, :])
    return torch.sigmoid(torch.matmul(hid, p.w2) - p.b2[:, None, :])
