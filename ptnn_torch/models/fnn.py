"""Two-layer sigmoid feed-forward network on tensors.

Port of ``ptnn/models/fnn.py``.

The flat weight codec is ``[W1.ravel(), W2.ravel(), B1, B2]`` and the forward
pass SUBTRACTS the biases, ``sigmoid(sigmoid(x @ W1 - B1) @ W2 - B2)``, as in
the reference network and in ``ptnn``. ``unpack`` takes any number of
leading batch dimensions on ``w``. ``neg_half_sse_grad`` is the
hand-written backprop of -SSE/2 that the preconditioned MALA/HMC samplers
take their likelihood gradient from.

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


def neg_half_sse_grad(
    w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, topo: Topology
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every chain at once, one output: w (C, W), x (N, n_in), y (N,) ->
    ``(-SSE/2 (C,), d(-SSE/2)/dw (C, W))`` in the flat codec's order.

    The two-layer chain rule written out, as ``_fwd_grad_reg`` in
    ``ptnn/ops/pallas_step.py``: delta = (y - fx) fx (1 - fx); dW2_h =
    sum delta s_h; dB2 = -sum delta; delta_h = delta W2_h s_h (1 - s_h);
    dW1_ih = sum delta_h x_i; dB1_h = -sum delta_h. The gradient is
    independent of tau and of the temperature; the samplers scale it.
    """
    p = unpack(w, topo)
    s = torch.sigmoid(torch.matmul(x, p.w1) - p.b1[:, None, :])  # (C, N, H)
    fx = torch.sigmoid(torch.matmul(s, p.w2)[..., 0] - p.b2)  # (C, N)
    resid = y - fx
    val = -0.5 * torch.sum(resid * resid, dim=-1)
    delta = resid * fx * (1.0 - fx)  # (C, N)
    d_w2 = torch.einsum("cn,cnh->ch", delta, s)
    d_b2 = -torch.sum(delta, dim=-1, keepdim=True)
    dh = delta[:, :, None] * p.w2[:, None, :, 0] * s * (1.0 - s)  # (C, N, H)
    d_b1 = -torch.sum(dh, dim=1)
    d_w1 = torch.einsum("ni,cnh->cih", x, dh)
    grad = torch.cat([d_w1.reshape(w.shape[0], -1), d_w2, d_b1, d_b2], dim=-1)
    return val, grad
