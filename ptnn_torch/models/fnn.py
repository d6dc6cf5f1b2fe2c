"""Two-layer sigmoid feed-forward network on tensors.

Port of ``ptnn/models/fnn.py``.

The flat weight codec is ``[W1.ravel(), W2.ravel(), B1, B2]`` and the forward
pass SUBTRACTS the biases, ``sigmoid(sigmoid(x @ W1 - B1) @ W2 - B2)``, as in
the reference network and in ``ptnn``. ``unpack`` takes any number of
leading batch dimensions on ``w``. ``neg_half_sse_grad`` (regression) and
``multinomial_ll_grad`` (classification) are the hand-written backprops the
preconditioned MALA/HMC samplers take their likelihood gradient from.
Classification's class probabilities are a softmax over the SIGMOID outputs
and the predicted class is their first argmax.

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


def class_probs(out: torch.Tensor) -> torch.Tensor:
    """Softmax over the sigmoid outputs (..., O)."""
    return torch.softmax(out, dim=-1)


def log_class_probs(out: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the sigmoid outputs (..., O): the log class
    probabilities the multinomial likelihood gathers."""
    return torch.log_softmax(out, dim=-1)


def predict_class(out: torch.Tensor) -> torch.Tensor:
    """Predicted class index (..., ) int64: the FIRST argmax of the outputs
    over the last axis (a later class wins only if strictly larger)."""
    best = out[..., 0]
    pred = torch.zeros(out.shape[:-1], dtype=torch.int64, device=out.device)
    for o in range(1, out.shape[-1]):
        better = out[..., o] > best
        pred = torch.where(better, o, pred)
        best = torch.maximum(best, out[..., o])
    return pred


def multinomial_ll_grad(
    w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, topo: Topology
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every chain at once: w (C, W), x (N, n_in), integer-valued labels y
    (N,) -> ``(ll (C,), d ll/dw (C, W), outputs (C, N, O))`` where ll is the
    multinomial log-likelihood ``sum_n log softmax(out_n)[y_n]``.

    The chain rule written out, as ``_fwd_grad_cls`` in
    ``ptnn/ops/pallas_step.py``: delta2_o = (onehot_o - p_o) out_o (1 -
    out_o); dW2_ho = sum delta2_o s_h; dB2_o = -sum delta2_o; delta1_h =
    (sum_o delta2_o W2_ho) s_h (1 - s_h); dW1_ih = sum delta1_h x_i;
    dB1_h = -sum delta1_h. Independent of the temperature.
    """
    p = unpack(w, topo)
    s = torch.sigmoid(torch.matmul(x, p.w1) - p.b1[:, None, :])  # (C, N, H)
    out = torch.sigmoid(torch.matmul(s, p.w2) - p.b2[:, None, :])  # (C, N, O)
    logp = log_class_probs(out)
    onehot = torch.nn.functional.one_hot(y.to(torch.int64),
                                         out.shape[-1]).to(out.dtype)
    ll = torch.sum(logp * onehot, dim=(-2, -1))
    d2 = (onehot - torch.exp(logp)) * out * (1.0 - out)  # (C, N, O)
    d_w2 = torch.einsum("cnh,cno->cho", s, d2)
    d_b2 = -torch.sum(d2, dim=1)
    dh = torch.einsum("cno,cho->cnh", d2, p.w2) * s * (1.0 - s)  # (C, N, H)
    d_b1 = -torch.sum(dh, dim=1)
    d_w1 = torch.einsum("ni,cnh->cih", x, dh)
    c = w.shape[0]
    grad = torch.cat([d_w1.reshape(c, -1), d_w2.reshape(c, -1), d_b1, d_b2],
                     dim=-1)
    return ll, grad, out
