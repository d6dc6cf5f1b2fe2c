"""Bayesian convolutional network for image classification.

Port of ``ptnn/models/cnn.py``: a conv-pool-conv-pool-dense classifier whose
flat weight vector plugs into the same parallel-tempering sampler as the
FNN. The flat vector keeps ptnn's order, per stage the conv taps as
(kh, kw, c_in, c_out) then the bias, then ``dense_w`` (flat, hidden),
``dense_b``, ``out_w``, ``out_b``; activations keep ptnn's layout too, with
the chain axis written out in front: (C, N, H, W, channels).

A stage is conv(SAME) + bias + relu + the 2x2 average pool. The taps differ
per chain, so a stage is one batched product over the chains: the 3x3
patches of the activations, (C, N*H*W, 9*c_in), times the chain's taps,
(C, 9*c_in, c_out), which is the flat taps' own order. Stage 1's images are
the same for every chain, so its patches are made once and broadcast. (One
``F.conv2d`` with ``groups = C`` computes the same stage; on an H100, at the
digits widths, its forward takes twice as long and its forward and backward
together a fifth less: ``chip_smoke.py`` times both, and the port keeps the
one way for evals and drifts.) Products run in full float32 (``ops.precision``). The pool is ``reduce_window(add, SAME) /
4.0``: an odd side gets one zero row and column at the END and still divides
by 4.

The Langevin drift is one full-batch gradient step of the cross-entropy by
autograd (``api.grad_drift``). ``spec(fused_eval=True)`` evaluates with
``batched_forward_fused``, whose stage 1 is the hand-written kernel of
``ops.conv_stage``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ptnn_torch.models import api
from ptnn_torch.models.mlp import unflatten
from ptnn_torch.ops import conv_stage
from ptnn_torch.ops.precision import full_float32


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    image_hw: int  # square image side
    n_classes: int
    channels: Tuple[int, ...] = (8, 16)  # conv channels per stage
    kernel: int = 3
    hidden: int = 32  # dense layer before logits


def _shapes(cfg: CnnConfig):
    """Per-layer parameter shapes in flat-vector order."""
    shapes = []
    c_in = 1
    for c_out in cfg.channels:
        shapes.append(("conv_w", (cfg.kernel, cfg.kernel, c_in, c_out)))
        shapes.append(("conv_b", (c_out,)))
        c_in = c_out
    hw = cfg.image_hw
    for _ in cfg.channels:
        hw = (hw + 1) // 2  # stride-2 avg pool per stage
    flat = hw * hw * c_in
    shapes.append(("dense_w", (flat, cfg.hidden)))
    shapes.append(("dense_b", (cfg.hidden,)))
    shapes.append(("out_w", (cfg.hidden, cfg.n_classes)))
    shapes.append(("out_b", (cfg.n_classes,)))
    return shapes


def w_size(cfg: CnnConfig) -> int:
    total = 0
    for _, shape in _shapes(cfg):
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def unpack(w: torch.Tensor, cfg: CnnConfig) -> List[torch.Tensor]:
    """Flat weights (..., W) -> the layers' tensors, in ``_shapes`` order,
    each with w's leading dimensions."""
    return unflatten(w, [s for _, s in _shapes(cfg)])


def _patches(h: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k SAME patches of h (B, N, H, W, c_in) -> (B, N*H*W,
    k*k*c_in), columns in (kh, kw, c_in) order. XLA's SAME padding of an
    even window puts the extra row and column at the end."""
    b, n, hh, ww, ci = h.shape
    lo = (k - 1) // 2
    hp = F.pad(h, (0, 0, lo, k - 1 - lo, lo, k - 1 - lo))
    cols = [hp[:, :, dy:dy + hh, dx:dx + ww, :]
            for dy in range(k) for dx in range(k)]
    return torch.cat(cols, dim=-1).reshape(b, n * hh * ww, k * k * ci)


def _pool(z: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 ``reduce_window(add, SAME) / 4.0`` over (..., H, W, ch)."""
    hh, ww = z.shape[-3], z.shape[-2]
    if hh % 2 or ww % 2:
        z = F.pad(z, (0, 0, 0, ww % 2, 0, hh % 2))
    lead, ch = z.shape[:-3], z.shape[-1]
    z = z.reshape(lead + ((hh + 1) // 2, 2, (ww + 1) // 2, 2, ch))
    return z.sum(dim=(-4, -2)) / 4.0


def _conv_stage(h: torch.Tensor, cw: torch.Tensor,
                cb: torch.Tensor) -> torch.Tensor:
    """conv(SAME) + bias + relu + 2x2 avg-pool for every chain: h (C or 1,
    N, H, W, c_in) (1: images shared by the chains), cw (C, k, k, c_in,
    c_out), cb (C, c_out) -> (C, N, ceil(H/2), ceil(W/2), c_out)."""
    c, k, _, ci, co = cw.shape
    _b, n, hh, ww, _ci = h.shape
    with full_float32():
        z = torch.matmul(_patches(h, k), cw.reshape(c, k * k * ci, co))
    z = z.reshape(c, n, hh, ww, co) + cb[:, None, None, None, :]
    return _pool(torch.relu(z))


def _tail(params, h: torch.Tensor, cfg: CnnConfig, stage: int) -> torch.Tensor:
    """Stages ``stage``.. plus the dense head for every chain; ``h``: (C or
    1, N, hw', hw', c_in) -> (C, N, n_classes) logits."""
    pi = 2 * stage
    for _ in cfg.channels[stage:]:
        h = _conv_stage(h, params[pi], params[pi + 1])
        pi += 2
    dw, db, ow, ob = params[pi:pi + 4]
    h = h.reshape(h.shape[0], h.shape[1], -1)
    with full_float32():
        h = torch.relu(torch.matmul(h, dw) + db[:, None, :])
        return torch.matmul(h, ow) + ob[:, None, :]


def forward(w: torch.Tensor, x: torch.Tensor, cfg: CnnConfig) -> torch.Tensor:
    """w (C, W), x (N, H*W) flat pixels -> (C, N, n_classes) logits."""
    params = unpack(w, cfg)
    h = x.reshape(1, x.shape[0], cfg.image_hw, cfg.image_hw, 1)
    return _tail(params, h, cfg, stage=0)


def batched_forward_fused(ws: torch.Tensor, x: torch.Tensor,
                          cfg: CnnConfig) -> torch.Tensor:
    """(C, W) x (N, hw*hw) -> (C, N, n_classes) with stage 1 through
    ``conv_stage.conv1_relu_pool`` (the CUDA kernel on the card): its input
    is the same for every chain, and the pre-pool tensor is never written.
    The chain-dependent stages stay batched products."""
    params = unpack(ws, cfg)
    h = conv_stage.conv1_relu_pool(
        x, params[0].contiguous(), params[1].contiguous(), hw=cfg.image_hw,
        in_ch=1, out_ch=cfg.channels[0])  # (C, N, hw/2, hw/2, c1)
    return _tail(params, h, cfg, stage=1)


def spec(cfg: CnnConfig, fused_eval: bool = False) -> api.ModelSpec:
    ws = w_size(cfg)

    def fwd(w, x):
        return forward(w, x, cfg)

    def log_probs(out):
        return torch.log_softmax(out, dim=-1)

    def xent(w, x, t):
        # t: (N, n_classes) one-hot targets; each chain's own loss (C,)
        logp = torch.log_softmax(forward(w, x, cfg), dim=-1)
        return -torch.sum(t * logp, dim=(-2, -1))

    bf = None
    if fused_eval:
        def bf(ws_batch, x):
            return batched_forward_fused(ws_batch, x, cfg)

    return api.ModelSpec(
        name=f"cnn{cfg.image_hw}x{cfg.image_hw}c{cfg.channels}"
        + ("-fused" if fused_eval else ""),
        w_size=ws,
        forward=fwd,
        log_probs=log_probs,
        drift=api.grad_drift(xent),
        prior_dim_classification=ws,
        prior_dim_regression=ws,
        batched_forward=bf,
        drift_per_chain_rate=True,
    )


def digits_spec(channels=(8, 16), hidden=32, fused_eval=False) -> api.ModelSpec:
    """CNN for the bundled 8x8 digits set."""
    return spec(
        CnnConfig(image_hw=8, n_classes=10, channels=channels, hidden=hidden),
        fused_eval=fused_eval,
    )


def mnist_spec(channels=(8, 16), hidden=64, fused_eval=False) -> api.ModelSpec:
    """The 28x28 MNIST layout."""
    return spec(
        CnnConfig(image_hw=28, n_classes=10, channels=channels, hidden=hidden),
        fused_eval=fused_eval,
    )
