"""Posterior-predictive serving (port of ``ptnn/predict.py``'s
``posterior_predict``).

``posterior_predict(cfg, draws, x)`` evaluates the network for every
posterior weight draw at once, the draw axis a batch axis, in chunks of
``batch`` draws, and reduces:

* classification: ``probs`` (N, K), the posterior-mean class probabilities
  (softmax over the sigmoid outputs), ``label`` (N,) their first argmax and
  ``entropy`` (N,) of the predictive distribution in nats. This is the
  served predictor that the iris quality gate (96.76 %) reads;
* regression: ``mean`` (N,) and the percentile band ``low`` / ``high`` and
  ``std`` of the network outputs across draws (the epistemic band; the
  ``noise="conditional"`` full predictive, ``cond=`` and ``return_samples``
  are not ported yet and raise).

``spec=`` serves draws of a model of the zoo (``models.cnn.digits_spec()``,
``models.mlp.spec(...)``): a run sampled with ``model_spec=`` passes the same
spec here, as in ptnn. Its draws go through ``spec.forward`` and, for
classification, ``exp(spec.log_probs(...))``.

Plain PyTorch on ``device`` ("cuda" unless the caller asks for the CPU):
ptnn computes this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ptnn_torch.config import PTConfig
from ptnn_torch.models import fnn
from ptnn_torch.models.api import ModelSpec
from ptnn_torch.ops.precision import full_float32


def posterior_predict(
    cfg: PTConfig,
    draws: np.ndarray,
    x: np.ndarray,
    lo: float = 5.0,
    hi: float = 95.0,
    batch: int = 512,
    device: Any = "cuda",
    spec: Optional[ModelSpec] = None,
    noise: Optional[str] = None,
    cond=None,
    seed: int = 0,
    return_samples: bool = False,
) -> Dict[str, np.ndarray]:
    """Posterior-predictive summary on inputs ``x`` (N, I) from weight
    ``draws`` (M, w_size) of the reference FNN of ``cfg.topology``, or of
    ``spec``; NumPy arrays out, as ptnn's. ``seed`` only seeds the noise
    draws of ``noise=``, which is not ported yet."""
    for name, value in (("noise", noise), ("cond", cond),
                        ("return_samples", return_samples or None)):
        if value is not None:
            raise NotImplementedError(
                f"posterior_predict({name}=...) is not ported yet "
                f"(ROADMAP Queue 1 item 10)")
    w_dim = spec.w_size if spec is not None else fnn.w_size(cfg.topology)
    draws = np.asarray(draws, np.float32)
    if draws.ndim != 2 or draws.shape[1] != w_dim:
        raise ValueError(
            f"draws must be (M, {w_dim}) for "
            f"{spec.name if spec is not None else cfg.topology}; got "
            f"{draws.shape}")
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    cls = cfg.task == "classification"
    outs = []
    with torch.no_grad(), full_float32():
        for i in range(0, draws.shape[0], max(batch, 1)):
            w = torch.as_tensor(draws[i:i + batch], device=device)
            if spec is not None:
                out = spec.forward(w, xt)  # (m, N, O)
                outs.append(torch.exp(spec.log_probs(out)) if cls
                            else out[..., 0])
                continue
            out = fnn.batched_forward(w, xt, cfg.topology)  # (m, N, O)
            outs.append(fnn.class_probs(out) if cls else out[..., 0])
        out = torch.cat(outs)  # (M, N, K) or (M, N)
        if cls:
            probs = out.mean(dim=0)
            ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)),
                             dim=-1)
            probs_np = probs.cpu().numpy()
            return {"probs": probs_np, "label": probs_np.argmax(axis=-1),
                    "entropy": ent.cpu().numpy()}
        q = torch.tensor([lo / 100.0, hi / 100.0], device=out.device)
        band = torch.quantile(out, q, dim=0)
        return {"mean": out.mean(dim=0).cpu().numpy(),
                "low": band[0].cpu().numpy(), "high": band[1].cpu().numpy(),
                "std": out.std(dim=0, correction=0).cpu().numpy()}
