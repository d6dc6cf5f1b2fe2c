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
  ``noise="conditional"`` full predictive is not ported yet).

Plain PyTorch on ``device`` ("cuda" unless the caller asks for the CPU):
ptnn computes this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ptnn_torch.config import PTConfig
from ptnn_torch.models import fnn


def posterior_predict(
    cfg: PTConfig,
    draws: np.ndarray,
    x: np.ndarray,
    lo: float = 5.0,
    hi: float = 95.0,
    batch: int = 512,
    device: Any = "cuda",
) -> Dict[str, np.ndarray]:
    """Posterior-predictive summary on inputs ``x`` (N, I) from weight
    ``draws`` (M, w_size); NumPy arrays out, as ptnn's."""
    w_dim = fnn.w_size(cfg.topology)
    draws = np.asarray(draws, np.float32)
    if draws.ndim != 2 or draws.shape[1] != w_dim:
        raise ValueError(
            f"draws must be (M, {w_dim}) for topology {cfg.topology}; got "
            f"{draws.shape}")
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    cls = cfg.task == "classification"
    outs = []
    with torch.no_grad():
        for i in range(0, draws.shape[0], max(batch, 1)):
            w = torch.as_tensor(draws[i:i + batch], device=device)
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
