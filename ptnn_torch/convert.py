"""Chain state to and from NumPy, to start the port from ``ptnn``'s state.

``ptnn``'s ``ChainState`` fetched to the host (``jax.device_get(state)
._asdict()``) is a dict of NumPy arrays, None for the fields a run does not
use. ``chain_state_from_numpy`` takes the fields the port holds (the
accuracy carries, the Langevin counter ``n_langevin`` and, for
classification, a state without ``log_step_eta`` included), with their
dtypes and bits unchanged; ``chain_state_to_numpy`` gives them back.
``model_params_from_numpy`` takes ``ptnn``'s flat model weights: every model
of the port keeps ptnn's flat order, so it is the identity with the shape
and the type checked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ptnn_torch.kernel import ChainState
from ptnn_torch.models.api import ModelSpec

FIELDS = tuple(f.name for f in dataclasses.fields(ChainState))
OPTIONAL = ("log_step_w", "g_like", "pc_mean", "pc_m2", "log_step_eta",
            "log_traj", "chees_m1", "chees_v2", "replica_id")


def chain_state_from_numpy(d: Dict[str, Any], device="cpu") -> ChainState:
    kw = {}
    for name in FIELDS:
        v = d.get(name)
        if v is None:
            if name not in OPTIONAL:
                raise KeyError(f"chain state field {name!r} is missing")
            kw[name] = None
        else:
            kw[name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return ChainState(**kw)


def chain_state_to_numpy(state: ChainState) -> Dict[str, Optional[np.ndarray]]:
    out = {}
    for name in FIELDS:
        v = getattr(state, name)
        out[name] = None if v is None else v.detach().cpu().numpy()
    return out


def model_params_from_numpy(w: Any, spec: ModelSpec,
                            device="cpu") -> torch.Tensor:
    """``ptnn``'s flat weights (C, W) of the model ``spec`` describes (the
    FNN codec, the MLP's ``[W1, b1, ...]``, the CNN's taps as (kh, kw, c_in,
    c_out)) as the port's: the same vector, float32, checked against
    ``spec.w_size``."""
    a = np.asarray(w)
    if a.ndim != 2 or a.shape[1] != spec.w_size:
        raise ValueError(f"weights of shape {a.shape} are not (chains, "
                         f"{spec.w_size}) as {spec.name} takes them")
    if a.dtype != np.float32:
        raise ValueError(f"weights have dtype {a.dtype}, expected float32")
    return torch.from_numpy(np.array(a, copy=True)).to(device)
