"""Chain state to and from NumPy, to start the port from ``ptnn``'s state.

``ptnn``'s ``ChainState`` fetched to the host (``jax.device_get(state)
._asdict()``) is a dict of NumPy arrays, None for the fields a run does not
use. ``chain_state_from_numpy`` takes the fields the port holds (the
accuracy carries, the Langevin counter ``n_langevin`` and, for
classification, a state without ``log_step_eta`` included), with their
dtypes and bits unchanged; ``chain_state_to_numpy`` gives them back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ptnn_torch.kernel import ChainState

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
