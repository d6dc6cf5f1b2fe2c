"""Chain state to and from NumPy, to start the port from ``ptnn``'s state.

``ptnn``'s ``ChainState`` fetched to the host (``jax.device_get(state)
._asdict()``) is a dict of NumPy arrays, None for the fields a run does not
use. ``chain_state_from_numpy`` takes the fields the port holds (the
accuracy carries, the Langevin counter ``n_langevin`` and, for
classification, a state without ``log_step_eta`` included), with their
dtypes and bits unchanged; ``chain_state_to_numpy`` gives them back.
The surrogate's state (``surr``: ``SurrogateState``) and the
delayed-acceptance segment (``da``: ``DAState``) are nested: each is a dict
of arrays (or ptnn's NamedTuple, whose fields are the same), and
``surrogate_proj_from_numpy`` takes ptnn's projection, so that the tests can
start both packages from one state.
``model_params_from_numpy`` takes ``ptnn``'s flat model weights: every model
of the port keeps ptnn's flat order, so it is the identity with the shape
and the type checked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ptnn_torch.kernel import ChainState, DAState
from ptnn_torch.models.api import ModelSpec
from ptnn_torch.surrogate import SurrogateState

FIELDS = tuple(f.name for f in dataclasses.fields(ChainState))
OPTIONAL = ("log_step_w", "g_like", "pc_mean", "pc_m2", "log_step_eta",
            "log_traj", "chees_m1", "chees_v2", "replica_id", "fx_train",
            "fx_test", "vr_mean", "vr_m2", "vr_chol", "n_regen_accepted",
            "n_regen_proposed", "surr", "da", "sg_anchor_w",
            "sg_anchor_eta", "sg_anchor_full")
NESTED = {"surr": SurrogateState, "da": DAState}


def _tensor(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(v, copy=True)).to(device)


def _nested(name: str, v: Any, device):
    """A ``SurrogateState`` / ``DAState`` from a dict of arrays or ptnn's
    NamedTuple of the same fields."""
    d = v._asdict() if hasattr(v, "_asdict") else v
    cls = NESTED[name]
    return cls(**{f.name: _tensor(d[f.name], device)
                  for f in dataclasses.fields(cls)})


def chain_state_from_numpy(d: Dict[str, Any], device="cpu") -> ChainState:
    kw = {}
    for name in FIELDS:
        v = d.get(name)
        if v is None:
            if name not in OPTIONAL:
                raise KeyError(f"chain state field {name!r} is missing")
            kw[name] = None
        elif name in NESTED:
            kw[name] = _nested(name, v, device)
        else:
            kw[name] = _tensor(v, device)
    return ChainState(**kw)


def chain_state_to_numpy(state: ChainState) -> Dict[str, Any]:
    """Every field as an array (``surr`` and ``da`` as dicts of arrays),
    None where the run does not use it."""
    out = {}
    for name in FIELDS:
        v = getattr(state, name)
        if v is None:
            out[name] = None
        elif name in NESTED:
            out[name] = {k: t.detach().cpu().numpy()
                         for k, t in vars(v).items()}
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def surrogate_proj_from_numpy(proj: Any, device="cpu") -> torch.Tensor:
    """ptnn's fixed projection (n_proj, W + 1) as the port's tensor, float32
    checked (``kernel.make_step_fn(surrogate_proj=)``)."""
    a = np.asarray(proj)
    if a.ndim != 2 or a.dtype != np.float32:
        raise ValueError(f"projection of shape {a.shape} and dtype "
                         f"{a.dtype}, expected a float32 matrix")
    return _tensor(a, device)


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
