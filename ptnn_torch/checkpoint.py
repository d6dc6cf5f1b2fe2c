"""Checkpoint/resume for long PT runs (port of ``ptnn/checkpoint.py``).

Every chunk boundary of the per-step sampler is a resume point: the chain
state, the step counter, the traces gathered so far and a fingerprint of the
config, seed and model round-trip through one compressed ``.npz`` written
atomically (tmp + rename); the surrogate's ring buffers, fit and pointer
and the delayed-acceptance segment's state ride as ``state__surr__<field>``
and ``state__da__<field>``, so a run stopped in the middle of a segment
resumes in it. The per-step noise depends on a step's absolute index alone
(``sampler.step_noise``; a boundary's closure draw on the boundary,
``sampler.close_noise``), so a resumed run is bit-identical to one that was
never interrupted.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ptnn_torch import convert
from ptnn_torch.config import PTConfig
from ptnn_torch.kernel import ChainState


def config_fingerprint(cfg: PTConfig, seed: int, spec_name: str = "") -> str:
    """ptnn's fingerprint: the same config, seed and model name give the
    same 16 hex digits in both packages."""
    blob = json.dumps(
        {**dataclasses.asdict(cfg), "seed": seed, "model_spec": spec_name},
        sort_keys=True,
        default=str,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save(
    path: str,
    state: ChainState,
    done_steps: int,
    traces: Dict[str, np.ndarray],
    cfg: PTConfig,
    seed: int,
    spec_name: str = "",
) -> None:
    """Atomic checkpoint write (tmp + rename): the state's tensors as
    ``state__<field>``, the traces as ``trace__<name>``, ``done_steps`` and
    the fingerprint."""
    payload = {}
    for k, v in convert.chain_state_to_numpy(state).items():
        if isinstance(v, dict):  # the surrogate's ring and fit, the DA state
            payload |= {f"state__{k}__{f}": a for f, a in v.items()}
        elif v is not None:
            payload[f"state__{k}"] = v
    payload |= {f"trace__{k}": v for k, v in traces.items()}
    payload["done_steps"] = np.asarray(done_steps)
    payload["fingerprint"] = np.asarray(
        config_fingerprint(cfg, seed, spec_name))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def load(
    path: str, cfg: PTConfig, seed: int, spec_name: str = "", device="cpu"
) -> Optional[Tuple[ChainState, int, Dict[str, np.ndarray]]]:
    """The checkpoint's (state on ``device``, done steps, traces); None when
    the file is absent or was written for another config, seed or model
    (resuming someone else's run would corrupt the statistics silently)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["fingerprint"]) != config_fingerprint(cfg, seed, spec_name):
            return None
        fields = {}
        for name in convert.FIELDS:
            key = f"state__{name}"
            nested = {k[len(key) + 2:]: z[k] for k in z.files
                      if k.startswith(key + "__")}
            fields[name] = (z[key] if key in z.files
                            else nested if nested else None)
        state = convert.chain_state_from_numpy(fields, device)
        traces = {k[len("trace__"):]: z[k] for k in z.files
                  if k.startswith("trace__")}
        return state, int(z["done_steps"]), traces
