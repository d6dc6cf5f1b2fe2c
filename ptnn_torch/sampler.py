"""Sampling entry points (port of ``ptnn/sampler.py``).

Only the fused-block sampler is ported: ``sample`` and ``throughput_runner``
dispatch to ``ptnn_torch.fused`` when ``cfg.fused_step`` is set and raise
otherwise. Every entry point takes an explicit ``device``; on "cuda" the
block kernels run on the card, on "cpu" their plain versions run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ptnn_torch.config import PTConfig
from ptnn_torch.kernel import ChainState, Dataset


@dataclass
class SampleResult:
    """Host-side result of a PT run (the fields of ``ptnn.SampleResult``).

    Trace arrays have shape (samples_per_chain, num_chains, ...) with row 0
    the reference's init row (w ones, ll -100, replica ids in order);
    "acc_train" / "acc_test" are the accuracy traces (zeros for
    regression).
    """

    traces: Dict[str, np.ndarray]
    final_state: ChainState  # tensors on the CPU
    temperatures: np.ndarray
    accept_ratio_per_chain: np.ndarray  # percent, per chain
    swap_percent: float
    langevin_ratio_per_chain: np.ndarray
    elapsed_s: float
    chain_steps_per_sec: float
    config: PTConfig = field(repr=False, default=None)
    da_segments: int = 0
    da_accept_per_chain: Optional[np.ndarray] = None
    pair_swap_accept: Optional[np.ndarray] = None
    vr_regen_accept_pct: Optional[float] = None
    vr_regen_proposed: int = 0


def make_dataset(cfg: PTConfig, train, test, device) -> Dataset:
    """Split raw ``[features..., label]`` rows into float32 tensors (the
    class index of a classification row stays a float32, as ptnn keeps
    it)."""
    i = cfg.topology[0]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=device)

    return Dataset(x_train=t(train[:, :i]), y_train=t(train[:, i]),
                   x_test=t(test[:, :i]), y_test=t(test[:, i]))


def _not_ported(cfg: PTConfig) -> None:
    if not cfg.fused_step:
        raise NotImplementedError(
            "ptnn_torch runs the fused-block sampler only; the per-step "
            "sampler is not yet ported (set fused_step=True)"
        )


def sample(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
    init_state: Optional[ChainState] = None,
    noise_fn=None,
) -> SampleResult:
    """Run the PT sampler and return its traces and counters."""
    cfg.validate()
    _not_ported(cfg)
    from ptnn_torch import fused

    return fused.sample_fused(cfg, train, test, seed=seed, device=device,
                              init_state=init_state, noise_fn=noise_fn)


def throughput_runner(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
):
    """Build a benchmark run, run it once as warm-up, and return a zero-arg
    callable that executes one timed rep."""
    cfg = cfg.validate()
    _not_ported(cfg)
    from ptnn_torch import fused

    return fused.throughput_build_fused(cfg, train, test, seed=seed,
                                        device=device)
