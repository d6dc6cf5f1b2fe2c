"""Feedback-optimized temperature ladders from pilot runs (port of
``ptnn/tuning.py``).

Run a short pilot, read the per-pair expected swap acceptance
(``SampleResult.pair_swap_accept``), re-space the rungs at equal increments
of the estimated communication barrier (``ops.ladder.
barrier_tuned_temperatures``, Syed et al. 2021), and repeat; the tuned
ladder feeds back in through ``PTConfig.custom_ladder``.
``suggest_num_chains`` turns the measured barrier into the chain count a
target per-pair rejection needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np

from ptnn_torch import sampler as sampler_mod
from ptnn_torch.config import PTConfig
from ptnn_torch.ops import ladder as ladder_mod


class TuneRound(NamedTuple):
    temperatures: np.ndarray  # (K,) the ladder this round measured
    pair_reject: np.ndarray  # (K-1,) mean expected rejection per pair
    barrier: float  # the total communication barrier, Lambda
    swap_percent: float


class TuneResult(NamedTuple):
    temperatures: np.ndarray  # (K,) the tuned ladder (custom_ladder)
    history: list  # [TuneRound], the pilot first
    barrier: float  # the last round's barrier
    suggested_num_chains: int  # chains for a rejection of 0.5 a pair


def suggest_num_chains(total_barrier: float,
                       target_reject: float = 0.5) -> int:
    """Chains such that each of the C-1 links carries at most
    ``target_reject`` of the barrier (an equalized schedule splits it
    evenly)."""
    if not (0.0 < target_reject < 1.0):
        raise ValueError("target_reject must be in (0, 1)")
    if total_barrier <= 0.0:
        return 2
    return int(np.ceil(total_barrier / target_reject)) + 1


def tune_ladder(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    rounds: int = 2,
    seeds: Sequence[int] = (0,),
    pilot_samples: int | None = None,
    mesh=None,
    model_spec=None,
    device: Any = "cuda",
) -> TuneResult:
    """Equalize the per-pair swap rejection over ``rounds`` pilots on
    ``device``, each averaging the rejection profile over ``seeds``. Pilots
    hold tempering for the whole run (``pt_phase_frac=2.0``: after a temper
    switch every rung samples T = 1 and the profile dilutes) and record no
    traces. Returns the tuned ladder (not re-measured), the history and the
    chain count the last barrier suggests. Replicated ladders pool their
    profiles, and every array is per ladder."""
    if mesh is not None:
        raise NotImplementedError("tune_ladder(mesh=...): the port runs on "
                                  "one device (ROADMAP Queue 1 item 14)")
    if cfg.num_chains < 3:
        raise ValueError("ladder tuning needs at least 3 chains")
    pilot = dataclasses.replace(
        cfg,
        num_samples=(pilot_samples if pilot_samples is not None
                     else cfg.num_samples),
        pt_phase_frac=2.0,
        record_fx=False,
        record_w=False,
        track_replicas=False,
    ).validate()
    temps = None
    history: list[TuneRound] = []
    k = pilot.rungs_per_ladder
    for _ in range(max(1, rounds)):
        cur = pilot if temps is None else dataclasses.replace(
            pilot, custom_ladder=tuple(float(t) for t in temps)).validate()
        rej_acc, swap_acc, temps_used = [], [], None
        for seed in seeds:
            res = sampler_mod.sample(cur, train, test, seed=seed,
                                     device=device, model_spec=model_spec)
            acc = res.pair_swap_accept  # (C-1,)
            if pilot.n_ladders > 1:
                # every replica measures the same (K-1)-pair profile
                acc = np.mean([acc[r * k:r * k + k - 1]
                               for r in range(pilot.n_ladders)], axis=0)
            rej_acc.append(1.0 - acc)
            swap_acc.append(res.swap_percent)
            temps_used = res.temperatures[:k]
        rej = np.mean(rej_acc, axis=0)
        history.append(TuneRound(temperatures=np.asarray(temps_used),
                                 pair_reject=rej, barrier=float(rej.sum()),
                                 swap_percent=float(np.mean(swap_acc))))
        temps = ladder_mod.barrier_tuned_temperatures(temps_used, rej)
    barrier = history[-1].barrier
    return TuneResult(temperatures=np.asarray(temps), history=history,
                      barrier=barrier,
                      suggested_num_chains=suggest_num_chains(barrier))
