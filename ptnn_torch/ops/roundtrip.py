"""Replica round-trip and ladder-flow diagnostics.

The port's own copy of ``ptnn/ops/roundtrip.py``, whole and with the same names.

The reference's only replica-exchange health metric is the scalar swap
acceptance percentage (`swap_perc`, pt_classification.py:773-776).  That
number cannot distinguish productive temperature transport (configurations
completing cold -> hot -> cold round trips, which is what decorrelates the
cold chain) from adjacent rungs ping-ponging the same pair of states back
and forth.  The standard diagnostics for the real thing — round-trip rate
and the up/down flow fraction f(k) of Katzgraber et al. (J. Stat. Mech.
2006, P03018), also the objective that DEO / non-reversible PT schemes
(Syed et al. 2021) optimize — need replica *identity* labels, which the
reference never tracks.

ptnn records them natively: ``PTConfig.track_replicas=True`` threads an
int32 label per rung through every swap permutation (kernel.py:do_swap)
and emits it as ``traces["replica"]`` with shape ``(samples, chains)``,
where ``replica[t, k]`` is the identity of the configuration sitting at
rung ``k`` (rung 0 = coldest) after step ``t``.  This module turns that
trace into the diagnostics.  Pure NumPy on host traces — this is analysis,
not the hot path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RoundTripStats(NamedTuple):
    round_trips: np.ndarray  # (C,) completed cold->hot->cold trips per replica
    rate_per_kstep: float  # total round trips per 1000 steps (whole ladder)
    flow_up: np.ndarray  # (C,) f(k): fraction of labeled visitors at rung k
    #                      that are moving up (last extreme visited = cold)
    flow_samples: np.ndarray  # (C,) number of labeled visits behind each f(k)
    visits_cold: np.ndarray  # (C,) visits each replica made to rung 0
    visits_hot: np.ndarray  # (C,) visits each replica made to rung C-1


def _positions(replica: np.ndarray) -> np.ndarray:
    """Invert the per-step rung->replica permutation.

    ``replica[t, k] = r``  (rung k holds replica r)  becomes
    ``pos[t, r] = k``      (replica r sits at rung k).
    """
    steps, c = replica.shape
    pos = np.empty_like(replica)
    rows = np.arange(steps)[:, None]
    pos[rows, replica] = np.arange(c, dtype=replica.dtype)[None, :]
    return pos


def roundtrip_stats(replica: np.ndarray, n_ladders: int = 1) -> RoundTripStats:
    """Compute round-trip counts and the Katzgraber flow fraction.

    Parameters
    ----------
    replica : (steps, C) int array — ``traces["replica"]`` from a run with
        ``track_replicas=True`` (rung-major, as recorded).
    n_ladders : with replicated tempering ensembles (``PTConfig.n_ladders``)
        the C chains are R independent K-rung ladders; swaps never cross a
        boundary, so each ladder block is analyzed on its own (cold = its
        rung 0, hot = its rung K-1) and the per-rung/per-replica arrays are
        concatenated back in chain order. ``rate_per_kstep`` totals trips
        across all ladders.

    Notes
    -----
    A replica's *label* is +1 ("up") from the moment it touches rung 0
    until it touches rung C-1, then -1 ("down") until it returns to rung 0;
    unlabeled history (before the first extreme visit) is excluded from
    f(k).  One round trip = one completed up half-trip followed by a
    completed down half-trip.  For a well-tuned ladder f(k) falls roughly
    linearly from 1 at the cold end to 0 at the hot end; a plateau marks
    the bottleneck rung pair.
    """
    replica = np.asarray(replica)
    if replica.ndim != 2:
        raise ValueError(f"replica trace must be (steps, C), got {replica.shape}")
    steps, c = replica.shape
    if n_ladders > 1:
        if c % n_ladders:
            raise ValueError(f"n_ladders={n_ladders} must divide C={c}")
        k = c // n_ladders
        parts = [
            roundtrip_stats(replica[:, b * k : (b + 1) * k] - b * k)
            for b in range(n_ladders)
        ]
        return RoundTripStats(
            round_trips=np.concatenate([p.round_trips for p in parts]),
            rate_per_kstep=float(
                sum(p.round_trips.sum() for p in parts)
            ) * 1000.0 / max(steps, 1),
            flow_up=np.concatenate([p.flow_up for p in parts]),
            flow_samples=np.concatenate([p.flow_samples for p in parts]),
            visits_cold=np.concatenate([p.visits_cold for p in parts]),
            visits_hot=np.concatenate([p.visits_hot for p in parts]),
        )
    pos = _positions(replica)  # (steps, C) rung of each replica over time

    # Label evolution, vectorized over replicas: +1 after touching cold,
    # -1 after touching hot, carried forward in between (0 = not yet labeled).
    at_cold = pos == 0
    at_hot = pos == (c - 1)
    raw = np.where(at_cold, 1, np.where(at_hot, -1, 0)).astype(np.int8)
    # forward-fill nonzeros down the time axis
    idx = np.where(raw != 0, np.arange(steps)[:, None], -1)
    np.maximum.accumulate(idx, axis=0, out=idx)
    cols = np.arange(c)[None, :]
    label = np.where(idx >= 0, raw[np.clip(idx, 0, None), cols], 0)

    # Half-trips: a labeled replica flipping sign completed one traversal.
    flips = (label[1:] * label[:-1]) < 0  # (steps-1, C)
    # The up->down flip happens at the hot touch, down->up at the cold touch.
    up_flips = np.logical_and(flips, label[1:] == 1).sum(axis=0)
    # A round trip (cold->hot->cold) is one down flip closed by a later up
    # flip.  Flips alternate per replica, so: first extreme cold (label +1,
    # flips d,u,d,u,...) -> every up flip closes a trip.  First extreme hot
    # (label -1, flips u,d,u,d,...) -> the first up flip only starts the
    # first trip; trips = up_flips - 1.
    first_label = label[(label != 0).argmax(axis=0), np.arange(c)]
    trips = np.where(
        first_label == 1, up_flips, np.maximum(up_flips - 1, 0)
    ).astype(np.int64)
    ever = (label != 0).any(axis=0)
    trips = np.where(ever, trips, 0)

    # Flow fraction per rung over labeled visits.
    lab_rung = np.take_along_axis(label, replica, axis=1)  # label at (t, rung k)
    up_visits = (lab_rung == 1).sum(axis=0).astype(np.float64)
    labeled = (lab_rung != 0).sum(axis=0).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        flow = np.where(labeled > 0, up_visits / np.maximum(labeled, 1), np.nan)

    return RoundTripStats(
        round_trips=trips,
        rate_per_kstep=float(trips.sum()) * 1000.0 / max(steps, 1),
        flow_up=flow,
        flow_samples=labeled,
        visits_cold=at_cold.sum(axis=0),
        visits_hot=at_hot.sum(axis=0),
    )


def format_report(stats: RoundTripStats, temps: np.ndarray | None = None) -> str:
    """Markdown summary of a RoundTripStats, one row per rung."""
    c = stats.flow_up.shape[0]
    lines = [
        f"total round trips: {int(stats.round_trips.sum())} "
        f"({stats.rate_per_kstep:.2f} per 1k steps); "
        f"per-replica median {int(np.median(stats.round_trips))}",
        "",
        "| rung | T | f(k) up-flow | labeled visits |",
        "|---|---|---|---|",
    ]
    for k in range(c):
        t = f"{float(temps[k]):.3f}" if temps is not None else "-"
        f_k = stats.flow_up[k]
        f_s = "nan" if np.isnan(f_k) else f"{f_k:.3f}"
        lines.append(f"| {k} | {t} | {f_s} | {int(stats.flow_samples[k])} |")
    return "\n".join(lines)
