"""Replica-exchange swap sweeps on tensors (port of ``ptnn/parallel/swap.py``).

Pair acceptance, kept from the reference with its 0.5 prefactor and the
exp-overflow clamp at 709:

    half_exp    a = min(1, 0.5 * exp(min(709, lh2 - lh1)))
    unclamped   a = min(1, 0.5 * exp(lh2 - lh1))
    metropolis  a = min(1, exp(min(709, (beta_k - beta_k+1)(lh2 - lh1) - pen_k)))

The sweeps take their C-1 uniforms as an argument (``ptnn`` draws them from a
key inside), so the same numbers can be fed to both packages.

The bubbling sweep is sequential in the pairs: pair k compares the payload
that travelled up from pair k-1 with rung k+1's own. The travelling payload
is always the original payload of some rung j, the start of the current
run of accepted pairs, so every decision the sweep could take is one entry
of the (C, C-1) matrix ``A[j, k] = a(ll[j], ll[k+1])``. The runs are then
followed by pointer doubling in ceil(log2(C+1)) rounds. That is a fixed
few dozen tensor operations on the device for any ladder, where a loop over
the pairs would launch ten small kernels per pair. Each decision uses the
same float operations on the same values as the sequential loop, so the
permutation is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

_EXP_CLAMP = 709.0


class SwapResult(NamedTuple):
    perm: torch.Tensor  # (C,) int64: new_state[i] = old_state[perm[i]]
    n_accepted: torch.Tensor  # () int32
    n_proposed: torch.Tensor  # () int32
    pair_accept: torch.Tensor  # (C-1,) expected acceptance of each pair
    pair_active: torch.Tensor  # (C-1,) bool: the pair was proposed


def pair_accept_prob(lh1, lh2, rule: str, beta1=None, beta2=None, penalty=None):
    """Acceptance probability of swapping payloads lh1 (rung k) and lh2
    (rung k+1); broadcasts."""
    if rule == "half_exp":
        return torch.clamp(
            0.5 * torch.exp(torch.clamp(lh2 - lh1, max=_EXP_CLAMP)), max=1.0
        )
    if rule == "unclamped":
        return torch.clamp(0.5 * torch.exp(lh2 - lh1), max=1.0)
    if rule == "metropolis":
        x = (beta1 - beta2) * (lh2 - lh1)
        if penalty is not None:
            x = x - penalty
        return torch.clamp(torch.exp(torch.clamp(x, max=_EXP_CLAMP)), max=1.0)
    raise ValueError(f"unknown swap rule {rule!r}")


def _check(rule, betas, pair_penalty):
    if rule == "metropolis" and betas is None:
        raise ValueError("metropolis swap rule requires betas")
    if pair_penalty is not None and rule != "metropolis":
        raise ValueError("pair_penalty applies to the metropolis rule only")


def _mask(pair_mask, c, device) -> torch.Tensor:
    if pair_mask is None:
        return torch.ones((c - 1,), dtype=torch.bool, device=device)
    return torch.as_tensor(pair_mask, dtype=torch.bool, device=device)


def sweep_permutation(
    payload_ll: torch.Tensor,
    us: torch.Tensor,
    rule: str = "half_exp",
    betas: Optional[torch.Tensor] = None,
    pair_penalty: Optional[torch.Tensor] = None,
    pair_mask: Optional[torch.Tensor] = None,
) -> SwapResult:
    """One sequential bubbling sweep over the adjacent pairs (0,1), (1,2), ...

    ``payload_ll`` (C,) payloads, ``us`` (C-1,) uniforms, ``betas`` (C,)
    1/T by rung (metropolis), ``pair_penalty`` (C-1,) (metropolis),
    ``pair_mask`` (C-1,) bool: masked pairs are never proposed.
    """
    _check(rule, betas, pair_penalty)
    c = payload_ll.shape[0]
    dev = payload_ll.device
    mask = _mask(pair_mask, c, dev)
    if c < 2:
        empty = torch.zeros((0,), dtype=payload_ll.dtype, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return SwapResult(
            torch.zeros((c,), dtype=torch.int64, device=dev), zero, zero,
            empty, mask,
        )
    ll = payload_ll
    # A[j, k]: acceptance of pair k when rung j's payload is travelling
    lh1 = ll[:, None]
    lh2 = ll[None, 1:]
    if rule == "metropolis":
        pen = None if pair_penalty is None else pair_penalty[None, :]
        acc = pair_accept_prob(lh1, lh2, rule, betas[None, :-1],
                               betas[None, 1:], pen)
    else:
        acc = pair_accept_prob(lh1, lh2, rule)
    k_idx = torch.arange(c - 1, device=dev)
    j_idx = torch.arange(c, device=dev)
    reachable = k_idx[None, :] >= j_idx[:, None]
    ok = (us[None, :] < acc) & mask[None, :] & reachable
    # end[j]: first pair k >= j that rejects rung j's payload (C-1 if none);
    # the payload of rung j then settles at rung end[j]
    stop = torch.cat(
        [~ok & reachable, torch.ones((c, 1), dtype=torch.bool, device=dev)],
        dim=1,
    )
    end = torch.argmax(stop.to(torch.int8), dim=1)
    # runs start at 0, end[0]+1, end[end[0]+1]+1, ...: mark them by doubling
    jump = torch.cat([end + 1, torch.full((1,), c, device=dev)])
    on = torch.zeros((c + 1,), dtype=torch.int32, device=dev)
    on[0] = 1
    for _ in range(math.ceil(math.log2(c + 1))):
        on = on | torch.zeros_like(on).scatter_add_(0, jump, on).clamp_(max=1)
        jump = jump[jump]
    starts = torch.where(on[:c] > 0, j_idx, torch.full_like(j_idx, -1))
    run = torch.cummax(starts, dim=0).values  # run start of each position
    run_end = end[run]
    perm = torch.where(j_idx == run_end, run, j_idx + 1)
    swaps = k_idx < run_end[:-1]
    pair_accept = torch.where(
        mask, acc[run[:-1], k_idx], torch.zeros((), dtype=acc.dtype, device=dev)
    )
    return SwapResult(
        perm=perm,
        n_accepted=swaps.sum(dtype=torch.int32),
        n_proposed=mask.sum(dtype=torch.int32),
        pair_accept=pair_accept,
        pair_active=mask,
    )


def disjoint_pair_permutation(
    payload_ll: torch.Tensor,
    us: torch.Tensor,
    rule: str = "metropolis",
    betas: Optional[torch.Tensor] = None,
    parity: int = 0,
    pair_penalty: Optional[torch.Tensor] = None,
    pair_mask: Optional[torch.Tensor] = None,
) -> SwapResult:
    """One even/odd sweep: the pairs (k, k+1) with ``k % 2 == parity`` are
    proposed together, so every rung moves at most one place."""
    _check(rule, betas, pair_penalty)
    c = payload_ll.shape[0]
    dev = payload_ll.device
    if betas is None:
        betas = torch.ones((c,), dtype=payload_ll.dtype, device=dev)
    a = pair_accept_prob(
        payload_ll[:-1], payload_ll[1:], rule, betas[:-1], betas[1:],
        pair_penalty,
    )
    k_idx = torch.arange(c - 1, device=dev)
    active = (k_idx % 2) == (int(parity) % 2)
    if pair_mask is not None:
        active = active & _mask(pair_mask, c, dev)
    swap = (us < a) & active
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    up = torch.cat([swap, no])
    down = torch.cat([no, swap])
    perm = (
        torch.arange(c, device=dev) + up.to(torch.int64) - down.to(torch.int64)
    )
    return SwapResult(
        perm=perm,
        n_accepted=swap.sum(dtype=torch.int32),
        n_proposed=active.sum(dtype=torch.int32),
        pair_accept=torch.where(active, a, torch.zeros((), dtype=a.dtype,
                                                       device=dev)),
        pair_active=active,
    )


def apply_permutation(
    perm: torch.Tensor, *arrays: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Gather chain-axis arrays through the sweep permutation."""
    return tuple(torch.index_select(a, 0, perm) for a in arrays)


def pair_mask(num_chains: int, rungs_per_ladder: int, device=None):
    """(C-1,) bool: pairs that cross a ladder boundary are never proposed
    (replicated ladders, ``PTConfig.n_ladders``); None for one ladder."""
    if rungs_per_ladder >= num_chains:
        return None
    k = torch.arange(1, num_chains, device=device)
    return k % rungs_per_ladder != 0
