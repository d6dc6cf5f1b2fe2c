"""The chain-batched FNN evaluation: forward, log-likelihood and metrics.

Port of ``ptnn/ops/pallas_eval.py`` (``fnn_eval_pallas``), the evaluation
the per-step sampler runs on every proposal, on the train and on the test
rows, every step. ``fnn_eval(w, x, y, tau, topo, task) -> (ll, rmse, acc)``,
each (C,), untempered:

* regression: ``ll = -n/2 (log 2 pi + log tau) - SSE / (2 tau)`` of the
  first output, ``rmse = sqrt(SSE / n)``, acc 0;
* classification: the multinomial ``ll = sum_n log softmax(out_n)[y_n]``
  over the SIGMOID outputs, the first-argmax prediction (a later class wins
  only if strictly larger), ``rmse`` of the predicted class index and
  ``acc`` in percent.

``fnn_eval_pair`` evaluates the same weights on two row sets (train and
test) in one launch. The metrics multiply by ``block_step.inv_rows``, the
float32 constants XLA folds ptnn's means into, so the accuracy traces match
ptnn's bit for bit. CUDA tensors launch the hand-written kernel
``csrc/fnn_eval.cu`` (one thread-block cluster per chain and row set, laid
out by ``launch_plan``); CPU tensors run ``fnn_eval_reference``. A CUDA
tensor never takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ptnn_torch.models import fnn
from ptnn_torch.models.fnn import Topology
from ptnn_torch.ops import block_step, likelihood
from ptnn_torch.ops.block_step import _SMEM_LIMIT, _check

launches = 0  # launches of csrc/fnn_eval.cu (the plain version counts none)

_MAX_OUT = 32  # MAX_OUT of csrc/fnn_eval.cu: the most outputs it takes
_MAX_CLUSTER = 8  # MAX_CLUSTER: blocks of a (chain, set) cluster
_MAX_WARPS = 16  # MAX_WARPS: warps a block
_TILE = 32  # TILE: rows of a row group a pass, one a lane

Eval = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fnn_eval_reference(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       tau: Optional[torch.Tensor], topo: Topology,
                       task: str) -> Eval:
    """The plain PyTorch version of ``fnn_eval``, on any device."""
    n = x.shape[0]
    if task == "classification":
        return block_step.cls_eval(w, x, y.to(torch.int64), topo)
    fx = fnn.batched_forward(w, x, topo)[:, :, 0]
    ll = likelihood.regression_eval_from_fx(fx, y, tau).loglik
    rmse = torch.sqrt(torch.sum(torch.square(fx - y), dim=-1)
                      * block_step.inv_rows(n))
    return ll, rmse, torch.zeros_like(ll)


def fnn_eval_pair_reference(w: torch.Tensor, x_tr: torch.Tensor,
                            y_tr: torch.Tensor, x_te: torch.Tensor,
                            y_te: torch.Tensor, tau: Optional[torch.Tensor],
                            topo: Topology, task: str) -> Tuple[Eval, Eval]:
    """The plain PyTorch version of ``fnn_eval_pair``: two
    ``fnn_eval_reference`` calls."""
    return (fnn_eval_reference(w, x_tr, y_tr, tau, topo, task),
            fnn_eval_reference(w, x_te, y_te, tau, topo, task))


@functools.lru_cache(maxsize=None)
def layouts() -> dict:
    """{(I, H, O): HPW} of the compile-time instantiations (the table
    FNN_LAYOUTS of csrc/fnn_layouts.cuh, read from the source)."""
    from ptnn_torch.ops import _build

    return {row[:3]: row[4]
            for row in _build.cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS")}


def smem_floats(topo: Topology, row_groups: int, hid_groups: int) -> int:
    """Dynamic shared memory of one block in floats (``eval_smem_floats``
    of csrc/fnn_eval.cu): the chain's weights rounded up to 4, the staged
    rows and their targets, two parities of the warps' output shares, the
    row groups' sums and the block's."""
    n_in, _n_hid, n_out = topo
    w = fnn.w_size(topo)
    rows = _TILE * row_groups
    return ((w + 3) // 4 * 4 + n_in * (rows + 1) + rows
            + 2 * row_groups * hid_groups * n_out * _TILE + 4 * row_groups + 4)


class EvalPlan(NamedTuple):
    """One launch of the eval kernel: ``cluster`` blocks a (chain, set),
    ``tile_rows`` the rows a block takes in each set, ``row_groups`` x
    ``hid_groups`` warps a block (a pass takes 32 rows a row group; the
    warps of a row group split the hidden units, ``hid_per_warp`` at a
    time), ``blocks`` in the grid and ``smem`` bytes a block."""
    cluster: int
    tile_rows: Tuple[int, ...]
    row_groups: int
    hid_groups: int
    hid_per_warp: int
    blocks: int
    smem: int


def launch_plan(chains: int, n_rows: Sequence[int], topo: Topology) -> EvalPlan:
    """The kernel's launch for ``chains`` chains on row sets of ``n_rows``
    rows (one count per set, one or two sets). Pure Python.

    A (chain, set) takes one cluster of T blocks, one for each 32 rows of
    the largest set, at most 8; block ``rank`` takes rows ``[rank R, (rank
    + 1) R)`` of each set, R = ceil(n / T) for that set. A row group has HG
    = ceil(H / HPW) warps (HPW from FNN_LAYOUTS, else GEN_HPW, at most
    MAX_WARPS warps); a block has as many row groups as make one pass of its
    largest tile, within MAX_WARPS warps."""
    n_rows = tuple(int(n) for n in n_rows)
    if not 1 <= len(n_rows) <= 2 or min(n_rows) < 1 or chains < 1:
        raise ValueError(f"{chains} chains on row sets {n_rows}: needs one or "
                         f"two non-empty sets and at least one chain")
    topo = tuple(int(d) for d in topo)
    cluster = min(_MAX_CLUSTER, -(-max(n_rows) // _TILE))
    tiles = tuple(-(-n // cluster) for n in n_rows)
    hpw = layouts().get(topo)
    if hpw is None:  # the generic instantiation
        from ptnn_torch.ops import _build

        hpw = _build.cu_define("fnn_eval.cu", "GEN_HPW")
    hid_groups = min(_MAX_WARPS, -(-topo[1] // hpw))
    row_groups = max(1, min(-(-max(tiles) // _TILE),
                            _MAX_WARPS // hid_groups))
    return EvalPlan(cluster, tiles, row_groups, hid_groups, hpw,
                    chains * len(n_rows) * cluster,
                    4 * smem_floats(topo, row_groups, hid_groups))


_plan = functools.lru_cache(maxsize=64)(launch_plan)


class _EvalSet(ctypes.Structure):
    """Mirror of ``struct EvalSet`` in csrc/fnn_eval.cu (same field
    order)."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in ("x", "y", "ll", "rmse", "acc")
    ] + [
        (name, ctypes.c_int) for name in ("n_rows", "tile_rows")
    ] + [
        (name, ctypes.c_float) for name in ("ll_const", "inv_n", "acc_n")
    ]


class _EvalParams(ctypes.Structure):
    """Mirror of ``struct EvalParams`` in csrc/fnn_eval.cu (same field
    order)."""

    _fields_ = [
        ("w", ctypes.c_void_p), ("tau", ctypes.c_void_p),
        ("set", _EvalSet * 2),
    ] + [
        (name, ctypes.c_int)
        for name in ("chains", "n_sets", "n_in", "n_hid", "n_out", "task_cls",
                     "cluster", "row_groups", "hid_groups")
    ] + [("log_2pi", ctypes.c_float)]


def _launch_cuda(w, sets, tau, topo, task) -> Tuple[Eval, ...]:
    """One launch over the row sets ``sets`` = ((x, y), ...)."""
    global launches
    from ptnn_torch.ops import _build

    n_in, n_hid, n_out = topo
    c = w.shape[0]
    dev = w.device
    cls = task == "classification"
    if n_out > _MAX_OUT:
        raise ValueError(f"the eval kernel takes at most {_MAX_OUT} outputs, "
                         f"not {n_out}")
    if c < 1 or min(x.shape[0] for x, _y in sets) < 1:
        raise ValueError(f"chains {c} and rows "
                         f"{[x.shape[0] for x, _y in sets]} must be positive")
    _check(w, "w", (c, fnn.w_size(topo)), torch.float32, dev)
    for x, y in sets:
        n = x.shape[0]
        _check(x, "x", (n, n_in), torch.float32, dev)
        _check(y, "y", (n,), torch.float32, dev)
    if not cls:
        _check(tau, "tau", (c,), torch.float32, dev)
    plan = _plan(c, tuple(x.shape[0] for x, _y in sets), tuple(topo))
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"topology {tuple(topo)} needs {plan.smem} bytes of "
                         f"shared memory per block; a Hopper block has "
                         f"{_SMEM_LIMIT}")
    lib = _build.build("fnn_eval").lib
    outs, c_sets = [], (_EvalSet * 2)()
    for k, ((x, y), tile) in enumerate(zip(sets, plan.tile_rows)):
        n = x.shape[0]
        ll, rmse, acc = (torch.empty((c,), dtype=torch.float32, device=dev)
                         for _ in range(3))
        outs.append((ll, rmse, acc))
        c_sets[k] = _EvalSet(
            x=x.data_ptr(), y=y.data_ptr(), ll=ll.data_ptr(),
            rmse=rmse.data_ptr(), acc=acc.data_ptr(), n_rows=n,
            tile_rows=tile, ll_const=-0.5 * n,
            inv_n=block_step.inv_rows(n),
            acc_n=block_step.inv_rows(n, 100.0))
    params = _EvalParams(
        w=w.data_ptr(), tau=None if cls else tau.data_ptr(), set=c_sets,
        chains=c, n_sets=len(sets), n_in=n_in, n_hid=n_hid, n_out=n_out,
        task_cls=int(cls), cluster=plan.cluster, row_groups=plan.row_groups,
        hid_groups=plan.hid_groups, log_2pi=likelihood._LOG_2PI)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ptnn_fnn_eval(ctypes.byref(params), plan.smem,
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"fnn_eval launch failed: {_build.error_string(lib, err)}")
    launches += 1
    return tuple(outs)


def _device_kind(task: str, tensors) -> str:
    if task not in ("regression", "classification"):
        raise ValueError(f"unknown task {task!r}")
    kinds = {a.device.type for a in tensors}
    if kinds in ({"cpu"}, {"cuda"}):
        return kinds.pop()
    raise ValueError(f"fnn_eval needs all tensors on one device type, got "
                     f"{sorted(kinds)}")


def fnn_eval(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             tau: Optional[torch.Tensor], topo: Topology, task: str) -> Eval:
    """Every chain's (ll, rmse, acc) on the rows (x, y): w (C, W), x (N, I),
    y (N,) float32 (class indices as floats), tau (C,) the noise variance
    (regression; None or ignored for classification). CUDA tensors launch
    the kernel, CPU tensors run the plain version."""
    tensors = [w, x, y] + ([tau] if task == "regression" else [])
    if _device_kind(task, tensors) == "cpu":
        return fnn_eval_reference(w, x, y, tau, topo, task)
    return _launch_cuda(w, ((x, y),), tau, topo, task)[0]


def fnn_eval_pair(w: torch.Tensor, x_tr: torch.Tensor, y_tr: torch.Tensor,
                  x_te: torch.Tensor, y_te: torch.Tensor,
                  tau: Optional[torch.Tensor], topo: Topology,
                  task: str) -> Tuple[Eval, Eval]:
    """``fnn_eval`` on the train rows and on the test rows of the same
    weights: ((ll, rmse, acc) of the train rows, the same of the test
    rows). CUDA tensors launch the kernel once for both sets, CPU tensors
    run the plain version twice."""
    tensors = [w, x_tr, y_tr, x_te, y_te] + (
        [tau] if task == "regression" else [])
    if _device_kind(task, tensors) == "cpu":
        return fnn_eval_pair_reference(w, x_tr, y_tr, x_te, y_te, tau, topo,
                                       task)
    tr, te = _launch_cuda(w, ((x_tr, y_tr), (x_te, y_te)), tau, topo, task)
    return tr, te
