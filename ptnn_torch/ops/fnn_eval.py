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

The metrics multiply by ``block_step.inv_rows``, the float32 constants XLA
folds ptnn's means into, so the accuracy traces match ptnn's bit for bit.
CUDA tensors launch the hand-written kernel ``csrc/fnn_eval.cu``; CPU tensors
run ``fnn_eval_reference``. A CUDA tensor never takes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ptnn_torch.models import fnn
from ptnn_torch.models.fnn import Topology
from ptnn_torch.ops import block_step, likelihood
from ptnn_torch.ops.block_step import _SMEM_LIMIT, _check

launches = 0  # launches of csrc/fnn_eval.cu (the plain version counts none)

_THREADS = 128  # must equal THREADS in csrc/fnn_eval.cu
_MAX_OUT = 32  # the largest output count the kernel instantiates

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


class _EvalParams(ctypes.Structure):
    """Mirror of ``struct EvalParams`` in csrc/fnn_eval.cu (same field
    order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("w", "x", "y", "tau", "ll", "rmse", "acc")
    ] + [
        (name, ctypes.c_int)
        for name in ("chains", "n_rows", "n_in", "n_hid", "n_out", "task_cls")
    ] + [
        (name, ctypes.c_float)
        for name in ("ll_const", "log_2pi", "inv_n", "acc_n")
    ]


def smem_bytes(topo: Topology) -> int:
    """Dynamic shared memory of one block: the chain's weights and a
    transposed tile of 128 rows with their targets."""
    return 4 * (fnn.w_size(topo) + (topo[0] + 1) * _THREADS)


def _launch_cuda(w, x, y, tau, topo, task) -> Eval:
    global launches
    from ptnn_torch.ops import _build

    n_in, n_hid, n_out = topo
    c, n = w.shape[0], x.shape[0]
    dev = w.device
    cls = task == "classification"
    if n_out > _MAX_OUT:
        raise ValueError(f"the eval kernel takes at most {_MAX_OUT} outputs, "
                         f"not {n_out}")
    if c < 1 or n < 1:
        raise ValueError(f"chains {c} and rows {n} must be positive")
    _check(w, "w", (c, fnn.w_size(topo)), torch.float32, dev)
    _check(x, "x", (n, n_in), torch.float32, dev)
    _check(y, "y", (n,), torch.float32, dev)
    if not cls:
        _check(tau, "tau", (c,), torch.float32, dev)
    smem = smem_bytes(topo)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"topology {tuple(topo)} needs {smem} bytes of shared "
                         f"memory per block; a Hopper block has {_SMEM_LIMIT}")
    lib = _build.build("fnn_eval").lib
    ll, rmse, acc = (torch.empty((c,), dtype=torch.float32, device=dev)
                     for _ in range(3))
    params = _EvalParams(
        w=w.data_ptr(), x=x.data_ptr(), y=y.data_ptr(),
        tau=None if cls else tau.data_ptr(), ll=ll.data_ptr(),
        rmse=rmse.data_ptr(), acc=acc.data_ptr(), chains=c, n_rows=n,
        n_in=n_in, n_hid=n_hid, n_out=n_out, task_cls=int(cls),
        ll_const=-0.5 * n, log_2pi=likelihood._LOG_2PI,
        inv_n=block_step.inv_rows(n), acc_n=block_step.inv_rows(n, 100.0),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ptnn_fnn_eval(ctypes.byref(params), smem,
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"fnn_eval launch failed: {_build.error_string(lib, err)}")
    launches += 1
    return ll, rmse, acc


def fnn_eval(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             tau: Optional[torch.Tensor], topo: Topology, task: str) -> Eval:
    """Every chain's (ll, rmse, acc) on the rows (x, y): w (C, W), x (N, I),
    y (N,) float32 (class indices as floats), tau (C,) the noise variance
    (regression; None or ignored for classification). CUDA tensors launch
    the kernel, CPU tensors run the plain version."""
    if task not in ("regression", "classification"):
        raise ValueError(f"unknown task {task!r}")
    tensors = [w, x, y] + ([tau] if task == "regression" else [])
    kinds = {a.device.type for a in tensors}
    if kinds == {"cpu"}:
        return fnn_eval_reference(w, x, y, tau, topo, task)
    if kinds == {"cuda"}:
        return _launch_cuda(w, x, y, tau, topo, task)
    raise ValueError(f"fnn_eval needs all tensors on one device type, got "
                     f"{sorted(kinds)}")
