"""The CUDA block kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/rw_block.cu);
without one they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda

Accept counters must match on every chain whose decision margin exceeds
1e-5 (at most 1% of chains may fall under it); floats within rtol 1e-4,
atol 1e-5, ll's rtol applying to the size of the terms that cancel in it
(``rw_block_reference(diagnostics=True)``).
"""

import math

import numpy as np
import pytest
import torch

from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step, likelihood

torch.set_num_threads(1)

TOPO = (4, 10, 1)
RTOL, ATOL, MARGIN = 1e-4, 1e-5, 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda")


def _inputs(device, c, k, adapt, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x_tr, y_tr = f(rng.normal(size=(37, 4))), f(rng.uniform(size=37))
    x_te, y_te = f(rng.normal(size=(23, 4))), f(rng.uniform(size=23))
    w = f(rng.normal(size=(c, fnn.w_size(TOPO))))
    eta = f(rng.normal(size=c) * 0.3 - 2.0)
    fx = fnn.batched_forward(w, x_tr, TOPO)[:, :, 0]
    tau = torch.exp(eta)
    state = dict(
        w=w, w_last=torch.ones_like(w), eta=eta,
        ll=likelihood.regression_eval_from_fx(fx, y_tr, tau).loglik,
        prior=likelihood.regression_log_prior(w, tau, TOPO),
        rmse_train=torch.zeros_like(eta), rmse_test=torch.zeros_like(eta),
        n_accept=torch.zeros(c, dtype=torch.int32, device=device),
        log_step_w=f(math.log(0.025) + 0.2 * rng.normal(size=c)),
    )
    noise = (f(rng.normal(size=(k, c, fnn.w_size(TOPO)))),
             f(rng.normal(size=(k, c))), f(rng.uniform(size=(k, c))))
    scal = dict(step_w=0.025, step_eta=0.2, sigma_sq=25.0, nu_1=0.0,
                nu_2=0.0, adapt=adapt, adapt_rate=0.1, adapt_target=0.234,
                burn_end=7, task_cls=False)
    data = block_step.prep_data(x_tr, y_tr, x_te, y_te)
    return state, noise, data, f(np.geomspace(1.0, 4.0, c)), scal


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", [False, True])
def test_rw_block_kernel_matches_plain_version(cuda, adapt):
    c, k, length = 130, 12, 9  # a ragged chain count; dead rows at the end
    state, noise, data, at, scal = _inputs(cuda, c, k, adapt)
    args = (state, *noise, 2, length, data, at, TOPO, scal)
    before = block_step.launches
    new_k, tr_k = block_step.fused_rw_block(*args, record_w=True)
    assert block_step.launches == before + 1
    new_r, tr_r = block_step.rw_block_reference(*args, record_w=True,
                                                diagnostics=True)
    torch.cuda.synchronize()
    ok = tr_r["margin"] > MARGIN
    assert int((~ok).sum()) <= 0.01 * c + 1
    assert torch.equal(new_k["n_accept"][ok], new_r["n_accept"][ok])
    assert torch.equal(tr_k["accept_count"][:, ok], tr_r["accept_count"][:, ok])
    for name in ("w", "w_last", "eta", "prior", "rmse_train", "rmse_test",
                 "log_step_w"):
        torch.testing.assert_close(new_k[name][ok], new_r[name][ok],
                                   rtol=RTOL, atol=ATOL)
    for name in ("rmse_train", "rmse_test", "w"):
        torch.testing.assert_close(tr_k[name][:, ok], tr_r[name][:, ok],
                                   rtol=RTOL, atol=ATOL)
    for got, ref, scale in ((new_k["ll"], new_r["ll"], tr_r["ll_scale_final"]),
                            (tr_k["ll"], tr_r["ll"], tr_r["ll_scale"])):
        diff = (got - ref).abs()[..., ok]
        assert bool((diff <= ATOL + RTOL * scale[..., ok]).all())


@pytest.mark.cuda
def test_rw_block_kernel_rejects_what_it_cannot_take(cuda):
    state, noise, data, at, scal = _inputs(cuda, 8, 4, False)
    with pytest.raises(ValueError, match="dtype"):
        block_step.fused_rw_block(dict(state, eta=state["eta"].double()),
                                  *noise, 0, 4, data, at, TOPO, scal)
    with pytest.raises(ValueError, match="one device type"):
        block_step.fused_rw_block(state, noise[0].cpu(), *noise[1:], 0, 4,
                                  data, at, TOPO, scal)
