"""The port's plain RW block against ptnn's Pallas kernel (interpret mode).

``ptnn_torch.ops.block_step.rw_block_reference`` and
``ptnn.ops.pallas_step.fused_rw_block_impl(..., interpret=True)`` get the
same state, noise and uniforms, made with numpy; ptnn's copy is laid out on
its padded (P, C) planes, the port's chains-major. Accept counters and
accept_count rows match exactly; floats within rtol 2e-4, atol 2e-5, the
tolerances of tests/test_pallas_step.py. All K trace rows are compared:
both write the carries into the rows of steps k >= length.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.ops import pallas_step as ps
from ptnn_torch.ops import block_step, likelihood
from ptnn_torch.models import fnn

torch.set_num_threads(1)

TOPO = (4, 10, 1)
W = 61
C, K = 6, 12
P_PAD, C_PAD = 64, ps.LANES
RTOL, ATOL = 2e-4, 2e-5


def _scal(adapt):
    return dict(step_w=0.025, step_eta=0.2, sigma_sq=25.0, nu_1=0.0,
                nu_2=0.0, adapt=adapt, adapt_rate=0.1, adapt_target=0.234,
                burn_end=37, task_cls=False)


def _inputs(rng):
    """Numpy state whose ll and prior are the true values at (w, eta)."""
    x_tr = rng.normal(size=(37, 4)).astype(np.float32)
    y_tr = rng.normal(size=(37,)).astype(np.float32)
    x_te = rng.normal(size=(23, 4)).astype(np.float32)
    y_te = rng.normal(size=(23,)).astype(np.float32)
    w = rng.normal(size=(C, W)).astype(np.float32)
    eta = (rng.normal(size=(C,)) * 0.3).astype(np.float32)
    tw, teta = torch.from_numpy(w), torch.from_numpy(eta)
    fx = fnn.batched_forward(tw, torch.from_numpy(x_tr), TOPO)[:, :, 0]
    tau = torch.exp(teta)
    ll = likelihood.regression_eval_from_fx(fx, torch.from_numpy(y_tr), tau)
    prior = likelihood.regression_log_prior(tw, tau, TOPO)
    state = dict(
        w=w, w_last=np.ones_like(w), eta=eta, ll=ll.loglik.numpy(),
        prior=prior.numpy(), rmse_train=np.zeros(C, np.float32),
        rmse_test=np.zeros(C, np.float32), n_accept=np.zeros(C, np.int32),
        log_step_w=(math.log(0.025) + 0.2 * rng.normal(size=C)).astype(
            np.float32),
    )
    noise = dict(
        w=rng.normal(size=(K, C, W)).astype(np.float32),
        eta=rng.normal(size=(K, C)).astype(np.float32),
        u=rng.uniform(size=(K, C)).astype(np.float32),
    )
    at = np.geomspace(1.0, 4.0, C).astype(np.float32)
    return (x_tr, y_tr, x_te, y_te), state, noise, at


def _run_ptnn(data, state, noise, at, start, length, scal, record_w):
    def pc(a):  # (C, W) -> (P, C)
        out = np.zeros((P_PAD, C_PAD), a.dtype)
        out[:W, :C] = a.T
        return jnp.asarray(out)

    def c1(a, fill=0):
        out = np.full((1, C_PAD), fill, a.dtype)
        out[0, :C] = a
        return jnp.asarray(out)

    jstate = dict(w=pc(state["w"]), w_last=pc(state["w_last"]),
                  acc_train=c1(np.zeros(C, np.float32)),
                  acc_test=c1(np.zeros(C, np.float32)))
    for k in ("eta", "ll", "prior", "rmse_train", "rmse_test", "n_accept",
              "log_step_w"):
        jstate[k] = c1(state[k])
    nw = np.zeros((K, P_PAD, C_PAD), np.float32)
    nw[:, :W, :C] = noise["w"].transpose(0, 2, 1)
    ne = np.zeros((K, C_PAD), np.float32)
    ne[:, :C] = noise["eta"]
    u = np.ones((K, C_PAD), np.float32)
    u[:, :C] = noise["u"]
    new, tr = ps.fused_rw_block_impl(
        jstate, jnp.asarray(nw), jnp.asarray(ne), jnp.asarray(u), start,
        length, ps.prep_data(*[jnp.asarray(a) for a in data]),
        c1(at, 1.0), TOPO, scal, record_w=record_w, interpret=True,
    )
    new = {k: np.asarray(v) for k, v in new.items()}
    out_state = {k: new[k][0, :C] for k in jstate if k not in ("w", "w_last")}
    out_state["w"] = new["w"][:W, :C].T
    out_state["w_last"] = new["w_last"][:W, :C].T
    out_tr = {k: np.asarray(tr[k])[:, :C]
              for k in ("ll", "rmse_train", "rmse_test", "accept_count")}
    if record_w:
        out_tr["w"] = np.asarray(tr["w"])[:, :W, :C].transpose(0, 2, 1)
    return out_state, out_tr


def _run_port(data, state, noise, at, start, length, scal, record_w,
              fn=block_step.rw_block_reference):
    t = lambda a: torch.from_numpy(np.array(a))
    new, tr = fn(
        {k: t(v) for k, v in state.items()}, t(noise["w"]), t(noise["eta"]),
        t(noise["u"]), start, length, block_step.prep_data(*map(t, data)),
        t(at), TOPO, scal, record_w=record_w,
    )
    return ({k: v.numpy() for k, v in new.items()},
            {k: v.numpy() for k, v in tr.items()})


def _assert_match(got, ref):
    (gs, gt), (rs, rt) = got, ref
    np.testing.assert_array_equal(gs["n_accept"], rs["n_accept"])
    np.testing.assert_array_equal(gt["accept_count"], rt["accept_count"])
    for k in ("w", "w_last", "eta", "ll", "prior", "rmse_train", "rmse_test",
              "log_step_w"):
        np.testing.assert_allclose(gs[k], rs[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in ("ll", "rmse_train", "rmse_test", "w"):
        if k in rt:
            np.testing.assert_allclose(gt[k], rt[k], rtol=RTOL, atol=ATOL,
                                       err_msg="trace " + k)
    assert set(gt) == set(rt)


@pytest.mark.parametrize("record_w", [False, True])
@pytest.mark.parametrize("adapt", [False, True])
def test_rw_block_reference_matches_ptnn(rng, adapt, record_w):
    data, state, noise, at = _inputs(rng)
    start, length = 30, 9  # length < K; RM adaptation stops at step 37
    scal = _scal(adapt)
    ref = _run_ptnn(data, state, noise, at, start, length, scal, record_w)
    got = _run_port(data, state, noise, at, start, length, scal, record_w)
    na = got[0]["n_accept"]
    assert 0 < na.sum() < length * C, na  # both branches of every carry
    _assert_match(got, ref)
    if record_w:  # w rows follow w_last, also in the dead rows
        np.testing.assert_array_equal(got[1]["w"][-1], got[0]["w_last"])


def test_rw_block_zero_length_is_noop(rng):
    data, state, noise, at = _inputs(rng)
    scal = _scal(True)
    ref = _run_ptnn(data, state, noise, at, 5, 0, scal, False)
    got = _run_port(data, state, noise, at, 5, 0, scal, False)
    _assert_match(got, ref)
    for k, v in state.items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)


def test_fused_rw_block_routes_cpu_tensors_to_the_plain_version(rng):
    data, state, noise, at = _inputs(rng)
    scal = _scal(True)
    before = block_step.launches
    ref = _run_port(data, state, noise, at, 30, 9, scal, True)
    got = _run_port(data, state, noise, at, 30, 9, scal, True,
                    fn=block_step.fused_rw_block)
    assert block_step.launches == before  # CPU tensors launch nothing
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k], err_msg=k)
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)
    # classification routes the same way: CPU tensors, the plain version
    topo_c = (4, 5, 3)
    w_c = fnn.w_size(topo_c)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    y = lambda n: t(rng.integers(0, 3, size=n))
    kdata = block_step.prep_data(t(data[0]), y(37), t(data[2]), y(23),
                                 n_classes=3)
    cstate = {k: t(v) for k, v in state.items()}
    cstate.update(w=t(rng.normal(size=(C, w_c))), w_last=torch.ones(C, w_c),
                  acc_train=torch.zeros(C), acc_test=torch.zeros(C))
    args = (cstate, t(rng.normal(size=(K, C, w_c))), None, t(noise["u"]), 30,
            9, kdata, t(at), topo_c, dict(scal, task_cls=True))
    before_cls = block_step.cls_launches
    got = block_step.fused_rw_block(*args)
    ref = block_step.rw_block_reference(*args)
    assert block_step.cls_launches == before_cls
    for a, b in zip(got, ref):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The regression kernel's variants and launch plan (pure Python).


@pytest.mark.parametrize("chains, sms, warps", [
    (1, 132, 8), (64, 132, 8), (132, 132, 8), (133, 132, 4), (1000, 132, 4),
    (1024, 132, 4), (64, 16, 4), (16, 16, 8)])
def test_rw_launch_plan_picks_warps_by_the_rule(chains, sms, warps):
    """One block a chain: 8 warps while the grid fits one wave of one block
    an SM (the Sunspot path's 64 chains on the H100's 132 SMs), else 4 (1000
    and 1024 chains)."""
    plan = block_step.rw_launch_plan(chains, sms)
    assert (plan.warps, plan.blocks) == (warps, chains)
    assert plan.warps in block_step.RW_WARPS
    assert ("exceed" in plan.why) == (chains > sms)


def test_rw_variant_follows_the_bundled_table():
    """The fixed-shape kernel is built for the one-output lines of
    csrc/fnn_layouts.cuh, (4, 10, 1), the topology of every bundled
    regression set; any other (I, H, 1) takes the generic kernel."""
    from ptnn_torch.ops import _build

    table = _build.cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS")
    assert block_step.fixed_topologies() == tuple(
        (i, h, 1) for i, h, o, *_ in table if o == 1) == ((4, 10, 1),)
    assert block_step.variant(TOPO) == "fixed"
    for topo in ((3, 7, 1), (4, 9, 1), (9, 12, 1)):
        assert block_step.variant(topo) == "generic"


@pytest.mark.parametrize("n_rows", [496, 60, 7])
def test_rw_smem_layout_matches_the_wrapper(n_rows):
    """csrc/rw_block.cu's shared memory: the generic kernel's rows, three
    weight vectors and three reduction slots a warp of its 4; the
    fixed-shape kernel's rows padded to 16 bytes, two weight and two noise
    slots of w_size + 2 floats padded to 16 bytes (61 -> 64), and two
    parities of a 4-float partial slot per warp."""
    rows = n_rows * 5
    for warps in block_step.RW_WARPS:
        assert block_step.smem_bytes(n_rows, TOPO, warps) == 4 * (
            -(-rows // 4) * 4 + 4 * 64 + 2 * warps * 4)
    w = fnn.w_size((3, 7, 1))
    assert block_step.smem_bytes(n_rows, (3, 7, 1)) == 4 * (
        n_rows * 4 + 3 * w + 3 * 4)
