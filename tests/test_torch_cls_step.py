"""The port's classification blocks, likelihood and init against ptnn.

``block_step.rw_block_reference`` (``task_cls``) and
``precond_cls_step.{mala,hmc}_cls_block_reference`` get the same state,
noise and uniforms as ``ptnn.ops.pallas_step``'s ``fused_rw_block_impl``,
``fused_mala_cls_block_impl`` and ``fused_hmc_cls_block_impl`` run with
``interpret=True``, made with numpy; ptnn's copy is laid out on its padded
(P, C) planes, the port's chains-major. Accept counters, accept_count rows,
acc and traj_len match exactly; floats within rtol 2e-4, atol 2e-5 (ll,
a sum of negative terms, on its own size). Also here: the multinomial
gradient against ptnn's autodiff and torch's, the classification
likelihood and prior, and ``init_state`` for the three proposals.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import kernel as jkernel
from ptnn import sampler as jsampler
from ptnn.data import load_classification as jload_classification
from ptnn.ops import likelihood as jlik
from ptnn.ops import pallas_step as ps
from ptnn_torch import convert, kernel
from ptnn_torch.data import load_classification
from ptnn_torch.models import fnn
from ptnn_torch.ops import (block_step, likelihood, precond_cls_step,
                            precond_step)
from ptnn_torch.sampler import make_dataset

torch.set_num_threads(1)

TOPO = (4, 5, 3)
W = fnn.w_size(TOPO)  # 43
LANES = ps.LANES
RTOL, ATOL = 2e-4, 2e-5
K = 12


def _data(rng, ntr=37, nte=23, topo=TOPO):
    n_in, n_classes = topo[0], topo[2]
    x_tr = rng.normal(size=(ntr, n_in)).astype(np.float32)
    y_tr = rng.integers(0, n_classes, size=(ntr,)).astype(np.float32)
    x_te = rng.normal(size=(nte, n_in)).astype(np.float32)
    y_te = rng.integers(0, n_classes, size=(nte,)).astype(np.float32)
    return x_tr, y_tr, x_te, y_te


def _state(rng, c, data, log_step, precond=False, chees=False, topo=TOPO):
    """Numpy state whose ll, prior (and g_like) are the true values at w."""
    w = rng.normal(size=(c, fnn.w_size(topo))).astype(np.float32)
    ll, g, _out = fnn.multinomial_ll_grad(
        torch.from_numpy(w), torch.from_numpy(data[0]),
        torch.from_numpy(data[1]), topo)
    prior = likelihood.classification_log_prior(torch.from_numpy(w), topo)
    z = lambda: np.zeros(c, np.float32)
    state = dict(w=w, w_last=np.ones_like(w), eta=z(), ll=ll.numpy(),
                 prior=prior.numpy(), rmse_train=z(), rmse_test=z(),
                 acc_train=z(), acc_test=z(), n_accept=np.zeros(c, np.int32),
                 log_step_w=np.full(c, math.log(log_step), np.float32))
    if precond:
        state.update(g_like=g.numpy(), pc_mean=np.zeros_like(w),
                     pc_m2=np.zeros_like(w))
    if chees:
        state.update(log_traj=np.full(c, math.log(2.0 * log_step), np.float32),
                     chees_m1=z(), chees_v2=z())
    return state


def _noise(rng, c, hmc=False, w=W):
    f = lambda a: np.asarray(a, np.float32)
    noise = dict(w=f(rng.normal(size=(K, c, w))), u=f(rng.uniform(size=(K, c))))
    if hmc:
        noise["u_jit"] = f(rng.uniform(size=(K, c)))
        noise["u_traj"] = f(rng.uniform(size=(K,)))
    return noise


def _temps(c, rungs):
    return np.tile(np.geomspace(1.0, 4.0, rungs), -(-c // rungs))[:c].astype(
        np.float32)


def _run_ptnn(kind, data, state, noise, at, start, length, scal, record_w,
              topo=TOPO):
    """ptnn's Pallas kernel in interpret mode on the padded planes."""
    c, W = state["w"].shape
    c_pad = -(-c // LANES) * LANES
    P_PAD = -(-W // 8) * 8

    def pc(a):  # (C, W) -> (P, C_pad)
        out = np.zeros((P_PAD, c_pad), a.dtype)
        out[:W, :c] = a.T
        return jnp.asarray(out)

    def c1(a, fill=0):
        out = np.full((1, c_pad), fill, a.dtype)
        out[0, :c] = a
        return jnp.asarray(out)

    def kcp(a, fill=1.0):
        out = np.full((K, c_pad), fill, np.float32)
        out[:, :c] = a
        return jnp.asarray(out)

    jstate = {k: (pc(v) if v.ndim == 2 else c1(v)) for k, v in state.items()}
    if kind == "hmc" and "log_traj" not in state:
        for k in ("log_traj", "chees_m1", "chees_v2"):
            jstate[k] = c1(np.zeros(c, np.float32))
    nw = np.zeros((K, P_PAD, c_pad), np.float32)
    nw[:, :W, :c] = noise["w"].transpose(0, 2, 1)
    jdata = ps.prep_data(*[jnp.asarray(a) for a in data], n_classes=topo[2])
    args = (start, length, jdata, c1(at, 1.0), topo, scal)
    kw = dict(record_w=record_w, interpret=True)
    if kind == "rw":
        new, tr = ps.fused_rw_block_impl(
            jstate, jnp.asarray(nw), kcp(np.zeros((K, c), np.float32), 0.0),
            kcp(noise["u"]), *args, **kw)
    elif kind == "mala":
        new, tr = ps.fused_mala_cls_block_impl(
            jstate, jnp.asarray(nw), kcp(noise["u"]), *args, **kw)
    else:
        ut = np.broadcast_to(noise["u_traj"][:, None], (K, c_pad))
        if not scal["chees"]:
            rs = jnp.zeros((LANES, LANES), jnp.float32)
        elif c <= LANES:
            rs = ps.rung_sum_matrix(c, scal["rungs"], c_pad)
        else:
            rs = ps.rung_sum_matrix(LANES, scal["rungs"], LANES)
        new, tr = ps.fused_hmc_cls_block_impl(
            jstate, jnp.asarray(nw), kcp(noise["u"]), kcp(noise["u_jit"]),
            jnp.asarray(ut), rs, *args, **kw)
    out_state = {}
    for k in state:
        v = np.asarray(new[k])
        out_state[k] = v[:W, :c].T if state[k].ndim == 2 else v[0, :c]
    out_tr = {k: np.asarray(v)[:, :c] for k, v in tr.items() if k != "w"}
    if record_w:
        out_tr["w"] = np.asarray(tr["w"])[:, :W, :c].transpose(0, 2, 1)
    return out_state, out_tr


def _run_port(kind, data, state, noise, at, start, length, scal, record_w,
              fn=None, topo=TOPO):
    t = lambda a: torch.from_numpy(np.array(a))
    kdata = block_step.prep_data(*map(t, data), n_classes=topo[2])
    st = {k: t(v) for k, v in state.items()}
    if kind == "rw":
        fn = fn or block_step.rw_block_reference
        new, tr = fn(st, t(noise["w"]), None, t(noise["u"]), start, length,
                     kdata, t(at), topo, scal, record_w=record_w)
    else:
        fn = fn or (precond_cls_step.hmc_cls_block_reference if kind == "hmc"
                    else precond_cls_step.mala_cls_block_reference)
        new, tr = fn(st, {k: t(v) for k, v in noise.items()}, start, length,
                     kdata, t(at), topo, scal, record_w=record_w)
    return ({k: v.numpy() for k, v in new.items()},
            {k: v.numpy() for k, v in tr.items()})


def _assert_match(got, ref, length, rtol=RTOL, atol=ATOL):
    (gs, gt), (rs, rt) = got, ref
    assert set(gs) == set(rs) and set(gt) == set(rt)
    exact = ("n_accept", "eta", "acc_train", "acc_test", "rmse_train",
             "rmse_test")
    for k in exact:
        np.testing.assert_array_equal(gs[k], rs[k], err_msg=k)
    for k in gs:
        if k not in exact:
            np.testing.assert_allclose(gs[k], rs[k], rtol=rtol, atol=atol,
                                       err_msg=k)
    for k in ("accept_count", "acc_train", "acc_test", "rmse_train",
              "rmse_test"):
        np.testing.assert_array_equal(gt[k], rt[k], err_msg="trace " + k)
    if "traj_len" in gt:
        np.testing.assert_array_equal(gt["traj_len"][:length],
                                      rt["traj_len"][:length])
        np.testing.assert_array_equal(gt["traj_len"][length:], 0.0)
    for k in ("ll", "w"):
        if k in rt:
            np.testing.assert_allclose(gt[k], rt[k], rtol=rtol, atol=atol,
                                       err_msg="trace " + k)


def _rw_scal(adapt):
    return dict(step_w=0.5, step_eta=0.2, sigma_sq=25.0, nu_1=0.0, nu_2=0.0,
                adapt=adapt, adapt_rate=0.1, adapt_target=0.234, burn_end=37,
                task_cls=True)


# the classification RW kernel's fixed-shape networks (iris's, Cancer's,
# TicTac's, Ionosphere's) beside (4, 5, 3); the (4, 5, 3) cases keep their
# ids
RW_CLS_CASES = [pytest.param(adapt, TOPO, id=str(adapt))
                for adapt in (False, True)] + [
    pytest.param(adapt, topo, id=f"{adapt}-{'-'.join(map(str, topo))}")
    for topo in ((9, 12, 2), (9, 25, 2), (34, 50, 2)) for adapt in (False, True)]


@pytest.mark.parametrize("adapt, topo", RW_CLS_CASES)
def test_rw_cls_block_reference_matches_ptnn(rng, adapt, topo):
    c = 6
    step = 0.5 if fnn.w_size(topo) < 1000 else 0.05  # some accepts, not all
    data = _data(rng, topo=topo)
    state = _state(rng, c, data, step, topo=topo)
    noise = _noise(rng, c, w=fnn.w_size(topo))
    at = _temps(c, c)
    start, length = 30, 9  # length < K; RM adaptation stops at step 37
    scal = dict(_rw_scal(adapt), step_w=step)
    ref = _run_ptnn("rw", data, state, noise, at, start, length, scal, True,
                    topo=topo)
    got = _run_port("rw", data, state, noise, at, start, length, scal, True,
                    topo=topo)
    na = got[0]["n_accept"]
    assert 0 < na.sum() < length * c, na  # both branches of every carry
    _assert_match(got, ref, length)
    # eta passes through; ll is recorded UNTEMPERED
    np.testing.assert_array_equal(got[0]["eta"], state["eta"])
    assert got[1]["ll"][length - 1].max() < 0


def _precond_scal(hmc=False, chees=False, rungs=3, n_ladders=2):
    """Warm start to step 5, preconditioner from 8, adaptation to 11: a
    block from step 2 crosses every phase boundary."""
    s = dict(sigma_sq=25.0, nu_1=0.0, nu_2=0.0, adapt_rate=0.1,
             warmstart_step=0.05, precond_power=1.0, pc_start=8, warm_end=5,
             burn_end=11)
    if not hmc:
        return dict(s, mala_target=0.574)
    return dict(s, hmc_target=0.75, leapfrog=4, eps_jitter=0.2, chees=chees,
                chees_rate=0.025, rungs=rungs, n_ladders=n_ladders)


def test_mala_cls_block_reference_matches_ptnn(rng):
    c = 6
    data = _data(rng)
    state = _state(rng, c, data, 0.6, precond=True)
    noise = _noise(rng, c)
    at = _temps(c, 3)
    start, length = 2, 11  # crosses warm_end 5, pc_start 8, burn_end 11
    scal = _precond_scal()
    ref = _run_ptnn("mala", data, state, noise, at, start, length, scal, True)
    got = _run_port("mala", data, state, noise, at, start, length, scal, True)
    na = got[0]["n_accept"]
    assert 3 * c <= na.sum() < length * c, na  # forced warm accepts + rejects
    _assert_match(got, ref, length)
    assert not np.array_equal(got[0]["pc_m2"], state["pc_m2"])


@pytest.mark.parametrize("chees", [False, True])
def test_hmc_cls_block_reference_matches_ptnn(rng, chees):
    c = 6  # 2 ladders of 3 rungs: one panel
    data = _data(rng)
    state = _state(rng, c, data, 0.75, precond=True, chees=chees)
    noise = _noise(rng, c, hmc=True)
    at = _temps(c, 3)
    start, length = 2, 11
    scal = _precond_scal(hmc=True, chees=chees)
    ref = _run_ptnn("hmc", data, state, noise, at, start, length, scal, True)
    got = _run_port("hmc", data, state, noise, at, start, length, scal, True)
    na = got[0]["n_accept"]
    assert 3 * c <= na.sum() < length * c, na
    _assert_match(got, ref, length)
    tl = got[1]["traj_len"][:length]
    assert tl.min() >= 1 and tl.max() <= scal["leapfrog"]
    if chees:
        assert len(np.unique(tl)) > 1
        assert not np.allclose(got[0]["log_traj"], state["log_traj"])
    else:
        assert "log_traj" not in got[0] and np.all(tl == scal["leapfrog"])


def test_hmc_cls_chees_two_panels_match_ptnn(rng):
    """256 chains = 2 panels of 32 four-rung ladders: each pools its own."""
    c, rungs = 256, 4
    data = _data(rng)
    state = _state(rng, c, data, 0.75, precond=True, chees=True)
    noise = _noise(rng, c, hmc=True)
    at = _temps(c, rungs)
    start, length = 5, 4  # adapting steps 5..8
    scal = _precond_scal(hmc=True, chees=True, rungs=rungs,
                         n_ladders=LANES // rungs)
    ref = _run_ptnn("hmc", data, state, noise, at, start, length, scal, False)
    got = _run_port("hmc", data, state, noise, at, start, length, scal, False)
    _assert_match(got, ref, length)
    lt = got[0]["log_traj"].reshape(2, LANES)
    assert not np.allclose(lt[0], lt[1])


@pytest.mark.parametrize("kind", ["rw", "mala", "hmc"])
def test_cls_zero_length_block_changes_nothing(rng, kind):
    c = 6
    data = _data(rng)
    state = _state(rng, c, data, 0.5, precond=kind != "rw",
                   chees=kind == "hmc")
    noise = _noise(rng, c, hmc=kind == "hmc")
    scal = (_rw_scal(True) if kind == "rw"
            else _precond_scal(hmc=kind == "hmc", chees=kind == "hmc"))
    got = _run_port(kind, data, state, noise, _temps(c, 3), 7, 0, scal, False)
    ref = _run_ptnn(kind, data, state, noise, _temps(c, 3), 7, 0, scal, False)
    _assert_match(got, ref, 0)
    for k, v in state.items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)


def test_cls_blocks_route_cpu_tensors_to_the_plain_version(rng):
    c = 6
    data = _data(rng)
    before = (block_step.cls_launches, dict(precond_cls_step.launches))
    for kind, fn in (("rw", block_step.fused_rw_block),
                     ("mala", precond_cls_step.fused_mala_cls_block),
                     ("hmc", precond_cls_step.fused_hmc_cls_block)):
        state = _state(rng, c, data, 0.5, precond=kind != "rw",
                       chees=kind == "hmc")
        noise = _noise(rng, c, hmc=kind == "hmc")
        scal = (_rw_scal(True) if kind == "rw"
                else _precond_scal(hmc=kind == "hmc", chees=kind == "hmc"))
        args = (data, state, noise, _temps(c, 3), 2, 9, scal, True)
        ref, got = _run_port(kind, *args), _run_port(kind, *args, fn=fn)
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (block_step.cls_launches, precond_cls_step.launches) == before


def test_multinomial_grad_matches_ptnn_and_autograd(rng):
    prob = load_classification("iris")
    topo = prob.topology
    cfg = ptnn.PTConfig(task="classification", topology=topo,
                        num_samples=5 * 20, num_chains=5,
                        proposal="precond_mala").validate()
    jdata = jsampler.make_dataset(cfg, prob.train, prob.test)
    w = (rng.normal(size=(5, fnn.w_size(topo))) * 1.5).astype(np.float32)
    (jval, _out), jg = jkernel._like_value_and_grad(
        cfg, jkernel.default_spec(cfg), jdata)(jnp.asarray(w))
    tdata = make_dataset(cfg, prob.train, prob.test, "cpu")
    val, g, _out = fnn.multinomial_ll_grad(torch.from_numpy(w), tdata.x_train,
                                           tdata.y_train, topo)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=2e-5)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * scale)
    w64 = torch.from_numpy(w).double().requires_grad_()
    x64 = tdata.x_train.double()
    likelihood.classification_eval(w64, x64, tdata.y_train, topo
                                   ).loglik.sum().backward()
    _v, g64, _o = fnn.multinomial_ll_grad(w64.detach(), x64, tdata.y_train,
                                          topo)
    torch.testing.assert_close(g64, w64.grad, rtol=1e-12, atol=1e-12)


def test_classification_eval_and_prior_match_ptnn(rng):
    prob = load_classification("iris")
    topo = prob.topology
    w = rng.normal(size=(7, fnn.w_size(topo))).astype(np.float32)
    x = prob.test[:, :4].astype(np.float32)
    y = prob.test[:, 4].astype(np.float32)
    jev = jax.vmap(lambda wi: jlik.classification_eval(
        wi, jnp.asarray(x), jnp.asarray(y), topo))(jnp.asarray(w))
    tev = likelihood.classification_eval(torch.from_numpy(w),
                                         torch.from_numpy(x),
                                         torch.from_numpy(y), topo)
    np.testing.assert_allclose(tev.loglik.numpy(), np.asarray(jev.loglik),
                               rtol=1e-5)
    for k in ("rmse", "acc", "fx"):
        np.testing.assert_allclose(getattr(tev, k).numpy(),
                                   np.asarray(getattr(jev, k)), rtol=1e-6,
                                   err_msg=k)
    jprior = jax.vmap(lambda wi: jlik.classification_log_prior(wi, topo))(
        jnp.asarray(w))
    np.testing.assert_allclose(
        likelihood.classification_log_prior(torch.from_numpy(w), topo).numpy(),
        np.asarray(jprior), rtol=1e-6)
    # ties keep the first class, as jnp.argmax
    out = torch.tensor([[0.5, 0.5, 0.1], [0.2, 0.7, 0.7], [0.3, 0.3, 0.3]])
    assert fnn.predict_class(out).tolist() == [0, 1, 0]


def _cls_kw(**kw):
    base = dict(task="classification", topology=(4, 12, 3),
                num_samples=8 * 50, num_chains=8, n_ladders=2, maxtemp=5.0,
                swap_interval=10, swap_offset=1, swap_style="even_odd",
                warmstart_frac=0.1, precond_start_frac=0.3,
                track_replicas=True, fused_step=True)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [dict(proposal="reference", warmstart_frac=0.0,
                                     precond_start_frac=0.0),
                                dict(proposal="precond_mala"),
                                dict(proposal="hmc", hmc_leapfrog=4,
                                     hmc_adapt_traj=True, step_w=0.01)])
def test_cls_init_state_matches_ptnn(rng, kw):
    prob = jload_classification("iris")
    jcfg = ptnn.PTConfig(**_cls_kw(**kw)).validate()
    tcfg = ptnn_torch.PTConfig(**_cls_kw(**kw)).validate()
    init_w = rng.normal(size=(8, 99)).astype(np.float32)
    jst = jkernel.init_state(jax.random.PRNGKey(0), jcfg,
                             jsampler.make_dataset(jcfg, prob.train,
                                                   prob.test),
                             init_w=init_w)
    tst = kernel.init_state(tcfg, make_dataset(tcfg, prob.train, prob.test,
                                               "cpu"),
                            init_w=torch.from_numpy(init_w))
    ref = {k: (None if v is None else np.asarray(v))
           for k, v in jax.device_get(jst)._asdict().items()}
    got = convert.chain_state_to_numpy(tst)
    for k in convert.FIELDS:
        assert (got[k] is None) == (ref[k] is None), k
        if got[k] is None:
            continue
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        if k == "g_like":
            scale = np.abs(ref[k]).max()
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                       atol=1e-5 * scale)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert got["log_step_eta"] is None
    np.testing.assert_array_equal(got["eta"], 0.0)
    # the state round-trips through ptnn's numpy arrays
    back = convert.chain_state_from_numpy(ref)
    np.testing.assert_array_equal(back.acc_test.numpy(), ref["acc_test"])


# ---------------------------------------------------------------------------
# The HMC kernel's launch plan (``precond_cls_step.launch_plan``): pure
# Python, fed occupancy numbers in place of the card's queries. H100-like:
# seven 16-block clusters fit at once (as the card reports for the
# regression HMC kernel), smaller clusters fill the 132 SMs, and one block
# an SM.
IRIS, IRIS_ROWS = (4, 12, 3), 150


def _h100_fits(wpc, smem, cluster):
    return 7 if cluster == 16 else 132 // cluster


def _plan(chains, chees, fits=_h100_fits, coop=lambda wpc, smem: 132):
    panel = 0
    if chees:
        panel = precond_step.panel_layout(chains, 1 if chains == 1 else 4)[0]
    seen = []

    def fits_logged(wpc, smem, cluster):
        seen.append((wpc, smem))
        return fits(wpc, smem, cluster)

    def coop_logged(wpc, smem):
        seen.append((wpc, smem))
        return coop(wpc, smem)

    plan = precond_cls_step.launch_plan(chains, panel, IRIS_ROWS, IRIS,
                                        fits_logged, coop_logged)
    for wpc, smem in seen:  # each query at its layout's shared memory
        assert smem == precond_cls_step.hmc_smem_bytes(IRIS_ROWS, IRIS, True,
                                                       wpc)
    return plan, panel


@pytest.mark.parametrize("chees", [False, True])
@pytest.mark.parametrize("chains", [1, 52, 64, 100, 130, 256, 1024])
def test_hmc_cls_plan_covers_every_chain_once(chains, chees):
    """Every chain sits in exactly one (block, chain slot); under ChEES every
    block holds chains of one panel only, a panel spans whole blocks and, on
    the cluster route, whole clusters; shared memory fits a Hopper block.
    130 chains do not tile ChEES's 128-chain panels and are refused, as
    ``precond_step.panel_layout`` refuses them."""
    if chees and chains == 130:
        with pytest.raises(ValueError, match="complete ladders"):
            _plan(chains, chees)
        return
    plan, panel = _plan(chains, chees)
    warps = precond_cls_step._hmc("HMC_CLS_THREADS") // 32
    assert plan.wpc in precond_cls_step.WPCS
    assert plan.per_block == warps // plan.wpc
    assert plan.blocks == -(-chains // plan.per_block)
    slots = np.arange(plan.blocks * plan.per_block)
    chain_of = slots[slots < chains]
    np.testing.assert_array_equal(np.sort(chain_of), np.arange(chains))
    assert plan.smem <= precond_step._SMEM_LIMIT
    assert plan.smem == precond_cls_step.hmc_smem_bytes(IRIS_ROWS, IRIS,
                                                        chees, plan.wpc)
    if not chees:
        assert (plan.route, plan.cluster) == ("plain", 1)
        return
    block = np.arange(chains) // plan.per_block
    for b in range(plan.blocks):  # a block's chains share one panel
        assert len(np.unique(np.arange(chains)[block == b] // panel)) == 1
    assert plan.cluster == -(-panel // plan.per_block)
    if chains > panel:
        assert panel % plan.per_block == 0
    if plan.route == "cluster":
        assert plan.blocks % plan.cluster == 0
        assert plan.cluster <= precond_cls_step._hmc("HMC_CLS_MAX_CLUSTER")


@pytest.mark.parametrize("chains, chees, want", [
    (64, True, (4, 2, 32, "grid")), (256, True, (4, 2, 128, "grid")),
    (52, True, (4, 2, 26, "grid")), (1024, True, (1, 8, 128, "grid")),
    (1, True, (4, 2, 1, "cluster")), (1024, False, (4, 2, 512, "plain")),
    (130, False, (4, 2, 65, "plain"))])
def test_hmc_cls_plan_picks_warps_and_route_by_the_rule(chains, chees, want):
    """On the H100-like numbers: the largest WPC at which every panel's
    exchange runs at once, a cluster a panel when all panels' clusters fit,
    else the cooperative grid when every block fits; without ChEES the
    largest WPC."""
    plan, _panel = _plan(chains, chees)
    assert (plan.wpc, plan.per_block, plan.blocks, plan.route) == want


def test_hmc_cls_plan_steps_down_when_the_card_holds_less():
    # half the card for the grid: 256 chains at 4 warps a chain need 128
    # blocks, at 2 warps 64
    plan, _ = _plan(256, True, coop=lambda wpc, smem: 64)
    assert (plan.wpc, plan.blocks, plan.route) == (2, 64, "grid")
    # all eight 16-block clusters fit: 1024 chains take one a panel at 1
    # warp a chain (the grid, 128 blocks, would fit too: clusters first)
    plan, _ = _plan(1024, True, fits=lambda wpc, smem, cl: 8)
    assert (plan.wpc, plan.cluster, plan.route) == (1, 16, "cluster")
    # neither route at once: clusters in waves at 1 warp a chain
    plan, _ = _plan(1024, True, fits=lambda wpc, smem, cl: 2,
                    coop=lambda wpc, smem: 100)
    assert (plan.wpc, plan.route) == (1, "cluster") and "waves" in plan.why
    with pytest.raises(ValueError, match="fits neither"):
        _plan(1024, True, fits=lambda wpc, smem, cl: 0,
              coop=lambda wpc, smem: 0)


def test_hmc_cls_shared_memory_layout():
    """Rows padded to 16 bytes; per warp of the 8 a broadcast slot (128
    floats), a 32-record tile at stride 33 and two parities of its partial
    slot (128 + 8); under ChEES two parities of an exchange slot (2 * 128 +
    4) a chain. The MALA kernel has the same layout without the exchange,
    whatever its warps a chain."""
    rows = (150 * 5 + 3) // 4 * 4
    per_warp = 128 + 32 * 33 + 2 * (128 + 8)
    for wpc in precond_cls_step.WPCS:
        assert precond_cls_step.hmc_smem_bytes(150, IRIS, False, wpc) == 4 * (
            rows + 8 * per_warp)
        assert precond_cls_step.hmc_smem_bytes(150, IRIS, True, wpc) == 4 * (
            rows + 8 * per_warp + 8 // wpc * 2 * 260)
    assert precond_cls_step.mala_smem_bytes(150, IRIS) == 4 * (
        rows + 8 * per_warp)


# ---------------------------------------------------------------------------
# The MALA kernel's launch plan (``precond_cls_step.mala_launch_plan``):
# pure Python, fed the card's SM count (132 on the H100).


@pytest.mark.parametrize("chains", [1, 52, 64, 100, 130, 256, 1024])
def test_mala_cls_plan_covers_every_chain_once(chains):
    """Every chain sits in exactly one (block, chain slot) of WPC warps; the
    blocks are 8 warps; shared memory fits a Hopper block."""
    plan = precond_cls_step.mala_launch_plan(chains, IRIS_ROWS, IRIS, 132)
    assert plan.wpc in precond_cls_step.WPCS
    assert plan.per_block * plan.wpc == 8
    assert plan.blocks == -(-chains // plan.per_block)
    slots = np.arange(plan.blocks * plan.per_block)
    block, slot = slots // plan.per_block, slots % plan.per_block
    chain = block * plan.per_block + slot
    np.testing.assert_array_equal(np.sort(chain[chain < chains]),
                                  np.arange(chains))
    assert (plan.blocks - 1) * plan.per_block < chains  # no empty block
    assert plan.smem == precond_cls_step.mala_smem_bytes(IRIS_ROWS, IRIS)
    assert plan.smem <= precond_step._SMEM_LIMIT


@pytest.mark.parametrize("chains, sms, want", [
    (64, 132, (4, 2, 32)), (256, 132, (4, 2, 128)), (1024, 132, (1, 8, 128)),
    (52, 132, (4, 2, 26)), (1, 132, (4, 2, 1)), (130, 132, (4, 2, 65)),
    (264, 132, (4, 2, 132)), (266, 132, (2, 4, 67)),
    (2000, 132, (1, 8, 250)),
    # fewer SMs: step down
    (64, 16, (2, 4, 16)), (64, 8, (1, 8, 8)), (64, 4, (1, 8, 8))])
def test_mala_cls_plan_picks_warps_by_the_rule(chains, sms, want):
    """The largest WPC whose blocks fit one wave of the card's SMs (one
    block an SM), else one warp a chain in waves: on the H100's 132 SMs WPC
    4 at the path's 64 chains (32 blocks) and WPC 1 at 1024 (128 blocks);
    on a card with fewer SMs the plan steps down."""
    plan = precond_cls_step.mala_launch_plan(chains, IRIS_ROWS, IRIS, sms)
    assert (plan.wpc, plan.per_block, plan.blocks) == want
    assert ("waves" in plan.why) == (plan.blocks > sms)
