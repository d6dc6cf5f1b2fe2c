"""The port's plain MALA and HMC blocks against ptnn's Pallas kernels.

``ptnn_torch.ops.precond_step.{mala,hmc}_block_reference`` and
``ptnn.ops.pallas_step.fused_{mala,hmc}_block_impl(..., interpret=True)`` get
the same state, noise and uniforms, made with numpy; ptnn's copy is laid out
on its padded (P, C) planes, the port's chains-major. Accept counters,
accept_count rows and traj_len rows match exactly; floats within rtol 5e-4,
atol 5e-5, the tolerance tests/test_pallas_step.py holds ptnn's own MALA and
HMC kernels to against their oracles. Also here: the hand-written -SSE/2
gradient, ``vdc_u``, the preconditioned ``init_state`` and ``do_swap``.
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
from ptnn.data import load_regression
from ptnn.ops import pallas_step as ps
from ptnn_torch import convert, kernel
from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step, likelihood, precond_step
from ptnn_torch.sampler import make_dataset

torch.set_num_threads(1)

TOPO = (4, 10, 1)
W = 61
P_PAD, LANES = 64, ps.LANES
RTOL, ATOL = 5e-4, 5e-5
K = 12
# scales at which both samplers reject some proposals of these inputs
STEP_MALA, STEP_HMC = 0.8, 0.5


def _scal(hmc=False, chees=False, rungs=3, n_ladders=2):
    """Warm start to step 5, preconditioner from 8, adaptation to 11: a
    block from step 2 crosses every phase boundary."""
    s = dict(sigma_sq=25.0, nu_1=0.0, nu_2=0.0, adapt_rate=0.1,
             warmstart_step=0.05, precond_power=1.0, pc_start=8, warm_end=5,
             burn_end=11)
    if not hmc:
        return dict(s, mala_target=0.574)
    return dict(s, hmc_target=0.75, leapfrog=4, eps_jitter=0.2, chees=chees,
                chees_rate=0.025, rungs=rungs, n_ladders=n_ladders)


def _inputs(rng, c, hmc=False, chees=False):
    """Numpy data, state (with the true ll, prior and g_like at (w, eta)),
    noise and temperatures (by rung, chain = ladder * K + rung)."""
    x_tr = rng.normal(size=(37, 4)).astype(np.float32)
    y_tr = rng.normal(size=(37,)).astype(np.float32)
    x_te = rng.normal(size=(23, 4)).astype(np.float32)
    y_te = rng.normal(size=(23,)).astype(np.float32)
    w = rng.normal(size=(c, W)).astype(np.float32)
    eta = (rng.normal(size=(c,)) * 0.3).astype(np.float32)
    tw, teta = torch.from_numpy(w), torch.from_numpy(eta)
    fx = fnn.batched_forward(tw, torch.from_numpy(x_tr), TOPO)[:, :, 0]
    tau = torch.exp(teta)
    ll = likelihood.regression_eval_from_fx(fx, torch.from_numpy(y_tr), tau)
    prior = likelihood.regression_log_prior(tw, tau, TOPO)
    g_like = fnn.neg_half_sse_grad(tw, torch.from_numpy(x_tr),
                                   torch.from_numpy(y_tr), TOPO)[1]
    state = dict(
        w=w, w_last=np.ones_like(w), g_like=g_like.numpy(),
        pc_mean=np.zeros_like(w), pc_m2=np.zeros_like(w), eta=eta,
        ll=ll.loglik.numpy(), prior=prior.numpy(),
        rmse_train=np.zeros(c, np.float32), rmse_test=np.zeros(c, np.float32),
        n_accept=np.zeros(c, np.int32),
        log_step_w=np.full(c, math.log(STEP_HMC if hmc else STEP_MALA), np.float32),
        log_step_eta=np.full(c, math.log(0.2), np.float32),
    )
    if chees:
        # half the static bound, as init_state: below the cap log(eps L)
        state.update(log_traj=np.full(c, math.log(2 * STEP_HMC), np.float32),
                     chees_m1=np.zeros(c, np.float32),
                     chees_v2=np.zeros(c, np.float32))
    f = lambda a: np.asarray(a, np.float32)
    noise = dict(w=f(rng.normal(size=(K, c, W))),
                 eta=f(rng.normal(size=(K, c))),
                 u=f(rng.uniform(size=(K, c))),
                 u_eta=f(rng.uniform(size=(K, c))))
    if hmc:
        noise["u_jit"] = f(rng.uniform(size=(K, c)))
        noise["u_traj"] = f(rng.uniform(size=(K,)))
    rungs = _scal(True)["rungs"] if c <= LANES else 4
    at = np.tile(np.geomspace(1.0, 4.0, rungs), -(-c // rungs))[:c]
    return (x_tr, y_tr, x_te, y_te), state, noise, at.astype(np.float32)


def _run_ptnn(hmc, data, state, noise, at, start, length, scal, record_w):
    c = state["w"].shape[0]
    c_pad = -(-c // LANES) * LANES

    def pc(a):  # (C, W) -> (P, C_pad)
        out = np.zeros((P_PAD, c_pad), a.dtype)
        out[:W, :c] = a.T
        return jnp.asarray(out)

    def c1(a, fill=0):
        out = np.full((1, c_pad), fill, a.dtype)
        out[0, :c] = a
        return jnp.asarray(out)

    def kc(a, fill=1.0):
        out = np.full((K, c_pad), fill, np.float32)
        out[:, :c] = a
        return jnp.asarray(out)

    jstate = {k: (pc(v) if v.ndim == 2 else c1(v)) for k, v in state.items()}
    if hmc and "log_traj" not in state:  # ptnn's kernel takes them anyway
        for k in ("log_traj", "chees_m1", "chees_v2"):
            jstate[k] = c1(np.zeros(c, np.float32))
    nw = np.zeros((K, P_PAD, c_pad), np.float32)
    nw[:, :W, :c] = noise["w"].transpose(0, 2, 1)
    args = [jnp.asarray(nw), kc(noise["eta"], 0.0), kc(noise["u"]),
            kc(noise["u_eta"])]
    jdata = ps.prep_data(*[jnp.asarray(a) for a in data])
    if hmc:
        ut = np.broadcast_to(noise["u_traj"][:, None], (K, c_pad))
        if not scal["chees"]:
            rs = jnp.zeros((LANES, LANES), jnp.float32)
        elif c <= LANES:
            rs = ps.rung_sum_matrix(c, scal["rungs"], c_pad)
        else:
            rs = ps.rung_sum_matrix(LANES, scal["rungs"], LANES)
        new, tr = ps.fused_hmc_block_impl(
            jstate, *args, kc(noise["u_jit"]), jnp.asarray(ut), rs, start,
            length, jdata, c1(at, 1.0), TOPO, scal, record_w=record_w,
            interpret=True)
    else:
        new, tr = ps.fused_mala_block_impl(
            jstate, *args, start, length, jdata, c1(at, 1.0), TOPO, scal,
            record_w=record_w, interpret=True)
    out_state = {}
    for k in state:
        v = np.asarray(new[k])
        out_state[k] = v[:W, :c].T if state[k].ndim == 2 else v[0, :c]
    out_tr = {k: np.asarray(v)[:, :c] for k, v in tr.items() if k != "w"}
    if record_w:
        out_tr["w"] = np.asarray(tr["w"])[:, :W, :c].transpose(0, 2, 1)
    return out_state, out_tr


def _run_port(hmc, data, state, noise, at, start, length, scal, record_w,
              fn=None):
    t = lambda a: torch.from_numpy(np.array(a))
    if fn is None:
        fn = (precond_step.hmc_block_reference if hmc
              else precond_step.mala_block_reference)
    new, tr = fn({k: t(v) for k, v in state.items()},
                 {k: t(v) for k, v in noise.items()}, start, length,
                 block_step.prep_data(*map(t, data)), t(at), TOPO, scal,
                 record_w=record_w)
    return ({k: v.numpy() for k, v in new.items()},
            {k: v.numpy() for k, v in tr.items()})


def _assert_match(got, ref, length):
    (gs, gt), (rs, rt) = got, ref
    assert set(gs) == set(rs)
    np.testing.assert_array_equal(gs["n_accept"], rs["n_accept"])
    for k in gs:
        if k != "n_accept":
            np.testing.assert_allclose(gs[k], rs[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    np.testing.assert_array_equal(gt["accept_count"], rt["accept_count"])
    if "traj_len" in gt:
        np.testing.assert_array_equal(gt["traj_len"][:length],
                                      rt["traj_len"][:length])
        np.testing.assert_array_equal(gt["traj_len"][length:], 0.0)
    for k in ("ll", "rmse_train", "rmse_test", "w"):
        if k in rt:
            np.testing.assert_allclose(gt[k], rt[k], rtol=RTOL, atol=ATOL,
                                       err_msg="trace " + k)


@pytest.mark.parametrize("record_w", [False, True])
def test_mala_block_reference_matches_ptnn(rng, record_w):
    c = 6
    data, state, noise, at = _inputs(rng, c)
    start, length = 2, 11  # crosses warm_end 5, pc_start 8, burn_end 11
    scal = _scal()
    ref = _run_ptnn(False, data, state, noise, at, start, length, scal,
                    record_w)
    got = _run_port(False, data, state, noise, at, start, length, scal,
                    record_w)
    na = got[0]["n_accept"]
    assert 3 * c <= na.sum() < length * c, na  # forced warm accepts + rejects
    _assert_match(got, ref, length)
    assert not np.array_equal(got[0]["pc_m2"], state["pc_m2"])
    assert not np.array_equal(got[0]["log_step_eta"], state["log_step_eta"])


@pytest.mark.parametrize("chees", [False, True])
def test_hmc_block_reference_matches_ptnn(rng, chees):
    c = 6  # 2 ladders of 3 rungs: one panel
    data, state, noise, at = _inputs(rng, c, hmc=True, chees=chees)
    start, length = 2, 11
    scal = _scal(hmc=True, chees=chees)
    ref = _run_ptnn(True, data, state, noise, at, start, length, scal, True)
    got = _run_port(True, data, state, noise, at, start, length, scal, True)
    na = got[0]["n_accept"]
    assert 3 * c <= na.sum() < length * c, na
    _assert_match(got, ref, length)
    tl = got[1]["traj_len"][:length]
    assert tl.min() >= 1 and tl.max() <= scal["leapfrog"]
    if chees:
        assert len(np.unique(tl)) > 1  # per-chain realized lengths vary
        assert not np.allclose(got[0]["log_traj"], state["log_traj"])
    else:
        assert "log_traj" not in got[0] and np.all(tl == scal["leapfrog"])


def test_hmc_chees_multipanel_matches_ptnn(rng):
    """256 chains = 2 panels of 32 four-rung ladders: each panel pools its
    own replicas, as ptnn's two 128-lane blocks do."""
    c, rungs = 256, 4
    data, state, noise, at = _inputs(rng, c, hmc=True, chees=True)
    start, length = 5, 4  # adapting steps 5..8
    scal = _scal(hmc=True, chees=True, rungs=rungs, n_ladders=LANES // rungs)
    assert precond_step.panel_layout(c, rungs) == (LANES, LANES // rungs)
    ref = _run_ptnn(True, data, state, noise, at, start, length, scal, False)
    got = _run_port(True, data, state, noise, at, start, length, scal, False)
    _assert_match(got, ref, length)
    # each panel adapts from its own replicas
    lt = got[0]["log_traj"].reshape(2, LANES)
    assert not np.allclose(lt[0], lt[1])


@pytest.mark.parametrize("hmc", [False, True])
def test_zero_length_block_changes_nothing(rng, hmc):
    data, state, noise, at = _inputs(rng, 6, hmc=hmc, chees=hmc)
    scal = _scal(hmc=hmc, chees=hmc)
    ref = _run_ptnn(hmc, data, state, noise, at, 7, 0, scal, False)
    got = _run_port(hmc, data, state, noise, at, 7, 0, scal, False)
    _assert_match(got, ref, 0)
    for k, v in state.items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)


def test_fused_blocks_route_cpu_tensors_to_the_plain_version(rng):
    data, state, noise, at = _inputs(rng, 6, hmc=True, chees=True)
    scal = _scal(hmc=True, chees=True)
    before = dict(precond_step.launches)
    for hmc, fn in ((False, precond_step.fused_mala_block),
                    (True, precond_step.fused_hmc_block)):
        sc = scal if hmc else _scal()
        st = state if hmc else {k: v for k, v in state.items()
                                if k not in ("log_traj", "chees_m1",
                                             "chees_v2")}
        ref = _run_port(hmc, data, st, noise, at, 2, 9, sc, True)
        got = _run_port(hmc, data, st, noise, at, 2, 9, sc, True, fn=fn)
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert precond_step.launches == before  # CPU tensors launch nothing
    t = lambda a: torch.from_numpy(np.array(a))
    mixed = {k: t(v) for k, v in noise.items()}
    mixed["u"] = mixed["u"].to("meta")
    with pytest.raises(ValueError, match="one device type"):
        precond_step.fused_hmc_block(
            {k: t(v) for k, v in state.items()}, mixed, 0, 4,
            block_step.prep_data(*map(t, data)), t(at), TOPO, scal)


def test_neg_half_sse_grad_matches_ptnn_and_autograd(rng):
    prob = load_regression("Sunspot")
    cfg = ptnn.PTConfig(task="regression", topology=TOPO, num_samples=5 * 20,
                        num_chains=5, proposal="precond_mala").validate()
    jdata = jsampler.make_dataset(cfg, prob.train, prob.test)
    w = (rng.normal(size=(5, W)) * 1.5).astype(np.float32)
    (jval, _fx), jg = jkernel._like_value_and_grad(
        cfg, jkernel.default_spec(cfg), jdata)(jnp.asarray(w))
    tdata = make_dataset(cfg, prob.train, prob.test, "cpu")
    val, g = fnn.neg_half_sse_grad(torch.from_numpy(w), tdata.x_train,
                                   tdata.y_train, TOPO)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=2e-5)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * scale)
    w64 = torch.from_numpy(w).double().requires_grad_()
    x64, y64 = tdata.x_train.double(), tdata.y_train.double()
    fx = fnn.batched_forward(w64, x64, TOPO)[:, :, 0]
    (-0.5 * torch.sum((y64 - fx) ** 2)).backward()
    val64, g64 = fnn.neg_half_sse_grad(w64.detach(), x64, y64, TOPO)
    torch.testing.assert_close(g64, w64.grad, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), w64.grad.numpy(), rtol=1e-4,
                               atol=1e-5 * scale)


def test_vdc_u_matches_ptnn_bit_for_bit():
    idx = np.concatenate([
        np.arange(2 ** 16), 2 ** 31 + np.arange(-300, 300),
        2 ** 32 - 1 - np.arange(600), [2 ** 32 - 1],
    ]).astype(np.int64)
    ref = np.asarray(jkernel.vdc_u(jnp.asarray(idx.astype(np.uint32))))
    got = kernel.vdc_u(torch.from_numpy(idx)).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    assert float(kernel.vdc_u(5)) == float(jkernel.vdc_u(5))


def _cfg_kw(**kw):
    base = dict(task="regression", topology=TOPO, num_samples=8 * 50,
                num_chains=8, n_ladders=2, maxtemp=5.0, swap_interval=10,
                swap_style="even_odd", proposal="hmc", hmc_leapfrog=4,
                hmc_adapt_traj=True, warmstart_frac=0.1,
                precond_start_frac=0.3, step_w=0.01, track_replicas=True,
                fused_step=True)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [dict(proposal="precond_mala",
                                     hmc_adapt_traj=False),
                                dict(hmc_adapt_traj=False), dict()])
def test_precond_init_state_matches_ptnn(rng, kw):
    prob = load_regression("Sunspot")
    jcfg = ptnn.PTConfig(**_cfg_kw(**kw)).validate()
    tcfg = ptnn_torch.PTConfig(**_cfg_kw(**kw)).validate()
    init_w = rng.normal(size=(8, W)).astype(np.float32)
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
    assert (got["log_traj"] is not None) == (kw == {})


def test_do_swap_permutes_g_like_with_w_under_deo(rng):
    prob = load_regression("Sunspot")
    jcfg = ptnn.PTConfig(**_cfg_kw()).validate()
    tcfg = ptnn_torch.PTConfig(**_cfg_kw()).validate()
    jdata = jsampler.make_dataset(jcfg, prob.train, prob.test)
    temps = jnp.asarray(ptnn.ops.ladder.build_temperatures(jcfg), jnp.float32)
    jst = jkernel.init_state(jax.random.PRNGKey(3), jcfg, jdata)
    # close payloads, so that some pairs swap and some do not
    jst = jst._replace(ll=jnp.asarray(-50.0 + 5.0 * rng.normal(size=8),
                                      jnp.float32))
    step = jkernel.make_step_fn(jcfg, jdata, temps)
    src = {k: (None if v is None else np.asarray(v))
           for k, v in jax.device_get(jst)._asdict().items()}
    tst = convert.chain_state_from_numpy(src)
    pair_mask = ptnn_torch.parallel.swap.pair_mask(8, tcfg.rungs_per_ladder)
    assert pair_mask is not None and not bool(pair_mask.all())
    for i, ks in ((9, jax.random.PRNGKey(5)), (19, jax.random.PRNGKey(6))):
        ref = step.do_swap(jst, i, ks)
        us = torch.from_numpy(np.array(jax.random.uniform(ks, (7,))))
        got = kernel.do_swap(tcfg, tst, torch.from_numpy(np.array(temps)),
                             i, us, pair_mask)
        rid = np.asarray(ref.replica_id)
        np.testing.assert_array_equal(got.replica_id.numpy(), rid)
        assert not np.array_equal(rid, np.arange(8))
        for k in ("w", "g_like", "eta", "ll"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)))
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          src[k][rid])
        for k in ("pc_mean", "pc_m2", "log_step_w", "log_traj"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), src[k])


@pytest.mark.parametrize("chains,rungs", [(8, 4), (52, 4), (96, 4),
                                          (128, 4), (256, 4), (1024, 4),
                                          (384, 8), (120, 3)])
def test_hmc_panel_and_cluster_layout_match_ptnn(chains, rungs):
    """The HMC kernel's ChEES layout (``hmc_layout``, ``exchange_reads``:
    the arithmetic of csrc/hmc_block.cu) against ptnn's
    ``rung_sum_matrix``: the chains a chain sums are exactly its rung's
    replicas in its panel (one (128, 128) matrix per panel past 128 chains,
    ``ptnn/fused.py:414-428``), each once, in replica order, and all in its
    own panel's blocks, 8 chains a block and at most 16 blocks a panel."""
    panel, n_lad = precond_step.panel_layout(chains, rungs)
    blocks, cluster = precond_step.hmc_layout(chains, panel)
    assert precond_step._hmc("HMC_WARPS") == 8
    assert precond_step._mala_warps() == 8
    assert blocks == -(-chains // 8) and cluster == -(-panel // 8) <= 16
    if chains > 128:
        assert blocks % cluster == 0 and blocks // cluster == chains // 128
        want = np.kron(np.eye(chains // 128), np.asarray(
            ps.rung_sum_matrix(128, rungs, 128)))
    else:
        assert cluster == blocks
        want = np.asarray(ps.rung_sum_matrix(chains, rungs, chains))
    reads = precond_step.exchange_reads(chains, rungs)
    assert reads.shape == (chains, n_lad)
    got = np.zeros((chains, chains))
    np.add.at(got, (np.arange(chains)[:, None], reads), 1.0)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(reads, axis=1) == rungs).all()  # replica order
    own = np.arange(chains) // 8 // cluster  # the panel of a chain's block
    assert (reads // 8 // cluster == own[:, None]).all()
    # the rung sums of the plain version agree with the same reads
    x = torch.arange(chains, dtype=torch.float64) ** 1.5
    torch.testing.assert_close(
        precond_step.rung_sum(x, panel, rungs),
        x[torch.from_numpy(reads)].sum(dim=1), rtol=0, atol=1e-9)


def test_hmc_layouts_that_do_not_fit_are_refused():
    """A panel that does not tile the chains, or a second panel of another
    size than 128, is refused before any launch; without ChEES any chain
    count runs. HMC blocks hold 8 chains; MALA's 8 warps hold a broadcast
    slot and two parities of a partial slot each, whatever the warps a
    chain; shared memory follows."""
    assert precond_step.hmc_layout(130) == (17, 1)
    for chains, panel in ((256, 64), (100, 64), (200, 100)):
        with pytest.raises(ValueError, match="does not tile"):
            precond_step.hmc_layout(chains, panel)
    with pytest.raises(ValueError, match="complete ladders"):
        precond_step.panel_layout(160, 4)
    rows = 496 * 5  # 496 rows of 4 inputs and a target, a multiple of 4
    mala = precond_step.smem_bytes(496, 4, False)
    hmc = precond_step.smem_bytes(496, 4, True, hmc=True)
    assert mala == 4 * (rows + 8 * 3 * 64)
    assert hmc == 4 * (rows + 8 * (6 * 64 + 2 * (2 * 64 + 4)))
    assert precond_step.hmc_route("cpu", hmc, 1, 128, chees=False)[0] == (
        "plain")


# ---------------------------------------------------------------------------
# The MALA kernel's launch plan (``precond_step.mala_launch_plan``): pure
# Python, fed the card's SM count (132 on the H100); the rule is
# ``precond_step.warp_plan``, which the iris MALA kernel's plan shares.

SUNSPOT_ROWS = 298 + 198


@pytest.mark.parametrize("chains", [1, 52, 64, 130, 256, 1024, 2000])
def test_mala_plan_covers_every_chain_once(chains):
    """Every chain sits in exactly one (block, chain slot) of WPC warps; the
    blocks are 8 warps; shared memory fits a Hopper block."""
    plan = precond_step.mala_launch_plan(chains, SUNSPOT_ROWS, 132)
    assert plan.wpc in precond_step.MALA_WPCS
    assert plan.per_block * plan.wpc == 8
    assert plan.blocks == -(-chains // plan.per_block)
    slots = np.arange(plan.blocks * plan.per_block)
    chain = (slots // plan.per_block) * plan.per_block + slots % plan.per_block
    np.testing.assert_array_equal(np.sort(chain[chain < chains]),
                                  np.arange(chains))
    assert (plan.blocks - 1) * plan.per_block < chains  # no empty block
    assert plan.smem == precond_step.smem_bytes(SUNSPOT_ROWS, 4, False)
    assert plan.smem <= precond_step._SMEM_LIMIT


@pytest.mark.parametrize("chains, sms, want", [
    (64, 132, (8, 1, 64)), (130, 132, (8, 1, 130)), (1024, 132, (1, 8, 128)),
    (52, 132, (8, 1, 52)), (1, 132, (8, 1, 1)), (256, 132, (4, 2, 128)),
    (264, 132, (4, 2, 132)), (266, 132, (2, 4, 67)),
    (2000, 132, (1, 8, 250)),
    # fewer SMs: step down
    (64, 16, (2, 4, 16)), (64, 8, (1, 8, 8)), (130, 8, (1, 8, 17))])
def test_mala_plan_picks_warps_by_the_rule(chains, sms, want):
    """The largest WPC whose blocks fit one wave of the card's SMs (one
    block an SM), else one warp a chain in waves: on the H100's 132 SMs
    WPC 8 (one chain a block) at the path's 64 chains and at 130, WPC 4 at
    256 (128 blocks), WPC 1 at 1024 (128 blocks); on a card with fewer SMs
    the plan steps down."""
    plan = precond_step.mala_launch_plan(chains, SUNSPOT_ROWS, sms)
    assert (plan.wpc, plan.per_block, plan.blocks) == want
    assert ("waves" in plan.why) == (plan.blocks > sms)


@pytest.mark.parametrize("chains, sms", [(64, 132), (1024, 132), (266, 132),
                                         (64, 16), (2000, 132), (130, 132)])
def test_both_mala_plans_take_one_rule(chains, sms):
    """The regression and the iris MALA plans are ``warp_plan`` over their
    own kernels' WPCs (the regression kernel adds 8) at their own shared
    memory; where one chain a block does not fit one wave, both take the
    same warps a chain, blocks and reason."""
    from ptnn_torch.ops import precond_cls_step

    reg = precond_step.mala_launch_plan(chains, SUNSPOT_ROWS, sms)
    cls = precond_cls_step.mala_launch_plan(chains, 150, (4, 12, 3), sms)
    assert reg == precond_step.warp_plan(chains, 8, sms,
                                         precond_step.MALA_WPCS, reg.smem)
    assert cls == precond_step.warp_plan(chains, 8, sms,
                                         precond_cls_step.WPCS, cls.smem)
    assert precond_step.MALA_WPCS == (8,) + precond_cls_step.WPCS
    if chains > sms:
        assert reg[:3] == cls[:3] and reg.why == cls.why
    else:
        assert (reg.wpc, reg.blocks, cls.wpc) == (8, chains, 4)


@pytest.mark.parametrize("wpc", [8, 4, 2, 1])
def test_mala_smem_layout_matches_the_wrapper(wpc):
    """csrc/mala_block.cu's offsets: the rows padded to 16 bytes, a
    VEC-float broadcast slot per warp, then per chain two parities of WPC
    VEC-float partial slots. The last chain's last partial slot ends where
    the wrapper's shared memory ends, at every WPC; every slot starts on
    16 bytes (float4 and float2 loads)."""
    vec, warps = precond_step._common("VEC"), precond_step._mala_warps()
    for n_rows, n_in in ((SUNSPOT_ROWS, 4), (37 + 23, 4), (7, 4)):
        row_floats = (n_rows * (n_in + 1) + 3) & ~3
        wb = [row_floats + w * vec for w in range(warps)]
        part = [row_floats + warps * vec + cl * 2 * wpc * vec
                for cl in range(warps // wpc)]
        end = part[-1] + 2 * wpc * vec
        assert all(o % 4 == 0 for o in wb + part)
        assert wb[-1] + vec == part[0]
        assert 4 * end == precond_step.smem_bytes(n_rows, n_in, False)
