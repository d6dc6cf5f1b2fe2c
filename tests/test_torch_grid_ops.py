"""The grid's arguments of the port's ops against ptnn's masked ones.

A grid (``ptnn_torch.sweeps``) gives the drift and the eval each cell's own
rows (x (G, N, I), padded to the largest set), each cell's count of valid
rows and of real classes, a parameter mask a cell and a drift rate a chain.
The plain versions here are held to ptnn's on the same inputs: the masked
``sgd_epoch_sequential`` and ``sgd_epoch_batch`` (``mask``, ``w_mask``)
vmapped over cells and chains, and the masked likelihood with ptnn's -1e9
class fill (ptnn/kernel.py:258-270), at rtol 2e-4, atol 2e-5, the padded
parameters exactly 0. ``tests/test_torch_cuda_kernels.py`` holds the CUDA
routes to these plain versions on the card. Also: the port reads
bank-additional without pandas, as ptnn's pandas reader does.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn import data as jdata
from ptnn import sweeps as jsweeps
from ptnn.models import fnn as jfnn
from ptnn.ops import drift as jdrift
from ptnn.ops import likelihood as jlik
from ptnn_torch import sampler
from ptnn_torch.models import fnn
from ptnn_torch.ops import drift, fnn_eval, likelihood

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid(rng, topo, rows, cpc, task, env=None, classes=None):
    """Random grid inputs: G = len(rows) cells of ``cpc`` chains, each
    cell's valid rows first and zero rows after, the envelope ``env``
    (default ``topo``) and each cell's ``classes``; weights with the
    cell's parameter mask applied (zeros outside its own network)."""
    env = env or topo
    g, n = len(rows), max(rows)
    i, _h, o = env
    x = np.zeros((g, n, i), np.float32)
    y = np.zeros((g, n), np.float32)
    wm = np.ones((g, fnn.w_size(env)), np.float32)
    cls = classes or [o] * g
    for k, r in enumerate(rows):
        x[k, :r, :topo[0]] = rng.normal(size=(r, topo[0]))
        y[k, :r] = (rng.integers(0, cls[k], size=r) if task ==
                    "classification" else rng.uniform(size=r))
        if env != topo or classes is not None:
            wm[k] = sampler.envelope_w_mask((topo[0], topo[1], cls[k]), env)
    w = (rng.normal(size=(g * cpc, fnn.w_size(env))) * 0.5).astype(
        np.float32) * np.repeat(wm, cpc, axis=0)
    return x, y, w, wm


def _targets(y, o, task):
    if task == "classification":
        return np.eye(o, dtype=np.float32)[y.astype(np.int64)]
    return y[..., None]


@pytest.mark.parametrize("mode", ["sequential", "batch"])
@pytest.mark.parametrize("case", ["regression", "envelope"])
def test_grid_drift_matches_ptnn(rng, mode, case):
    """Each cell's rows and row count, a rate a chain, and (envelope) the
    parameter mask: the port's epoch against ptnn's masked epoch of every
    chain on its cell's rows."""
    if case == "regression":
        topo, env, task, classes = (4, 10, 1), None, "regression", None
        rows = [30, 22, 30]
    else:
        topo, env, task = (3, 5, 3), (4, 7, 3), "classification"
        rows, classes = [25, 17, 9], [3, 2, 3]
    cpc = 3
    x, y, w, wm = _grid(rng, topo, rows, cpc, task, env, classes)
    o = (env or topo)[2]
    t = _targets(y, o, task)
    lr = rng.uniform(0.005, 0.1, size=len(rows) * cpc).astype(np.float32)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    rows_t = torch.tensor(rows, dtype=torch.int32)
    masked = case == "envelope"
    got = drift.sgd_epoch(tt(w), tt(x), tt(t), env or topo, tt(lr),
                          mode=mode, rows=rows_t,
                          w_mask=tt(wm) if masked else None).numpy()
    mask = (np.arange(x.shape[1])[None, :] < np.asarray(rows)[:, None]
            ).astype(np.float32)
    fn = (jdrift.sgd_epoch_sequential if mode == "sequential"
          else jdrift.sgd_epoch_batch)

    def cell(wc, xc, tc, mc, wmc, lrc):
        return jax.vmap(lambda wi, li: fn(
            wi, xc, tc, env or topo, li, mask=mc,
            w_mask=wmc if masked else None))(wc, lrc)

    want = np.asarray(jax.vmap(cell)(
        jnp.asarray(w.reshape(len(rows), cpc, -1)), jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(mask), jnp.asarray(wm),
        jnp.asarray(lr.reshape(len(rows), cpc)))).reshape(w.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want - w).max() > 1e-3
    if masked:
        off = np.repeat(wm, cpc, axis=0) == 0
        assert (got[off] == 0).all()


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_grid_eval_matches_ptnn(rng, task):
    """The eval of each cell's chains on its own rows, valid rows and real
    classes against ptnn's masked likelihood and metrics (true divisions by
    the row count; the padded class columns filled with -1e9 before the
    log-softmax and the argmax)."""
    if task == "regression":
        topo, env, classes, rows = (4, 10, 1), None, None, [40, 31, 12]
    else:
        topo, env, classes, rows = (3, 6, 4), (5, 6, 4), [4, 2, 3], [35, 20, 8]
    cpc = 4
    x, y, w, _wm = _grid(rng, topo, rows, cpc, task, env, classes)
    tau = rng.uniform(0.01, 0.2, size=len(rows) * cpc).astype(np.float32)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ll, rmse, acc = fnn_eval.fnn_eval(
        tt(w), tt(x), tt(y), tt(tau), env or topo, task,
        rows=torch.tensor(rows, dtype=torch.int32),
        classes=None if classes is None else torch.tensor(classes,
                                                          dtype=torch.int32))
    n = x.shape[1]
    for k, r in enumerate(rows):
        sl = slice(k * cpc, (k + 1) * cpc)
        m = jnp.asarray((np.arange(n) < r).astype(np.float32))
        out = jax.vmap(lambda wi: jfnn.forward(wi, jnp.asarray(x[k]),
                                               env or topo))(jnp.asarray(w[sl]))
        if task == "regression":
            ev = jax.vmap(lambda f, ta: jlik.regression_eval_from_fx(
                f, jnp.asarray(y[k]), ta, m))(out[:, :, 0], jnp.asarray(tau[sl]))
            want_acc = np.zeros(cpc, np.float32)
        else:
            cm = jnp.arange(out.shape[-1]) < classes[k]
            out = jnp.where(cm, out, -1e9)
            ev = jax.vmap(lambda lp, oo: jlik.classification_eval_from_logp(
                lp, oo, jnp.asarray(y[k]), m))(jax.nn.log_softmax(out, -1), out)
            want_acc = np.asarray(ev.acc)
        np.testing.assert_allclose(ll[sl].numpy(), np.asarray(ev.loglik),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rmse[sl].numpy(), np.asarray(ev.rmse),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(acc[sl].numpy(), want_acc)


def test_masked_likelihood_matches_ptnn(rng):
    """The masked likelihood and metrics on their own (a padded row adds
    nothing, the counts divide), against ptnn's."""
    n, pad = 30, 9
    fx = rng.normal(size=(3, n + pad)).astype(np.float32)
    y = rng.normal(size=n + pad).astype(np.float32)
    tau = rng.uniform(0.05, 0.2, size=3).astype(np.float32)
    m = np.r_[np.ones(n), np.zeros(pad)].astype(np.float32)
    got = likelihood.regression_eval_from_fx(
        torch.from_numpy(fx), torch.from_numpy(y), torch.from_numpy(tau),
        torch.from_numpy(m))
    want = jax.vmap(lambda f, t: jlik.regression_eval_from_fx(
        f, jnp.asarray(y), t, jnp.asarray(m)))(jnp.asarray(fx),
                                               jnp.asarray(tau))
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(want.loglik),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(want.rmse),
                               rtol=RTOL, atol=ATOL)
    out = rng.uniform(size=(3, n + pad, 4)).astype(np.float32)
    lab = rng.integers(0, 4, size=n + pad).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(out), -1))
    got = likelihood.classification_eval_from_logp(
        torch.from_numpy(lp), torch.from_numpy(out), torch.from_numpy(lab),
        torch.from_numpy(m))
    want = jax.vmap(lambda a, b: jlik.classification_eval_from_logp(
        a, b, jnp.asarray(lab), jnp.asarray(m)))(jnp.asarray(lp),
                                                 jnp.asarray(out))
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(want.loglik),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.acc.numpy(), np.asarray(want.acc))
    np.testing.assert_array_equal(got.rmse.numpy(), np.asarray(want.rmse))


def test_envelope_mask_and_grid_dataset_match_ptnn():
    """``sampler.envelope_w_mask`` is ptnn's; ``make_grid_dataset`` pads
    rows and columns as ptnn's ``classification_grid`` does and gives the
    kernels each cell's row and class counts."""
    for small, env in (((4, 12, 3), (9, 12, 3)), ((9, 12, 2), (34, 50, 3))):
        np.testing.assert_array_equal(sampler.envelope_w_mask(small, env),
                                      jsweeps.envelope_w_mask(small, env))
    import ptnn_torch

    probs = [jdata.load_classification(n) for n in ("iris", "Cancer")]
    cfg = ptnn_torch.classification_preset((9, 12, 3), num_samples=40,
                                           num_chains=4)
    d = sampler.make_grid_dataset(
        cfg, [(p.train, p.test, p.topology) for p in probs], "cpu",
        envelope=True)
    assert d.x_train.shape == (2, 489, 9) and d.t_train.shape == (2, 489, 3)
    assert d.rows_train.tolist() == [105, 489]
    assert d.rows_test.tolist() == [45, 210]
    assert d.classes.tolist() == [3, 2]
    assert float(d.x_train[0, :, 4:].abs().max()) == 0.0
    assert float(d.t_train[1, :, 2].abs().max()) == 0.0


def test_bank_additional_loads_without_pandas():
    """The port reads bank.csv with the csv module and NumPy: the machine
    that runs the port has no pandas. Its rows equal ptnn's (pandas)
    loader's, bit for bit."""
    code = ("import sys, numpy as np\n"
            "sys.modules['pandas'] = None\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from ptnn_torch import data\n"
            "p = data.load_classification('bank-additional')\n"
            "np.save(sys.argv[1], np.concatenate([p.train, p.test]))\n"
            "print(p.topology)\n")
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"bank_{os.getpid()}.npy")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, path],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(51, 50, 2)"
    got = np.load(path)
    os.remove(path)
    ref = jdata.load_classification("bank-additional")
    np.testing.assert_array_equal(got, np.concatenate([ref.train, ref.test]))
