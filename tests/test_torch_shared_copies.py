"""The port's own copies of ptnn's NumPy modules against the originals.

``ptnn_torch.{config,data}`` and ``ptnn_torch.ops.{ladder,roundtrip,ess}``
are copies of ``ptnn``'s modules (the port loads no file of ``ptnn/``).
They must give the same arrays and the same configurations: the datasets,
the temperature ladders, the round-trip and ESS diagnostics, ``PTConfig``'s
fields and defaults, the presets, and every bench.py variant the port runs.
Also here: ``predict.posterior_predict`` against ptnn's.
"""

import dataclasses

import numpy as np
import pytest

import bench
import ptnn
import ptnn_torch
from ptnn import data as jdata
from ptnn import predict as jpredict
from ptnn.ops import ess as jess
from ptnn.ops import ladder as jladder
from ptnn.ops import roundtrip as jroundtrip
from ptnn_torch import data as tdata
from ptnn_torch import fused as tfused
from ptnn_torch import predict as tpredict
from ptnn_torch.ops import ess as tess
from ptnn_torch.ops import ladder as tladder
from ptnn_torch.ops import roundtrip as troundtrip

DERIVED = ("samples_per_chain", "n_steps", "temper_switch_step", "w_size",
           "rungs_per_ladder", "swaps_enabled")


def _same_config(jcfg, tcfg):
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for name in DERIVED:
        assert getattr(jcfg, name) == getattr(tcfg, name), name
    np.testing.assert_array_equal(jladder.build_temperatures(jcfg),
                                  tladder.build_temperatures(tcfg))


def test_ptconfig_fields_and_defaults_match_ptnn():
    jf = {f.name: f for f in dataclasses.fields(ptnn.PTConfig)}
    tf = {f.name: f for f in dataclasses.fields(ptnn_torch.PTConfig)}
    assert list(jf) == list(tf)
    for name, f in jf.items():
        assert f.default == tf[name].default, name
    kw = dict(task="classification", topology=(4, 12, 3))
    _same_config(ptnn.PTConfig(**kw).validate(),
                 ptnn_torch.PTConfig(**kw).validate())


@pytest.mark.parametrize("name, kw", [
    ("regression_preset", dict()),
    ("regression_preset", dict(num_samples=8000, num_chains=8)),
    ("classification_preset", dict(topology=(4, 12, 3),
                                   num_samples=50_000)),
    ("classification_preset", dict(topology=(34, 50, 2), num_samples=8000,
                                   num_chains=16, maxtemp=5.0,
                                   canonical=True)),
])
def test_presets_match_ptnn(name, kw):
    _same_config(getattr(ptnn, name)(**kw), getattr(ptnn_torch, name)(**kw))


def _port_cfg(jcfg):
    return ptnn_torch.PTConfig(**dataclasses.asdict(jcfg)).validate()


def test_bench_variants_the_port_runs_match_ptnn():
    reg = bench._variants(64, 100)
    names = ("rw_fused", "mala_fused_16x4", "chees16_fused_256x4")
    cls = bench._cls_variants((4, 12, 3), steps_per_chain=100)
    for jcfg in [reg[n] for n in names if n in reg] + list(cls.values()):
        tcfg = _port_cfg(jcfg)
        _same_config(jcfg, tcfg)
        assert tfused.fused_reason(tcfg) is None
    assert set(cls) == {"chees16_fused_16x4", "chees16_fused_64x4",
                        "mala_fused_16x4"}


@pytest.mark.parametrize("name", ["iris", "Ionosphere", "Cancer", "TicTac",
                                  "winequality-red"])
def test_load_classification_matches_ptnn(name):
    for seed in (0, 3):
        j = jdata.load_classification(name, seed=seed)
        t = tdata.load_classification(name, seed=seed)
        assert (t.name, t.task, t.topology) == (j.name, j.task, j.topology)
        np.testing.assert_array_equal(t.train, j.train)
        np.testing.assert_array_equal(t.test, j.test)


def test_load_regression_and_data_root_match_ptnn():
    assert tdata.data_root() == jdata.data_root()
    for name in ("Sunspot", "Lazer"):
        j, t = jdata.load_regression(name), tdata.load_regression(name)
        np.testing.assert_array_equal(t.train, j.train)
        np.testing.assert_array_equal(t.test, j.test)
        assert t.topology == j.topology == (4, 10, 1)


def test_roundtrip_and_ess_match_ptnn(rng):
    # two ladders of 4 rungs: each permutes its own replicas
    reps = np.stack([np.concatenate([rng.permutation(4), 4 + rng.permutation(4)])
                     for _ in range(400)]).astype(np.int32)
    j = jroundtrip.roundtrip_stats(reps, n_ladders=2)
    t = troundtrip.roundtrip_stats(reps, n_ladders=2)
    for field in j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t, field)),
                                      np.asarray(getattr(j, field)),
                                      err_msg=field)
    x = np.cumsum(rng.normal(size=(600, 3, 5)), axis=0)
    assert tess.pooled_multi_ess(x) == jess.pooled_multi_ess(x)
    assert tess.split_rhat(x[:, :, 0]) == jess.split_rhat(x[:, :, 0])
    # the copy's function_space_rhat runs its forward in PyTorch, held to
    # ptnn's in tests/test_torch_precond_zoo.py
    assert callable(tess.function_space_rhat)


def test_posterior_predict_matches_ptnn(rng):
    prob = jdata.load_classification("iris")
    cfg = ptnn.classification_preset((4, 12, 3), num_samples=1000)
    draws = rng.normal(size=(300, 99)).astype(np.float32)
    x = prob.test[:, :4]
    j = jpredict.posterior_predict(cfg, draws, x, batch=128)
    t = tpredict.posterior_predict(_port_cfg(cfg), draws, x, batch=128,
                                   device="cpu")
    np.testing.assert_allclose(t["probs"], j["probs"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t["label"], j["label"])
    np.testing.assert_allclose(t["entropy"], j["entropy"], rtol=1e-5)
    rcfg = ptnn.regression_preset(num_samples=800, num_chains=8)
    rdraws = rng.normal(size=(200, 61)).astype(np.float32)
    rx = jdata.load_regression("Sunspot").test[:, :4]
    j = jpredict.posterior_predict(rcfg, rdraws, rx)
    t = tpredict.posterior_predict(_port_cfg(rcfg), rdraws, rx, device="cpu")
    for k in ("mean", "low", "high", "std"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["cnn", "mlp", "mlp_regression"])
def test_posterior_predict_with_a_spec_matches_ptnn(rng, model):
    """``spec=`` serves draws of a zoo model, as ptnn's: a small digits CNN
    and a deep MLP (classification), and an MLP regressor, on the same
    numpy draws. Tolerance rtol 1e-5, atol 1e-6: the forward passes sum in
    another order."""
    from ptnn.models import cnn as jcnn
    from ptnn.models import mlp as jmlp

    if model == "cnn":
        jspec = jcnn.digits_spec(channels=(4,), hidden=8)
        tspec = ptnn_torch.cnn.digits_spec(channels=(4,), hidden=8)
        cfg = ptnn.classification_preset((64, 8, 10), num_samples=1000)
        x = tdata.load_digits(0).test[:40, :64]
    elif model == "mlp":
        jspec = jmlp.spec((64, 16, 12, 10))
        tspec = ptnn_torch.mlp.spec((64, 16, 12, 10))
        cfg = ptnn.classification_preset((64, 16, 10), num_samples=1000)
        x = tdata.load_digits(0).test[:40, :64]
    else:
        jspec = jmlp.spec((4, 8, 6, 1), task="regression")
        tspec = ptnn_torch.mlp.spec((4, 8, 6, 1), task="regression")
        cfg = ptnn.regression_preset(num_samples=800, num_chains=8)
        x = jdata.load_regression("Sunspot").test[:, :4]
    assert tspec.w_size == jspec.w_size
    draws = (rng.normal(size=(150, tspec.w_size)) * 0.3).astype(np.float32)
    j = jpredict.posterior_predict(cfg, draws, x, batch=64, spec=jspec)
    t = tpredict.posterior_predict(_port_cfg(cfg), draws, x, batch=64,
                                   device="cpu", spec=tspec)
    assert set(t) == set(j)
    for k in t:
        if k == "label":
            np.testing.assert_array_equal(t[k], j[k])
        else:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    with pytest.raises(ValueError, match="draws must be"):
        tpredict.posterior_predict(_port_cfg(cfg), draws[:, 1:], x,
                                   device="cpu", spec=tspec)
    for kw in (dict(noise="conditional"), dict(return_samples=True)):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            tpredict.posterior_predict(_port_cfg(cfg), draws, x, device="cpu",
                                       spec=tspec, **kw)
