"""The port's run reports (``ptnn_torch.results``) against ptnn's.

One run of the port's sampler (the CPU, small) is handed to both packages:
the port's ``SampleResult`` as it is, and the same traces and numbers in a
``ptnn.sampler.SampleResult`` with ptnn's config of the same fields. Every
file of the artifact tree is equal byte for byte (``metrics.jsonl`` after
its timestamp), and so are the summaries, the pooled posterior and the
master row.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import results as jresults
from ptnn import sampler as jsampler
from ptnn.data import load_digits, load_regression
from ptnn_torch import results
from ptnn_torch.models import cnn

torch.set_num_threads(1)


def _run(case):
    if case == "sunspot":
        prob = load_regression("Sunspot")
        kw = dict(ptnn.regression_preset(
            num_samples=6 * 30, num_chains=6, maxtemp=3.0).__dict__,
            swap_interval=5, record_w=True, learn_rate=0.01)
        spec, name = None, "Sunspot"
        train, test = prob.train, prob.test
    elif case == "sunspot_ladders":
        prob = load_regression("Sunspot")
        kw = dict(ptnn.regression_preset(
            num_samples=8 * 20, num_chains=8, maxtemp=3.0,
            use_langevin_gradients=False).__dict__,
            swap_interval=5, record_w=True, record_w_chains=1, n_ladders=2)
        spec, name = None, "Sunspot"
        train, test = prob.train, prob.test
    else:
        prob = load_digits(0)
        kw = dict(ptnn.classification_preset(
            (64, 16, 10), num_samples=4 * 20, num_chains=4, maxtemp=3.0,
            use_langevin_gradients=True, learn_rate=5e-5).__dict__,
            swap_interval=5, step_w=0.01, record_w=False)
        spec = cnn.digits_spec(channels=(4,), hidden=16, fused_eval=True)
        name, train, test = "digits", prob.train[:48], prob.test[:24]
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    res = ptnn_torch.sample(tcfg, train, test, seed=1, device="cpu",
                            model_spec=spec)
    jres = jsampler.SampleResult(
        traces=res.traces, final_state=None, temperatures=res.temperatures,
        accept_ratio_per_chain=res.accept_ratio_per_chain,
        swap_percent=res.swap_percent,
        langevin_ratio_per_chain=res.langevin_ratio_per_chain,
        elapsed_s=res.elapsed_s, chain_steps_per_sec=res.chain_steps_per_sec,
        config=ptnn.PTConfig(**kw).validate(),
        pair_swap_accept=res.pair_swap_accept)
    return res, jres, name


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("case", ["sunspot", "sunspot_ladders", "digits"])
def test_artifact_tree_equals_ptnn(case, tmp_path):
    res, jres, name = _run(case)
    a = results.versioned_dir(str(tmp_path / "port"), name)
    b = jresults.versioned_dir(str(tmp_path / "ptnn"), name)
    assert os.path.basename(a) == os.path.basename(b) == f"{name}_0"
    assert results.versioned_dir(str(tmp_path / "port"), name).endswith("_1")
    s = results.write_artifacts(res, a, name, plots=False)
    js = jresults.write_artifacts(jres, b, name, plots=False)
    assert s == results.Summary(**vars(js))
    np.testing.assert_array_equal(s.row(), js.row())
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    assert len(ta) >= 4 + 7 * res.config.num_chains
    for rel in ta:
        if rel == "metrics.jsonl":
            ma, mb = json.loads(ta[rel]), json.loads(tb[rel])
            assert ma.pop("ts") > 0 and mb.pop("ts") > 0
            assert ma == mb
        else:
            assert ta[rel] == tb[rel], rel
    assert any(k.startswith(os.path.join("posterior", "pos_w"))
               for k in ta) == res.config.record_w
    cold, jcold = (results.summarize(res, name, cold_only=True),
                   jresults.summarize(jres, name, cold_only=True))
    assert vars(cold) == vars(jcold)
    if res.config.record_w:
        np.testing.assert_array_equal(results.pooled_posterior(res),
                                      jresults.pooled_posterior(jres))
    results.append_master_row(str(tmp_path / "m" / "port.txt"), s, "run")
    jresults.append_master_row(str(tmp_path / "m" / "ptnn.txt"), js, "run")
    with open(tmp_path / "m" / "port.txt", "rb") as f1, \
            open(tmp_path / "m" / "ptnn.txt", "rb") as f2:
        assert f1.read() == f2.read()


def test_cnn_digits_cli_writes_the_tree_and_refuses_what_is_not_ported(
        tmp_path, monkeypatch, capsys):
    from ptnn_torch.experiments import cnn_digits

    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    full = ptnn_torch.data.load_digits
    monkeypatch.setattr(
        cnn_digits, "load_digits",
        lambda seed: dataclasses.replace(full(seed), train=full(seed).train[:40],
                                         test=full(seed).test[:20]))
    out = tmp_path / "cnn"
    cnn_digits.main(["--chains", "4", "--steps", "10", "--swap-interval", "5",
                     "--adapt", "--out", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[digits] chains=4 test_acc mean=")
    run = out / "digits_0"
    for rel in ("config.json", "metrics.jsonl", "likelihood.txt",
                "accept_list.txt", "acceptpercent.txt",
                "posterior/pos_likelihood/chain_1.0.txt",
                "predictions/acc_test_chain_1.0.txt"):
        assert (run / rel).is_file(), rel
    with open(run / "config.json") as f:
        cfg = json.load(f)
    assert cfg["adapt_step_size"] and cfg["use_langevin_gradients"]
    assert cfg["learn_rate"] == 0.01 * 0.01 / 2.0 and not cfg["record_w"]
    with pytest.raises(NotImplementedError, match="mesh"):
        cnn_digits.main(["--chains", "4", "--steps", "10", "--mesh"])
    # --sgld-batch runs since sgld was ported: minibatches of 8 rows, exact
    # swaps every 5 steps
    capsys.readouterr()
    cnn_digits.main(["--chains", "4", "--steps", "10", "--swap-interval",
                     "5", "--sgld-batch", "8", "--out", str(out / "sg")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[digits] chains=4 test_acc mean=")
    with open(out / "sg" / "digits_0" / "config.json") as f:
        sg = json.load(f)
    assert sg["proposal"] == "sgld" and sg["sg_batch"] == 8
    assert sg["swap_rule"] == "metropolis" and not sg["adapt_step_size"]
