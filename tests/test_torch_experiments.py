"""The port's experiment drivers against ptnn's.

``experiments.runner.run_problem`` of both packages on the same problem,
config and seed, each package's ``sample`` given the unjitted initial state
of ptnn's run key and the port's also ptnn's replayed noise
(``test_torch_step.ptnn_noise_fn``, ``test_torch_fused_driver._ptnn_noise_fn``)
through a monkeypatch: a Sunspot random walk per step with ``roundtrip`` and
``replicate=2``, and the iris random walk fused. The artifact trees are
equal byte for byte, ``roundtrip.txt`` and ``replication.txt`` included,
but for the files that print a float32 trace in full (``posterior/pos_w``,
``%.18e``: the two packages round a proposal ``w + step * noise`` apart by
an ulp, held at ``test_torch_step``'s rtol 2e-4, atol 2e-5), those that
print the log-likelihood to four or five decimals
(``posterior/pos_likelihood``, ``likelihood.txt``: two float32 evaluations
part there, held at the ll tolerance of ``test_torch_step``) and the wall
times of ``metrics.jsonl``; the master rows agree but for ``time_min``.

The command lines: every flag and default of ptnn's ``regression`` and
``classification`` parsers, and the flags that are not ported raise
``NotImplementedError`` naming their ROADMAP item.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import kernel as jkernel
from ptnn import sampler as jsampler
from ptnn.data import load_classification, load_regression
from ptnn.experiments import classification as jcls_cli
from ptnn.experiments import regression as jreg_cli
from ptnn.experiments import runner as jrunner
from ptnn.ops import ladder as jladder
from ptnn_torch import convert
from ptnn_torch import sampler as tsampler
from ptnn_torch.data import load as tload
from ptnn_torch.experiments import classification as tcls_cli
from ptnn_torch.experiments import regression as treg_cli
from ptnn_torch.experiments import runner as trunner
from ptnn_torch.models import fnn
from test_torch_fused_driver import _ptnn_noise_fn
from test_torch_step import ptnn_noise_fn

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _ptnn_start(jcfg, train, test, seed):
    data = jsampler.make_dataset(jcfg, train, test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    return jkernel.init_state(k_init, jcfg, data), k_run


def _patch_samplers(monkeypatch):
    """Both runners' ``sample`` start from the unjitted initial state of
    ptnn's key for the seed; the port's replays ptnn's noise."""

    def ptnn_sample(cfg, train, test, seed=0, mesh=None):
        st0, _ = _ptnn_start(cfg, train, test, seed)
        return ptnn.sample(cfg, train, test, seed=seed, init_state=st0)

    def port_sample(cfg, train, test, seed=0, device="cuda"):
        jcfg = ptnn.PTConfig(**dataclasses.asdict(cfg)).validate()
        st0, k_run = _ptnn_start(jcfg, train, test, seed)
        st0_np = {k: (None if v is None else np.asarray(v))
                  for k, v in jax.device_get(st0)._asdict().items()}
        if cfg.fused_step:
            w = fnn.w_size(cfg.topology)
            noise = _ptnn_noise_fn(k_run, -(-w // 8) * 8, 128, w)
        else:
            noise = ptnn_noise_fn(k_run)
        return tsampler.sample(
            cfg, train, test, seed=seed, device="cpu",
            init_state=convert.chain_state_from_numpy(st0_np),
            noise_fn=noise)

    monkeypatch.setattr(jrunner, "sample", ptnn_sample)
    monkeypatch.setattr(trunner, "sample", port_sample)


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _ll_close(got: bytes, want: bytes, rows: int, temps):
    """Printed ll columns within the ll tolerance on the size of its
    cancelling terms (the train rows over T, at least)."""
    a = np.loadtxt(got.decode().splitlines())
    b = np.loadtxt(want.decode().splitlines())
    assert a.shape == b.shape
    terms = rows / min(temps)
    assert np.all(np.abs(a - b) <= ATOL + RTOL * (np.abs(b) + terms)
                  + 1e-4)  # the last printed digit


CASES = {
    # the regression CLI's --no-langevin at 8 x 40 (swaps every 5 steps)
    "sunspot_rw": dict(
        problem="Sunspot", fmt="%1.4f",
        cfg=lambda: dataclasses.replace(
            ptnn.regression_preset(num_samples=8 * 40, num_chains=8,
                                   swap_ratio=0.125,
                                   use_langevin_gradients=False),
            record_w=True).validate(),
        run=dict(roundtrip=True, replicate=2)),
    # the classification CLI's --fused on iris at 8 x 40 (swaps every 4)
    "iris_rw_fused": dict(
        problem="iris", fmt="%1.2f",
        cfg=lambda: dataclasses.replace(
            ptnn.classification_preset((4, 12, 3), num_samples=8 * 40,
                                       num_chains=8, swap_ratio=0.1),
            fused_step=True).validate(),
        run=dict(truepos=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_problem_writes_ptnn_tree(case, tmp_path, monkeypatch):
    spec = CASES[case]
    jcfg = spec["cfg"]()
    tcfg = ptnn_torch.PTConfig(**dataclasses.asdict(jcfg)).validate()
    assert jcfg.swaps_enabled
    jprob = (load_regression(spec["problem"]) if spec["problem"] == "Sunspot"
             else load_classification(spec["problem"]))
    tprob = tload(spec["problem"])
    np.testing.assert_array_equal(tprob.train, jprob.train)
    _patch_samplers(monkeypatch)
    js = jrunner.run_problem(jprob, jcfg, str(tmp_path / "ptnn"), seed=3,
                             plots=False, master_fmt=spec["fmt"],
                             **spec["run"])
    ts = trunner.run_problem(tprob, tcfg, str(tmp_path / "port"), seed=3,
                             plots=False, master_fmt=spec["fmt"],
                             device="cpu", **spec["run"])
    for k, v in vars(js).items():
        if isinstance(v, str):
            assert getattr(ts, k) == v
        elif k != "time_min":
            np.testing.assert_allclose(getattr(ts, k), v, rtol=1e-6,
                                       err_msg=k)
    name = spec["problem"]
    ta = _tree(tmp_path / "port" / f"{name}_0")
    tb = _tree(tmp_path / "ptnn" / f"{name}_0")
    assert sorted(ta) == sorted(tb)
    assert ("roundtrip.txt" in ta) == bool(spec["run"].get("roundtrip"))
    assert ("replication.txt" in ta) == bool(spec["run"].get("replicate"))
    temps = jladder.build_temperatures(jcfg)
    n_ll = n_w = 0
    for rel in ta:
        if rel == "metrics.jsonl":
            ma, mb = json.loads(ta[rel]), json.loads(tb[rel])
            for k in ("ts", "elapsed_s", "chain_steps_per_sec"):
                assert ma.pop(k) > 0 and mb.pop(k) > 0
            assert ma.keys() == mb.keys()
            for k in ma:
                if isinstance(ma[k], float):
                    np.testing.assert_allclose(ma[k], mb[k], rtol=1e-6,
                                               err_msg=k)
                else:
                    assert ma[k] == mb[k], k
        elif rel.startswith(os.path.join("posterior", "pos_likelihood")) \
                or rel == "likelihood.txt":
            n_ll += 1
            if ta[rel] != tb[rel]:
                _ll_close(ta[rel], tb[rel], jprob.train.shape[0], temps)
        elif rel.startswith(os.path.join("posterior", "pos_w")):
            n_w += 1
            np.testing.assert_allclose(
                np.loadtxt(ta[rel].decode().splitlines()),
                np.loadtxt(tb[rel].decode().splitlines()), rtol=RTOL,
                atol=ATOL, err_msg=rel)
        else:
            assert ta[rel] == tb[rel], rel
    assert n_ll == 1 + jcfg.num_chains
    assert n_w == (jcfg.num_chains if jcfg.record_w else 0)
    with open(tmp_path / "port" / "master_result_file.txt") as f1, \
            open(tmp_path / "ptnn" / "master_result_file.txt") as f2:
        ra, rb = f1.read().split(), f2.read().split()
    assert len(ra) == len(rb) == 16
    assert ra[:14] + ra[15:] == rb[:14] + rb[15:]


def _options(parser):
    return {tuple(a.option_strings): (a.default, a.type, a.choices,
                                      type(a).__name__)
            for a in parser._actions}


@pytest.mark.parametrize("cli", ["regression", "classification"])
def test_cli_flags_and_defaults_match_ptnn(cli):
    j, t = ((jreg_cli, treg_cli) if cli == "regression"
            else (jcls_cli, tcls_cli))
    assert _options(t.build_parser()) == _options(j.build_parser())
    assert vars(t.build_parser().parse_args([])) == \
        vars(j.build_parser().parse_args([]))
    if cli == "classification":
        assert t.PROBLEM_ORDER == j.PROBLEM_ORDER


@pytest.mark.parametrize("flags,word", [
    (["--evidence"], "item 13"), (["--vref"], "item 13"),
    (["--vr-rounds", "2"], "item 13"), (["--mesh"], "item 14")])
@pytest.mark.parametrize("cli", ["regression", "classification"])
def test_cli_refuses_what_is_not_ported(cli, flags, word, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    mod = treg_cli if cli == "regression" else tcls_cli
    with pytest.raises(NotImplementedError, match=word):
        mod.main(["--samples", "40", "--chains", "4", "--no-plots",
                  "--out", str(tmp_path)] + flags)
    assert not os.listdir(tmp_path)


def test_cli_runs_the_paper_command_line(tmp_path, monkeypatch, capsys):
    """``python -m ptnn_torch.experiments.regression`` at a tiny budget on
    the CPU: ptnn's tree, the master row and the summary line."""
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    treg_cli.main(["--samples", "240", "--chains", "4", "--no-plots",
                   "--no-langevin", "--fused", "--out", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[Sunspot] test_mean=")
    run = tmp_path / "Sunspot_0"
    for rel in ("config.json", "metrics.jsonl", "likelihood.txt",
                "accept_list.txt", "acceptpercent.txt",
                "posterior/pos_w/chain_1.0.txt",
                "predictions/rmse_test_chain_1.0.txt"):
        assert (run / rel).is_file(), rel
    with open(run / "config.json") as f:
        cfg = json.load(f)
    assert cfg["fused_step"] and not cfg["use_langevin_gradients"]
    assert cfg["num_samples"] == 240 and cfg["maxtemp"] == 2.0
    with open(tmp_path / "master_result_file.txt") as f:
        assert f.read().split()[-1] == "Sunspot_0"


# ptnn's own command lines at their defaults, the source of chip_smoke.py's
# bands for the port's CLI runs on the card (10 chains: Sunspot 10,000
# steps, iris 5,000)
REFERENCE_RUNS = {
    "regression": (jreg_cli, ["--problem", "Sunspot"]),
    "regression-rw": (jreg_cli, ["--problem", "Sunspot", "--no-langevin"]),
    "classification": (jcls_cli, ["--problem", "iris"]),
}


def reference_run(name: str, seed: int, out: str) -> dict:
    """ptnn's CLI ``name`` at ``seed`` (``--no-plots``, artifacts under
    ``out``): the run's test mean (pooled over every chain after burn-in),
    swap % and accept % (``metrics.jsonl``), and the served test RMSE of
    the posterior mean or accuracy of the mean probabilities over the cold
    chain's draws (``ptnn.predict``, as its command line serves the run)."""
    from ptnn import predict as jpredict
    from ptnn.data import load

    mod, argv = REFERENCE_RUNS[name]
    mod.main(argv + ["--no-plots", "--seed", str(seed), "--out", out])
    (run,) = [os.path.join(out, d) for d in os.listdir(out)
              if d != "master_result_file.txt"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        m = json.loads(f.read().splitlines()[-1])
    draws, cfg = jpredict.load_posterior(run)
    prob = load(m["problem"])
    nx = cfg.topology[0]
    pred = jpredict.posterior_predict(cfg, draws, prob.test[:, :nx])
    y = prob.test[:, nx]
    served = (float(np.sqrt(np.mean((pred["mean"] - y) ** 2)))
              if cfg.task == "regression"
              else 100.0 * float(np.mean(pred["label"] == y.astype(int))))
    return dict(test_mean=m["test_mean"], swap=m["swap_percent"],
                accept=m["accept_per"], served=served)


if __name__ == "__main__":
    # python tests/test_torch_experiments.py regression|regression-rw|
    #     classification SEED ... : ptnn's CLI on the CPU, one line a seed
    import sys
    import tempfile

    for s in sys.argv[2:]:
        with tempfile.TemporaryDirectory() as d:
            print(sys.argv[1], "seed", s,
                  json.dumps(reference_run(sys.argv[1], int(s), d)),
                  flush=True)
