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
import re

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
    assert ("roundtrip.txt" in ta) == bool(spec["run"].get("roundtrip"))
    assert ("replication.txt" in ta) == bool(spec["run"].get("replicate"))
    n_ll, n_w = _assert_trees_match(ta, tb, jprob.train.shape[0],
                                    jladder.build_temperatures(jcfg))
    assert n_ll == 1 + jcfg.num_chains
    assert n_w == (jcfg.num_chains if jcfg.record_w else 0)
    _assert_master_rows_match(tmp_path / "port", tmp_path / "ptnn")


def _assert_master_rows_match(a, b):
    with open(a / "master_result_file.txt") as f1, \
            open(b / "master_result_file.txt") as f2:
        ra, rb = f1.read().split(), f2.read().split()
    assert len(ra) == len(rb) == 16
    assert ra[:14] + ra[15:] == rb[:14] + rb[15:]


def _numbers(text: bytes):
    return np.asarray(re.findall(rb"-?[0-9]+\.[0-9]+(?:e[-+][0-9]+)?",
                                 text), np.float64)


def _assert_trees_match(ta, tb, n_train, temps):
    """Two artifact trees: the same files, byte for byte but for the
    float32 traces printed in full (pos_w at the run tolerance), the
    printed ll (at the ll tolerance), the wall times of metrics.jsonl, and
    the evidence and rounds files, whose numbers are held at the run
    tolerance on the size of the ll terms (``evidence.txt``) or column by
    column to one unit of its printed decimal (``rounds_history.md``, the
    counts exactly). Returns the numbers of ll
    and pos_w files."""
    # a re-spaced ladder (the rounds) names chains by temperatures that the
    # two runs compute apart by rounding: pair the files by position
    pairs = list(zip(sorted(ta), sorted(tb)))
    assert len(ta) == len(tb)
    chain = re.compile(r"(.*chain_)([0-9]+\.[0-9]+|inf)(.*)$")
    for a, b in pairs:
        if a != b:
            ma, mb = chain.match(a), chain.match(b)
            assert ma and mb and ma.group(1, 3) == mb.group(1, 3), (a, b)
            np.testing.assert_allclose(float(ma.group(2)),
                                       float(mb.group(2)), rtol=RTOL)
    tb = {a: tb[b] for a, b in pairs}
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
                _ll_close(ta[rel], tb[rel], n_train, temps)
        elif rel.startswith(os.path.join("posterior", "pos_w")):
            n_w += 1
            np.testing.assert_allclose(
                np.loadtxt(ta[rel].decode().splitlines()),
                np.loadtxt(tb[rel].decode().splitlines()), rtol=RTOL,
                atol=ATOL, err_msg=rel)
        elif rel == "config.json" and ta[rel] != tb[rel]:
            # a re-spaced ladder's custom_ladder, apart by rounding
            ca, cb = json.loads(ta[rel]), json.loads(tb[rel])
            np.testing.assert_allclose(ca.pop("custom_ladder"),
                                       cb.pop("custom_ladder"), rtol=RTOL)
            assert ca == cb
        elif rel == "evidence.txt":
            a, b = _numbers(ta[rel]), _numbers(tb[rel])
            assert a.shape == b.shape
            assert np.all(np.abs(a - b) <= ATOL + RTOL * (np.abs(b)
                                                          + n_train)), rel
        elif rel == "rounds_history.md":
            ra = parse_rounds(ta[rel].decode())
            rb = parse_rounds(tb[rel].decode())
            assert len(ra) == len(rb)
            for a, b in zip(ra, rb):
                # the counts exactly; each other column to one unit of the
                # decimal it is printed to
                for k in ("round", "samples", "fit_draws"):
                    assert a[k] == b[k], (rel, k)
                assert (a["regen"] is None) == (b["regen"] is None), rel
                for k, unit in ROUNDS_UNITS.items():
                    if a[k] is not None:
                        assert abs(a[k] - b[k]) <= unit * (1 + 1e-6), \
                            (rel, k, a[k], b[k])
        else:
            assert ta[rel] == tb[rel], rel
    return n_ll, n_w


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


@pytest.mark.parametrize("flags", [
    pytest.param(["--evidence"], id="flags0-item 13"),
    pytest.param(["--vref"], id="flags1-item 13"),
    pytest.param(["--vr-rounds", "2"], id="flags2-item 13"),
    pytest.param(["--mesh"], id="flags3-item 14")])
@pytest.mark.parametrize("cli", ["regression", "classification"])
def test_cli_refuses_what_is_not_ported(cli, flags, tmp_path, monkeypatch):
    """``--mesh`` raises naming its ROADMAP item (14) and writes nothing.
    ``--evidence``, ``--vref`` and ``--vr-rounds`` (the extensions of item
    13) run: each command line of the port and of ptnn at 8 chains x 40
    (the rounds: 40 a round), the port's runs from ptnn's initial states
    with ptnn's draws, write the same tree (``evidence.txt`` and
    ``rounds_history.md`` included, ``_assert_trees_match``) and master
    row."""
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    t, j = ((treg_cli, jreg_cli) if cli == "regression"
            else (tcls_cli, jcls_cli))
    if flags == ["--mesh"]:
        with pytest.raises(NotImplementedError, match="item 14"):
            t.main(["--samples", "40", "--chains", "4", "--no-plots",
                    "--out", str(tmp_path)] + flags)
        assert not os.listdir(tmp_path)
        return
    from test_torch_tuning import replay_sample

    replay_sample(monkeypatch)
    _patch_samplers(monkeypatch)
    monkeypatch.setattr(trunner, "sample", tsampler.sample)
    argv = ["--samples", "320", "--chains", "8", "--no-plots", "--seed", "3"]
    argv += (["--swap-ratio", "0.125", "--problem", "Sunspot"]
             if cli == "regression" else
             ["--swap-ratio", "0.1", "--problem", "iris"])
    if flags[0] == "--vr-rounds":
        argv += ["--evidence", "--no-langevin"] if cli == "regression" \
            else []
    for mod, out in ((j, "ptnn"), (t, "port")):
        mod.main(argv + flags + ["--out", str(tmp_path / out)])
    name = "Sunspot" if cli == "regression" else "iris"
    ta = _tree(tmp_path / "port" / f"{name}_0")
    tb = _tree(tmp_path / "ptnn" / f"{name}_0")
    with open(tmp_path / "port" / f"{name}_0" / "config.json") as f:
        cfg = ptnn_torch.config.from_json_dict(json.load(f))
    assert ("evidence.txt" in ta) == ("--evidence" in argv + flags)
    assert ("rounds_history.md" in ta) == (flags[0] == "--vr-rounds")
    assert cfg.variational_reference == (flags[0] != "--evidence")
    prob = tload(name)
    n_ll, _n_w = _assert_trees_match(ta, tb, prob.train.shape[0],
                                     jladder.build_temperatures(cfg))
    assert n_ll == 1 + cfg.num_chains
    _assert_master_rows_match(tmp_path / "port", tmp_path / "ptnn")


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
    # the variational-reference paths: the Langevin default with the T = inf
    # rung, three full-covariance rounds, and iris's canonical schedule
    "regression-vref": (jreg_cli, ["--problem", "Sunspot", "--vref",
                                   "--evidence", "--roundtrip"]),
    "regression-rounds": (jreg_cli, ["--problem", "Sunspot", "--no-langevin",
                                     "--vr-rounds", "3", "--evidence"]),
    "classification-vref": (jcls_cli, ["--problem", "iris", "--vref",
                                       "--evidence"]),
}


def read_evidence(path: str) -> dict:
    """``evidence.txt``'s named lines (ti, ss and, anchored, log_z0, abs_ti,
    abs_ss) as floats."""
    out = {}
    with open(path) as f:
        for line in f:
            key, _, rest = line.partition(" ")
            if key in ("ti", "ss", "log_z0", "abs_ti", "abs_ss"):
                out[key] = float(rest)
    return out


# one unit of the decimal each float column of rounds_history.md is
# printed to (rounds.format_history)
ROUNDS_UNITS = dict(swap=0.1, barrier=0.01, trips=0.1, regen=0.1,
                    metric=1e-4)


def parse_rounds(text: str) -> list:
    """``rounds_history.md``'s rows as dicts of the printed numbers (regen
    None where the table prints a dash)."""
    rows = []
    for line in text.splitlines()[2:]:
        c = [x.strip() for x in line.strip("|").split("|")]
        rows.append(dict(round=int(c[0]), samples=int(c[1]),
                         swap=float(c[2]), barrier=float(c[3]),
                         trips=float(c[4]),
                         regen=None if c[5] == "—" else float(c[5]),
                         metric=float(c[6]), fit_draws=int(c[7])))
    return rows


def read_rounds(path: str) -> list:
    """``parse_rounds`` of the file at ``path``."""
    with open(path) as f:
        return parse_rounds(f.read())


def reference_run(name: str, seed: int, out: str) -> dict:
    """ptnn's CLI ``name`` at ``seed`` (``--no-plots``, artifacts under
    ``out``): the run's test mean (pooled over every chain after burn-in),
    swap % and accept % (``metrics.jsonl``), and the served test RMSE of
    the posterior mean or accuracy of the mean probabilities over the cold
    chain's draws (``ptnn.predict``, as its command line serves the run)."""
    from ptnn import predict as jpredict
    from ptnn.data import load

    import contextlib
    import io
    import re

    mod, argv = REFERENCE_RUNS[name]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
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
    out = dict(test_mean=m["test_mean"], swap=m["swap_percent"],
               accept=m["accept_per"], served=served)
    if os.path.exists(os.path.join(run, "evidence.txt")):
        out["evidence"] = read_evidence(os.path.join(run, "evidence.txt"))
    if os.path.exists(os.path.join(run, "rounds_history.md")):
        out["rounds"] = read_rounds(os.path.join(run, "rounds_history.md"))
    if os.path.exists(os.path.join(run, "roundtrip.txt")):
        trips = re.search(r"([0-9]+) round trips", printed.getvalue())
        out["round_trips"] = int(trips.group(1))
    regen = re.search(r"hot-rung regen ([0-9.]+)% accepted",
                      printed.getvalue())
    if regen:
        out["regen"] = float(regen.group(1))
    return out


if __name__ == "__main__":
    # python tests/test_torch_experiments.py NAME SEED ... (NAME a key of
    #     REFERENCE_RUNS): ptnn's CLI on the CPU, one line a seed
    import sys
    import tempfile

    for s in sys.argv[2:]:
        with tempfile.TemporaryDirectory() as d:
            print(sys.argv[1], "seed", s,
                  json.dumps(reference_run(sys.argv[1], int(s), d)),
                  flush=True)
