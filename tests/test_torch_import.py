"""ptnn_torch imports, with every module of the slice, where jax cannot,
and loads no file of the JAX package ``ptnn/``."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "ptnn_torch",
    "ptnn_torch.config",
    "ptnn_torch.data",
    "ptnn_torch.convert",
    "ptnn_torch.fused",
    "ptnn_torch.kernel",
    "ptnn_torch.predict",
    "ptnn_torch.sampler",
    "ptnn_torch.models.api",
    "ptnn_torch.models.fnn",
    "ptnn_torch.models.mlp",
    "ptnn_torch.models.cnn",
    "ptnn_torch.results",
    "ptnn_torch.experiments.cnn_digits",
    "ptnn_torch.ops.conv_stage",
    "ptnn_torch.ops.precision",
    "ptnn_torch.ops",
    "ptnn_torch.ops._build",
    "ptnn_torch.ops.block_step",
    "ptnn_torch.ops.drift",
    "ptnn_torch.ops.fnn_eval",
    "ptnn_torch.ops.precond_cls_step",
    "ptnn_torch.ops.precond_step",
    "ptnn_torch.ops.ess",
    "ptnn_torch.ops.ladder",
    "ptnn_torch.ops.roundtrip",
    "ptnn_torch.ops.likelihood",
    "ptnn_torch.parallel.swap",
)


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import ptnn_torch\n"
        "cfg = ptnn_torch.PTConfig(task='regression', topology=(4, 10, 1),\n"
        "                          fused_step=True).validate()\n"
        "from ptnn_torch import data\n"
        "from ptnn_torch.ops import ladder\n"
        "p = data.load_regression('Sunspot')\n"
        "assert p.train.shape == (298, 5) and p.test.shape == (198, 5)\n"
        "p = data.load_classification('iris')\n"
        "assert p.train.shape == (105, 5) and p.test.shape == (45, 5)\n"
        "assert ladder.build_temperatures(cfg).shape == (cfg.num_chains,)\n"
        "lg = ptnn_torch.PTConfig(task='regression', topology=(4, 10, 1),\n"
        "                         num_samples=4 * 6, num_chains=4,\n"
        "                         use_langevin_gradients=True,\n"
        "                         drift_mode='pallas').validate()\n"
        "s = data.load_regression('Sunspot')\n"
        "r = ptnn_torch.sample(lg, s.train, s.test, device='cpu')\n"
        "assert r.traces['ll'].shape == (6, 4)\n"
        "d = data.load('digits')\n"
        "assert d.train.shape == (1257, 65) and d.test.shape == (540, 65)\n"
        "from ptnn_torch.models import cnn\n"
        "zoo = ptnn_torch.classification_preset((64, 16, 10),\n"
        "    num_samples=4 * 4, num_chains=4, use_langevin_gradients=True)\n"
        "r = ptnn_torch.sample(zoo, d.train[:16], d.test[:8], device='cpu',\n"
        "    model_spec=cnn.digits_spec(channels=(4,), hidden=8,\n"
        "                               fused_eval=True))\n"
        "assert r.traces['acc_test'].shape == (4, 4)\n"
        "assert not any(k.split('.')[0] in ('sklearn', 'matplotlib')\n"
        "               for k in sys.modules)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'ptnn.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "assert not any(k.startswith('_ptnn_shared_') for k in sys.modules)\n"
        "import os\n"
        f"jax_pkg = os.path.join({ROOT!r}, 'ptnn') + os.sep\n"
        "for k, m in list(sys.modules.items()):\n"
        "    f = getattr(m, '__file__', None) or ''\n"
        "    assert not os.path.abspath(f).startswith(jax_pkg), (k, f)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_stay_clear_of_jax_and_fallbacks():
    """No file of the port, and not chip_smoke.py, imports jax, calls Pallas
    or torch.compile, or loads a module by file path (``importlib.util``,
    ``spec_from_file_location``); docstrings may cite ``ptnn/...`` files."""
    banned = ("import jax", "from jax", "pallas_call", "torch.compile",
              "scaled_dot_product_attention", "spec_from_file_location",
              "importlib.util", "from ptnn import", "from ptnn.",
              "import ptnn\n", "import ptnn.")
    pkg = os.path.join(ROOT, "ptnn_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(pkg):
        paths += [os.path.join(dirpath, name) for name in files
                  if name.endswith((".py", ".cu", ".cuh"))]
    for path in paths:
        with open(path) as f:
            text = f.read()
        for word in banned:
            assert word not in text, (path, word)


def test_chip_smoke_defines_each_function_once_and_runs_every_phase():
    """A second ``def`` of a name in chip_smoke.py silently replaces the
    first, and ``main`` would then run one phase in place of another: every
    top-level function is defined once, and every ``phase_*`` function is
    called by ``main``."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    defs = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert len(defs) == len(set(defs)), sorted(
        {d for d in defs if defs.count(d) > 1})
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = {n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    phases = {d for d in defs if d.startswith("phase_")}
    assert phases <= called, sorted(phases - called)


def test_port_exports_ptnn_surface_or_names_what_is_missing():
    """Every name of ``ptnn.__all__`` is exported by ``ptnn_torch`` or listed
    in ``ptnn_torch.NOT_PORTED`` with the ROADMAP item that brings it;
    ``throughput_run`` keeps ptnn's contract (a warm-up, then one timed
    run, ptnn's keys) and refuses ``mesh=``."""
    import ptnn
    import ptnn_torch
    from ptnn_torch.data import load_regression

    exported = set(ptnn_torch.__all__)
    missing = set(ptnn.__all__) - exported
    assert missing == set(ptnn_torch.NOT_PORTED), sorted(missing)
    assert not exported & set(ptnn_torch.NOT_PORTED)
    for name in exported:
        assert hasattr(ptnn_torch, name), name
    prob = load_regression("Sunspot")
    cfg = ptnn_torch.PTConfig(task="regression", topology=(4, 10, 1),
                              num_samples=8 * 12, num_chains=8,
                              use_langevin_gradients=True).validate()
    out = ptnn_torch.throughput_run(cfg, prob.train, prob.test, seed=1,
                                    device="cpu")
    assert {"trace_means", "elapsed_s", "steps", "chains",
            "chain_steps_per_sec", "accept_pct", "swap_pct",
            "final_rmse_test_cold"} <= set(out)
    assert out["steps"] == 11.0 and out["chains"] == 8.0
    again = ptnn_torch.sampler.throughput_runner(cfg, prob.train, prob.test,
                                                 seed=1, device="cpu")()
    assert out["trace_means"] == again["trace_means"]
    import pytest

    with pytest.raises(NotImplementedError, match="mesh"):
        ptnn_torch.throughput_run(cfg, prob.train, prob.test, mesh=object())
