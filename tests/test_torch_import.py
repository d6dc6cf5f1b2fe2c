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
    "ptnn_torch.models.fnn",
    "ptnn_torch.ops",
    "ptnn_torch.ops._build",
    "ptnn_torch.ops.block_step",
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
