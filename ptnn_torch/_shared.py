"""The framework-free modules of ``ptnn``, loaded by file path.

``import ptnn.config`` would run ``ptnn/__init__.py``, which imports the JAX
sampler. The five modules below import only the standard library and NumPy
(``ess.function_space_rhat`` imports jax inside its body; the port never
calls it), so they are executed here from their files under private module
names and shared unchanged: nothing is copied.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_PTNN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ptnn"
)


def _load(rel_path: str):
    name = "_ptnn_shared_" + rel_path[:-3].replace("/", "_")
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PTNN, rel_path)
    )
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves a class's module through sys.modules while the
    # module body runs, so register before executing
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


config = _load("config.py")
data = _load("data.py")
ladder = _load("ops/ladder.py")
roundtrip = _load("ops/roundtrip.py")
ess = _load("ops/ess.py")
