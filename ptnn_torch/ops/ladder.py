"""Temperature ladders: ``ptnn/ops/ladder.py``, shared unchanged (NumPy)."""

from ptnn_torch._shared import ladder as _ladder

build_temperatures = _ladder.build_temperatures

__all__ = ["build_temperatures"]
