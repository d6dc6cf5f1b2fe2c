"""Dataset loaders: ``ptnn/data.py``, shared unchanged (NumPy float64)."""

from ptnn_torch._shared import data as _data

Problem = _data.Problem
load_regression = _data.load_regression

__all__ = ["Problem", "load_regression"]
