"""Sampler configuration: ``ptnn/config.py``, shared unchanged."""

from ptnn_torch._shared import config as _config

PTConfig = _config.PTConfig
regression_preset = _config.regression_preset

__all__ = ["PTConfig", "regression_preset"]
