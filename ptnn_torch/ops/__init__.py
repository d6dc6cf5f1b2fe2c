"""Tensor operations of the port: model likelihoods, the block kernel, ladders.

``roundtrip`` and ``ess`` are ``ptnn``'s NumPy modules, shared unchanged.
"""

from ptnn_torch._shared import ess, roundtrip

__all__ = ["ess", "roundtrip"]
