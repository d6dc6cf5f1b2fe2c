"""Tensor operations of the port: model likelihoods, the block kernels,
ladders, and the NumPy diagnostics ``roundtrip`` and ``ess``."""

from ptnn_torch.ops import ess, roundtrip

__all__ = ["ess", "roundtrip"]
