"""Float32 precision on the card.

A float32 matrix product runs in full float32 by default, but cuDNN
convolves float32 in TF32 unless told otherwise. TF32 keeps about three
decimal digits, which would move the log-likelihoods the MH test compares
(``ptnn`` asks for ``Precision.HIGHEST``), so the model zoo's products and
convolutions run inside ``full_float32``.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """Float32 products and convolutions in full float32 inside the block;
    both switches are restored on the way out."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
