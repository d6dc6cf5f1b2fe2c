"""The fused first stage of the chain-batched CNN eval.

Port of ``ptnn/ops/pallas_conv.py`` (``conv1_relu_pool``): for every chain
at once, a 3x3 SAME convolution of the chain-SHARED images with the chain's
own taps, bias, ReLU and the 2x2 average pool (the sum of each block over
4.0), with only the pooled tensor written:

    x  (N, hw*hw*in_ch) float32   flat images (rows, columns, channels)
    w1 (C, 3, 3, in_ch, out_ch)   per-chain taps, ptnn's (kh, kw, in, out)
    b1 (C, out_ch)
    -> (C, N, hw/2, hw/2, out_ch)

CUDA tensors launch the hand-written kernel ``csrc/conv1_relu_pool.cu`` (its
fixed-shape kernel for the bundled stage-1 shape, hw 8, 1 -> 8 channels, its
generic kernel for any other: ``launch_plan``); CPU
tensors run ``conv1_relu_pool_reference``, the same function through
``F.conv2d`` (the C chains as C * out_ch output channels of one convolution,
TF32 off), ``relu`` and ``F.avg_pool2d``. A CUDA tensor never takes the
plain version: it launches or raises. ``ptnn``'s kernel has no backward (the
drift's gradient flows through the plain forward), so neither has this one:
an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ptnn_torch.ops import _build
from ptnn_torch.ops.block_step import _SMEM_LIMIT, _check
from ptnn_torch.ops.precision import full_float32

launches = 0  # launches of csrc/conv1_relu_pool.cu (the plain version counts none)
fixed_launches = 0  # of them, launches of its fixed-shape kernel

_CHAINS_PER_BLOCK = 8  # chains that share one staged image tile (generic)
_TILE_BYTES = 16384  # target size of a block's image tile (with its halo)


def _define(name: str) -> int:
    """A constant of csrc/conv1_relu_pool.cu (THREADS, FIXED_*), read from
    the source at first use."""
    return _build.cu_define("conv1_relu_pool.cu", name)


def fixed_shape():
    """(hw, in_ch, out_ch) the fixed-shape kernel is compiled for."""
    return (_define("FIXED_HW"), _define("FIXED_IN"), _define("FIXED_OUT"))


def _validate(w1: torch.Tensor, hw: int) -> None:
    if tuple(w1.shape[1:3]) != (3, 3):
        raise ValueError(
            f"conv1_relu_pool supports 3x3 kernels only, got "
            f"{tuple(w1.shape[1:3])}")
    if hw % 2 != 0:
        raise ValueError(f"conv1_relu_pool needs an even image side, got {hw}")


def conv1_relu_pool_reference(x: torch.Tensor, w1: torch.Tensor,
                              b1: torch.Tensor, hw: int, in_ch: int = 1,
                              out_ch: int = 8) -> torch.Tensor:
    """The plain PyTorch version of ``conv1_relu_pool``, on any device."""
    _validate(w1, hw)
    c, n = w1.shape[0], x.shape[0]
    img = x.reshape(n, hw, hw, in_ch).permute(0, 3, 1, 2)
    weight = w1.permute(0, 4, 3, 1, 2).reshape(c * out_ch, in_ch, 3, 3)
    with full_float32():
        z = F.conv2d(img, weight, b1.reshape(c * out_ch), padding=1)
    z = F.avg_pool2d(torch.relu(z), 2)  # (N, C * out_ch, hw/2, hw/2)
    z = z.reshape(n, c, out_ch, hw // 2, hw // 2)
    return z.permute(1, 0, 3, 4, 2).contiguous()


class _ConvParams(ctypes.Structure):
    """Mirror of ``struct ConvParams`` in csrc/conv1_relu_pool.cu (same field
    order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("x", "w", "b", "out")] + [
        (name, ctypes.c_int)
        for name in ("chains", "n_img", "hw", "in_ch", "out_ch", "tile_img",
                     "chains_per_block", "x_floats")
    ]


class ConvPlan(NamedTuple):
    """One launch: the kernel ("fixed" or "generic"), images a block
    (``tile``), chains a block (``per_block``), floats of the image tile
    (``x_floats``) and bytes of dynamic shared memory (``smem``)."""
    kernel: str
    tile: int
    per_block: int
    x_floats: int
    smem: int


def launch_plan(c: int, n: int, hw: int, in_ch: int, out_ch: int) -> ConvPlan:
    """The launch for ``c`` chains on ``n`` images. The bundled stage-1
    shape (``fixed_shape()``) takes the fixed-shape kernel: THREADS *
    FIXED_EPT output vectors a block, so 16 images at hw 8 and 8 channels,
    and FIXED_CHAINS chains. Any other shape takes the generic kernel: as
    many haloed, channel-planar images as fit ``_TILE_BYTES`` (at least
    one) and 8 chains. The taps and biases of the block's chains follow the
    image tile."""
    img = in_ch * (hw + 2) * (hw + 2)
    if (hw, in_ch, out_ch) == fixed_shape():
        per_img = (hw // 2) ** 2 * (out_ch // 4)
        tile = _define("THREADS") * _define("FIXED_EPT") // per_img
        cb = min(c, _define("FIXED_CHAINS"))
        kernel = "fixed"
    else:
        tile = max(1, min(n, _TILE_BYTES // (4 * img)))
        cb = min(c, _CHAINS_PER_BLOCK)
        kernel = "generic"
    x_floats = -(-tile * img // 4) * 4
    smem = 4 * (x_floats + cb * (9 * in_ch * out_ch + out_ch))
    return ConvPlan(kernel, tile, cb, x_floats, smem)


def _launch_cuda(x, w1, b1, hw, in_ch, out_ch) -> torch.Tensor:
    global launches, fixed_launches

    c, n = w1.shape[0], x.shape[0]
    dev = x.device
    if c < 1 or n < 1 or in_ch < 1 or out_ch < 1:
        raise ValueError(f"chains {c}, images {n}, in_ch {in_ch} and out_ch "
                         f"{out_ch} must be positive")
    _check(x, "x", (n, hw * hw * in_ch), torch.float32, dev)
    _check(w1, "w1", (c, 3, 3, in_ch, out_ch), torch.float32, dev)
    _check(b1, "b1", (c, out_ch), torch.float32, dev)
    plan = launch_plan(c, n, hw, in_ch, out_ch)
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(
            f"one {hw}x{hw}x{in_ch} image with its halo and {plan.per_block} "
            f"chains' taps need {plan.smem} bytes of shared memory per block; "
            f"a Hopper block has {_SMEM_LIMIT}")
    lib = _build.build("conv1_relu_pool").lib
    out = torch.empty((c, n, hw // 2, hw // 2, out_ch), dtype=torch.float32,
                      device=dev)
    params = _ConvParams(
        x=x.data_ptr(), w=w1.data_ptr(), b=b1.data_ptr(), out=out.data_ptr(),
        chains=c, n_img=n, hw=hw, in_ch=in_ch, out_ch=out_ch,
        tile_img=plan.tile, chains_per_block=plan.per_block,
        x_floats=plan.x_floats,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ptnn_conv1_relu_pool(ctypes.byref(params), plan.smem,
                                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"conv1_relu_pool launch failed: {_build.error_string(lib, err)}")
    launches += 1
    fixed_launches += plan.kernel == "fixed"
    return out


def conv1_relu_pool(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    hw: int, in_ch: int = 1, out_ch: int = 8) -> torch.Tensor:
    """Fused conv1 (SAME, 3x3) + bias + relu + 2x2 average pool for every
    chain: -> (C, N, hw/2, hw/2, out_ch). 3x3 taps and an even ``hw`` only
    (``ValueError`` otherwise, as in ptnn). CUDA tensors launch the kernel,
    CPU tensors run the plain version."""
    _validate(w1, hw)
    if any(a.requires_grad for a in (x, w1, b1)):
        raise ValueError(
            "conv1_relu_pool has no backward (as ptnn's kernel): take "
            "gradients through the plain forward")
    kinds = {a.device.type for a in (x, w1, b1)}
    if kinds == {"cpu"}:
        return conv1_relu_pool_reference(x, w1, b1, hw, in_ch, out_ch)
    if kinds == {"cuda"}:
        return _launch_cuda(x, w1, b1, hw, in_ch, out_ch)
    raise ValueError(f"conv1_relu_pool needs all tensors on one device type, "
                     f"got {sorted(kinds)}")
