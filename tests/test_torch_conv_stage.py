"""The port's fused conv1 stage against ptnn's Pallas kernel.

``ptnn_torch.ops.conv_stage.conv1_relu_pool`` on CPU tensors (its plain
version: ``F.conv2d`` + ``relu`` + ``avg_pool2d``) against
``ptnn.ops.pallas_conv.conv1_relu_pool(interpret=True)`` on the same numpy
inputs, atol 1e-5 (two summation orders of nine float32 products), and
``cnn.batched_forward_fused`` against ptnn's, atol 1e-4, the tolerances of
``tests/test_pallas_conv.py``. The CUDA kernel itself is compared with the
plain version on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.models import cnn as jcnn
from ptnn.ops import pallas_conv
from ptnn_torch.models import cnn
from ptnn_torch.ops import conv_stage

torch.set_num_threads(1)


def _inputs(c, n, hw, in_ch, out_ch, seed):
    rng = np.random.RandomState(seed)
    w1 = (rng.randn(c, 3, 3, in_ch, out_ch) * 0.3).astype(np.float32)
    b1 = (rng.randn(c, out_ch) * 0.1).astype(np.float32)
    x = rng.rand(n, hw * hw * in_ch).astype(np.float32)
    return x, w1, b1


@pytest.mark.parametrize("c,n,in_ch", [(3, 19, 1), (130, 8, 1), (4, 6, 3)])
def test_conv1_relu_pool_matches_ptnn(c, n, in_ch):
    x, w1, b1 = _inputs(c, n, 8, in_ch, 8, seed=c)
    want = pallas_conv.conv1_relu_pool(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), hw=8, in_ch=in_ch,
        out_ch=8, interpret=True)
    before = conv_stage.launches
    got = conv_stage.conv1_relu_pool(
        torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(b1), 8,
        in_ch, 8)
    assert conv_stage.launches == before  # CPU tensors count no launch
    assert tuple(got.shape) == (c, n, 4, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_conv1_relu_pool_refuses_what_ptnn_refuses():
    x, w1, b1 = _inputs(2, 3, 8, 1, 8, seed=0)
    t = torch.from_numpy
    w5 = np.zeros((2, 5, 5, 1, 8), np.float32)
    for fn, mod, wrap in ((conv_stage.conv1_relu_pool, torch, t),
                          (pallas_conv.conv1_relu_pool, jnp, jnp.asarray)):
        with pytest.raises(ValueError, match="supports 3x3 kernels only"):
            fn(wrap(x), wrap(w5), wrap(b1), hw=8)
        with pytest.raises(ValueError, match="needs an even image side"):
            fn(wrap(x[:, :49]), wrap(w1), wrap(b1), hw=7)
    with pytest.raises(ValueError, match="no backward"):
        conv_stage.conv1_relu_pool(t(x), t(w1).requires_grad_(), t(b1), 8)


SHAPES = ((256, 1257, 8, 1, 8), (256, 540, 8, 1, 8), (3, 19, 8, 1, 8),
          (130, 8, 8, 1, 8), (4, 6, 8, 3, 8), (5, 7, 8, 2, 6),
          (32, 64, 28, 1, 8), (9, 5, 28, 1, 8), (256, 77, 8, 1, 4),
          (1, 1, 2, 1, 1))


def test_launch_plan_fits_a_block_and_covers_every_image():
    for c, n, hw, in_ch, out_ch in SHAPES:
        plan = conv_stage.launch_plan(c, n, hw, in_ch, out_ch)
        assert 1 <= plan.per_block <= c
        assert plan.x_floats % 4 == 0
        assert plan.x_floats >= plan.tile * in_ch * (hw + 2) ** 2
        assert plan.smem == 4 * (plan.x_floats
                                 + plan.per_block * (9 * in_ch + 1) * out_ch)
        assert plan.smem <= 48 * 1024
        if plan.kernel == "generic":
            assert 1 <= plan.tile <= n and plan.per_block <= 8


@pytest.mark.parametrize("c,n,hw,in_ch,out_ch", SHAPES)
def test_conv_plan_takes_the_fixed_kernel_for_the_digits_shape_only(
        c, n, hw, in_ch, out_ch):
    """The fixed-shape kernel is compiled for the bundled stage-1 shape (hw
    8, one input channel, 8 outputs: ``cnn.digits_spec``): a block of 256
    threads, two output vectors a thread, so 16 images of 32 vectors, and
    16 chains. Every other shape takes the generic kernel."""
    plan = conv_stage.launch_plan(c, n, hw, in_ch, out_ch)
    fixed = (hw, in_ch, out_ch) == (8, 1, 8)
    assert conv_stage.fixed_shape() == (8, 1, 8)
    assert plan.kernel == ("fixed" if fixed else "generic")
    if fixed:
        assert (plan.tile, plan.per_block) == (16, min(c, 16))


@pytest.mark.parametrize("c,n,hw,in_ch,out_ch", SHAPES)
def test_conv_plan_covers_every_chain_and_image_once(c, n, hw, in_ch, out_ch):
    """The grid (image tiles, chain groups) of the launch, with the kernel's
    masks of the ragged last tile and group, writes each (chain, image)
    exactly once."""
    plan = conv_stage.launch_plan(c, n, hw, in_ch, out_ch)
    count = np.zeros((c, n), np.int64)
    for bx in range(-(-n // plan.tile)):
        for by in range(-(-c // plan.per_block)):
            n0, c0 = bx * plan.tile, by * plan.per_block
            count[c0:min(c, c0 + plan.per_block), n0:min(n, n0 + plan.tile)] += 1
    np.testing.assert_array_equal(count, 1)


def test_batched_forward_fused_matches_ptnn():
    jcfg = jcnn.CnnConfig(image_hw=8, n_classes=10)
    tcfg = cnn.CnnConfig(image_hw=8, n_classes=10)
    rng = np.random.RandomState(5)
    ws = (rng.randn(3, cnn.w_size(tcfg)) * 0.2).astype(np.float32)
    x = rng.rand(11, 64).astype(np.float32)
    want = jcnn.batched_forward_fused(jnp.asarray(ws), jnp.asarray(x), jcfg,
                                      interpret=True)
    got = cnn.batched_forward_fused(torch.from_numpy(ws), torch.from_numpy(x),
                                    tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    plain = cnn.forward(torch.from_numpy(ws), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4)
