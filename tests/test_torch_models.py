"""The port's model zoo (``models.mlp``, ``models.cnn``, ``api.grad_drift``,
``data.load_digits``, ``cnn_digits.load_mnist``, ``convert.
model_params_from_numpy``) against ptnn's on the same numpy inputs.

Forwards within rtol 2e-6, atol 2e-6 of ptnn's vmapped forward (two float32
summation orders, over up to 784 terms for the MNIST layout); gradient drifts
within rtol 1e-5 of ``jax.grad``'s.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.data import load_digits as jload_digits
from ptnn.models import cnn as jcnn
from ptnn.models import mlp as jmlp
from ptnn_torch import convert
from ptnn_torch.data import load, load_digits
from ptnn_torch.experiments.cnn_digits import load_mnist
from ptnn_torch.models import cnn, mlp
from ptnn_torch.ops.precision import full_float32

torch.set_num_threads(1)
t = torch.from_numpy


def _vmapped(fn, w, *rest):
    return np.asarray(jax.vmap(lambda wi: fn(wi, *rest))(jnp.asarray(w)))


@pytest.mark.parametrize("act", ["sigmoid", "relu", "tanh", "gelu"])
def test_mlp_forward_matches_ptnn(act):
    sizes = (64, 32, 16, 10)
    assert mlp.w_size(sizes) == jmlp.w_size(sizes) == 2778
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(4, mlp.w_size(sizes))) * 0.2).astype(np.float32)
    x = rng.uniform(size=(9, 64)).astype(np.float32)
    want = _vmapped(lambda wi: jmlp.forward(wi, jnp.asarray(x), sizes, act), w)
    got = mlp.forward(t(w), t(x), sizes, act)
    assert tuple(got.shape) == (4, 9, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    for a, b in zip(mlp.unpack(t(w), sizes), jmlp.unpack(jnp.asarray(w[0]),
                                                         sizes)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


@pytest.mark.parametrize("hw,channels,hidden", [
    (8, (8, 16), 32), (8, (4,), 16), (6, (4, 8), 16), (28, (8, 16), 64)])
def test_cnn_forward_matches_ptnn(hw, channels, hidden):
    """image_hw=6 pools an odd side (6 -> 3 -> 2): one zero row and column
    at the end, and still a division by 4."""
    kw = dict(image_hw=hw, n_classes=10, channels=channels, hidden=hidden)
    jcfg, tcfg = jcnn.CnnConfig(**kw), cnn.CnnConfig(**kw)
    assert cnn.w_size(tcfg) == jcnn.w_size(jcfg)
    assert cnn._shapes(tcfg) == jcnn._shapes(jcfg)
    rng = np.random.default_rng(hw)
    w = (rng.normal(size=(3, cnn.w_size(tcfg))) * 0.2).astype(np.float32)
    x = rng.uniform(size=(7, hw * hw)).astype(np.float32)
    want = _vmapped(lambda wi: jcnn.forward(wi, jnp.asarray(x), jcfg), w)
    got = cnn.forward(t(w), t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    for a, b in zip(cnn.unpack(t(w), tcfg), jcnn.unpack(jnp.asarray(w[1]),
                                                        jcfg)):
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b))


def test_digits_and_mnist_specs_match_ptnn():
    for make, jmake in ((cnn.digits_spec, jcnn.digits_spec),
                        (cnn.mnist_spec, jcnn.mnist_spec)):
        for fused in (False, True):
            a, b = make(fused_eval=fused), jmake(fused_eval=fused)
            assert (a.name, a.w_size) == (b.name, b.w_size)
            assert (a.batched_forward is None) == (b.batched_forward is None)
            assert a.prior_dim_classification == b.prior_dim_classification
    assert cnn.digits_spec().w_size == 3658


def _drift_inputs(spec, n, rng, classes=10):
    w = (rng.normal(size=(6, spec.w_size)) * 0.2).astype(np.float32)
    x = rng.uniform(size=(n, 64)).astype(np.float32)
    tt = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return w, x, tt


@pytest.mark.parametrize("model", ["cnn", "mlp", "mlp_regression"])
def test_grad_drift_matches_jax_grad(model):
    rng = np.random.default_rng(7)
    if model == "cnn":
        jspec = jcnn.digits_spec(channels=(4,), hidden=16)
        tspec = cnn.digits_spec(channels=(4,), hidden=16)
        w, x, tt = _drift_inputs(tspec, 12, rng)
    elif model == "mlp":
        jspec = jmlp.spec((64, 32, 16, 10), act="gelu")
        tspec = mlp.spec((64, 32, 16, 10), act="gelu")
        w, x, tt = _drift_inputs(tspec, 12, rng)
    else:
        jspec = jmlp.spec((64, 8, 1), task="regression", act="tanh")
        tspec = mlp.spec((64, 8, 1), task="regression", act="tanh")
        w, x, _ = _drift_inputs(tspec, 12, rng)
        tt = rng.normal(size=(12, 1)).astype(np.float32)
    assert tspec.drift_per_chain_rate and tspec.fnn_topology is None
    jx, jt = jnp.asarray(x), jnp.asarray(tt)
    want = _vmapped(lambda wi: jspec.drift(wi, jx, jt, 0.01), w)
    got = tspec.drift(t(w), t(x), t(tt), 0.01)
    assert np.abs(want - w).max() > 1e-3  # the step moved the weights
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    # one rate per chain, what adapt_step_size with Langevin gradients uses
    lr = rng.uniform(0.001, 0.02, 6).astype(np.float32)
    want = np.asarray(jax.vmap(lambda wi, li: jspec.drift(wi, jx, jt, li))(
        jnp.asarray(w), jnp.asarray(lr)))
    got = tspec.drift(t(w), t(x), t(tt), t(lr))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert not got.requires_grad


def test_drift_in_chain_chunks_equals_the_whole():
    """``drift_chain_microbatch``: the chains are independent, so chunks of
    chains give the whole batch's numbers (rtol 1e-5: a product over fewer
    chains may block its sums otherwise)."""
    import ptnn_torch
    from ptnn_torch import kernel
    from ptnn_torch.sampler import make_dataset

    prob = load_digits(0)
    spec = cnn.digits_spec(channels=(4,), hidden=16)
    rng = np.random.default_rng(2)
    w = t((rng.normal(size=(8, spec.w_size)) * 0.2).astype(np.float32))
    lr = t(rng.uniform(0.001, 0.02, 8).astype(np.float32))
    outs = []
    for mb in (1, 4):
        cfg = ptnn_torch.PTConfig(
            task="classification", topology=(64, 16, 10), num_chains=8,
            num_samples=80, use_langevin_gradients=True,
            drift_chain_microbatch=mb).validate()
        data = make_dataset(cfg, prob.train[:32], prob.test[:8], "cpu")
        fn = kernel.make_step_fn(cfg, data, torch.ones(8), spec)
        outs.append((fn._drift(w, 0.01), fn._drift(w, lr)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_full_float32_restores_the_switches():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with full_float32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


@pytest.mark.parametrize("seed", [0, 3])
def test_load_digits_equals_ptnn(seed):
    a, b = load_digits(seed), jload_digits(seed)
    assert (a.name, a.task, a.topology) == (b.name, b.task, b.topology)
    assert a.train.shape == (1257, 65) and a.test.shape == (540, 65)
    np.testing.assert_array_equal(a.train, b.train)
    np.testing.assert_array_equal(a.test, b.test)
    np.testing.assert_array_equal(load("digits", seed).train, a.train)


def test_mnist_idx_loader_synthetic(tmp_path):
    rng = np.random.RandomState(0)
    imgs_tr = rng.randint(0, 256, (12, 28, 28), dtype=np.uint8)
    lab_tr = rng.randint(0, 10, (12,), dtype=np.uint8)
    imgs_te = rng.randint(0, 256, (5, 28, 28), dtype=np.uint8)
    lab_te = rng.randint(0, 10, (5,), dtype=np.uint8)

    def write_idx(path, arr, gz=False):
        hdr = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(
            f">{arr.ndim}I", *arr.shape)
        with (gzip.open if gz else open)(path, "wb") as f:
            f.write(hdr + arr.tobytes())

    write_idx(tmp_path / "train-images-idx3-ubyte", imgs_tr)
    write_idx(tmp_path / "train-labels-idx1-ubyte", lab_tr)
    write_idx(tmp_path / "t10k-images-idx3-ubyte.gz", imgs_te, gz=True)
    write_idx(tmp_path / "t10k-labels-idx1-ubyte.gz", lab_te, gz=True)
    prob = load_mnist(str(tmp_path))
    assert prob.train.shape == (12, 785) and prob.test.shape == (5, 785)
    np.testing.assert_allclose(prob.train[:, :-1],
                               imgs_tr.reshape(12, -1) / 255.0)
    np.testing.assert_array_equal(prob.train[:, -1], lab_tr)
    np.testing.assert_array_equal(prob.test[:, -1], lab_te)
    assert prob.topology == (784, 64, 10)
    with pytest.raises(FileNotFoundError):
        load_mnist(str(tmp_path / "nowhere"))


def test_model_params_from_numpy_is_the_checked_identity():
    spec = cnn.digits_spec(channels=(4,), hidden=16)
    w = np.random.default_rng(0).normal(size=(3, spec.w_size)).astype(
        np.float32)
    got = convert.model_params_from_numpy(jnp.asarray(w), spec)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), w)
    with pytest.raises(ValueError, match="not \\(chains"):
        convert.model_params_from_numpy(w[:, :-1], spec)
    with pytest.raises(ValueError, match="float32"):
        convert.model_params_from_numpy(w.astype(np.float64), spec)
