"""The port's swap sweeps against ptnn.parallel.swap.

The uniforms are drawn from the key exactly as ptnn's sweeps draw them
(``jax.random.uniform(key, (C-1,))``) and handed to the port. Permutations
and counts must match exactly, expected pair acceptances within 1e-6. The
vectorised bubbling sweep is also held against the plain sequential loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.parallel import swap as jswap
from ptnn_torch.parallel import swap as tswap

torch.set_num_threads(1)

RULES = ("half_exp", "unclamped", "metropolis")


def _inputs(rng, c, rule, masked, ladders=2):
    scale = 20.0 if rule == "metropolis" else 1.5
    payload = (rng.normal(size=c) * scale).astype(np.float32)
    payload[c // 3] += 800.0  # past the exp clamp (709)
    betas = (1.0 / np.geomspace(1.0, 5.0, c)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(c - 1) + 1) % max(c // ladders, 1) != 0
    return payload, betas, mask


def _us(key, c):
    return np.array(jax.random.uniform(key, (c - 1,), dtype=jnp.float32))


def _sequential(payload, us, rule, betas, mask):
    """The sweep as the reference runs it: pair after pair."""
    c = payload.shape[0]
    perm = torch.arange(c)
    ll = payload.clone()
    n_acc, accs = 0, []
    for k in range(c - 1):
        a = tswap.pair_accept_prob(ll[k], ll[k + 1], rule, betas[k],
                                   betas[k + 1])
        active = True if mask is None else bool(mask[k])
        if active and us[k] < a:
            perm[[k, k + 1]] = perm[[k + 1, k]]
            ll[[k, k + 1]] = ll[[k + 1, k]]
            n_acc += 1
        accs.append(float(a) if active else 0.0)
    return perm, n_acc, np.asarray(accs, np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rule", RULES)
def test_sweep_permutation_matches_ptnn(rng, rule, masked):
    for c, seed in ((2, 0), (9, 1), (9, 2), (33, 3)):
        payload, betas, mask = _inputs(rng, c, rule, masked)
        key = jax.random.PRNGKey(seed)
        jb = jnp.asarray(betas) if rule == "metropolis" else None
        jm = None if mask is None else jnp.asarray(mask)
        ref = jswap.sweep_permutation(jnp.asarray(payload), key, rule=rule,
                                      betas=jb, pair_mask=jm)
        us = torch.from_numpy(_us(key, c))
        tb = torch.from_numpy(betas) if rule == "metropolis" else None
        tm = None if mask is None else torch.from_numpy(mask)
        got = tswap.sweep_permutation(torch.from_numpy(payload), us,
                                      rule=rule, betas=tb, pair_mask=tm)
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
        assert int(got.n_accepted) == int(ref.n_accepted), (c, seed)
        assert int(got.n_proposed) == int(ref.n_proposed)
        np.testing.assert_array_equal(got.pair_active.numpy(),
                                      np.asarray(ref.pair_active))
        np.testing.assert_allclose(got.pair_accept.numpy(),
                                   np.asarray(ref.pair_accept), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rule", RULES)
def test_sweep_permutation_matches_sequential_loop(rng, rule, masked):
    """Long ladders (many pointer-doubling rounds) against the loop."""
    for c in (2, 9, 64, 129, 300):
        payload, betas, mask = _inputs(rng, c, rule, masked, ladders=3)
        us = torch.from_numpy(rng.uniform(size=c - 1).astype(np.float32))
        tb = torch.from_numpy(betas) if rule == "metropolis" else None
        tm = None if mask is None else torch.from_numpy(mask)
        got = tswap.sweep_permutation(torch.from_numpy(payload), us,
                                      rule=rule, betas=tb, pair_mask=tm)
        seq = _sequential(torch.from_numpy(payload), us, rule,
                          torch.from_numpy(betas), mask)
        np.testing.assert_array_equal(got.perm.numpy(), seq[0].numpy())
        assert int(got.n_accepted) == seq[1], c
        np.testing.assert_allclose(got.pair_accept.numpy(), seq[2], atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rule", RULES)
def test_disjoint_pair_permutation_matches_ptnn(rng, rule, masked):
    for c, seed in ((2, 0), (9, 1), (33, 2)):
        payload, betas, mask = _inputs(rng, c, rule, masked)
        key = jax.random.PRNGKey(seed)
        jb = jnp.asarray(betas) if rule == "metropolis" else None
        tb = torch.from_numpy(betas) if rule == "metropolis" else None
        for parity in (0, 1):
            ref = jswap.disjoint_pair_permutation(
                jnp.asarray(payload), key, rule=rule, betas=jb, parity=parity,
                pair_mask=None if mask is None else jnp.asarray(mask))
            got = tswap.disjoint_pair_permutation(
                torch.from_numpy(payload), torch.from_numpy(_us(key, c)),
                rule=rule, betas=tb, parity=parity,
                pair_mask=None if mask is None else torch.from_numpy(mask))
            np.testing.assert_array_equal(got.perm.numpy(),
                                          np.asarray(ref.perm))
            assert int(got.n_accepted) == int(ref.n_accepted)
            assert int(got.n_proposed) == int(ref.n_proposed)
            np.testing.assert_allclose(got.pair_accept.numpy(),
                                       np.asarray(ref.pair_accept), atol=1e-6)


def test_apply_permutation_and_pair_mask(rng):
    perm = torch.tensor([2, 0, 1])
    a = torch.arange(3.0)
    b = torch.arange(6.0).reshape(3, 2)
    pa, pb = tswap.apply_permutation(perm, a, b)
    ja, jb = jswap.apply_permutation(jnp.asarray([2, 0, 1]),
                                     jnp.arange(3.0),
                                     jnp.arange(6.0).reshape(3, 2))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    # ptnn/kernel.py's ensemble mask: pairs crossing a ladder boundary off
    expected = (np.arange(11) + 1) % 4 != 0
    np.testing.assert_array_equal(tswap.pair_mask(12, 4).numpy(), expected)
    assert tswap.pair_mask(12, 12) is None
    with pytest.raises(ValueError, match="betas"):
        tswap.sweep_permutation(torch.zeros(4), torch.zeros(3),
                                rule="metropolis")
