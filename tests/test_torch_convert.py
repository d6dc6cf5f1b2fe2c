"""A ptnn ChainState survives numpy -> ptnn_torch -> numpy bit for bit."""

import jax
import numpy as np
import pytest
import torch

import ptnn
from ptnn import kernel as jkernel
from ptnn import sampler as jsampler
from ptnn.data import load_regression
from ptnn_torch import convert

torch.set_num_threads(1)


@pytest.mark.parametrize("optional", [False, True])
def test_chain_state_round_trip_is_bit_exact(optional):
    prob = load_regression("Sunspot")
    cfg = ptnn.PTConfig(task="regression", topology=(4, 10, 1),
                        num_samples=5 * 20, num_chains=5,
                        adapt_step_size=optional,
                        track_replicas=optional).validate()
    data = jsampler.make_dataset(cfg, prob.train, prob.test)
    st = jkernel.init_state(jax.random.PRNGKey(4), cfg, data)
    src = {k: (None if v is None else np.asarray(v))
           for k, v in jax.device_get(st)._asdict().items()}

    back = convert.chain_state_to_numpy(convert.chain_state_from_numpy(src))
    assert set(back) == set(convert.FIELDS)
    for k, v in back.items():
        if src[k] is None:
            assert v is None, k
            continue
        assert v.dtype == src[k].dtype and v.shape == src[k].shape, k
        assert v.tobytes() == src[k].tobytes(), k
    assert (back["log_step_w"] is not None) == optional
    assert (back["replica_id"] is not None) == optional
    # the accuracy carries and the Langevin counter start at 0
    for k in ("acc_train", "acc_test", "n_langevin"):
        assert not np.any(src[k]), k
    for k in ("fx_train", "g_like", "surr", "vr_mean"):
        assert src[k] is None, k


def test_missing_field_raises():
    with pytest.raises(KeyError, match="eta"):
        convert.chain_state_from_numpy({"w": np.zeros((2, 3), np.float32)})
