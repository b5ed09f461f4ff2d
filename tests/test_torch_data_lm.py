"""The port's synthetic LM token pipeline equals the reference's array for
array, for every seed, step and host shard (both are numpy only)."""

import numpy as np
import pytest

from repro.data import lm as rlm
from repro_torch.data import lm as tlm


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (4, 0), (4, 3)])
def test_batches_equal_reference(seed, n_hosts, host_id):
    kw = dict(vocab=257, seq_len=33, global_batch=8, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    tcfg, rcfg = tlm.LmDataConfig(**kw), rlm.LmDataConfig(**kw)
    assert tcfg.host_batch == rcfg.host_batch == 8 // n_hosts
    for step in (0, 1, 5, 1000):
        got, want = tlm.lm_batch(tcfg, step), rlm.lm_batch(rcfg, step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_stream_resumes_at_a_step():
    cfg = tlm.LmDataConfig(vocab=100, seq_len=9, global_batch=2, seed=3)
    stream = tlm.lm_stream(cfg, start_step=4)
    for step in range(4, 7):
        np.testing.assert_array_equal(next(stream)["tokens"], tlm.lm_batch(cfg, step)["tokens"])
