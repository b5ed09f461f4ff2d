"""The port's ``core/pipeline.py`` against the reference's.

The reference's params (its ``init_lstm`` under a JAX key) are carried
across with ``repro_torch.convert``; inputs come from numpy with a seed.

* ``pack_lstm_stack`` / ``pack_uniform`` give the reference's packed arrays
  exactly (zero padding moves values, it computes nothing).
* ``wavefront`` (the single-program schedule) and ``pipeline_lstm_stack``
  (through the executor's ``wavefront`` backend) at ``test_pipeline.py``'s
  dims and ``n_chunks`` in {1, 2, 5, 10}: within the reference's own
  tolerances of the reference's functions (1e-5 for one padded layer, 2e-5
  for a stack, 3e-5 for its chunk-invariance property): both run plain
  products in their framework's own summation order.
* ``wavefront_shard_map`` on a mesh of CPU stages: the reference's
  distributed test, held across packages (2e-5 of the reference's
  sequential stack), and equal to the port's single-program ``wavefront``
  to the same tolerance (a batched and an unbatched product may sum in
  other orders).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import pipeline as rpipe  # noqa: E402
from repro.core.lstm import LstmConfig as RLstmConfig  # noqa: E402
from repro.core.lstm import init_lstm as r_init_lstm  # noqa: E402
from repro.core.lstm import lstm_forward as r_lstm_forward  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.lstm import LstmConfig  # noqa: E402

DIMS = [
    [(1, 8), (8, 8)],                     # homogeneous pair
    [(1, 32), (32, 8), (8, 8), (8, 32)],  # the GW nominal stack (no sync)
    [(4, 16), (16, 16), (16, 16)],
]
N_CHUNKS = [1, 2, 5, 10]


def _stack(seed, dims):
    """(reference params, port params, port cfgs) of one stack."""
    r_cfgs = [RLstmConfig(in_dim=a, hidden=b) for a, b in dims]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(dims))
    r_params = [r_init_lstm(k, c) for k, c in zip(keys, r_cfgs)]
    t_params = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
                for p in r_params]
    return r_params, t_params, [LstmConfig(in_dim=a, hidden=b) for a, b in dims]


def _sequential(r_params, dims, xs):
    h = jax.numpy.asarray(xs)
    for p, (a, b) in zip(r_params, dims):
        h, _ = r_lstm_forward(p, h, RLstmConfig(in_dim=a, hidden=b))
    return np.asarray(h)


def _inputs(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module", params=range(len(DIMS)), ids=["pair", "gw_nominal", "w16"])
def stack(request):
    dims = DIMS[request.param]
    r_params, t_params, cfgs = _stack(request.param, dims)
    xs = _inputs(10 + request.param, (3, 20, dims[0][0]))
    return dims, r_params, t_params, cfgs, xs, _sequential(r_params, dims, xs)


def test_pack_uniform_equals_the_reference(stack):
    dims, r_params, t_params, _, _, _ = stack
    in_dims, hidden = [a for a, _ in dims], [b for _, b in dims]
    r_stacked, r_width = rpipe.pack_uniform(r_params, in_dims, hidden)
    t_stacked, t_width = tpipe.pack_uniform(t_params, in_dims, hidden)
    assert t_width == r_width
    for key in ("w_x", "w_h", "b"):
        np.testing.assert_array_equal(t_stacked[key].numpy(), np.asarray(r_stacked[key]))
    r_packed, r_d, r_h = rpipe.pack_lstm_stack(r_params, in_dims, hidden)
    t_packed, t_d, t_h = tpipe.pack_lstm_stack(t_params, in_dims, hidden)
    assert (t_d, t_h) == (r_d, r_h)
    np.testing.assert_array_equal(t_packed["w_x"].numpy(), np.asarray(r_packed["w_x"]))


@pytest.mark.parametrize("n_chunks", N_CHUNKS)
def test_wavefront_matches_the_reference(stack, n_chunks):
    """The single-program schedule on the uniform pack, function against
    function, and ``pipeline_lstm_stack`` against the reference's
    sequential stack (its own test's 2e-5)."""
    dims, r_params, t_params, cfgs, xs, want = stack
    in_dims, hidden = [a for a, _ in dims], [b for _, b in dims]
    r_stacked, width = rpipe.pack_uniform(r_params, in_dims, hidden)
    t_stacked, _ = tpipe.pack_uniform(t_params, in_dims, hidden)
    xs_p = np.pad(xs, ((0, 0), (0, 0), (0, width - xs.shape[-1])))
    r_out = np.asarray(rpipe.wavefront(r_stacked, jax.numpy.asarray(xs_p), n_chunks))
    t_out = tpipe.wavefront(t_stacked, torch.from_numpy(xs_p), n_chunks)
    np.testing.assert_allclose(t_out.numpy(), r_out, rtol=2e-5, atol=2e-5)
    got = tpipe.pipeline_lstm_stack(t_params, cfgs, torch.from_numpy(xs), n_chunks=n_chunks)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_pad_exactness():
    """A padded layer computes as the unpadded one on the real lanes (the
    reference's test, with the reference's single layer as the yardstick)."""
    r_params, t_params, _ = _stack(0, [(3, 5)])
    stacked, width = tpipe.pack_uniform(t_params, [3], [5])
    xs = _inputs(1, (2, 8, 3))
    ref, _ = r_lstm_forward(r_params[0], jax.numpy.asarray(xs), RLstmConfig(in_dim=3, hidden=5))
    out = tpipe.wavefront(stacked, torch.nn.functional.pad(torch.from_numpy(xs),
                                                           (0, width - 3)), n_chunks=2)
    np.testing.assert_allclose(out[..., :5].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_layers,hidden,n_chunks,seed", [
    (1, 2, 1, 0), (2, 7, 2, 1), (3, 12, 4, 2), (4, 5, 4, 3), (4, 12, 2, 4),
])
def test_chunk_invariance(n_layers, hidden, n_chunks, seed):
    """The reference's property test at fixed examples: any chunking of the
    window gives the sequential stack."""
    dims = [(2, hidden)] + [(hidden, hidden)] * (n_layers - 1)
    r_params, t_params, cfgs = _stack(seed, dims)
    xs = _inputs(seed, (2, 8, 2))
    got = tpipe.pipeline_lstm_stack(t_params, cfgs, torch.from_numpy(xs), n_chunks=n_chunks)
    np.testing.assert_allclose(got.numpy(), _sequential(r_params, dims, xs),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_shard_map_on_cpu_stages_matches_sequential(n_chunks):
    """The reference's 4-stage distributed test (its own script runs on
    virtual XLA devices): four one-layer stages on ``("cpu",) * 4``."""
    dims = [(1, 8), (8, 8), (8, 8), (8, 8)]
    r_params, t_params, _ = _stack(0, dims)
    xs = _inputs(1, (2, 16, 1))
    stacked, width = tpipe.pack_uniform(t_params, [a for a, _ in dims], [b for _, b in dims])
    xs_p = torch.nn.functional.pad(torch.from_numpy(xs), (0, width - 1))
    out = tpipe.wavefront_shard_map(stacked, xs_p, n_chunks, ("cpu",) * 4)
    np.testing.assert_allclose(out[..., :8].numpy(), _sequential(r_params, dims, xs),
                               rtol=2e-5, atol=2e-5)
    single = tpipe.wavefront(stacked, xs_p, n_chunks)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=2e-5, atol=2e-5)


def test_schedule_errors():
    stacked, _ = tpipe.pack_uniform(_stack(0, [(4, 4), (4, 4)])[1], [4, 4], [4, 4])
    xs = torch.zeros(1, 6, 4)
    with pytest.raises(ValueError, match="does not divide"):
        tpipe.wavefront(stacked, xs, 4)
    with pytest.raises(ValueError, match="stacked stages"):
        tpipe.wavefront_shard_map(stacked, xs, 2, ("cpu",) * 3)
    with pytest.raises(ValueError, match="does not divide"):
        tpipe.wavefront_shard_map(stacked, xs, 4, ("cpu",) * 2)
    with pytest.raises(ValueError, match="pack_uniform"):
        tpipe.wavefront(stacked, torch.zeros(1, 6, 3), 2)
