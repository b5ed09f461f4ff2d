"""Decode attention (K5) against the reference, on the CPU.

The port's ``decode_attn_op`` runs its plain version here
(``decode_attn_plain``, the CUDA kernel's arithmetic: q scaled first, an
fp32 softmax partial per split of ``SPLIT_ROWS`` cache rows, the partials
combined in split order).  It is held to the reference's Pallas
``decode_attn_op`` in interpret mode and to its oracle ``decode_attn_ref``,
with inputs made by numpy from a seed, over the head geometries of every
dense config, cache lengths that are not a multiple of either package's
block, lengths at the edges of a split, and ragged per-row lengths down to
1.  Tolerances
are the reference's own for this kernel (``tests/test_ssd_decode_kernels.py``):
rtol/atol 2e-5 in fp32 (the two packages sum the scores and the softmax in
other orders) and 0.03 in bf16 (one rounding of the output to bf16).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import decode_attn_op as r_op  # noqa: E402
from repro.kernels.decode_attn import decode_attn_ref as _r_ref  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attn,
    decode_attn_op,
    decode_attn_plain,
    decode_attn_ref,
)
from repro_torch.kernels.decode_attn.decode_attn import (  # noqa: E402
    BLOCK_S,
    SPLIT_ROWS,
    n_splits,
)

r_ref = jax.jit(_r_ref)  # op-by-op dispatch takes several times longer

TOL = {"fp32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=0.03, atol=0.03)}
#: (Hq, Hkv, D) of smollm-360m, granite-3-2b, qwen1.5-4b and yi-9b
GEOMETRIES = [(15, 5, 64), (32, 8, 64), (20, 20, 128), (32, 4, 128)]


def _inputs(seed, b, s, hq, hkv, d, lengths, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    lens = np.asarray(lengths, np.int32)
    ref = tuple(jnp.asarray(a, jdt) for a in (q, k, v)) + (jnp.asarray(lens),)
    port = tuple(torch.from_numpy(a).to(tdt) for a in (q, k, v)) + (torch.from_numpy(lens),)
    return ref, port


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", GEOMETRIES)
def test_plain_matches_reference_kernel_and_oracle(hq, hkv, d, dtype):
    # S = 70 is a multiple of neither BLOCK_S (32) nor the reference's block
    # (32 here, padded by its wrapper); lengths ragged, one row at length 1
    s, lengths = 70, [70, 33, 1]
    ref, port = _inputs(hq + d, 3, s, hq, hkv, d, lengths, dtype)
    got = decode_attn_op(*port)
    assert got.dtype == port[0].dtype and got.shape == (3, hq, d)
    want_kernel = r_op(*ref, block_s=32, interpret=True)
    want_oracle = r_ref(*ref)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want_oracle), **TOL[dtype])


@pytest.mark.parametrize("s,lengths", [(1, [1, 1]), (BLOCK_S, [BLOCK_S, 5]),
                                       (BLOCK_S + 1, [BLOCK_S + 1, BLOCK_S]),
                                       (100, [1, 99])])
def test_lengths_at_block_edges(s, lengths):
    ref, port = _inputs(s, 2, s, 8, 2, 16, lengths, "fp32")
    got = decode_attn_op(*port)
    np.testing.assert_allclose(_np(got), _np(r_ref(*ref)), **TOL["fp32"])
    np.testing.assert_allclose(_np(got), _np(decode_attn_ref(*port)), **TOL["fp32"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s,lengths", [
    # one below, at and one above a split
    (SPLIT_ROWS + 1, [SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1]),
    # shorter than one split, in a cache of one split
    (SPLIT_ROWS, [5, SPLIT_ROWS - 1, 2]),
    # S not a multiple of SPLIT_ROWS; a row of length 1 beside a full one
    (2 * SPLIT_ROWS + 7, [2 * SPLIT_ROWS + 7, 1, SPLIT_ROWS + 3]),
])
def test_lengths_at_split_edges(s, lengths, dtype):
    ref, port = _inputs(s + len(lengths), len(lengths), s, 6, 2, 16, lengths, dtype)
    got = decode_attn_op(*port)
    assert got.dtype == port[0].dtype and got.shape == (len(lengths), 6, 16)
    np.testing.assert_allclose(_np(got), _np(r_op(*ref, block_s=32, interpret=True)),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(r_ref(*ref)), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(decode_attn_ref(*port)), **TOL[dtype])


@pytest.mark.parametrize("lengths", [[SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, 1],
                                     [3, 2 * SPLIT_ROWS + 5, 2 * SPLIT_ROWS, SPLIT_ROWS + 2]])
def test_nan_past_every_length_is_never_read(lengths):
    """NaN in K and V past every row's length, at the split edges: the
    output is finite and equal, bit for bit, to the output without it."""
    s = 2 * SPLIT_ROWS + 5
    _, (q, k, v, lens) = _inputs(7, len(lengths), s, 6, 3, 16, lengths, "fp32")
    want = decode_attn_plain(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:] = float("nan")
        v2[b, n:] = float("nan")
    got = decode_attn_plain(q, k2, v2, lens)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_splits_are_a_fixed_number_of_rows():
    """The split is a constant number of cache rows (a row's output must not
    depend on the batch it is served in), staged in blocks of BLOCK_S."""
    assert SPLIT_ROWS % BLOCK_S == 0
    assert [n_splits(s) for s in (1, SPLIT_ROWS, SPLIT_ROWS + 1, 576)] == \
        [1, 1, 2, -(-576 // SPLIT_ROWS)]


def test_rows_past_the_length_are_never_read():
    """Garbage (even NaN) past a row's length does not reach its output."""
    _, (q, k, v, lens) = _inputs(3, 2, 50, 6, 3, 16, [20, 41], "fp32")
    want = decode_attn_plain(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[0, 20:] = float("nan")
    v2[1, 41:] = float("inf")
    torch.testing.assert_close(decode_attn_plain(q, k2, v2, lens), want, rtol=0, atol=0)


def test_cpu_runs_plain_and_counts_no_launch():
    _, port = _inputs(0, 2, 10, 4, 2, 8, [10, 3], "fp32")
    before = decode_attn.launches
    torch.testing.assert_close(decode_attn(*port), decode_attn_plain(*port), rtol=0, atol=0)
    assert decode_attn.launches == before


@pytest.mark.parametrize("bad", ["dtype", "heads", "lengths"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    _, (q, k, v, lens) = _inputs(0, 2, 10, 4, 2, 8, [10, 3], "fp32")
    if bad == "dtype":
        q = q.to(torch.bfloat16)
    elif bad == "heads":
        q = torch.zeros(2, 5, 8)
    else:
        lens = lens[:1]
    with pytest.raises(ValueError, match="decode_attn"):
        decode_attn(q, k, v, lens)
