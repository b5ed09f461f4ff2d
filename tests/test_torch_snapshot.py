"""Snapshots across the two packages, and the port's fingerprint.

A reference engine's ``save_snapshot`` restores into the port's engine and
the reverse; the restored engine then scores within 1e-5 of the other
package's engine continuing on its own (the packages round differently,
so across them the tolerance is the reference's own 1e-5).  Inside the
port, snapshot + restore is bit-equal.  A mismatched fingerprint or
schema version raises ``SnapshotMismatchError`` in both directions.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.autoencoder import AutoencoderConfig as RConfig  # noqa: E402
from repro.core.autoencoder import init_autoencoder as r_init  # noqa: E402
from repro.serve import engine as reng  # noqa: E402
from repro.serve import health as rhealth  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.autoencoder import AutoencoderConfig  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import health as thealth  # noqa: E402

T = 12
_R_CFG = RConfig(hidden=(9, 9), latent_boundary=1, timesteps=T)
_T_CFG = AutoencoderConfig(hidden=(9, 9), latent_boundary=1, timesteps=T)
_R_PARAMS = r_init(jax.random.PRNGKey(7), _R_CFG)
_T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, _R_PARAMS), "cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = ["fused_step", "kernel"]


def _ref(impl, **kw):
    return reng.StreamingAnomalyEngine(_R_PARAMS, _R_CFG, batch=kw.pop("batch", 1),
                                       impl=impl, **kw)


def _port(impl, **kw):
    return teng.StreamingAnomalyEngine(_T_PARAMS, _T_CFG, batch=kw.pop("batch", 1),
                                       impl=impl, device="cpu", **kw)


def _data(seed):
    return np.random.RandomState(seed).randn(3, 3 * T, 1).astype(np.float32)


def _first_half(eng, x):
    """Pool streams at ragged fill levels, one with a completed window."""
    eng.push_many(["a", "b"], x[:2, :5])
    eng.push_many(["a", "b", "c"], x[:, 5:16])
    eng.threshold = 0.75


def _second_half(eng, x):
    out = {sid: [] for sid in "abc"}
    for a, b in ((16, 20), (20, 2 * T + 3)):
        for sid, scores in eng.push_many(["a", "b", "c"], x[:, a:b]).items():
            out[sid] += [np.asarray(s) for s in scores]
    return out


def _scores_close(got, want, **tol):
    assert got.keys() == want.keys()
    for sid in want:
        assert len(got[sid]) == len(want[sid]) >= 1
        for g, w in zip(got[sid], want[sid]):
            if tol:
                np.testing.assert_allclose(g, w, **tol)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("impl", IMPLS)
def test_fingerprints_read_the_same(impl):
    assert _port(impl).fingerprint() == _ref(impl).fingerprint()
    bf = dataclasses.replace(_T_CFG, dtype=torch.bfloat16)
    fp = teng.StreamingAnomalyEngine(_T_PARAMS, bf, impl=impl, device="cpu").fingerprint()
    assert fp["dtype"] == "bfloat16"


@pytest.mark.parametrize("impl", IMPLS)
def test_reference_snapshot_restores_in_port(tmp_path, impl):
    path = str(tmp_path / "ref.npz")
    x = _data(1)
    src = _ref(impl)
    _first_half(src, x)
    src.save_snapshot(path)
    dst = _port(impl)
    dst.restore(path)
    assert dst.threshold == 0.75 and dst.stream_ids == ("a", "b", "c")
    _scores_close(_second_half(dst, x), _second_half(src, x), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_port_snapshot_restores_in_reference(tmp_path, impl):
    path = str(tmp_path / "port.npz")
    x = _data(2)
    src = _port(impl)
    _first_half(src, x)
    src.save_snapshot(path)
    dst = _ref(impl)
    dst.restore(path)
    assert dst.threshold == 0.75 and set(dst.stream_ids) == {"a", "b", "c"}
    _scores_close(_second_half(dst, x), _second_half(src, x), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_port_snapshot_roundtrip_bit_equal(tmp_path, impl):
    path = str(tmp_path / "port.npz")
    x = _data(3)
    src = _port(impl)
    _first_half(src, x)
    lock = _port(impl, batch=2)
    lock.push(x[:2, :7])
    src.save_snapshot(path)
    lock_snap = lock.snapshot()
    dst, dst_lock = _port(impl), _port(impl, batch=2)
    dst.restore(path)
    dst_lock.restore(lock_snap)
    _scores_close(_second_half(dst, x), _second_half(src, x))
    np.testing.assert_array_equal(dst_lock.push(x[:2, 7:T])[0], lock.push(x[:2, 7:T])[0])


def test_mismatched_fingerprint_refused_both_ways(tmp_path):
    other_r = RConfig(hidden=(6, 6), latent_boundary=1, timesteps=T)
    r_other = reng.StreamingAnomalyEngine(r_init(jax.random.PRNGKey(1), other_r), other_r)
    p_path, r_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    _port("fused_step").save_snapshot(p_path)
    _ref("fused_step").save_snapshot(r_path)
    with pytest.raises(rhealth.SnapshotMismatchError, match="hidden"):
        r_other.restore(p_path)
    with pytest.raises(thealth.SnapshotMismatchError, match="state_layout"):
        _port("kernel").restore(r_path)
    with pytest.raises(rhealth.SnapshotMismatchError, match="carry_state"):
        _ref("fused_step", carry_state=True).restore(p_path)
    with pytest.raises(thealth.SnapshotMismatchError, match="window"):
        _port("fused_step", window=6).restore(r_path)


def test_version_gate_both_ways(tmp_path):
    p_path, r_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    snap = _port("fused_step").snapshot()
    snap["version"] = thealth.SNAPSHOT_VERSION + 1
    thealth.write_snapshot(p_path, snap)
    with pytest.raises(rhealth.SnapshotMismatchError, match="version"):
        _ref("fused_step").restore(p_path)
    rsnap = _ref("fused_step").snapshot()
    rsnap["version"] = rhealth.SNAPSHOT_VERSION + 1
    rhealth.write_snapshot(r_path, rsnap)
    with pytest.raises(thealth.SnapshotMismatchError, match="version"):
        _port("fused_step").restore(r_path)
    assert thealth.SNAPSHOT_VERSION == rhealth.SNAPSHOT_VERSION == 1


def test_health_module_matches_reference():
    """The copied leaf: same screen verdicts, same config validation."""
    for chunk in (np.zeros((3, 1)), np.full((2, 1), np.nan), np.full((2, 1), -np.inf),
                  np.full((2, 1), 50.0)):
        for limit in (None, 10.0):
            assert thealth.screen_chunk(chunk, limit) == rhealth.screen_chunk(chunk, limit)
    for kw in (dict(sanitize="drop"), dict(state_limit=0), dict(max_backoff_s=0.001),
               dict(drain_deadline_s=0), dict(checkpoint_interval_s=-1.0)):
        with pytest.raises(ValueError):
            thealth.HealthConfig(**kw)
        with pytest.raises(ValueError):
            rhealth.HealthConfig(**kw)
    assert dataclasses.asdict(thealth.HealthConfig()) == dataclasses.asdict(
        rhealth.HealthConfig())
