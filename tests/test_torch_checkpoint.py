"""``repro_torch.train.checkpoint`` in the reference's on-disk format.

The reference's own checkpoint cases (``tests/test_substrate.py::
TestCheckpoint``) run on the port, then the two packages read each other's
checkpoints: keys, shapes and dtypes equal, values bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as RManager
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import flatten, tree_map


def tree(v=1.0):
    return {
        "params": {"w": torch.full((8, 8), v), "b": torch.zeros(8)},
        "opt": {"m": {"w": torch.zeros(8, 8), "b": torch.zeros(8)},
                "step": torch.tensor(3, dtype=torch.int32)},
    }


def test_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    cm.save(10, tree(2.5), metrics={"loss": 0.5})
    out = cm.restore(tree(0.0))
    assert torch.equal(out["params"]["w"], torch.full((8, 8), 2.5))
    assert out["opt"]["step"].dtype == torch.int32 and int(out["opt"]["step"]) == 3
    assert cm.manifest()["metrics"]["loss"] == 0.5


def test_keep_k_retention(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree(float(s)))
    assert cm.all_steps() == [3, 4]
    assert torch.equal(cm.restore(tree(), step=4)["params"]["w"], torch.full((8, 8), 4.0))


def test_async_save(tmp_path):
    cm = CheckpointManager(tmp_path)
    t = tree(7.0)
    cm.save_async(7, t)
    t["params"]["w"].fill_(-1.0)  # the host copy was taken at the call
    cm.wait()
    assert cm.latest() == 7
    assert torch.equal(cm.restore(tree())["params"]["w"], torch.full((8, 8), 7.0))


def test_async_write_error_is_raised_by_wait(tmp_path, monkeypatch):
    cm = CheckpointManager(tmp_path)

    def broken(*_, **__):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    cm.save_async(1, tree())
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    assert cm.all_steps() == [] and not list(tmp_path.iterdir())


def test_interrupted_write_invisible(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, tree())
    (tmp_path / "step_0000000002.tmp-999").mkdir()
    assert cm.all_steps() == [1]
    assert cm.latest() == 1


def test_restore_missing_raises(tmp_path):
    cm = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        cm.restore(tree())
    cm.save(1, {"params": {"w": torch.ones(2)}})
    with pytest.raises(KeyError, match="params/b"):
        cm.restore({"params": {"w": torch.ones(2), "b": torch.ones(2)}})


def test_restore_places_on_device_and_casts_to_like(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"w": torch.arange(6.0).reshape(2, 3), "h": torch.ones(4, dtype=torch.bfloat16)})
    out = cm.restore({"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                      "h": torch.zeros(4, dtype=torch.bfloat16)}, device="cpu")
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert torch.equal(out["w"].float(), torch.arange(6.0).reshape(2, 3))
    assert torch.equal(out["h"], torch.ones(4, dtype=torch.bfloat16))
    assert cm.manifest()["dtypes"] == {"h": "bfloat16", "w": "float32"}


def _gw_tree(seed):
    """A GW train state: params and AdamW state, in jax and torch form."""
    from repro.configs.gw import GW_MODELS
    from repro.core.autoencoder import init_autoencoder
    from repro.train.optimizer import AdamWConfig, init_opt_state

    params = init_autoencoder(jax.random.PRNGKey(seed), GW_MODELS["gw_small"])
    opt = init_opt_state(params, AdamWConfig())
    opt = {**opt, "m": jax.tree_util.tree_map(lambda p: p * 0.5, params),
           "step": jnp.asarray(17, jnp.int32)}
    jtree = {"params": params, "opt": opt}
    return jtree, tree_map(lambda a: torch.from_numpy(np.array(a)), jtree)


def _assert_same(torch_tree, jax_tree):
    want = {k: np.asarray(v) for k, v in flatten(jax.tree_util.tree_map(np.asarray,
                                                                         jax_tree)).items()}
    got = flatten(torch_tree)
    assert list(got) == list(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_bf16_leaf_restores_into_a_wider_like(tmp_path):
    """bf16 goes to disk as 2-byte items; they are read as bf16 bits
    whatever the ``like`` leaf's dtype."""
    cm = CheckpointManager(str(tmp_path))
    h = torch.tensor([1.5, -2.25, 3.0e-3, 65280.0], dtype=torch.bfloat16)
    cm.save(1, {"h": h})
    out = cm.restore({"h": torch.zeros(4)})
    assert out["h"].dtype == torch.float32 and torch.equal(out["h"], h.float())


def test_port_restores_a_reference_checkpoint(tmp_path):
    jtree, ttree = _gw_tree(0)
    RManager(tmp_path).save(17, jtree, metrics={"loss": 1.25})
    cm = CheckpointManager(tmp_path)
    out = cm.restore(tree_map(torch.zeros_like, ttree))
    _assert_same(out, jtree)
    assert cm.manifest()["step"] == 17


def test_reference_restores_a_port_checkpoint(tmp_path):
    jtree, ttree = _gw_tree(1)
    CheckpointManager(tmp_path).save(5, ttree, metrics={"loss": 0.75})
    rm = RManager(tmp_path)
    out = rm.restore(jax.tree_util.tree_map(jnp.zeros_like, jtree))
    _assert_same(ttree, out)
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
    manifest = json.loads((tmp_path / "step_0000000005" / "manifest.json").read_text())
    ref_dir = tmp_path / "ref"
    RManager(ref_dir).save(5, jtree, metrics={"loss": 0.75})
    want = json.loads((ref_dir / "step_0000000005" / "manifest.json").read_text())
    for key in ("step", "keys", "shapes", "dtypes", "metrics"):
        assert manifest[key] == want[key], key
