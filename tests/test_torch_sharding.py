"""The port's sharding rules (``launch/sharding.py``) and mesh helpers
(``launch/mesh.py``) against the reference's.

* The reference's rule-engine cases (``tests/test_launch_sharding.py``),
  mirrored on the port's tables.
* For every arch at full width (``abstract_params``), every mode
  (``train``, ``serve``, ``serve_2d``, ``dp``) and four mesh shapes (the
  reference's (16, 16) and (2, 16, 16), the port's (32, 8) and
  (2, 32, 8)), every leaf's spec equals the reference's ``_spec_for`` on
  the same path, shape and {axis: size}; so do the optimizer, batch and
  cache specs (the reference's functions with ``NamedSharding`` standing
  in as the bare spec).  Every spec converts to DTensor placements: a dim
  that names several axes names them in the mesh's order, the order in
  which DTensor and JAX agree (``test_torch_dryrun.py`` holds the shard
  DTensor gives such a dim against JAX's order on real ranks).
"""

import jax
import pytest
from jax.sharding import PartitionSpec as P

import repro.launch.sharding as R
from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.models.api import abstract_cache as r_abstract_cache
from repro.models.api import abstract_params as r_abstract_params
from repro.train.optimizer import init_opt_state as r_init_opt_state
from repro_torch.configs import ARCHS, SHAPES, cell_supported
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import data_axes, model_size, placements
from repro_torch.models.api import abstract_cache, abstract_params, fake_mode
from repro_torch.train.optimizer import init_opt_state
from repro_torch.tree import flatten


class _Leaf:
    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)


class FakeMesh:
    """A mesh's {axis: size} and axis names (the reference's test stand-in)."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {
    "ref_pod_16x16": {"data": 16, "model": 16},
    "ref_multipod_2x16x16": {"pod": 2, "data": 16, "model": 16},
    "pod_32x8": {"data": 32, "model": 8},
    "multipod_2x32x8": {"pod": 2, "data": 32, "model": 8},
}
MODES = ("train", "serve", "serve_2d", "dp")


class TestRuleEngine:
    def test_train_2d_fsdp(self):
        assert S._spec_for("layers/attn/wq", _Leaf((4, 64, 512)), S._TRAIN_RULES) \
            == (None, "data", "model")
        assert S._spec_for("layers/mlp/w_down", _Leaf((4, 512, 64)), S._TRAIN_RULES) \
            == (None, "model", "data")
        assert S._spec_for("embed", _Leaf((1024, 64)), S._TRAIN_RULES) == ("model", "data")

    def test_moe_vs_dense_disambiguation(self):
        assert S._spec_for("layers/moe/w_gate", _Leaf((4, 16, 64, 128)), S._TRAIN_RULES) \
            == (None, "model", "data", None)
        assert S._spec_for("layers/mlp/w_gate", _Leaf((4, 64, 128)), S._TRAIN_RULES) \
            == (None, "data", "model")

    def test_norms_replicated(self):
        assert S._spec_for("layers/ln1", _Leaf((4, 64)), S._TRAIN_RULES) == ()

    def test_sanitizer_drops_nondivisible(self):
        spec = S._spec_for("embed", _Leaf((49155, 64)), S._TRAIN_RULES,
                           FakeMesh({"data": 1, "model": 1}))
        assert spec == ("model", "data")
        spec = S._spec_for("embed", _Leaf((49155, 64)), S._TRAIN_RULES, FakeMesh(MESHES["pod_32x8"]))
        assert spec == (None, "data")

    def test_serve_candidates_fallback(self):
        """60 experts don't divide a 16-way model axis -> fall through to
        the (d, ff) candidate."""
        spec = S._spec_for("layers/moe/w_gate", _Leaf((24, 60, 2048, 1408)), S._SERVE_RULES,
                           FakeMesh(MESHES["ref_pod_16x16"]))
        assert spec == (None, None, "data", "model")

    def test_dp_rules_strip_model(self):
        assert S._spec_for("layers/attn/wq", _Leaf((4, 64, 512)), S._DP_RULES) \
            == (None, "data", None)

    def test_tables_are_the_reference_tables(self):
        for mine, ref in ((S._TRAIN_RULES, R._TRAIN_RULES), (S._SERVE_RULES, R._SERVE_RULES),
                          (S._DP_RULES, R._DP_RULES)):
            assert mine == ref

    def test_mesh_helpers(self):
        mesh = FakeMesh(MESHES["multipod_2x32x8"])
        assert data_axes(mesh) == ("pod", "data") and model_size(mesh) == 8
        assert data_axes(FakeMesh(MESHES["pod_32x8"])) == ("data",)

    def test_placements_refuse_an_order_dtensor_would_not_keep(self):
        with pytest.raises(ValueError, match="order"):
            placements(FakeMesh(MESHES["pod_32x8"]), (("model", "data"),))


def _leaves(tree) -> dict:
    """A reference tree (of arrays, ShapeDtypeStructs or specs) -> {path: leaf}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {R._path_str(path): leaf for path, leaf in flat}


def _canon(spec) -> tuple:
    """A spec with one-axis tuples written as the axis (JAX's
    ``PartitionSpec`` keeps ``("data",)`` as ``"data"``; the two name the
    same placement)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _ref(spec) -> tuple:
    return _canon(tuple(spec))


@pytest.fixture
def bare_named_sharding(monkeypatch):
    """The reference's rule functions return their specs bare."""
    monkeypatch.setattr(R, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, bare_named_sharding):
    ref_params = _leaves(r_abstract_params(R_ARCHS[arch]))
    mine = flatten(abstract_params(ARCHS[arch]))
    assert set(mine) == set(ref_params)
    for mesh_name, sizes in MESHES.items():
        mesh = FakeMesh(sizes)
        for mode in MODES:
            rules = {"serve": R._SERVE_RULES, "dp": R._DP_RULES}.get(mode, R._TRAIN_RULES)
            mine_rules = {"serve": S._SERVE_RULES, "dp": S._DP_RULES}.get(mode, S._TRAIN_RULES)
            ref_specs = _leaves(R.param_shardings(mesh, r_abstract_params(R_ARCHS[arch]), mode))
            specs = flatten(S.param_shardings(mesh, abstract_params(ARCHS[arch]), mode))
            for path, leaf in mine.items():
                want = _ref(R._spec_for(path, ref_params[path], rules, mesh))
                assert S._spec_for(path, leaf, mine_rules, mesh) == want, (mesh_name, mode, path)
                assert specs[path] == _ref(ref_specs[path]) == want, (mesh_name, mode, path)
                placements(mesh, specs[path])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_batch_cache_specs_match_reference(arch, bare_named_sharding):
    from repro.models.api import input_specs as r_input_specs
    from repro_torch.models.api import input_specs

    rcfg, cfg = R_ARCHS[arch], ARCHS[arch]
    r_params = r_abstract_params(rcfg)
    r_opt = jax.eval_shape(lambda p: r_init_opt_state(p), r_params)
    params = abstract_params(cfg)
    with fake_mode():
        opt = init_opt_state(params)
    for mesh_name, sizes in MESHES.items():
        mesh = FakeMesh(sizes)
        for mode in ("train", "dp"):
            want = _leaves(R.opt_shardings(mesh, r_opt, None, mode))
            got = flatten(S.opt_shardings(mesh, opt, None, mode))
            assert set(got) == set(want)
            for path, spec in got.items():
                assert spec == _ref(want[path]), (mesh_name, mode, path)
                placements(mesh, spec)
        for name, shape in SHAPES.items():
            if not cell_supported(cfg, shape)[0]:
                continue
            rshape = R_SHAPES[name]
            for extra in ((), ("model",)):
                want = _leaves(R.batch_shardings(mesh, r_input_specs(rcfg, rshape), rshape, extra))
                got = S.batch_shardings(mesh, input_specs(cfg, shape), shape, extra)
                assert set(got) == set(want)
                for path, spec in got.items():
                    assert _canon(spec) == _ref(want[path]), (mesh_name, name, extra, path)
                    placements(mesh, spec)
            if shape.kind != "decode":
                continue
            want = _leaves(R.cache_shardings(mesh, r_abstract_cache(rcfg, rshape), rcfg, rshape))
            got = flatten(S.cache_shardings(mesh, abstract_cache(cfg, shape), cfg, shape))
            assert set(got) == set(want)
            for path, spec in got.items():
                assert _canon(spec) == _ref(want[path]), (mesh_name, name, path)
                placements(mesh, spec)
