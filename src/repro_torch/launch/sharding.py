"""Parameter / input / cache sharding rules for every (arch x shape x mesh):
the port of ``repro/launch/sharding.py``.

The rule tables, the sanitizer and the rule engine are the reference's;
a spec is its ``PartitionSpec`` as a tuple (``()`` for fully replicated,
as the reference's ``P()``), and ``distribute`` turns a tree and its specs
into DTensors (``launch/mesh.placements``).  A "mesh" here is a
``DeviceMesh`` or anything whose ``shape`` is an {axis: size} dict.

Two rule sets:

* ``train``: 2-D sharding.  The "model" axis carries tensor/expert
  parallelism and the "data" axis additionally shards parameter and
  optimizer state storage (FSDP / ZeRO-3).  FSDP stays on the intra-pod
  "data" axis; only gradient reductions cross the "pod" axis.

* ``serve``: 1-D.  Weights sharded over "model" only (no optimizer state to
  amortize; per-layer gathers would sit on the decode latency path).

Decode caches are **sequence-sharded** over "model" (and over "data" too
when batch == 1, i.e. long_500k): each rank holds a contiguous KV slice.

``_sanitize`` is kept exactly, although DTensor accepts uneven shards: an
axis that does not divide a dim is dropped from it (granite's vocab of
49,155 is replicated, as in the reference).
"""

from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import axis_sizes, data_axes, placements

_STACKED = ("layers", "enc_layers", "dec_layers")

# (regex on "/"-joined path) -> spec name
_TRAIN_RULES = [
    (r"moe/w_(gate|up)$", ("model", "data", None)),      # (E, d, ff)
    (r"moe/w_down$", ("model", None, "data")),           # (E, ff, d)
    (r"moe/router$", (None, None)),
    (r"moe/shared/w_(gate|up)$", ("data", "model")),
    (r"moe/shared/w_down$", ("model", "data")),
    (r"(wq|wk|wv|w_gate|w_up)$", ("data", "model")),     # (d, out)
    (r"(wo|w_down)$", ("model", "data")),                # (in, d)
    (r"(in_proj)$", ("data", "model")),
    (r"(out_proj)$", ("model", "data")),
    (r"conv_w$", ("model", None)),
    (r"embed$", ("model", "data")),                      # (V, d)
    (r"lm_head$", ("data", "model")),
    (r"dense/w$", (None, None)),
]

_SERVE_RULES = [
    # experts 2-D sharded even in serve: 132B MoE weights do not fit at
    # model-axis-only sharding; candidates are tried in order until every
    # dim divides (qwen2-moe's 60 experts fall through to (d, ff) sharding)
    (r"moe/w_(gate|up)$", [("model", None, "data"), (None, "data", "model")]),
    (r"moe/w_down$", [("model", "data", None), (None, "model", "data")]),
    (r"moe/router$", (None, None)),
    (r"moe/shared/w_(gate|up)$", (None, "model")),
    (r"moe/shared/w_down$", ("model", None)),
    (r"(wq|wk|wv|w_gate|w_up)$", (None, "model")),
    (r"(wo|w_down)$", ("model", None)),
    (r"(in_proj)$", (None, "model")),
    (r"(out_proj)$", ("model", None)),
    (r"conv_w$", ("model", None)),
    (r"embed$", ("model", None)),
    (r"lm_head$", (None, "model")),
    (r"dense/w$", (None, None)),
]


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def _sanitize(mesh, spec: tuple, shape: tuple) -> tuple:
    """Drop mesh axes from dims they don't divide evenly (the reference's
    jit in_shardings require exact divisibility; e.g. granite's vocab
    49155 % 16 != 0: such dims are replicated instead)."""
    out = []
    for dim, axes in zip(shape, spec):
        if axes is not None and dim % _axis_size(mesh, axes) != 0:
            axes = None
        out.append(axes)
    return tuple(out)


def _spec_for(path_s: str, leaf, rules, mesh=None) -> tuple:
    """The spec of one leaf (anything with ``shape`` and ``ndim``) at a
    "/"-joined path."""
    stacked = any(s in path_s for s in _STACKED)
    shape = tuple(leaf.shape)
    for pat, axes in rules:
        if not re.search(pat, path_s):
            continue
        candidates = axes if isinstance(axes, list) else [axes]
        chosen = None
        for cand in candidates:
            spec = (None, *cand) if stacked else tuple(cand)
            if len(spec) != leaf.ndim:
                continue
            if mesh is None or all(
                a is None or dim % _axis_size(mesh, a) == 0
                for dim, a in zip(shape, spec)
            ):
                chosen = spec
                break
        if chosen is None:  # fall back: first candidate, sanitized per-dim
            spec = (None, *candidates[0]) if stacked else tuple(candidates[0])
            if len(spec) != leaf.ndim:
                return ()
            chosen = spec
        if mesh is not None:
            return _sanitize(mesh, chosen, shape)
        return tuple(chosen)
    return ()  # norms, biases, scalars: replicated


def _strip_model(axes):
    if isinstance(axes, list):
        return [_strip_model(a) for a in axes]
    return tuple(None if a == "model" else a for a in axes)


#: pure data-parallel rules: FSDP over "data", no tensor parallelism (the
#: right posture for small models: a 130M model tensor-parallel over 8
#: cards is all resharding and no compute)
_DP_RULES = [(pat, _strip_model(axes)) for pat, axes in _TRAIN_RULES]


def _map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict, paths "/"-joined."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_shardings(mesh, params_abs: Any, mode: str = "train"):
    """Tree of specs matching the (abstract) parameter tree.

    mode: "train" (2-D FSDP) | "serve" (1-D, latency-first) | "serve_2d"
    (2-D weight sharding without optimizer state) | "dp" (no TP; small
    models use the model axis as extra data parallelism).
    """
    rules = {"serve": _SERVE_RULES, "dp": _DP_RULES}.get(mode, _TRAIN_RULES)
    return _map_with_path(lambda path, leaf: _spec_for(path, leaf, rules, mesh), params_abs)


def opt_shardings(mesh, opt_abs: Any, p_shard: Any = None, mode: str = "train"):
    """m/v/err mirror the parameter shardings; step is replicated."""
    rules = _DP_RULES if mode == "dp" else _TRAIN_RULES

    def build(path, leaf):
        if path.startswith(("m/", "v/", "err/")):
            return _spec_for(path.split("/", 1)[1], leaf, rules, mesh)
        return ()  # step

    return _map_with_path(build, opt_abs)


def _prod(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def batch_shardings(mesh, batch_abs: Any, shape: InputShape, extra_axes: tuple = ()):
    """Inputs: batch over the data axes (replicated when they do not divide
    it).  ``extra_axes``: further mesh axes folded into the batch sharding
    (the "dp_all" posture shards the batch over data AND model)."""
    da = (*data_axes(mesh), *extra_axes)
    bspec = da if shape.global_batch % _prod(mesh, da) == 0 else None

    def spec(path, leaf):
        if len(leaf.shape) == 0:
            return ()
        return (bspec, *(None,) * (len(leaf.shape) - 1))

    return _map_with_path(spec, batch_abs)


def cache_shardings(mesh, cache_abs: Any, cfg: ArchConfig, shape: InputShape):
    """Decode caches: sequence-sharded KV; SSM state sharded over heads."""
    da = data_axes(mesh)
    batch_ok = shape.global_batch % _prod(mesh, da) == 0
    bspec = da if batch_ok else None
    # when the batch cannot use the data axes (long_500k b=1), fold them
    # into the sequence sharding instead
    seq_axes = ("model",) if batch_ok else (*da, "model")

    def spec(path, leaf):
        ndim = len(leaf.shape)
        if ndim == 0 or path.endswith("pos"):
            return ()
        if re.search(r"(^|/)(k|v|xk|xv)$", path):
            # (L, B, S, Hkv, hd): shard S
            return _sanitize(mesh, (None, bspec, seq_axes, None, None), leaf.shape)
        if path.endswith("ssd"):
            # (L, B, H, P, N): shard SSD heads over model
            return _sanitize(mesh, (None, bspec, "model", None, None), leaf.shape)
        if path.endswith("conv"):
            return _sanitize(mesh, (None, bspec, None, "model"), leaf.shape)
        return (None,) * ndim

    return _map_with_path(spec, cache_abs)


def distribute(mesh, tree: Any, specs: Any) -> Any:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements (every rank keeps its own shard of its local full tensor:
    no collective)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        return distribute_tensor(t, mesh, placements(mesh, spec), src_data_rank=None)

    if isinstance(tree, dict):
        return {k: distribute(mesh, tree[k], specs[k]) for k in tree}
    return one(tree, specs)
