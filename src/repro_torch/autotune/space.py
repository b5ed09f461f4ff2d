"""Per-backend knob grids, legality pulled from the backend capability table.

The paper's design space is per-layer reuse factors; the port's is the
plan-time knob tuple ``(chunk_len, block_b, fuse_gates, n_chunks, split)``.  This
module is the only place sweep candidates are generated, and it generates
them from ``core.backends.BackendSpec.knobs``: a backend that does not
declare a knob never sees grid points for it, so the sweep cannot propose
a plan ``plan_stack`` would reject.  The axes follow this port's kernels:

* ``chunk_len``  - chunked-step backends only, capped by the step kernel's
  ``MAX_STEP_UNROLL`` sequential-cell ceiling per layer count;
* ``block_b``    - rows of the batch one CTA of K1/K2 runs (the default,
  ``None``, is one); candidates are powers of two up to the batch whose
  CTA fits the kernels' shared memory (``lstm_stack.smem_bytes`` against
  ``MAX_SMEM_BYTES``, the launch's own check);
* ``fuse_gates`` - the step kernel's single ``[x;h] @ [W_x;W_h]`` chain per
  gate; never proposed ``True`` for int8 packs, which refuse it;
* ``n_chunks``   - the wavefront-pipelined backends' (sharded placement,
  ``wavefront``) time chunks per window: 2 and 4 where they divide the
  case's ``t_len`` (1 chunk is the default's coarsest hand-off);
* ``split``      - the mixed backend's int8-early/fp32-late storage split,
  every point of 0..L.

``None`` on any axis means "the hand-set default", so every grid contains
the all-``None`` default point, and it comes first.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, fields
from typing import Any, Sequence

from repro_torch.core.backends import get_backend


@dataclass(frozen=True)
class KnobPoint:
    """One assignment of the tunable plan knobs; ``None`` = hand-set default."""

    chunk_len: int | None = None
    block_b: int | None = None
    fuse_gates: bool | None = None
    n_chunks: int | None = None
    split: int | None = None

    def overrides(self) -> dict[str, Any]:
        """The non-default knobs, as ``plan_stack`` keyword arguments."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) is not None}

    @property
    def is_default(self) -> bool:
        return not self.overrides()

    def describe(self) -> str:
        ov = self.overrides()
        return ",".join(f"{k}={v}" for k, v in sorted(ov.items())) or "default"


DEFAULT_POINT = KnobPoint()


def _chunk_len_axis(n_layers: int) -> list[int | None]:
    from repro_torch.kernels.lstm_stack.step import MAX_STEP_UNROLL

    ceil = max(1, MAX_STEP_UNROLL // max(1, n_layers))
    return [None] + sorted(v for v in (4, 8, 16, 32, 64) if v <= ceil)


def _block_b_axis(cfgs: Sequence, batch: int) -> list[int | None]:
    """Rows per CTA above the default one, up to the batch, whose CTA fits
    the shared memory of both kernels for the whole stack packed as one
    segment at fp32 storage (the widest pack any split or storage of these
    layers can make, so every segment of every plan fits too)."""
    from repro_torch.kernels.lstm_stack.lstm_stack import MAX_SMEM_BYTES, smem_bytes
    from repro_torch.kernels.lstm_stack.ops import _pack_width

    width = _pack_width(cfgs)
    fits = [b for b in (2, 4, 8, 16, 32, 64) if b <= batch and all(
        smem_bytes(len(cfgs), width, b, 4, step) <= MAX_SMEM_BYTES for step in (False, True))]
    return [None] + fits


def _n_chunks_axis(t_len: int | None) -> list[int | None]:
    if t_len is None:
        return [None]
    return [None] + [n for n in (2, 4) if t_len % n == 0]


def _split_axis(n_layers: int) -> list[int | None]:
    # every interior split plus both homogeneous ends (0 = all fp32, L = all
    # int8); None = the plan's own resolution (the cfgs' per-layer storage)
    return [None] + list(range(0, n_layers + 1))


def knob_space(cfgs: Sequence, impl: str, *, weight_dtype=None, batch: int = 8,
               t_len: int | None = None, max_points: int | None = None) -> list[KnobPoint]:
    """Every legal knob assignment for (geometry, backend, dtype, batch,
    window length ``t_len``; without it no ``n_chunks`` point is proposed).

    ``max_points`` thins the grid deterministically (the default point is
    always kept, the rest evenly strided).
    """
    spec = get_backend(impl)
    wd = weight_dtype
    if wd is None and cfgs:
        wd = cfgs[0].weight_dtype

    axes: dict[str, list] = {}
    if "chunk_len" in spec.knobs:
        axes["chunk_len"] = _chunk_len_axis(len(cfgs))
    if "block_b" in spec.knobs:
        axes["block_b"] = _block_b_axis(cfgs, batch)
    if "fuse_gates" in spec.knobs:
        # int8 packs refuse fused gates; a mixed plan may hold an int8
        # segment at any proposed split, so it never proposes True either
        int8_possible = wd == "int8" or spec.heterogeneous or (
            isinstance(wd, (tuple, list)) and "int8" in wd)
        axes["fuse_gates"] = [None, False] if int8_possible else [None, False, True]
    if "n_chunks" in spec.knobs:
        axes["n_chunks"] = _n_chunks_axis(t_len)
    if "split" in spec.knobs:
        # an explicit weight_dtype pins the assignment: split on top of it
        # is refused at plan time
        axes["split"] = [None] if weight_dtype is not None else _split_axis(len(cfgs))

    if not axes:
        return [DEFAULT_POINT]
    names = list(axes)
    points = [KnobPoint(**dict(zip(names, combo)))
              for combo in itertools.product(*(axes[n] for n in names))]
    points.sort(key=lambda p: not p.is_default)  # the default first
    if max_points is not None and len(points) > max_points:
        rest = points[1:]
        stride = max(1, -(-len(rest) // max(1, max_points - 1)))
        points = [points[0]] + rest[::stride][: max_points - 1]
    return points


def check_legal(cfgs: Sequence, impl: str, point: KnobPoint, *, weight_dtype=None) -> None:
    """Resolve the point through ``plan_stack``: raises iff illegal."""
    from repro_torch.core.executor import plan_stack

    plan_stack(cfgs, impl=impl, weight_dtype=weight_dtype, **point.overrides())
