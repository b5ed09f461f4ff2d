"""Per-rank costs of one traced call: the counterpart of
``repro/analysis/hlo.py``.

The reference compiles each cell and parses the per-device HLO.  The port
has no HLO: it runs the cell's step once, on DTensors whose local shards
are fake tensors (``FakeTensorMode``: shapes and dtypes, no storage) over a
fake process group (``launch/dryrun.py``), and counts what rank 0's
program does.  A ``TorchDispatchMode`` lets DTensor turn each op into its
local op and its collectives first (it declines ops on DTensors), then sees
those.  Field by field, against ``HloAnalysis``:

* ``dot_flops``: the reference's scan-corrected dot walk.  Here each local
  op that ``torch.utils.flop_counter``'s formulas cover (mm, bmm, addmm,
  baddbmm, convolutions, the fused attentions and their backwards: the
  matmuls every einsum and ``@`` lowers to) adds its FLOPs, as
  ``FlopCounterMode`` counts them; the fused attentions take
  ``attention_flops()``'s formulas (the CPU's is not in the registry, and
  some versions' formulas refuse grouped-query attention).
  Python loops run every layer, so no trip multiplier is needed.
* ``collective_bytes`` / ``collective_count``: by type, from the
  ``_c10d_functional`` collectives (and DTensor's all-to-all), each
  result buffer's bytes times the reference's ring factor: all-reduce
  2(n-1)/n, all-gather and reduce-scatter (n-1)/n, all-to-all 1.  On a
  CPU mesh DTensor has no all-to-all (gloo has none) and traces one as
  an all-gather and a chunk: there, all-to-all traffic counts as
  all-gather bytes, n times over.
* ``memory``: ``argument_bytes`` is the bytes of the local shards of the
  call's arguments (params, optimizer state, batch, cache: the reference's
  ``argument_size_in_bytes``); ``peak_bytes`` the most that rank 0 holds
  at once during the call, arguments included: every storage a local op
  creates counts, rounded up to 512 bytes as the caching allocator
  rounds, from its creation until it is freed (no cuBLAS or cuDNN
  workspace).  This is ``MemTracker``'s count (``torch.distributed.
  _tools.mem_tracker``) with its rule for DTensor made explicit: the ops
  DTensor runs at global shapes to propagate shardings are not counted.
  The MemTracker of torch 2.11 counts them, and so gave dbrx-132b's
  train_4k cell a 525 GB peak per rank.

``xla_*``, ``custom_call_*`` and ``cpu_convert_artifact_bytes`` describe a
compiled XLA executable and have no counterpart.  The trace never reaches
a kernel of this package: on fake CPU tensors every kernel wrapper takes
its plain version, as the reference lowers its Pallas kernels in
interpret mode.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.tree import tree_leaves

_F = torch.ops._c10d_functional

#: collective op packet -> (type, group-size argument index or None)
_COLLECTIVES = {
    _F.all_reduce: ("all-reduce", None),
    _F.all_reduce_: ("all-reduce", None),
    _F.all_gather_into_tensor: ("all-gather", 1),
    _F.reduce_scatter_tensor: ("reduce-scatter", 2),
    _F.all_to_all_single: ("all-to-all", None),
}


def _extra_collectives() -> dict:
    out = {}
    auto = getattr(torch.ops, "_c10d_functional_autograd", None)
    for name, entry in (("all_gather_into_tensor", ("all-gather", 1)),
                        ("reduce_scatter_tensor", ("reduce-scatter", 2)),
                        ("all_to_all_single", ("all-to-all", None))):
        if auto is not None and hasattr(auto, name):
            out[getattr(auto, name)] = entry
    if hasattr(torch.ops, "_dtensor") and hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        out[torch.ops._dtensor.shard_dim_alltoall] = ("all-to-all", None)
    return out


def _sdpa_fwd(q, k, v, *args, out_shape=None, **kwargs) -> int:
    """QK^T and PV of fused attention over (B, H, S, D) shapes, every query
    head counted (grouped KV heads are read by G query heads each)."""
    b, hq, sq, d = q
    return 2 * b * hq * sq * k[2] * (d + v[3])


def _sdpa_bwd(grad_out, q, k, v, *args, out_shape=None, **kwargs) -> int:
    """The backward's five products: QK^T again, dO V^T, P^T dO, dS K and
    dS^T Q."""
    b, hq, sq, d = q
    return 2 * b * hq * sq * k[2] * (3 * d + 2 * v[3])


def attention_flops() -> dict:
    """FLOP formulas (on shapes, as ``FlopCounterMode``'s ``custom_mapping``
    takes them) of PyTorch's fused attentions, forward and backward, on
    the card (flash, efficient, cuDNN) and on the CPU, whose fused
    attention the registry lacks.  They count grouped-query attention,
    which some PyTorch versions' own formulas refuse."""
    aten = torch.ops.aten
    out = {}
    for name in ("_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
                 "_scaled_dot_product_cudnn_attention",
                 "_scaled_dot_product_flash_attention_for_cpu"):
        if hasattr(aten, name):
            out[getattr(aten, name)] = _sdpa_fwd
            if hasattr(aten, name + "_backward"):
                out[getattr(aten, name + "_backward")] = _sdpa_bwd
    return out


_RING = {"all-reduce": lambda n: 2.0 * (n - 1) / n,
         "all-gather": lambda n: (n - 1) / n,
         "reduce-scatter": lambda n: (n - 1) / n,
         "all-to-all": lambda n: 1.0}


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


@dataclass
class Costs:
    """One rank's costs of one call (the reference's ``HloAnalysis`` fields
    that a trace can give, and its ``memory_analysis``)."""

    dot_flops: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: defaultdict(float))
    collective_count: int = 0
    argument_bytes: int = 0
    peak_bytes: int = 0


_MIN_ALLOC = 512  # bytes: the caching allocator's rounding


class CostCounter(TorchDispatchMode):
    """Counts dot FLOPs, collective bytes and live storage bytes of the
    local ops it sees.  Ops on DTensors are declined (``NotImplemented``),
    so DTensor lowers them to local ops and collectives, which come back
    through this mode."""

    def __init__(self, costs: Costs):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry, shape_wrapper

        from torch._guards import active_fake_mode

        self.costs = costs
        self._dtensor = DTensor
        self._active_fake = active_fake_mode
        self._entry_fake = active_fake_mode()
        self._flops = {**flop_registry,
                       **{k: shape_wrapper(f) for k, f in attention_flops().items()}}
        self._coll = {**_COLLECTIVES, **_extra_collectives()}
        self._live: dict = {}  # storage id -> bytes, while the storage lives
        self._live_bytes = 0

    def track(self, t) -> None:
        """Count the storages of ``t`` (tensors, DTensors' local shards,
        nested in lists or tuples) as live until they are freed."""
        if isinstance(t, (list, tuple)):
            for x in t:
                self.track(x)
            return
        if not isinstance(t, torch.Tensor):
            return
        if isinstance(t, self._dtensor):
            t = t.to_local()
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = -(-st.nbytes() // _MIN_ALLOC) * _MIN_ALLOC
        self._live[key] = n
        self._live_bytes += n
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._active_fake() is not self._entry_fake:
            # DTensor's sharding propagation runs ops at global shapes
            # under a fake mode of its own: bookkeeping, not work
            return out
        self.track(out)
        packet = func._overloadpacket
        if packet in self._flops:
            self.costs.dot_flops += float(self._flops[packet](*args, **kwargs, out_val=out))
        elif packet in self._coll:
            kind, size_arg = self._coll[packet]
            n = int(args[size_arg]) if size_arg is not None else _group_size(args)
            if n > 1:
                nbytes = out.numel() * out.element_size()
                self.costs.collective_bytes[kind] += nbytes * _RING[kind](n)
                self.costs.collective_count += 1
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def argument_bytes(*trees) -> int:
    """Bytes of the local shards of every tensor in ``trees``."""
    return sum(_local(t).numel() * _local(t).element_size()
               for tree in trees for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def measure(fn, *args):
    """``(fn(*args), Costs)``: one call of ``fn`` under the counter, with
    ``args`` counted as its arguments and live from the start."""
    costs = Costs(argument_bytes=argument_bytes(*args))
    counter = CostCounter(costs)
    for tree in args:
        for t in tree_leaves(tree):
            counter.track(t)
    with counter:
        return fn(*args), costs
