"""Plan / bind / execute: the one call surface for every LSTM backend.

    plan = plan_stack(cfgs, impl="fused_stack", weight_dtype="int8")  # once, memoised
    ex = plan.bind(params_list)                  # packs weights exactly once
    h_seq, finals = ex(xs)                       # full-sequence execution
    state = ex.zero_state(batch)                 # streaming serving loop:
    state = ex.step(chunk, state)                #   native-layout hot path

``plan_stack`` resolves backend legality (the rules live in
``core.backends``), weight storage, placement and the step-kernel threshold
once; the executor never re-checks them per call and never re-packs.

Backends (see ``core.backends.BACKENDS``):

    naive / split   layer by layer, plain PyTorch
    kernel          layer by layer, one scan-kernel launch per layer
    fused_stack     whole segment in ONE wavefront kernel launch
    fused_step      fused_stack + the step kernel for chunks with
                    T <= plan.chunk_len (the streaming serving default)
    mixed           per-layer heterogeneous: maximal homogeneous runs
                    become ordinary fused_step sub-plans (per-layer
                    weight_dtype / chunk geometry) chained through
                    native-layout state hand-off; tune="balanced" picks the
                    int8/fp32 split that equalizes the kernels' predicted
                    per-segment cost
    fused_stack_sharded  stages on the devices of a stage mesh (a tuple of
                    torch.device; one device may hold several stages),
                    each stage's body ONE wavefront kernel launch over its
                    contiguous sub-stack, only the sub-stack's last hidden
                    chunk handed on (``placement="sharded"``)
    wavefront       the plain single-program pipeline of one-layer stages
                    (``core.pipeline.wavefront``), stateless

``tune="cached"`` resolves knobs from the autotune store
(``repro_torch.autotune.cache``); ``StackPlan.knob_provenance`` says where
each knob came from.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Sequence

import torch

from .backends import (
    BackendSpec,
    DEFAULT_CHUNK_LEN,
    IDENTITY,
    check_weight_storage,
    get_backend,
    register_backend,
    requested_weight_storage,
)
from .lstm import LstmConfig, lstm_forward, zero_state as layer_zero_state
from .quant import ACT_BITS

Params = dict[str, Any]


@dataclass(frozen=True)
class StackPlan:
    """A fully resolved execution plan for one LSTM segment.

    ``cfgs`` already carry the resolved ``weight_dtype``.
    """

    cfgs: tuple[LstmConfig, ...]
    impl: str
    #: resolved weight storage ("fp32" | "bf16" | "int8") for packed
    #: backends; a per-layer tuple for ``impl="mixed"``; None for
    #: layer-by-layer backends (native storage)
    weight_dtype: Any = None
    #: "local" (one device) or "sharded" (``fused_stack_sharded``)
    placement: str = "local"
    #: sharded placement: the stage mesh, a tuple of ``torch.device`` (one
    #: stage each, in order); None = the default stage mesh, resolved at
    #: bind from the device the params live on
    mesh: Any = None
    #: time chunks per wavefront tick (sharded and wavefront backends; None
    #: = auto: one chunk per stage where the stages divide T, else one)
    n_chunks: int | None = None
    #: chunked-step backends only: chunks with T <= chunk_len run the step
    #: kernel instead of the wavefront kernel
    chunk_len: int | None = None
    #: batch rows per CTA of the fused kernels (None = 1)
    block_b: int | None = None
    #: in-kernel activation fake-quant on the layer hand-off; None = off
    act_bits: int | None = None
    #: chunked-step backends only: the step kernel's single [x;h] @ [W_x;W_h]
    #: chain per gate (None = separate chains; never with int8 packs)
    fuse_gates: bool | None = None
    #: ``impl="mixed"`` split knob: layers [0, split) store int8, the rest
    #: fp32; None when the per-layer dtypes came from an explicit tuple, the
    #: cfgs or the balancer without a prefix form
    split: int | None = None
    #: ``impl="mixed"`` only: the maximal homogeneous sub-plans (each an
    #: ordinary fused_step StackPlan) the executor chains
    segments: tuple = ()
    #: where each resolved knob came from ("explicit" | "tuned" | "default" |
    #: "balanced"); excluded from equality and hash, so tuned and hand-set
    #: plans with equal knob values are equal
    knob_sources: tuple = dataclasses.field(default=(), compare=False)

    @property
    def backend(self) -> BackendSpec:
        return get_backend(self.impl)

    def knob_provenance(self) -> dict[str, tuple[Any, str]]:
        """{knob: (resolved value, source)} for the backend's knobs (and
        ``act_bits``, and a mixed plan's per-layer storage): what
        ``launch/serve.py --plan-only`` prints."""
        sources = dict(self.knob_sources)
        out = {k: (getattr(self, k), sources.get(k, "default")) for k in self.backend.knobs}
        if self.act_bits is not None:
            out["act_bits"] = (self.act_bits, sources.get("act_bits", "default"))
        if self.backend.heterogeneous:
            out["weight_dtype"] = (self.weight_dtype, sources.get("weight_dtype", "default"))
        return out

    def layer_assignment(self) -> list[dict[str, Any]]:
        """Per-layer split of a mixed plan: one row per layer with its
        resolved dtype, chunk_len and stage (the segment's index)."""
        if not self.backend.heterogeneous:
            raise ValueError(f"layer_assignment() is a mixed-plan surface; "
                             f"impl={self.impl!r} is homogeneous")
        rows = []
        for stage, seg in enumerate(self.segments):
            for c in seg.cfgs:
                rows.append({"layer": len(rows), "hidden": c.hidden, "stage": stage,
                             "weight_dtype": seg.weight_dtype, "chunk_len": seg.chunk_len})
        return rows

    @property
    def n_layers(self) -> int:
        return len(self.cfgs)

    @property
    def hidden(self) -> tuple[int, ...]:
        return tuple(c.hidden for c in self.cfgs)

    def bind(self, params_list: Sequence[Params], *,
             packed: Any = None) -> "StackExecutor":
        """Bind parameters: pack weights exactly once, return the executor.

        Packing goes through ``pack_stack_cached`` (identity-keyed); an
        explicitly supplied ``packed`` is validated against the plan here.
        """
        params = tuple(params_list)
        if packed is not None and not self.backend.packs:
            raise ValueError(
                f"packed weights only apply to packing backends (impl={self.impl!r})"
            )
        if not (self.backend.packs and self.cfgs):
            return StackExecutor(self, params, packed)
        from repro_torch.kernels.lstm_stack.ops import (
            check_packed_matches_cfgs,
            pack_stack_cached,
        )

        if self.backend.heterogeneous:
            # one pack per segment, packed exactly as a hand-built fused_step
            # plan over that segment packs
            if packed is None:
                packs, i = [], 0
                for seg in self.segments:
                    packs.append(pack_stack_cached(list(params[i:i + seg.n_layers]),
                                                   list(seg.cfgs)))
                    i += seg.n_layers
                packed = tuple(packs)
            else:
                packed = tuple(packed)
                if len(packed) != len(self.segments):
                    raise ValueError(f"mixed plan has {len(self.segments)} segments but "
                                     f"{len(packed)} packs were supplied")
                for seg, pk in zip(self.segments, packed):
                    check_packed_matches_cfgs(pk, seg.cfgs)
        else:
            if packed is None:
                packed = pack_stack_cached(list(params), list(self.cfgs))
            else:
                check_packed_matches_cfgs(packed, self.cfgs)
        staged = None
        if self.placement == "sharded":
            # the sub-stacks are slices of the one pack, placed on their
            # stage devices here, once
            from .pipeline import StagedStack

            mesh = self.mesh or _default_stage_mesh(self.n_layers, packed.device)
            staged = StagedStack.place(packed, mesh)
        return StackExecutor(self, params, packed, staged)

    def describe(self) -> str:
        """One-line human summary."""
        dims = "->".join(str(c.hidden) for c in self.cfgs) or "(identity)"
        knobs = "".join(
            f" {k}={getattr(self, k)}"
            for k in ("n_chunks", "chunk_len", "block_b", "act_bits", "fuse_gates")
            if getattr(self, k) is not None
        )
        if self.segments:
            knobs += f" segments={len(self.segments)}"
        if self.placement == "sharded":
            knobs += " mesh=" + (",".join(map(str, self.mesh)) if self.mesh else "default")
        wd = self.weight_dtype
        if isinstance(wd, tuple):
            wd = "+".join(wd)
        return (f"impl={self.impl} placement={self.placement} layers={self.n_layers} "
                f"[{dims}] weight_dtype={wd or 'native'}{knobs}")


def _default_stage_mesh(n_layers: int, device: torch.device) -> tuple[torch.device, ...]:
    """The largest count of ``device``'s kind that divides the stack into
    whole sub-stacks: ``torch.cuda.device_count()`` cards for a CUDA
    device, starting at ``device``'s own card (stage 0 holds the params'
    card), one stage for the CPU (as the reference's default mesh has one
    stage on one device)."""
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        first = device.index if device.index is not None else torch.cuda.current_device()
        devices = [torch.device("cuda", (first + i) % n_cards) for i in range(n_cards)]
    else:
        devices = [device]
    n = max(1, min(len(devices), n_layers))
    while n > 1 and n_layers % n:
        n -= 1
    return tuple(devices[:n])


@functools.lru_cache(maxsize=128)
def _plan_stack_cached(cfgs: tuple[LstmConfig, ...], impl: str,
                       weight_dtype: str | None, chunk_len: int | None,
                       block_b: int | None, act_bits: int | None,
                       fuse_gates: bool | None, knob_sources: tuple = (),
                       placement: str = "local", mesh: tuple | None = None,
                       n_chunks: int | None = None) -> StackPlan:
    get_backend(impl)  # raises for unknown impl, even on empty segments
    if placement not in ("local", "sharded"):
        raise ValueError(f"unknown placement {placement!r}; choose 'local' or 'sharded'")
    if not cfgs:
        return StackPlan(cfgs=(), impl=IDENTITY)
    sources = dict(knob_sources)
    # -- placement normalization: the fused backends degrade to the sharded
    # wavefront, dropping the step kernel's knobs with the step kernel
    if impl == "fused_stack_sharded":
        placement = "sharded"
    if placement == "sharded":
        if impl not in ("fused_stack", "fused_step", "fused_stack_sharded"):
            raise ValueError(
                f"placement='sharded' requires the fused_stack backend (got impl={impl!r}); "
                "only fused sub-stacks can place pipeline stages on stage devices"
            )
        if impl == "fused_step":
            chunk_len = None
        fuse_gates = block_b = None
        sources.update(chunk_len="default", fuse_gates="default", block_b="default")
        impl = "fused_stack_sharded"
    elif mesh is not None:
        raise ValueError("a stage mesh was supplied but placement='local'; pass "
                         "placement='sharded' to place sub-stacks on the mesh's devices")
    spec = get_backend(impl)
    if n_chunks is not None:
        if "n_chunks" not in spec.knobs:
            raise ValueError(
                f"n_chunks only applies to wavefront-pipelined backends (impl='wavefront' "
                f"or sharded placement); got impl={impl!r}"
            )
        if n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if block_b is not None:
        if "block_b" not in spec.knobs:
            raise ValueError(
                f"block_b only applies to the fused kernel backends; got impl={impl!r}"
            )
        if block_b < 1:
            raise ValueError(f"block_b must be >= 1, got {block_b}")
    if act_bits is not None:
        if not spec.act_quant:
            raise ValueError(
                f"act_bits only applies to backends with in-kernel activation "
                f"quantization (the fused kernels); got impl={impl!r}"
            )
        if act_bits not in ACT_BITS:
            raise ValueError(f"act_bits={act_bits!r} unsupported; choose from {ACT_BITS}")
    if chunk_len is not None and not spec.chunked_step:
        raise ValueError(
            f"chunk_len only applies to chunked-step backends (impl='fused_step'); "
            f"got impl={impl!r}"
        )
    if fuse_gates is not None and "fuse_gates" not in spec.knobs:
        raise ValueError(
            f"fuse_gates only applies to the chunked-step backend (impl='fused_step'); "
            f"got impl={impl!r}"
        )
    if spec.chunked_step:
        from repro_torch.kernels.lstm_stack.step import MAX_STEP_UNROLL

        if chunk_len is None:
            chunk_len = max(1, min(DEFAULT_CHUNK_LEN, MAX_STEP_UNROLL // len(cfgs)))
        if chunk_len < 1:
            raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
        if chunk_len * len(cfgs) > MAX_STEP_UNROLL:
            raise ValueError(
                f"chunk_len={chunk_len} x {len(cfgs)} layers exceeds the step "
                f"kernel's {MAX_STEP_UNROLL} sequential-cell ceiling; long "
                "chunks belong to the wavefront kernel"
            )
    if weight_dtype is not None:
        cfgs = tuple(dataclasses.replace(c, weight_dtype=weight_dtype) for c in cfgs)
    check_weight_storage(requested_weight_storage(cfgs), impl)
    resolved_wd = None
    if spec.packs:
        from repro_torch.kernels.lstm_stack.ops import (
            _check_homogeneous,
            resolve_weight_dtype,
        )

        _check_homogeneous(cfgs)
        resolved_wd = resolve_weight_dtype(cfgs[0])
    if fuse_gates and resolved_wd == "int8":
        raise ValueError(
            "fuse_gates=True is incompatible with int8 packs: s_x and s_h scale two "
            "different fp32 accumulators, which one fused [x;h] chain would mix; drop "
            "fuse_gates or the int8 weight_dtype"
        )
    if mesh is not None and len(cfgs) % len(mesh):
        raise ValueError(
            f"sharded placement needs the {len(cfgs)}-layer stack to split into whole "
            f"sub-stacks across {len(mesh)} stage devices; pass a mesh whose length "
            "divides the layer count"
        )
    return StackPlan(cfgs=cfgs, impl=impl, weight_dtype=resolved_wd, placement=placement,
                     mesh=mesh, n_chunks=n_chunks, chunk_len=chunk_len, block_b=block_b,
                     act_bits=act_bits, fuse_gates=fuse_gates,
                     knob_sources=tuple(sorted(sources.items())))


#: the knobs ``tune="cached"`` may resolve from the autotune store (in step
#: with ``repro_torch.autotune.cache.KNOB_NAMES``, the reference's list)
_TUNABLE_KNOBS = ("chunk_len", "block_b", "fuse_gates", "n_chunks", "split")


def _normalize_per_layer(name: str, value, n: int) -> tuple:
    """Broadcast a scalar knob to per-layer, validate a sequence's length."""
    if not isinstance(value, (tuple, list)):
        return (value,) * n
    value = tuple(value)
    if len(value) != n:
        raise ValueError(f"per-layer {name} needs one entry per layer ({n}); got {len(value)}")
    return value


def _prefix_split(split: int, n: int) -> tuple[str, ...]:
    """``split=k``: int8 layers [0, k), fp32 the rest."""
    return ("int8",) * split + ("fp32",) * (n - split)


@functools.lru_cache(maxsize=64)
def _plan_mixed_cached(cfgs: tuple[LstmConfig, ...], wds: tuple, chunk_lens: tuple,
                       block_bs: tuple, fuse_gatess: tuple, act_bits: int | None,
                       split: int | None, knob_sources: tuple) -> StackPlan:
    """Build the mixed plan: segment on the per-layer signature, sub-plan
    each run.

    Layers with equal (weight_dtype, chunk_len, block_b, fuse_gates, compute
    dtype, cell dtype, activations) merge into one maximal run; each run
    becomes an ordinary ``fused_step`` plan through ``_plan_stack_cached``,
    equal to the plan a caller would build to chain the homogeneous
    segments by hand.  That is what makes the executor's bit-equality with
    hand-chained segments hold by construction.
    """
    def sig(i: int):
        c = cfgs[i]
        return (wds[i], chunk_lens[i], block_bs[i], fuse_gatess[i], c.dtype,
                c.cell_dtype, c.acts.name)

    bounds, start = [], 0
    for i in range(1, len(cfgs)):
        if sig(i) != sig(i - 1):
            bounds.append((start, i))
            start = i
    bounds.append((start, len(cfgs)))
    subs = tuple(
        _plan_stack_cached(cfgs[a:b], "fused_step", wds[a], chunk_len=chunk_lens[a],
                           block_b=block_bs[a], act_bits=act_bits, fuse_gates=fuse_gatess[a])
        for a, b in bounds
    )

    def uniform(values):
        vals = {v for v in values if v is not None}
        return vals.pop() if len(vals) == 1 else None

    return StackPlan(
        cfgs=tuple(c for sub in subs for c in sub.cfgs), impl="mixed",
        # the sub-plans carry the resolved storage, re-expanded per layer
        weight_dtype=tuple(sub.weight_dtype for sub in subs for _ in sub.cfgs),
        # chunks at or under the smallest segment threshold take the step
        # kernel in every segment (each segment still routes on its own)
        chunk_len=min(sub.chunk_len for sub in subs),
        block_b=uniform(block_bs), fuse_gates=uniform(fuse_gatess),
        act_bits=act_bits, split=split, segments=subs, knob_sources=knob_sources,
    )


def _plan_mixed(cfgs: tuple[LstmConfig, ...], weight_dtype, placement: str, mesh,
                n_chunks, chunk_len, block_b, fuse_gates, act_bits: int | None,
                split: int | None, tune: str) -> StackPlan:
    """Resolve per-layer weight storage for ``impl="mixed"`` and delegate.

    Storage precedence (first match wins, recorded in ``knob_sources``):
      1. explicit ``split=k`` or an explicit per-layer ``weight_dtype``
         sequence (or a scalar, broadcast)
      2. ``tune="cached"``: a tuned-store entry's ``split``
      3. ``tune="balanced"``: the roofline balancer
         (``core.stage_balance.choose_mixed_split``)
      4. each cfg's own ``weight_dtype`` (native resolution)
    """
    if not cfgs:
        return StackPlan(cfgs=(), impl=IDENTITY)
    if placement != "local" or mesh is not None:
        raise ValueError("impl='mixed' is single-host: heterogeneous segments chain "
                         "through local native-layout state hand-off; use "
                         "placement='local' (shard each homogeneous segment instead)")
    if n_chunks is not None:
        raise ValueError("n_chunks only applies to wavefront-pipelined backends; "
                         "impl='mixed' chains local fused_step segments")
    n = len(cfgs)
    sources = {k: ("explicit" if v is not None else "default")
               for k, v in (("chunk_len", chunk_len), ("block_b", block_b),
                            ("fuse_gates", fuse_gates), ("split", split))}
    if act_bits is not None:
        sources["act_bits"] = "explicit"

    wds = None
    if split is not None:
        if weight_dtype is not None:
            raise ValueError("pass either split= or weight_dtype=, not both: split is "
                             "shorthand for the int8-early/fp32-late prefix assignment")
        if not 0 <= split <= n:
            raise ValueError(f"split={split} outside [0, {n}] for a {n}-layer stack")
        wds = _prefix_split(split, n)
        sources["weight_dtype"] = "explicit"
    elif weight_dtype is not None:
        wds = _normalize_per_layer("weight_dtype", weight_dtype, n)
        sources["weight_dtype"] = "explicit"

    if tune == "cached":
        from repro_torch.autotune.cache import lookup_tuned

        tuned = lookup_tuned(cfgs, "mixed", weight_dtype) or {}
        knobs = {"chunk_len": chunk_len, "block_b": block_b, "fuse_gates": fuse_gates}
        for k, v in knobs.items():
            if v is None and tuned.get(k) is not None:
                knobs[k], sources[k] = tuned[k], "tuned"
        chunk_len, block_b, fuse_gates = knobs.values()
        if wds is None and tuned.get("split") is not None:
            split = int(tuned["split"])
            if 0 <= split <= n:
                wds = _prefix_split(split, n)
                sources["split"] = sources["weight_dtype"] = "tuned"
            else:  # an entry for another depth: keep the defaults
                split = None

    if wds is None:
        if tune == "balanced":
            from .stage_balance import choose_mixed_split

            choice = choose_mixed_split(cfgs)
            wds, split = tuple(choice.dtypes), choice.split
            sources["split"] = sources["weight_dtype"] = "balanced"
        else:
            from repro_torch.kernels.lstm_stack.ops import resolve_weight_dtype

            wds = tuple(resolve_weight_dtype(c) for c in cfgs)

    return _plan_mixed_cached(
        cfgs, wds, _normalize_per_layer("chunk_len", chunk_len, n),
        _normalize_per_layer("block_b", block_b, n),
        _normalize_per_layer("fuse_gates", fuse_gates, n),
        act_bits, split, tuple(sorted(sources.items())),
    )


def plan_stack(cfgs: Sequence[LstmConfig], impl: str = "split", *,
               weight_dtype=None, placement: str = "local", mesh=None,
               n_chunks: int | None = None, chunk_len=None, block_b=None,
               act_bits: int | None = None, fuse_gates=None,
               split: int | None = None, tune: str = "default") -> StackPlan:
    """Resolve an execution plan for a stacked LSTM segment, exactly once.

    All impl-dependent legality is checked here: unknown backends and
    placements, quantized storage on a non-fused backend, storage wider
    than compute, heterogeneous fused segments, a stage mesh that does not
    divide the layers (or one under local placement), ``act_bits`` on a
    backend without in-kernel activation quant, and a knob on a backend
    that does not take it.  Plans are memoised on their full argument
    tuple.

    ``placement="sharded"`` (or ``impl="fused_stack_sharded"``) places the
    stack's contiguous sub-stacks on the devices of ``mesh``, a sequence of
    devices, one stage each; a device may repeat (stages sharing one
    card).  ``fused_stack`` and ``fused_step`` degrade to
    ``fused_stack_sharded`` there and drop the step kernel's knobs
    (``chunk_len``, ``block_b``, ``fuse_gates``).  Without a mesh the
    default stage mesh is resolved at bind from the params' device: the
    largest count of CUDA cards that divides the layers, one stage on the
    CPU.  ``n_chunks`` (sharded and ``wavefront`` plans) is the number of
    time chunks a window is cut into; the default is one chunk per stage
    where the stages divide T, else one.

    ``fuse_gates`` (``fused_step`` only) runs each gate of the step kernel
    as one chain over ``[x ; h]`` (see ``kernels/lstm_stack/step.py``); int8
    packs refuse it.

    ``impl="mixed"`` takes per-layer heterogeneity: ``weight_dtype`` (and
    ``chunk_len``/``block_b``/``fuse_gates``) may be per-layer sequences,
    ``split=k`` is shorthand for int8 layers [0, k) and fp32 the rest, and
    ``tune="balanced"`` lets the roofline model choose the split.  The plan
    holds one ordinary ``fused_step`` sub-plan per maximal homogeneous run
    in ``StackPlan.segments``; execution chains them, bit-equal to chaining
    the segments by hand.

    ``tune="cached"`` looks the request up in the autotune store
    (``repro_torch.autotune.cache``): a knob not passed explicitly takes
    the measured-best value of an entry for this geometry, backend, weight
    storage and device, and the hand-set default where there is none.  An
    explicit argument always wins, and an illegal tuned knob raises here
    like an explicit one.  ``StackPlan.knob_sources`` records each knob's
    origin ("explicit" | "tuned" | "default" | "balanced").
    """
    if tune not in ("default", "cached", "balanced"):
        raise ValueError(
            f"unknown tune mode {tune!r}; choose 'default' (hand-set knob defaults), "
            "'cached' (consult the autotune store) or 'balanced' (mixed plans: "
            "roofline-model split)"
        )
    if isinstance(weight_dtype, list):
        weight_dtype = tuple(weight_dtype)
    if mesh is not None:
        from .pipeline import check_mesh

        mesh = check_mesh(mesh)
    if get_backend(impl).heterogeneous:
        return _plan_mixed(tuple(cfgs), weight_dtype, placement, mesh, n_chunks, chunk_len,
                           block_b, fuse_gates, act_bits, split, tune)
    if any(isinstance(v, (tuple, list)) for v in (weight_dtype, chunk_len, block_b, fuse_gates)):
        raise ValueError(
            "per-layer knob sequences (weight_dtype/chunk_len/block_b/fuse_gates) "
            f"require impl='mixed'; got impl={impl!r}"
        )
    if split is not None:
        raise ValueError(f"split= is the mixed backend's per-layer storage knob; got "
                         f"impl={impl!r}")
    if tune == "balanced":
        raise ValueError("tune='balanced' chooses a per-layer storage split, which only "
                         f"impl='mixed' can execute; got impl={impl!r}")
    knobs = {"chunk_len": chunk_len, "block_b": block_b, "fuse_gates": fuse_gates,
             "n_chunks": n_chunks}
    sources = {k: ("explicit" if v is not None else "default") for k, v in knobs.items()}
    if act_bits is not None:
        sources["act_bits"] = "explicit"
    if tune == "cached" and cfgs:
        from repro_torch.autotune.cache import lookup_tuned

        tuned = lookup_tuned(cfgs, impl, weight_dtype) or {}
        for k in knobs:
            if knobs[k] is None and tuned.get(k) is not None:
                knobs[k], sources[k] = tuned[k], "tuned"
    return _plan_stack_cached(tuple(cfgs), impl, weight_dtype, knobs["chunk_len"],
                              knobs["block_b"], act_bits, knobs["fuse_gates"],
                              tuple(sorted(sources.items())), placement, mesh,
                              knobs["n_chunks"])


def clear_plan_cache() -> None:
    """Drop memoised plans.  Not needed after the autotune store changes
    (``plan_stack`` resolves tuned knobs before the memo, so a new entry is
    a new memo key), but tests and long sweeps keep plan identities fresh
    and the memo bounded with it."""
    _plan_stack_cached.cache_clear()
    _plan_mixed_cached.cache_clear()


class StackExecutor:
    """A plan bound to parameters: the only call-time surface.  Construct
    via ``StackPlan.bind``."""

    __slots__ = ("plan", "params", "packed", "staged", "_graphs", "_subs")

    def __init__(self, plan: StackPlan, params: tuple, packed: Any = None,
                 staged: Any = None) -> None:
        self.plan = plan
        self.params = params
        self.packed = packed
        #: sharded plans: the pack's sub-stacks on their stage devices and a
        #: stream per stage (``core.pipeline.StagedStack``), made at bind
        self.staged = staged
        self._graphs: dict = {}  # batch width -> StepGraph (step_graph)
        self._subs: tuple | None = None  # mixed plans: the segment executors

    def _segment_executors(self) -> tuple["StackExecutor", ...]:
        """One ordinary homogeneous executor per mixed-plan segment, over
        this executor's own param and pack slices (made at first use)."""
        if self._subs is None:
            subs, i = [], 0
            for plan, pk in zip(self.plan.segments, self.packed or ()):
                subs.append(StackExecutor(plan, self.params[i:i + plan.n_layers], pk))
                i += plan.n_layers
            self._subs = tuple(subs)
        return self._subs

    def __call__(self, xs: torch.Tensor, initial_state=None, *,
                 return_state: bool = True):
        """Run the segment. xs: (B, T, in_dim) -> (B, T, hidden[-1]).

        ``initial_state``/finals are the portable per-layer ``[(h, c), ...]``
        at real widths, identical across backends.
        """
        self._refuse_grad(xs)
        h_seq, finals = self.plan.backend.forward(self, xs, initial_state)
        if not return_state:
            return h_seq
        if finals is None:
            raise ValueError(f"impl={self.plan.impl!r} does not thread per-layer state; "
                             "call with return_state=False (and no initial_state)")
        return h_seq, finals

    def _require_stateful(self) -> None:
        if not self.plan.backend.stateful:
            raise ValueError(
                f"impl={self.plan.impl!r} does not thread per-layer state; the streaming "
                "surfaces (zero_state/step/last_hidden) need a stateful backend such as "
                "'fused_stack'"
            )

    def _refuse_grad(self, xs: torch.Tensor) -> None:
        """Only ``naive`` and ``split`` are differentiable (as in the
        reference); a packed backend detaches its weights when it packs
        them, so its wrappers alone could not see that a gradient is
        wanted."""
        if not self.plan.backend.differentiable:
            from repro_torch.kernels import refuse_grad

            refuse_grad(f"impl={self.plan.impl!r}", xs,
                        *(t for p in self.params for t in p.values()))

    @property
    def mesh(self) -> tuple | None:
        """The stage devices of a sharded executor (None otherwise)."""
        return None if self.staged is None else self.staged.mesh

    @property
    def device(self) -> torch.device:
        """Where the executor's inputs, outputs and state live (a sharded
        executor's stages may run elsewhere)."""
        if isinstance(self.packed, tuple):
            return self.packed[0].device
        if self.packed is not None:
            return self.packed.device
        return self.params[0]["w_h"].device

    def zero_state(self, batch: int):
        """Backend-native zero state: the packed (L, B, W) pair for packed
        backends, one such pair per segment (a tuple) for ``mixed``,
        per-layer [(h, c), ...] at real widths otherwise."""
        plan = self.plan
        if plan.impl == IDENTITY:
            return []
        self._require_stateful()
        if plan.backend.heterogeneous:
            return tuple(pk.zero_state(batch) for pk in self.packed)
        if plan.backend.state_layout == "packed":
            return self.packed.zero_state(batch)
        return [layer_zero_state(batch, c, self.device) for c in plan.cfgs]

    def step_with_output(self, xs: torch.Tensor, state):
        """Advance native state by one chunk: (h_seq (B, T, hidden[-1]),
        new native state).  Packed backends route by the plan's chunk_len;
        ``mixed`` chains its segments, each routing on its own."""
        plan = self.plan
        if plan.impl == IDENTITY:
            return xs, state
        self._require_stateful()
        self._refuse_grad(xs)
        if plan.backend.heterogeneous:
            return _mixed_seq_call(self, xs, state)
        if plan.backend.state_layout == "packed":
            seq_call = _sharded_call if plan.backend.sharded else _fused_seq_call
            hs, h_f, c_f = seq_call(self, xs, state)
            return hs[..., : plan.hidden[-1]], (h_f, c_f)
        return plan.backend.forward(self, xs, state)

    def step(self, xs: torch.Tensor, state):
        """Advance native state by one chunk; returns only the new state
        (the streaming engines' per-push call)."""
        return self.step_with_output(xs, state)[1]

    def step_graph(self, batch: int) -> "StepGraph":
        """The bound step at batch width ``batch`` as CUDA graphs, one per
        chunk length up to the plan's ``chunk_len`` (the counterpart of the
        reference's ``step_jit``): made at first use, kept by this executor
        (``update_params`` returns one with none)."""
        graph = self._graphs.get(batch)
        if graph is None:
            graph = self._graphs[batch] = StepGraph(self, batch)
        return graph

    def last_hidden(self, state) -> torch.Tensor:
        """Last layer's current hidden at real width: the latent the GW
        autoencoder's RepeatVector bridge consumes."""
        plan = self.plan
        if plan.impl == IDENTITY:
            raise ValueError("identity executor has no hidden state")
        self._require_stateful()
        if plan.backend.heterogeneous:
            return state[-1][0][-1, :, : plan.hidden[-1]]
        if plan.backend.state_layout == "packed":
            return state[0][-1, :, : plan.hidden[-1]]
        return state[-1][0]

    def update_params(self, params_list: Sequence[Params]) -> "StackExecutor":
        """Re-bind on new parameters and evict this executor's superseded
        packs from the identity cache."""
        new = self.plan.bind(params_list)
        if self.packed is not None:
            from repro_torch.kernels.lstm_stack.ops import pack_cache_evict

            old = self.packed if isinstance(self.packed, tuple) else (self.packed,)
            cur = new.packed if isinstance(new.packed, tuple) else (new.packed,)
            stale = [p for p in old if all(p is not q for q in cur)]
            if stale:
                pack_cache_evict(*stale)
        return new

    @property
    def packed_bytes(self) -> int:
        """Bytes the bound pack occupies (0 for non-packing backends); mixed
        executors sum their segments' packs."""
        if self.packed is None:
            return 0
        if isinstance(self.packed, tuple):
            return sum(p.packed_bytes for p in self.packed)
        return self.packed.packed_bytes

    def __repr__(self) -> str:
        return f"StackExecutor({self.plan.describe()})"


def state_leaves(state) -> list[torch.Tensor]:
    """A native state's tensors in the reference's pytree order: ``[h, c]``
    of the packed layout, ``[h0, c0, h1, c1, ...]`` of the layers layout,
    each segment's ``[h, c]`` in turn of a mixed state."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for part in state for t in state_leaves(part)]


def state_like(leaves, template):
    """``leaves`` (in ``state_leaves`` order) in ``template``'s structure."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        parts = [build(part) for part in node]
        return parts if isinstance(node, list) else tuple(parts)

    return build(template)


class StepGraph:
    """``StackExecutor.step`` at one batch width, captured as one CUDA
    graph per chunk length T <= ``chunk_len`` over static buffers.

    The state is resident: ``state`` is the pair of (L, batch, W) buffers
    (one pair per segment of a mixed plan, whose whole chain is one graph)
    every graph of this width reads and overwrites in place, so a replay
    gives the bits of ``step`` and allocates nothing.  ``__call__(xs,
    state)`` copies ``xs`` (and ``state``, unless it is the resident state)
    in, replays, and returns the resident state.  Packed chunked-step
    backends (``fused_step``, ``mixed``) on the card only.
    """

    def __init__(self, ex: StackExecutor, batch: int):
        plan = ex.plan
        if not (plan.backend.chunked_step and plan.backend.state_layout == "packed"):
            raise ValueError(f"step_graph needs a chunked-step packed backend (fused_step, "
                             f"mixed), not impl={plan.impl!r}")
        if ex.device.type != "cuda":
            raise ValueError(f"step_graph captures CUDA graphs; the executor is on {ex.device}")
        self.ex, self.batch = ex, batch
        self.state = ex.zero_state(batch)
        self._calls: dict = {}  # T -> (x buffer, CapturedCall)

    def __call__(self, xs: torch.Tensor, state):
        from .graphs import CapturedCall

        t_len = xs.shape[1]
        if xs.shape[0] != self.batch or t_len > self.ex.plan.chunk_len:
            raise ValueError(f"step_graph({self.batch}): chunk {tuple(xs.shape)} is not "
                             f"(batch={self.batch}, T <= {self.ex.plan.chunk_len}, in_dim)")
        if state is not self.state:
            for dst, src in zip(state_leaves(self.state), state_leaves(state)):
                dst.copy_(src)
        entry = self._calls.get(t_len)
        if entry is not None:
            entry[0].copy_(xs)
            entry[1].replay()
            return self.state
        x_buf = torch.empty(xs.shape, dtype=xs.dtype, device=self.ex.device)
        x_buf.copy_(xs)

        def step():
            new = self.ex.step(x_buf, self.state)
            for dst, src in zip(state_leaves(self.state), state_leaves(new)):
                dst.copy_(src)

        self._calls[t_len] = (x_buf, CapturedCall(step, x_buf.device))
        return self.state


# ---------------------------------------------------------------------------
# backend implementations
# ---------------------------------------------------------------------------

def _forward_identity(ex: StackExecutor, xs, state):
    return xs, (state if state is not None else [])


def _forward_layerwise(ex: StackExecutor, xs, state):
    h_seq, finals = xs, []
    for i, (p, cfg) in enumerate(zip(ex.params, ex.plan.cfgs)):
        s = None if state is None else state[i]
        h_seq, final = lstm_forward(p, h_seq, cfg, s, impl=ex.plan.impl)
        finals.append(final)
    return h_seq, finals


def _forward_fused(ex: StackExecutor, xs, state):
    from repro_torch.kernels.lstm_stack.ops import lstm_stack_forward_fused

    return lstm_stack_forward_fused(
        list(ex.params), xs, list(ex.plan.cfgs), state, packed=ex.packed,
        block_b=ex.plan.block_b, act_bits=ex.plan.act_bits,
    )


def _fused_seq_call(ex: StackExecutor, xs, state):
    """The plan-routed fused kernel call on packed state: (hs (B, T, W
    padded), h_f, c_f).  Chunked-step plans send T <= chunk_len to the step
    kernel and longer chunks to the wavefront kernel."""
    plan, packed = ex.plan, ex.packed
    h, c = state
    kw = dict(acts=packed.acts, weight_dtype=packed.weight_dtype,
              block_b=plan.block_b, act_bits=plan.act_bits)
    if plan.backend.chunked_step and xs.shape[1] <= plan.chunk_len:
        from repro_torch.kernels.lstm_stack.step import lstm_stack_step_op

        return lstm_stack_step_op(packed.pad_input(xs), packed.stacked, h, c,
                                  fuse_gates=plan.fuse_gates, **kw)
    from repro_torch.kernels.lstm_stack.ops import lstm_stack_op

    return lstm_stack_op(packed.pad_input(xs), packed.stacked, h, c, widths=packed.widths, **kw)


def _resolve_n_chunks(ex: StackExecutor, t_len: int) -> int:
    n_chunks = ex.plan.n_chunks
    if n_chunks is not None:
        if t_len % n_chunks:
            raise ValueError(f"n_chunks={n_chunks} does not divide T={t_len}")
        return n_chunks
    # auto: one chunk per stage keeps the stages busy alike; a single chunk
    # (the coarsest hand-off) where T does not split evenly
    n_stages = len(ex.mesh)
    return n_stages if t_len % n_stages == 0 else 1


def _sharded_call(ex: StackExecutor, xs, state):
    """The sharded wavefront on packed state: (hs (B, T, W padded), h_f,
    c_f), every stage one K1 launch per chunk on its sub-stack."""
    from .pipeline import wavefront_shard_map_fused

    h, c = state
    packed = ex.packed
    return wavefront_shard_map_fused(packed, ex.staged, packed.pad_input(xs), h, c,
                                     _resolve_n_chunks(ex, xs.shape[1]))


def _forward_sharded(ex: StackExecutor, xs, state):
    packed = ex.packed
    if state is None:
        state = packed.zero_state(xs.shape[0])
    else:
        state = packed.pack_state(state)
    hs, h_f, c_f = _sharded_call(ex, xs, state)
    return hs[..., : packed.hidden[-1]], packed.unpack_state(h_f, c_f)


def _forward_wavefront(ex: StackExecutor, xs, state):
    """The plain single-program pipeline over an exact max-width pack
    (``pack_uniform``, made per call as the reference's XLA-level path
    does); stateless."""
    from .pipeline import pack_uniform, wavefront

    if state is not None:
        raise ValueError("impl='wavefront' does not thread state; use 'fused_stack' (or a "
                         "layer-by-layer backend) for the streaming path")
    cfgs = ex.plan.cfgs
    stacked, width = pack_uniform(list(ex.params), [c.in_dim for c in cfgs],
                                  [c.hidden for c in cfgs])
    xs_p = torch.nn.functional.pad(xs, (0, width - xs.shape[-1]))
    n_chunks = ex.plan.n_chunks if ex.plan.n_chunks is not None else 1
    out = wavefront(stacked, xs_p, n_chunks, cfgs[0].acts)
    return out[..., : cfgs[-1].hidden], None


def _mixed_seq_call(ex: StackExecutor, xs, state):
    """Chain the mixed plan's segments through native-layout hand-off: each
    segment's real-width hidden sequence feeds the next one's
    ``pad_input``.  Returns (the last segment's h_seq, the tuple of new
    per-segment native states)."""
    h_seq, new = xs, []
    for sub, st in zip(ex._segment_executors(), state):
        h_seq, st_new = sub.step_with_output(h_seq, st)
        new.append(st_new)
    return h_seq, tuple(new)


def _forward_mixed(ex: StackExecutor, xs, state):
    """Batch path: chain the segments' calls with portable per-layer state
    slices, as hand-chaining the homogeneous segments does."""
    h_seq, finals, i = xs, [], 0
    for sub in ex._segment_executors():
        n = sub.plan.n_layers
        h_seq, f = sub(h_seq, None if state is None else list(state[i:i + n]))
        finals.extend(f)
        i += n
    return h_seq, finals


register_backend(BackendSpec(name=IDENTITY, differentiable=True, forward=_forward_identity))
register_backend(BackendSpec(name="naive", differentiable=True, forward=_forward_layerwise))
register_backend(BackendSpec(name="split", differentiable=True, forward=_forward_layerwise))
register_backend(BackendSpec(name="kernel", kernel_acts=True, forward=_forward_layerwise))
register_backend(BackendSpec(
    name="fused_stack", packs=True, quantized=True, kernel_acts=True,
    state_layout="packed", act_quant=True, knobs=("block_b",),
    forward=_forward_fused))
register_backend(BackendSpec(
    name="fused_step", packs=True, quantized=True, kernel_acts=True,
    state_layout="packed", chunked_step=True, act_quant=True,
    knobs=("chunk_len", "block_b", "fuse_gates"), forward=_forward_fused))
register_backend(BackendSpec(
    name="mixed", packs=True, quantized=True, kernel_acts=True,
    state_layout="packed", chunked_step=True, act_quant=True, heterogeneous=True,
    knobs=("chunk_len", "block_b", "fuse_gates", "split"), forward=_forward_mixed))
register_backend(BackendSpec(
    name="fused_stack_sharded", packs=True, quantized=True, kernel_acts=True,
    sharded=True, state_layout="packed", knobs=("n_chunks",), forward=_forward_sharded))
register_backend(BackendSpec(
    name="wavefront", stateful=False, differentiable=True, knobs=("n_chunks",),
    forward=_forward_wavefront))
