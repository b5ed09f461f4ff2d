"""Plan / bind / execute: the one call surface for every LSTM backend.

    plan = plan_stack(cfgs, impl="fused_stack", weight_dtype="int8")  # once, memoised
    ex = plan.bind(params_list)                  # packs weights exactly once
    h_seq, finals = ex(xs)                       # full-sequence execution
    state = ex.zero_state(batch)                 # streaming serving loop:
    state = ex.step(chunk, state)                #   native-layout hot path

``plan_stack`` resolves backend legality (the rules live in
``core.backends``), weight storage and the step-kernel threshold once; the
executor never re-checks them per call and never re-packs.

Backends ported so far (see ``core.backends.BACKENDS``):

    naive / split   layer by layer, plain PyTorch
    kernel          layer by layer, one scan-kernel launch per layer
    fused_stack     whole segment in ONE wavefront kernel launch
    fused_step      fused_stack + the step kernel for chunks with
                    T <= plan.chunk_len (the streaming serving default)
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
    #: backends; None for layer-by-layer backends (native storage)
    weight_dtype: str | None = None
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

    @property
    def backend(self) -> BackendSpec:
        return get_backend(self.impl)

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
        if self.backend.packs and self.cfgs:
            from repro_torch.kernels.lstm_stack.ops import (
                check_packed_matches_cfgs,
                pack_stack_cached,
            )

            if packed is None:
                packed = pack_stack_cached(list(params), list(self.cfgs))
            else:
                check_packed_matches_cfgs(packed, self.cfgs)
        return StackExecutor(self, params, packed)

    def describe(self) -> str:
        """One-line human summary."""
        dims = "->".join(str(c.hidden) for c in self.cfgs) or "(identity)"
        knobs = "".join(
            f" {k}={getattr(self, k)}"
            for k in ("chunk_len", "block_b", "act_bits", "fuse_gates")
            if getattr(self, k) is not None
        )
        return (f"impl={self.impl} layers={self.n_layers} [{dims}] "
                f"weight_dtype={self.weight_dtype or 'native'}{knobs}")


@functools.lru_cache(maxsize=128)
def _plan_stack_cached(cfgs: tuple[LstmConfig, ...], impl: str,
                       weight_dtype: str | None, chunk_len: int | None,
                       block_b: int | None, act_bits: int | None,
                       fuse_gates: bool | None) -> StackPlan:
    spec = get_backend(impl)  # raises for unknown impl, even on empty segments
    if not cfgs:
        return StackPlan(cfgs=(), impl=IDENTITY)
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
    return StackPlan(cfgs=cfgs, impl=impl, weight_dtype=resolved_wd,
                     chunk_len=chunk_len, block_b=block_b, act_bits=act_bits,
                     fuse_gates=fuse_gates)


def plan_stack(cfgs: Sequence[LstmConfig], impl: str = "split", *,
               weight_dtype: str | None = None, chunk_len: int | None = None,
               block_b: int | None = None, act_bits: int | None = None,
               fuse_gates: bool | None = None,
               tune: str = "default") -> StackPlan:
    """Resolve an execution plan for a stacked LSTM segment, exactly once.

    All impl-dependent legality is checked here: unknown backends,
    quantized storage on a non-fused backend, storage wider than compute,
    heterogeneous fused segments, ``act_bits`` on a backend without
    in-kernel activation quant, and a knob on a backend that does not take
    it.  Plans are memoised on their full argument tuple.

    ``fuse_gates`` (``fused_step`` only) runs each gate of the step kernel
    as one chain over ``[x ; h]`` (see ``kernels/lstm_stack/step.py``); int8
    packs refuse it.  ``tune`` exists so that reference call sites fail
    loudly: it belongs to a later slice of the port.
    """
    if tune != "default":
        raise ValueError(
            f"tune={tune!r} is not ported yet; the autotuner and the balanced "
            "mixed split come with later slices of the port (ROADMAP queue 1, "
            "items 8 and 9)"
        )
    return _plan_stack_cached(tuple(cfgs), impl, weight_dtype, chunk_len,
                              block_b, act_bits, fuse_gates)


class StackExecutor:
    """A plan bound to parameters: the only call-time surface.  Construct
    via ``StackPlan.bind``."""

    __slots__ = ("plan", "params", "packed", "_graphs")

    def __init__(self, plan: StackPlan, params: tuple, packed: Any = None) -> None:
        self.plan = plan
        self.params = params
        self.packed = packed
        self._graphs: dict = {}  # batch width -> StepGraph (step_graph)

    def __call__(self, xs: torch.Tensor, initial_state=None, *,
                 return_state: bool = True):
        """Run the segment. xs: (B, T, in_dim) -> (B, T, hidden[-1]).

        ``initial_state``/finals are the portable per-layer ``[(h, c), ...]``
        at real widths, identical across backends.
        """
        h_seq, finals = self.plan.backend.forward(self, xs, initial_state)
        return (h_seq, finals) if return_state else h_seq

    @property
    def device(self) -> torch.device:
        if self.packed is not None:
            return self.packed.device
        return self.params[0]["w_h"].device

    def zero_state(self, batch: int):
        """Backend-native zero state: the packed (L, B, W) pair for packed
        backends, per-layer [(h, c), ...] at real widths otherwise."""
        plan = self.plan
        if plan.impl == IDENTITY:
            return []
        if plan.backend.state_layout == "packed":
            return self.packed.zero_state(batch)
        return [layer_zero_state(batch, c, self.device) for c in plan.cfgs]

    def step_with_output(self, xs: torch.Tensor, state):
        """Advance native state by one chunk: (h_seq (B, T, hidden[-1]),
        new native state).  Packed backends route by the plan's chunk_len."""
        plan = self.plan
        if plan.impl == IDENTITY:
            return xs, state
        if plan.backend.state_layout == "packed":
            hs, h_f, c_f = _fused_seq_call(self, xs, state)
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
        if plan.backend.state_layout == "packed":
            return state[0][-1, :, : plan.hidden[-1]]
        return state[-1][0]

    def update_params(self, params_list: Sequence[Params]) -> "StackExecutor":
        """Re-bind on new parameters and evict this executor's superseded
        pack from the identity cache."""
        new = self.plan.bind(params_list)
        if self.packed is not None and self.packed is not new.packed:
            from repro_torch.kernels.lstm_stack.ops import pack_cache_evict

            pack_cache_evict(self.packed)
        return new

    @property
    def packed_bytes(self) -> int:
        """Bytes the bound pack occupies (0 for non-packing backends)."""
        return 0 if self.packed is None else self.packed.packed_bytes

    def __repr__(self) -> str:
        return f"StackExecutor({self.plan.describe()})"


class StepGraph:
    """``StackExecutor.step`` at one batch width, captured as one CUDA
    graph per chunk length T <= ``chunk_len`` over static buffers.

    The state is resident: ``state`` is the pair of (L, batch, W) buffers
    every graph of this width reads and overwrites in place, so a replay
    gives the bits of ``step`` and allocates nothing.  ``__call__(xs,
    state)`` copies ``xs`` (and ``state``, unless it is the resident pair)
    in, replays, and returns the resident pair.  Packed chunked-step
    backends on the card only.
    """

    def __init__(self, ex: StackExecutor, batch: int):
        plan = ex.plan
        if not (plan.backend.chunked_step and plan.backend.state_layout == "packed"):
            raise ValueError(f"step_graph needs a chunked-step packed backend (fused_step), "
                             f"not impl={plan.impl!r}")
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
            for dst, src in zip(self.state, state):
                dst.copy_(src)
        entry = self._calls.get(t_len)
        if entry is not None:
            entry[0].copy_(xs)
            entry[1].replay()
            return self.state
        x_buf = torch.empty(xs.shape, dtype=xs.dtype, device=self.state[0].device)
        x_buf.copy_(xs)

        def step():
            for dst, src in zip(self.state, self.ex.step(x_buf, self.state)):
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

    return lstm_stack_op(packed.pad_input(xs), packed.stacked, h, c, **kw)


register_backend(BackendSpec(name=IDENTITY, forward=_forward_identity))
register_backend(BackendSpec(name="naive", forward=_forward_layerwise))
register_backend(BackendSpec(name="split", forward=_forward_layerwise))
register_backend(BackendSpec(name="kernel", kernel_acts=True, forward=_forward_layerwise))
register_backend(BackendSpec(
    name="fused_stack", packs=True, quantized=True, kernel_acts=True,
    state_layout="packed", act_quant=True, knobs=("block_b",),
    forward=_forward_fused))
register_backend(BackendSpec(
    name="fused_step", packs=True, quantized=True, kernel_acts=True,
    state_layout="packed", chunked_step=True, act_quant=True,
    knobs=("chunk_len", "block_b", "fuse_gates"), forward=_forward_fused))
