"""Backend registry and the legality rules every LSTM execution surface shares.

* ``BACKENDS``: one table of every way a stacked LSTM segment can execute
  (``naive``/``split`` layer by layer, ``kernel`` layer by layer with one
  scan-kernel launch per layer, ``fused_stack`` one wavefront kernel
  launch, ``fused_step`` the same plus the step kernel for short streaming
  chunks, ``mixed`` a chain of ``fused_step`` segments with per-layer
  weight storage, ``fused_stack_sharded`` the stage-pipelined wavefront
  over fused sub-stacks on a tuple of stage devices, ``wavefront`` the
  plain single-program pipeline), each declaring its capabilities.
* ``check_weight_storage`` and ``resolve_impl``: quantized-storage legality
  and the engines' backend resolution.

``core.executor.plan_stack`` consults this table once per plan; call-time
code never re-derives legality.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

from .quant import kernel_safe, native_weight_dtype


@dataclass(frozen=True)
class BackendSpec:
    """Capabilities of one stacked-LSTM execution backend.

    ``forward`` is attached by ``core.executor`` at registration.
    """

    name: str
    #: consumes a homogeneous ``PackedStack`` (bound once, never per call)
    packs: bool = False
    #: may honour non-native weight storage (bf16/int8 codes + scales)
    quantized: bool = False
    #: threads per-layer (h, c) initial/final state (the streaming surfaces)
    stateful: bool = True
    #: swaps non-kernel-safe activations (LUT sigmoid) for their PWL twins
    kernel_acts: bool = False
    #: places pipeline stages on the devices of a stage mesh
    #: (``placement="sharded"``)
    sharded: bool = False
    #: native streaming-state layout: "layers" (per-layer [(h, c), ...] at
    #: real widths) or "packed" (the bound PackedStack's (L, B, W) pair)
    state_layout: str = "layers"
    #: honours a plan-time ``chunk_len``: chunks with T <= chunk_len run the
    #: step kernel, longer ones the wavefront kernel
    chunked_step: bool = False
    #: honours the plan-time ``act_bits`` knob (in-kernel activation
    #: fake-quant on the layer hand-off)
    act_quant: bool = False
    #: executes per-layer heterogeneous sub-plans (the ``mixed`` backend):
    #: per-layer weight_dtype/geometry, chained through native-layout state
    heterogeneous: bool = False
    #: plan-time knobs this backend accepts, the single source of sweep
    #: legality (``autotune.space`` builds its grids from them): "chunk_len",
    #: "block_b", "fuse_gates", "n_chunks" (the wavefront's time chunks per
    #: tick), "split"
    knobs: tuple[str, ...] = ()
    #: plain PyTorch autograd reaches every weight (the backends a loss may
    #: be built on); the kernel backends are forward-only and refuse a call
    #: that needs a gradient
    differentiable: bool = False
    #: (executor, xs, state) -> (h_seq, finals | None)
    forward: Any = None


#: default ``chunk_len`` for chunked-step backends
DEFAULT_CHUNK_LEN = 32

#: the one backend table; ``core.executor`` registers the implementations
BACKENDS: dict[str, BackendSpec] = {}

#: the degenerate empty-segment backend
IDENTITY = "identity"

def register_backend(spec: BackendSpec) -> BackendSpec:
    BACKENDS[spec.name] = spec
    return spec


def _ensure_registered() -> None:
    # executor.py registers the implementations on import
    if not BACKENDS:
        from . import executor  # noqa: F401  (import side effect)


def available_backends() -> tuple[str, ...]:
    _ensure_registered()
    return tuple(n for n in BACKENDS if n != IDENTITY)


def get_backend(name: str) -> BackendSpec:
    _ensure_registered()
    spec = BACKENDS.get(name)
    if spec is None:
        raise ValueError(
            f"unknown impl {name!r}; registered backends: "
            f"{', '.join(available_backends())}"
        )
    return spec


def requested_weight_storage(cfgs) -> str | None:
    """First non-native weight storage requested by a list of layer configs."""
    for c in cfgs:
        if c.weight_dtype is not None and c.weight_dtype != native_weight_dtype(c.dtype):
            return c.weight_dtype
    return None


def quantized_weight_storage(cfg) -> str | None:
    """The first non-native weight storage an AutoencoderConfig requests."""
    native = native_weight_dtype(cfg.dtype)
    for wd in (cfg.weight_dtype, cfg.dec_weight_dtype, *(cfg.weight_dtypes or ())):
        if wd is not None and wd != native:
            return wd
    return None


def heterogeneous_weight_storage(cfg) -> bool:
    """True when an AutoencoderConfig pins more than one distinct per-layer
    weight storage: only the ``mixed`` backend executes that; every
    homogeneous backend's pack would refuse it."""
    if not cfg.weight_dtypes:
        return False
    return len({wd or "native" for wd in cfg.weight_dtypes}) > 1


def check_weight_storage(wd, impl: str) -> None:
    """Refuse quantized weight storage on a backend that cannot honour it.
    ``wd`` may be a per-layer sequence (mixed plans): the capability is
    needed as soon as any layer asks for narrow storage."""
    if isinstance(wd, (tuple, list)):
        wd = next((w for w in wd if w is not None and w != "fp32"), None)
    if wd is None:
        return
    if not get_backend(impl).quantized:
        legal = ", ".join(f"{n!r}" for n, s in BACKENDS.items() if s.quantized)
        raise ValueError(
            f"weight_dtype={wd!r} requires a quantized-capable backend (impl in "
            f"{{{legal}}}); got impl={impl!r}: quantized packed weights only "
            "exist on the fused path"
        )


def resolve_impl(cfg, impl: str | None):
    """Resolve a requested inference backend against kernel-safety.

    Returns ``(cfg, effective_impl, fallback_reason)``.  Kernel backends
    swap non-kernel-safe activations (PAPER_HW's LUT sigmoid) for their PWL
    twins, which would make scores inconsistent with thresholds calibrated
    on ``cfg.impl``; such a request is declined, ``cfg.impl`` is kept and
    the reason returned.  So is a request for a homogeneous backend when
    the config pins heterogeneous per-layer storage, which only ``mixed``
    executes.  Quantized weight storage on a backend that cannot honour it
    raises here, not at score time.
    """
    if impl is None or impl == cfg.impl:
        cfg, effective, reason = cfg, cfg.impl, None
    elif get_backend(impl).kernel_acts and kernel_safe(cfg.acts) is not cfg.acts:
        reason = (
            f"requested impl={impl!r} would swap acts={cfg.acts.name!r} for its "
            f"kernel-safe twin; keeping impl={cfg.impl!r} so scores stay "
            f"consistent with thresholds calibrated on it"
        )
        effective = cfg.impl
    elif heterogeneous_weight_storage(cfg) and not get_backend(impl).heterogeneous:
        reason = (
            f"config pins heterogeneous per-layer weight_dtypes, which only the "
            f"mixed backend executes; keeping impl={cfg.impl!r} over the "
            f"requested impl={impl!r}"
        )
        effective = cfg.impl
    else:
        cfg, effective, reason = replace(cfg, impl=impl), impl, None
    wd = quantized_weight_storage(cfg)
    if wd is not None and not get_backend(effective).quantized:
        raise ValueError(
            f"weight_dtype={wd!r} requires a fused backend, but the engine "
            f"resolved impl={effective!r}"
            + (f" ({reason})" if reason else "")
            + "; drop the quantized weight_dtype or fix the config so the "
            "fused path is eligible"
        )
    return cfg, effective, reason
