"""Wrappers around the fused stack kernels: pack, pad, dispatch.

Public entry points:

* ``lstm_stack_op(xs, stacked, h0, c0)``: batch-major wrapper over a packed
  stack.  It runs layer 0's ``mvm_x`` outside the kernel through the
  row-wise product kernel (compute dtype, then fp32, then per-gate scales,
  then the bias, time-major) and launches the wavefront kernel on the rest.
  An input repeated over time (the decoder's RepeatVector, time stride 0)
  stays a view: its one (B, W) block is projected once and the kernel reads
  the (B, 4W) result at every step.
* ``pack_stack(params_list, cfgs)``: one-time packing of a (possibly
  heterogeneous) stack to one common width, with a ``weight_dtype`` axis
  (fp32 | bf16 | int8); int8 packs quantize each gate of each matrix onto a
  power-of-two grid and carry the ``(L, 2, 4)`` dequant scales.
  ``pack_stack_cached`` memoizes it on the identity (and in-place version)
  of the parameter tensors, so engines pack once.
* ``lstm_stack_forward_fused(params_list, xs, cfgs, initial_state)``: the
  ``fused_stack`` backend; packs, runs ONE kernel for the whole segment
  (handing it the pack's real widths, so that the row-blocked launch skips
  the padding's work), and slices per-layer real widths back out.

The pack width is the stack's exact widest dimension (W=32 for the GW
nominal segments): shared memory has no 128-lane tiling to pad to, so the
packed arrays equal the reference's CPU packs element for element.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from repro_torch.core.pipeline import pack_lstm_stack
from repro_torch.core.quant import (
    EXACT,
    WEIGHT_DTYPES,
    ActivationSet,
    int8_symmetric_quant,
    kernel_safe,
    native_weight_dtype,
)
from repro_torch.trace import span

from .lstm_stack import lstm_stack
from .ref import Widths, apply_gate_scales, normalize_scales  # noqa: F401  (public here)

#: weight storage dtype -> the torch dtype the packed arrays hold
_WEIGHT_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def resolve_weight_dtype(cfg, override: str | None = None) -> str:
    """Canonical weight-storage dtype for a layer config.

    ``cfg.weight_dtype=None`` means native storage at the compute dtype.
    Storage wider than compute ('fp32' weights under a bf16 compute config)
    is refused.
    """
    wd = override if override is not None else cfg.weight_dtype
    if wd is None:
        native = native_weight_dtype(cfg.dtype)
        if native is None:
            raise ValueError(
                f"no native weight storage for compute dtype {cfg.dtype}; set "
                f"weight_dtype explicitly (one of {WEIGHT_DTYPES})"
            )
        return native
    if wd not in WEIGHT_DTYPES:
        raise ValueError(f"unknown weight_dtype {wd!r}; choose from {WEIGHT_DTYPES}")
    _check_not_wider(wd, cfg.dtype)
    return wd


def _check_not_wider(weight_dtype: str, compute_dtype: torch.dtype) -> None:
    if weight_dtype == "fp32" and compute_dtype != torch.float32:
        raise ValueError(
            f"weight_dtype='fp32' disagrees with compute dtype {compute_dtype}: "
            "storage must not be wider than compute; use 'bf16' or 'int8'"
        )


def check_packed_weight_dtype(stacked: dict, weight_dtype: str,
                              compute_dtype: torch.dtype) -> None:
    """Refuse a stacked-weights/weight_dtype disagreement up front."""
    if weight_dtype not in _WEIGHT_TORCH:
        raise ValueError(
            f"unknown weight_dtype {weight_dtype!r}; choose from {WEIGHT_DTYPES}"
        )
    have = stacked["w_h"].dtype
    if have != _WEIGHT_TORCH[weight_dtype]:
        raise ValueError(
            f"packed stack stores {have} weights but weight_dtype="
            f"{weight_dtype!r} was requested; re-pack via "
            "pack_stack(..., weight_dtype=...)"
        )
    if weight_dtype == "int8" and "scales" not in stacked:
        raise ValueError(
            "int8 packed stack is missing its per-layer dequant 'scales'; pack "
            "with pack_stack(weight_dtype='int8'), do not cast weights by hand"
        )
    _check_not_wider(weight_dtype, compute_dtype)


def repeats_over_time(xs: torch.Tensor) -> bool:
    """Whether a (B, T, W) input is one (B, W) block repeated over T > 1
    steps as a view (time stride 0), as the decoder's RepeatVector is."""
    return xs.shape[1] > 1 and xs.stride(1) == 0


def project_layer0(xs: torch.Tensor, stacked: dict, weight_dtype: str) -> torch.Tensor:
    """Layer 0's gate stream for the wavefront kernel (paper mvm_x): the
    product at the compute dtype, widened to fp32, per-gate int8 scales,
    then the bias, time-major.  (B, T, W) -> (T, B, 4W) fp32.

    The product runs through ``rowwise_matmul``: each sum in the step
    kernel's order (``seq_dot``), rounded once to the compute dtype, so a
    row's stream does not depend on the batch (cuBLAS picks its reduction
    by shape) and equals the step kernel's in-kernel product.  An input
    repeated over time (``repeats_over_time``) is projected once, over its
    B rows, and comes back as the same (B, 4W) block at every step (time
    stride 0): the same operations on the same values, so the same bits."""
    from repro_torch.kernels.rowwise import rowwise_matmul

    batch, t_len, width = xs.shape
    w0 = stacked["w_x"][0].to(xs.dtype).to(torch.float32)
    if repeats_over_time(xs):
        x_tb, steps = xs[:, 0], 1
    else:
        x_tb, steps = xs.transpose(0, 1).reshape(t_len * batch, width), t_len
    xw0 = rowwise_matmul(x_tb, w0).to(xs.dtype).to(torch.float32)
    xw0 = xw0.reshape(steps, batch, w0.shape[1])
    if weight_dtype == "int8":
        scales = normalize_scales(stacked["scales"], stacked["w_h"].shape[0])
        xw0 = apply_gate_scales(xw0, scales[0, 0])
    xw0 = xw0 + stacked["b"][0]
    return xw0 if steps == t_len else xw0.expand(t_len, batch, w0.shape[1])


def lstm_stack_op(
    xs: torch.Tensor,   # (B, T, W) layer-0 input, pre-padded to the pack width
    stacked: dict,      # {"w_x", "w_h": (L, W, 4W), "b": (L, 4W)[, "scales"]}
    h0: torch.Tensor,   # (L, B, W)
    c0: torch.Tensor,   # (L, B, W)
    *,
    block_b: int | None = None,
    acts: ActivationSet = EXACT,
    weight_dtype: str = "fp32",
    act_bits: int | None = None,
    widths: Widths | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hs_last (B, T, W), h_final (L, B, W), c_final fp32).
    ``widths``: the real ``(in_dims, hidden)`` of the pack ``stacked``
    came from (``PackedStack.widths``; ``lstm_stack``'s contract)."""
    width = xs.shape[2]
    if stacked["w_h"].shape[1] != width:
        raise ValueError(
            f"input width {width} != pack width {stacked['w_h'].shape[1]}"
        )
    check_packed_weight_dtype(stacked, weight_dtype, h0.dtype)
    with span("stack.gates"):
        xw0 = project_layer0(xs, stacked, weight_dtype)
    with span("stack.k1"):
        hs, h_f, c_f = lstm_stack(
            xw0, stacked["w_x"], stacked["w_h"],
            stacked["b"].to(torch.float32), h0, c0.to(torch.float32),
            scales=stacked["scales"] if weight_dtype == "int8" else None,
            acts=kernel_safe(acts), act_bits=act_bits, block_b=block_b, widths=widths,
        )
        return hs.transpose(0, 1), h_f, c_f


# ---------------------------------------------------------------------------
# one-time weight packing for the serve path
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PackedStack:
    """A homogeneous-packed LSTM stack ready for the fused kernels.

    ``stacked`` holds the padded weights with a leading layer axis; the
    other fields record the real (unpadded) geometry needed to slice
    results back out and to build zero/padded state.
    """

    stacked: dict[str, torch.Tensor]
    width_p: int                 # common packed width W
    in_dims: tuple[int, ...]
    hidden: tuple[int, ...]
    dtype: torch.dtype
    cell_dtype: torch.dtype
    acts: ActivationSet
    #: weight storage: fp32 | bf16 | int8 (int8 packs carry per-gate dequant
    #: scales in ``stacked["scales"]``)
    weight_dtype: str = "fp32"
    #: strong refs to the source parameter tensors: keeps the cache key's
    #: ids valid and lets lookups verify identity (``pack_stack_cached``)
    src_leaves: tuple = field(default=(), compare=False)

    @property
    def n_layers(self) -> int:
        return len(self.hidden)

    @property
    def device(self) -> torch.device:
        return self.stacked["w_h"].device

    @property
    def widths(self) -> Widths:
        """The real ``(in_dims, hidden)``, as the fused kernel takes them."""
        return self.in_dims, self.hidden

    @property
    def packed_bytes(self) -> int:
        """Bytes of the packed weights, biases and scales."""
        return sum(t.numel() * t.element_size() for t in self.stacked.values())

    def zero_state(self, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Packed-layout zero state: h (L, B, W) compute dtype, c fp32."""
        shape = (self.n_layers, batch, self.width_p)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device))

    def pad_input(self, xs: torch.Tensor) -> torch.Tensor:
        """Pad (B, T, in_dims[0]) features up to the pack width.  An input
        repeated over time (``repeats_over_time``) is padded once and
        comes back as the same repeat, a view."""
        if repeats_over_time(xs):
            return self.pad_input(xs[:, :1]).expand(-1, xs.shape[1], -1)
        return torch.nn.functional.pad(
            xs.to(self.dtype), (0, self.width_p - xs.shape[-1])
        )

    def pack_state(self, states: Sequence[tuple[torch.Tensor, torch.Tensor]]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-layer [(h, c), ...] at real widths -> packed (L, B, W) pair."""
        def pad(arr, dtype):
            return torch.nn.functional.pad(arr.to(dtype), (0, self.width_p - arr.shape[-1]))

        h = torch.stack([pad(h, self.dtype) for h, _ in states])
        c = torch.stack([pad(c, torch.float32) for _, c in states])
        return h, c

    def unpack_state(self, h_f: torch.Tensor, c_f: torch.Tensor
                     ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Packed (L, B, W) finals -> per-layer [(h, c), ...] at real widths."""
        return [
            (h_f[l, :, :w].to(self.dtype), c_f[l, :, :w].to(self.cell_dtype))
            for l, w in enumerate(self.hidden)
        ]


def _pack_width(cfgs: Sequence) -> int:
    return max(max(c.in_dim for c in cfgs), max(c.hidden for c in cfgs))


def _check_homogeneous(cfgs: Sequence) -> None:
    """One kernel executes every layer: activations, dtypes and weight
    storage must be segment-wide."""
    cfg0 = cfgs[0]
    if any(c.acts.name != cfg0.acts.name for c in cfgs):
        raise ValueError("fused_stack requires homogeneous activations across the segment")
    if any(c.dtype != cfg0.dtype or c.cell_dtype != cfg0.cell_dtype for c in cfgs):
        raise ValueError("fused_stack requires homogeneous dtypes across the segment")
    if any(c.weight_dtype != cfg0.weight_dtype for c in cfgs):
        raise ValueError(
            "fused_stack requires a homogeneous weight_dtype across the segment"
        )


def _leaves(params_list: Sequence[dict]) -> list[torch.Tensor]:
    return [p[k] for p in params_list for k in sorted(p)]


def pack_stack(params_list: Sequence[dict], cfgs: Sequence,
               weight_dtype: str | None = None) -> PackedStack:
    """Pack a (possibly heterogeneous) stack to the kernels' common width.

    ``weight_dtype`` picks the storage of ``W_x``/``W_h`` (default: the
    cfgs' ``weight_dtype``, else native storage at the compute dtype).
    int8 packs quantize each [i|f|g|o] slice of each matrix on its own
    power-of-two grid (``core.quant.int8_symmetric_quant``); the
    ``(L, 2, 4)`` ``[s_x, s_h]`` scales ride in ``stacked["scales"]``.
    Biases and the cell carry stay fp32 (paper Sec. IV-A).  The packing
    runs on the CPU, so a pack is the same on every device, and the result
    moves to the parameters' device.
    """
    _check_homogeneous(cfgs)
    cfg0 = cfgs[0]
    wd = resolve_weight_dtype(cfg0, override=weight_dtype)
    in_dims = tuple(c.in_dim for c in cfgs)
    hidden = tuple(c.hidden for c in cfgs)
    width_p = _pack_width(cfgs)
    device = params_list[0]["w_h"].device
    host = [{k: v.detach().cpu() for k, v in p.items()} for p in params_list]
    stacked, _, _ = pack_lstm_stack(host, list(in_dims), list(hidden),
                                    d_target=width_p, h_target=width_p)
    if wd == "int8":
        def quant_gates(w):  # (W, 4W) -> (codes (W, 4W), scales (4,))
            per_gate = w.reshape(w.shape[0], 4, -1)
            qs = [int8_symmetric_quant(per_gate[:, g]) for g in range(4)]
            codes = torch.stack([q for q, _ in qs], dim=1).reshape(w.shape)
            return codes, torch.stack([s for _, s in qs])

        q_x, s_x = zip(*(quant_gates(w) for w in stacked["w_x"]))
        q_h, s_h = zip(*(quant_gates(w) for w in stacked["w_h"]))
        stacked = {
            "w_x": torch.stack(q_x), "w_h": torch.stack(q_h), "b": stacked["b"],
            "scales": torch.stack([torch.stack(s_x), torch.stack(s_h)], dim=1),
        }
    else:
        store = _WEIGHT_TORCH[wd]
        stacked = {
            "w_x": stacked["w_x"].to(store), "w_h": stacked["w_h"].to(store),
            "b": stacked["b"],
        }
    return PackedStack(
        stacked={k: v.to(device) for k, v in stacked.items()},
        width_p=width_p, in_dims=in_dims, hidden=hidden, dtype=cfg0.dtype,
        cell_dtype=cfg0.cell_dtype, acts=cfg0.acts, weight_dtype=wd,
        src_leaves=tuple(_leaves(params_list)),
    )


#: identity-keyed pack cache: key -> PackedStack.  Each PackedStack keeps
#: strong refs to its source tensors, so their id()s stay valid for the
#: lifetime of the entry and a hit can verify ``is``-identity leaf by leaf.
_PACK_CACHE: dict[tuple, PackedStack] = {}
_PACK_CACHE_MAX = 16


def pack_stack_cached(params_list: Sequence[dict], cfgs: Sequence) -> PackedStack:
    """``pack_stack`` memoized on parameter identity (plus geometry).

    A params update that makes new tensors misses the cache and re-packs;
    so does an in-place update, because the key holds each tensor's
    version counter.  Stale packs are never served.
    """
    leaves = _leaves(params_list)
    key = (
        tuple((id(t), t._version) for t in leaves),
        tuple((c.in_dim, c.hidden) for c in cfgs),
        tuple((c.acts.name, c.dtype, c.cell_dtype, resolve_weight_dtype(c))
              for c in cfgs),
    )
    hit = _PACK_CACHE.get(key)
    if hit is not None and len(hit.src_leaves) == len(leaves) and all(
        a is b for a, b in zip(hit.src_leaves, leaves)
    ):
        return hit
    packed = pack_stack(params_list, cfgs)
    while len(_PACK_CACHE) >= _PACK_CACHE_MAX:
        _PACK_CACHE.pop(next(iter(_PACK_CACHE)))
    _PACK_CACHE[key] = packed
    return packed


def pack_cache_evict(*packs: PackedStack | None) -> None:
    """Drop cache entries holding the given PackedStacks (a memory release
    only: holders of a PackedStack keep using it)."""
    dead = {id(p) for p in packs if p is not None}
    for key in [k for k, v in _PACK_CACHE.items() if id(v) in dead]:
        del _PACK_CACHE[key]


def check_packed_matches_cfgs(packed: PackedStack, cfgs: Sequence) -> None:
    """Refuse a ``PackedStack`` built for different configs (geometry,
    activations, dtypes or weight storage)."""
    _check_homogeneous(cfgs)
    cfg0 = cfgs[0]
    want = (
        tuple(c.hidden for c in cfgs), tuple(c.in_dim for c in cfgs),
        cfg0.acts.name, cfg0.dtype, cfg0.cell_dtype, resolve_weight_dtype(cfg0),
    )
    have = (
        packed.hidden, packed.in_dims, packed.acts.name, packed.dtype,
        packed.cell_dtype, packed.weight_dtype,
    )
    if want != have:
        raise ValueError(f"packed stack mismatches cfgs: {have} != {want}")


def lstm_stack_forward_fused(
    params_list: Sequence[dict[str, Any]],
    xs: torch.Tensor,   # (B, T, in_dim of layer 0)
    cfgs: Sequence,     # list[LstmConfig], one per layer
    initial_state: Sequence[tuple[torch.Tensor, torch.Tensor]] | None = None,
    *,
    packed: PackedStack | None = None,
    block_b: int | None = None,
    act_bits: int | None = None,
) -> tuple[torch.Tensor, list[tuple[torch.Tensor, torch.Tensor]]]:
    """The ``fused_stack`` backend: one wavefront kernel for the segment.

    Returns (hs of the LAST layer (B, T, hidden[-1]), per-layer (h_f, c_f)).
    Pass a pre-built ``packed`` to skip packing (engines pack at init).
    """
    if packed is None:
        packed = pack_stack_cached(params_list, cfgs)
    else:
        check_packed_matches_cfgs(packed, cfgs)
    with span("stack.pad"):
        if initial_state is None:
            h0, c0 = packed.zero_state(xs.shape[0])
        else:
            h0, c0 = packed.pack_state(initial_state)
        xs = packed.pad_input(xs)
    hs, h_f, c_f = lstm_stack_op(
        xs, packed.stacked, h0, c0, acts=packed.acts,
        weight_dtype=packed.weight_dtype, block_b=block_b, act_bits=act_bits,
        widths=packed.widths,
    )
    return hs[..., : packed.hidden[-1]], packed.unpack_state(h_f, c_f)
