"""Coarse-grained time-wavefront pipeline for stacked recurrent layers.

The paper's Sec. III-B/III-D at the granularity of pipeline stages: stage
*s+1* starts on a chunk of timesteps as soon as stage *s* hands it over
(Fig. 7, "timestep overlapping"), so S stages process a length-T sequence
in ``n_chunks + S - 1`` ticks of ``T / n_chunks`` timesteps instead of
``S * n_chunks``.  Three executions of the same tick schedule:

* ``wavefront``: one program, every stage one layer, the stages batched
  over the stacked params; the hand-off is a roll along the stage axis.
* ``wavefront_shard_map``: the same schedule with each stage on a device
  of ``mesh`` (a tuple of ``torch.device``, the reference's "stage" mesh
  axis); the hand-off is a copy to the next stage's device.
* ``wavefront_shard_map_fused`` (the ``fused_stack_sharded`` backend):
  each stage a contiguous sub-stack of a ``PackedStack``, its body ONE
  call of the fused stack kernel (K1) over its layers; only the
  sub-stack's last hidden chunk ``(B, ct, W)`` crosses to the next stage.

One process drives every stage, as the reference's one SPMD program does.
On the card each stage runs on a CUDA stream of its own and waits for its
input on the stream that made it, so stages overlap wherever their
inputs allow; a device may appear in ``mesh`` more than once (stages that
share one card), and on the CPU the same code runs the stages in turn.
A stage that has no chunk at a tick (pipeline fill and drain) launches
nothing, where the reference masks its result away: the bits are the
same.

Stage weights must be shape-homogeneous: ``pack_lstm_stack`` pads every
layer to one width (exact for the LSTM equations, as padded rows and
columns stay zero).  The GW autoencoder's encoder -> decoder boundary is a
sync point: each segment is pipelined on its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import torch

from .quant import ActivationSet, EXACT

Mesh = tuple[torch.device, ...]


# ---------------------------------------------------------------------------
# homogeneous stage packing for LSTM stacks
# ---------------------------------------------------------------------------

def pack_lstm_stack(params_list: list[dict], in_dims: list[int],
                    hidden_dims: list[int], d_target: int | None = None,
                    h_target: int | None = None) -> tuple[dict, int, int]:
    """Zero-pad per-layer LSTM weights to common (D, H) and stack.

    Padding is gate-aware: each of the [i|f|g|o] segments pads ``lh`` to
    ``h_max`` on its own.  Returns (stacked params with a leading layer
    axis, D_max, H_max).
    """
    d_max = d_target or max(in_dims)
    h_max = h_target or max(hidden_dims)

    def place(src, rows, lh, n_rows):
        dst = torch.zeros(n_rows, 4, h_max, dtype=src.dtype, device=src.device)
        dst[:rows, :, :lh] = src.reshape(rows, 4, lh)
        return dst.reshape(n_rows, 4 * h_max)

    padded = []
    for p, lx, lh in zip(params_list, in_dims, hidden_dims):
        b = torch.zeros(4, h_max, dtype=p["b"].dtype, device=p["b"].device)
        b[:, :lh] = p["b"].reshape(4, lh)
        padded.append({
            "w_x": place(p["w_x"], lx, lh, d_max),
            "w_h": place(p["w_h"], lh, lh, h_max),
            "b": b.reshape(-1),
        })
    stacked = {k: torch.stack([p[k] for p in padded]) for k in ("w_x", "w_h", "b")}
    return stacked, d_max, h_max


def _lstm_chunk_step(p: dict, h: torch.Tensor, c: torch.Tensor, xs: torch.Tensor,
                     acts: ActivationSet):
    """One chunk of timesteps through one LSTM stage (the paper's split
    form: the chunk's input product first, then the recurrence).

    ``xs`` (..., B, ct, D), ``h``/``c`` (..., B, H), ``p`` leaves with the
    same leading axes: none for one stage, the stage axis for a batch of
    stages.  Returns (h, c fp32, hs (..., B, ct, H))."""
    h_max = h.shape[-1]
    xw = torch.matmul(xs, p["w_x"].unsqueeze(-3)).to(torch.float32) \
        + p["b"].unsqueeze(-2).unsqueeze(-2)
    c = c.to(torch.float32)
    hs = []
    for xw_t in xw.unbind(-2):
        gates = xw_t + torch.matmul(h, p["w_h"]).to(torch.float32)
        i = acts.sigma(gates[..., 0 * h_max : 1 * h_max])
        f = acts.sigma(gates[..., 1 * h_max : 2 * h_max])
        g = acts.tanh(gates[..., 2 * h_max : 3 * h_max])
        o = acts.sigma(gates[..., 3 * h_max : 4 * h_max])
        c = f * c + i * g
        h = (o * acts.tanh(c)).to(h.dtype)
        hs.append(h)
    return h, c, torch.stack(hs, dim=-2)


# ---------------------------------------------------------------------------
# single-program wavefront (stages batched, roll hand-off)
# ---------------------------------------------------------------------------

def wavefront(stacked: dict, xs: torch.Tensor, n_chunks: int,
              acts: ActivationSet = EXACT) -> torch.Tensor:
    """``stacked``: stage-stacked LSTM params (S, ...); ``xs`` (B, T, D)
    the input of stage 0, padded to D_max.  Returns the LAST stage's
    hidden sequence (B, T, H_max)."""
    n_stages = stacked["w_h"].shape[0]
    batch, t_len, d_max = xs.shape
    h_max = stacked["w_h"].shape[1]
    if t_len % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} does not divide T={t_len}")
    if d_max != h_max:
        raise ValueError(f"stage input width {d_max} != hidden width {h_max}: "
                         "pack with pack_uniform")
    ct = t_len // n_chunks
    chunks = xs.reshape(batch, n_chunks, ct, d_max)
    stage_ids = torch.arange(n_stages, device=xs.device)[:, None, None]
    h = torch.zeros(n_stages, batch, h_max, dtype=xs.dtype, device=xs.device)
    c = torch.zeros(n_stages, batch, h_max, dtype=torch.float32, device=xs.device)
    inbox = torch.zeros(n_stages, batch, ct, d_max, dtype=xs.dtype, device=xs.device)
    outs = []
    for k in range(n_chunks + n_stages - 1):
        # stage 0 reads the k-th input chunk (the last one again once the
        # chunks run out: its stage is idle then, see below)
        inbox[0] = chunks[:, min(k, n_chunks - 1)]
        h_new, c_new, out = _lstm_chunk_step(stacked, h, c, inbox, acts)
        # stage s is active at tick k iff s <= k < s + n_chunks; an idle
        # stage keeps its state (a step on a zero chunk would still move
        # (h, c) through the biases)
        active = (stage_ids <= k) & (k < stage_ids + n_chunks)
        h = torch.where(active, h_new, h)
        c = torch.where(active, c_new, c)
        # hand each chunk one stage on; emit the last stage's output
        inbox = torch.roll(out, 1, dims=0)
        inbox[0] = 0
        outs.append(out[-1])
    # chunk j of the last stage emerges at tick j + S - 1
    return torch.stack(outs[n_stages - 1 :], dim=1).reshape(batch, t_len, h_max)


# ---------------------------------------------------------------------------
# the tick schedule over a tuple of stage devices
# ---------------------------------------------------------------------------

def check_mesh(mesh: Sequence) -> Mesh:
    """A stage mesh as a tuple of ``torch.device`` (CPU or CUDA, repeats
    allowed); raises on an empty mesh, another device type, or a mesh that
    mixes the CPU with CUDA devices (the reference's stage mesh is of one
    kind of device)."""
    devices = tuple(torch.device(d) for d in mesh)
    if not devices:
        raise ValueError("a stage mesh needs at least one device")
    for dev in devices:
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"stage device {dev} is neither the CPU nor a CUDA device")
    if len({dev.type for dev in devices}) > 1:
        raise ValueError(f"stage mesh {devices} mixes the CPU with CUDA devices")
    return devices


def stage_streams(mesh: Mesh) -> tuple:
    """One new CUDA stream per stage on its device (None for a CPU stage)."""
    return tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in mesh)


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _reader(t: torch.Tensor, stream):
    """Mark ``t`` (made on another stream) as read by ``stream`` when it
    lies on that stream's device, else by its own device's current stream,
    where a copy off the device runs."""
    if t.device.type == "cuda":
        same = stream is not None and stream.device == t.device
        t.record_stream(stream if same else torch.cuda.current_stream(t.device))


def _run_ticks(mesh: Mesh, streams: tuple, home: torch.device, chunks: list,
               body: Callable[[int, torch.Tensor], torch.Tensor]) -> list:
    """The wavefront's tick schedule: at tick k stage s runs chunk k - s
    (if there is one), stage 0 on ``chunks[k]``, every later stage on what
    the stage before it produced at the tick before.  ``body(s, x)`` runs
    stage s on its device and returns its output chunk there.  Returns the
    last stage's output chunks in order.

    On the card stage s issues its work on ``streams[s]``, and a stage
    waits for the work issued so far on the stream its input came from.
    Stages are issued from the last to the first within a tick, so that
    wait covers the producing chunk and nothing later.  A tensor one
    stream allocates and another reads is marked with ``record_stream``,
    so the caching allocator does not hand its memory out again before the
    reader is done.  ``home``'s current stream (the caller's) made the
    inputs: every stage stream waits for it first, and it waits for every
    stage stream at the end, before the caller reads the outputs."""
    n_stages, n_chunks = len(mesh), len(chunks)
    caller = torch.cuda.current_stream(home) if home.type == "cuda" else None
    for stream in streams:
        if stream is not None and caller is not None:
            stream.wait_stream(caller)
    inbox: list = [None] * n_stages
    last = []
    for k in range(n_chunks + n_stages - 1):
        for s in range(n_stages - 1, -1, -1):
            j = k - s
            if not 0 <= j < n_chunks:
                continue  # fill or drain: this stage has no chunk at tick k
            x = chunks[j] if s == 0 else inbox[s - 1]
            with _on(streams[s]):
                if s > 0 and streams[s] is not None and streams[s - 1] is not None:
                    streams[s].wait_stream(streams[s - 1])
                    _reader(x, streams[s])
                # a copy to the CPU blocks: the stage reads it at once
                out = body(s, x.to(mesh[s], non_blocking=mesh[s].type == "cuda"))
            if s + 1 < n_stages:
                inbox[s] = out
            else:
                last.append(out)
    for stream in streams:
        if stream is None:
            continue
        if caller is not None:
            caller.wait_stream(stream)
        else:  # a host reader: copies to the CPU run on the device's own stream
            stream.synchronize()
    for out in last:
        _reader(out, caller)
    return last


def wavefront_shard_map(stacked: dict, xs: torch.Tensor, n_chunks: int, mesh: Sequence,
                        acts: ActivationSet = EXACT) -> torch.Tensor:
    """``wavefront``'s schedule with stage s (layer s of ``stacked``) on
    ``mesh[s]``.  Returns the last stage's hidden sequence (B, T, H_max) on
    ``xs``' device."""
    mesh = check_mesh(mesh)
    n_stages = len(mesh)
    if stacked["w_h"].shape[0] != n_stages:
        raise ValueError(f"{stacked['w_h'].shape[0]} stacked stages on a mesh of {n_stages}")
    batch, t_len, d_max = xs.shape
    if t_len % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} does not divide T={t_len}")
    ct = t_len // n_chunks
    h_max = stacked["w_h"].shape[1]
    params = [{k: v[s].to(dev) for k, v in stacked.items()} for s, dev in enumerate(mesh)]
    state = [(torch.zeros(batch, h_max, dtype=xs.dtype, device=dev),
              torch.zeros(batch, h_max, dtype=torch.float32, device=dev)) for dev in mesh]

    def body(s, x):
        h, c, out = _lstm_chunk_step(params[s], *state[s], x, acts)
        state[s] = (h, c)
        return out

    chunks = [xs[:, j * ct : (j + 1) * ct] for j in range(n_chunks)]
    last = _run_ticks(mesh, stage_streams(mesh), xs.device, chunks, body)
    return torch.cat([out.to(xs.device) for out in last], dim=1)


# ---------------------------------------------------------------------------
# the fused sub-stacks (each stage one K1 call)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagedStack:
    """A ``PackedStack`` placed on a stage mesh, made once (at bind): its
    contiguous sub-stacks (weights, biases and an int8 pack's per-layer
    scales, split along the layer axis), each on its stage's device (views
    of the one pack where a stage shares its device), their real widths
    (``PackedStack.widths`` split the same way), and one stream per
    stage."""

    mesh: Mesh
    stages: tuple
    widths: tuple
    streams: tuple

    @classmethod
    def place(cls, packed, mesh: Sequence) -> "StagedStack":
        mesh = check_mesh(mesh)
        n_layers, n_stages = packed.n_layers, len(mesh)
        if n_layers % n_stages:
            raise ValueError(f"the {n_layers}-layer stack does not split into whole "
                             f"sub-stacks across {n_stages} stages")
        per = n_layers // n_stages
        cuts = [slice(s * per, (s + 1) * per) for s in range(n_stages)]
        stages = tuple({k: v[cut].to(dev) for k, v in packed.stacked.items()}
                       for cut, dev in zip(cuts, mesh))
        widths = tuple((packed.in_dims[cut], packed.hidden[cut]) for cut in cuts)
        return cls(mesh, stages, widths, stage_streams(mesh))


def wavefront_shard_map_fused(packed, staged: StagedStack, xs_p: torch.Tensor,
                              h0: torch.Tensor, c0: torch.Tensor, n_chunks: int):
    """The ``wavefront_shard_map`` schedule with the fused stack kernel as
    every stage's body (the ``fused_stack_sharded`` backend).

    ``staged`` (``StagedStack.place(packed, mesh)``, made once) holds the
    L-layer pack split into ``len(mesh)`` contiguous sub-stacks and one
    stream per stage.  At each tick a stage advances its whole sub-stack
    over one chunk of ``T / n_chunks`` timesteps in ONE ``lstm_stack_op``
    call (weights and every layer's (h, c) on chip inside the kernel), and
    only the sub-stack's last hidden chunk ``(B, ct, W)`` goes on to the
    next stage.

    The per-step math and its order are the local ``fused_stack``'s; only
    where each (layer, chunk) cell runs changes.  Where a stage boundary
    falls, the next layer's input product is computed outside the kernel
    (``project_layer0``) in the order the kernel computes it inside, so
    fp32 and int8 packs (at fp32 compute) give the local backend's bits;
    with bf16 compute ``project_layer0`` rounds that product to bf16 and
    the kernel's inner layers do not (the reference rounds the same way).

    ``xs_p`` (B, T, W) is padded to the pack width; ``h0``/``c0`` (L, B, W)
    are in the packed layout.  Returns (hs_last (B, T, W), h_final (L, B,
    W), c_final fp32 (L, B, W)) on ``xs_p``'s device.
    """
    from repro_torch.kernels.lstm_stack.ops import lstm_stack_op

    mesh, n_stages = staged.mesh, len(staged.mesh)
    t_len = xs_p.shape[1]
    if t_len % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} does not divide T={t_len}")
    ct = t_len // n_chunks
    per = packed.n_layers // n_stages
    home = xs_p.device
    state = [(h0[s * per : (s + 1) * per].to(dev), c0[s * per : (s + 1) * per].to(dev))
             for s, dev in enumerate(mesh)]
    for stream, (h, c) in zip(staged.streams, state):
        if stream is not None:  # made on the caller's stream, read on the stage's
            _reader(h, stream)
            _reader(c, stream)

    def body(s, x):
        hs, h_f, c_f = lstm_stack_op(x, staged.stages[s], *state[s], acts=packed.acts,
                                     weight_dtype=packed.weight_dtype, widths=staged.widths[s])
        state[s] = (h_f, c_f)
        return hs

    chunks = [xs_p[:, j * ct : (j + 1) * ct] for j in range(n_chunks)]
    last = _run_ticks(mesh, staged.streams, home, chunks, body)
    caller = torch.cuda.current_stream(home) if home.type == "cuda" else None
    for h, c in state:  # made on the stage streams, read on the caller's
        _reader(h, caller)
        _reader(c, caller)
    hs = torch.cat([out.to(home) for out in last], dim=1)
    h_f = torch.cat([h.to(home) for h, _ in state])
    c_f = torch.cat([c.to(home) for _, c in state])
    return hs, h_f, c_f


# ---------------------------------------------------------------------------
# convenience: run a whole (possibly heterogeneous) LSTM stack
# ---------------------------------------------------------------------------

def pack_uniform(params_list: list[dict], in_dims: list[int],
                 hidden_dims: list[int]) -> tuple[dict, int]:
    """Pad every stage to one common width W = max(all dims): the
    wavefront hands a (B, ct, W) buffer from stage to stage, so input and
    hidden widths coincide across the stack.  Returns (stage-stacked
    params, W)."""
    width = max(max(in_dims), max(hidden_dims))
    stacked, _, _ = pack_lstm_stack(params_list, in_dims, hidden_dims,
                                    d_target=width, h_target=width)
    return stacked, width


def pipeline_lstm_stack(params_list: list[dict], cfgs: list, xs: torch.Tensor,
                        n_chunks: int, acts: ActivationSet = EXACT) -> torch.Tensor:
    """Wavefront the stack through the executor's ``wavefront`` backend;
    returns the last layer's (B, T, hidden[-1])."""
    from .executor import plan_stack

    if any(c.acts is not acts for c in cfgs):
        cfgs = [dataclasses.replace(c, acts=acts) for c in cfgs]
    plan = plan_stack(cfgs, impl="wavefront", n_chunks=n_chunks)
    return plan.bind(params_list)(xs, return_state=False)
