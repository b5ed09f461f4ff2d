"""Shared model building blocks: norms, RoPE, GQA attention, MLPs, embeddings.

The port of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors made by the ``init_*`` functions; every forward function is pure
except ``attention_decode``, which writes the new token's K and V into the
cache in place.  Each cast stands where the reference puts it, so bf16
models round at the same points: ``rms_norm`` accumulates x*x in fp32 and
normalises in the input dtype, ``apply_rope`` computes in fp32 and casts
back, ``_proj_qkv`` adds biases in fp32, ``sdpa`` forms scores and the
weighted sum in fp32 from operands at their own dtype (bf16 products are
exact in fp32), with the softmax weights rounded to V's dtype first.

``softmax_xent`` is the training loss and ``remat`` the per-layer
rematerialisation every family's ``forward`` runs its layers through (the
reference's ``jax.checkpoint``).

``ShardCtx`` carries the mesh into a sharded run (``launch/dryrun.py``):
parameters, batch and cache are DTensors, and ``ctx.constrain`` at the
reference's sites redistributes an activation to the placements its spec
names.  With ``NO_SHARD``, or on a plain tensor, it returns the tensor as
it is, so the unsharded path keeps its ops and its bits.  Attention on
DTensors runs the plain attention on each rank's heads (``attend``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# sharding context
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardCtx:
    """Optional activation-sharding context (mesh + axis names).

    ``residual``: how the carried (B, S, d) residual stream is sharded over
    the model axis between layers:
      "d"   : feature-sharded (Megatron-SP style; gathers d per layer)
      "seq" : sequence-sharded (Ulysses style; MLP/norms are token-local,
              attention reshards seq<->heads)
    """

    mesh: Any = None                  # a DeviceMesh; None: no sharding
    data_axes: tuple = ("data",)      # ("pod","data") on the multi-pod mesh
    model_axis: str | None = "model"  # None: no tensor parallelism (dp_all)
    residual: str = "d"

    def constrain(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """Redistribute a DTensor to ``spec``'s placements (axes dropped from
        dims they do not divide, as the rules' ``_sanitize`` drops them); a
        plain tensor, or any tensor without a mesh, comes back as it is."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        from repro_torch.launch.mesh import placements
        from repro_torch.launch.sharding import _sanitize

        want = placements(self.mesh, _sanitize(self.mesh, spec, tuple(x.shape)))
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def gather(self, tree):
        """FSDP's gather: each DTensor leaf all-gathered over the "pod" and
        "data" axes that shard its storage, its model-axis sharding kept
        (a layer's weights, taken at the start of the layer, so under
        remat the backward gathers them again and their gradients
        reduce-scatter back).  A plain tree comes back as it is."""
        if self.mesh is None:
            return tree

        def one(t):
            if not isinstance(t, DTensor):
                return t
            names = t.device_mesh.mesh_dim_names
            want = tuple(Replicate() if names[i] in ("pod", "data") else p
                         for i, p in enumerate(t.placements))
            return t if want == tuple(t.placements) else t.redistribute(t.device_mesh, want)

        return tree_map(one, tree)

    @property
    def batch_spec(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]


NO_SHARD = ShardCtx()

_STACKED = ("layers", "enc_layers", "dec_layers")


def gather_top(params: dict, ctx: ShardCtx) -> dict:
    """``params`` with the leaves outside the layer stacks (embeddings,
    head, final norms) gathered by ``ctx.gather``; the stacks are gathered
    a layer at a time inside each layer."""
    if ctx.mesh is None:
        return params
    return {k: v if k in _STACKED else ctx.gather(v) for k, v in params.items()}


def replicate_features(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """A block's (B, S, d) input replicated over the model axis (an
    all-gather of the feature-sharded residual): column-parallel weights
    then give head- or d_ff-sharded outputs.  Left to itself DTensor may
    instead all-gather the weights and compute every column on every
    rank."""
    return ctx.constrain(x, (ctx.batch_spec, None, None))


def constrain_residual(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Shard the carried residual stream (B, S, d) per ctx.residual."""
    if ctx.residual == "seq":
        return ctx.constrain(x, (ctx.batch_spec, ctx.model_axis, None))
    return ctx.constrain(x, (ctx.batch_spec, None, ctx.model_axis))

# ---------------------------------------------------------------------------
# initializers (drawn on the explicit generator's device; ``lead`` stacks a
# leading axis, e.g. (n_layers,))
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, n_in: int, n_out: int, dtype: torch.dtype,
               lead: tuple = ()) -> torch.Tensor:
    """x @ W weights (*lead, n_in, n_out) at ``dtype`` on ``gen``'s device,
    drawn in fp32 one (n_in, n_out) matrix at a time: a stacked leaf is
    never held in fp32 (llava-next-34b's MLP leaves would be 35 GB)."""
    scale = (1.0 / n_in) ** 0.5
    out = torch.empty(*lead, n_in, n_out, dtype=dtype, device=gen.device)
    for idx in np.ndindex(*lead):
        out[idx] = torch.randn(n_in, n_out, generator=gen, device=gen.device).mul_(scale).to(dtype)
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(vocab, d, generator=gen, device=gen.device).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: statistics accumulated in fp32, normalisation applied in the
    input dtype (bf16 products are exact in fp32)."""
    xf = x.float()
    ms = (xf * xf).sum(dim=-1) / x.shape[-1]
    inv = torch.rsqrt(ms + eps)[..., None].to(x.dtype)
    return x * inv * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for given integer positions: (..., head_dim/2) fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, cross: bool = False,
                   lead: tuple = ()) -> dict:
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, cfg.dtype, lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype, lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype, lead),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, cfg.dtype, lead),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros(*lead, cfg.n_heads * hd)
        p["bk"] = torch.zeros(*lead, cfg.n_kv_heads * hd)
        p["bv"] = torch.zeros(*lead, cfg.n_kv_heads * hd)
    return p


def _proj_qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor, cfg: ArchConfig):
    hd = cfg.hd
    q = x @ p["wq"]
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
    if "bq" in p:
        q = (q.float() + p["bq"]).to(q.dtype)
        k = (k.float() + p["bk"]).to(k.dtype)
        v = (v.float() + p["bv"]).to(v.dtype)
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(k, cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)
    return q, k, v


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H * D).  On a DTensor the gradient is held to
    the forward's placements: the output projection's backward would give
    it sharded over H * D, across head boundaries where the model axis
    does not divide the heads, and such a gradient cannot be split back
    into heads."""
    t = t.reshape(*t.shape[:2], -1)
    if isinstance(t, DTensor):
        t = DTensor.from_local(t.to_local(), t.device_mesh, t.placements, run_check=False,
                               shape=t.shape, stride=t.stride())
    return t


def _split_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd).  A DTensor whose last dim
    is sharded across heads' boundaries (smollm's 15 heads over 8 ranks)
    is replicated on that dim first: DTensor cannot split such a dim."""
    if isinstance(t, DTensor):
        pl = tuple(t.placements)
        n = math.prod(t.device_mesh.size(i) for i, p in enumerate(pl) if p == Shard(2))
        if heads % n:
            t = t.redistribute(t.device_mesh, tuple(Replicate() if p == Shard(2) else p
                                                    for p in pl))
    return t.reshape(*t.shape[:2], heads, hd)


def sdpa(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Sk, Hkv, D)
    v: torch.Tensor,              # (B, Sk, Hkv, D)
    *,
    causal: bool,
    q_offset: int | torch.Tensor = 0,        # absolute position of q[0] (decode)
    kv_len: int | torch.Tensor | None = None,  # valid cache length (masks padded tail)
    window: int | None = None,    # sliding-window width (tokens back)
) -> torch.Tensor:
    """Masked GQA scaled-dot-product attention (plain PyTorch).

    Returns (B, Sq, Hq, D).  GQA is computed by reshaping q heads into
    (Hkv, G) groups, with no repeat of K/V.  Scores and the weighted sum are
    fp32; masked entries take -1e30, as in the reference.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf.float(), k.float()) / d**0.5

    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask &= (k_pos < kv_len)[None, :]
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(
    p: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    rope: tuple[torch.Tensor, torch.Tensor] | None,
    causal: bool = True,
    x_kv: torch.Tensor | None = None,   # cross-attention source
    window: int | None = None,
    ctx: ShardCtx = NO_SHARD,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    b, s, _ = x.shape
    x = replicate_features(x, ctx)
    q, k, v = _proj_qkv(p, x, x_kv if x_kv is not None else x, cfg)
    if rope is not None and x_kv is None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = ctx.constrain(q, (ctx.batch_spec, None, ctx.model_axis, None))
    if max(s, k.shape[1]) > 1024:  # blocked path: no (Sq x Sk) tensor
        from repro_torch.models.flash_attention import flash_attention

        out = attend(lambda q, k, v: flash_attention(q, k, v, causal and x_kv is None, window, 0),
                     q, k, v)
    else:
        out = attend(lambda q, k, v: sdpa(q, k, v, causal=causal and x_kv is None,
                                          window=window), q, k, v)
    return merge_heads(out) @ p["wo"]


def attend(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` for (B, S, H, D) operands.  On DTensors it runs on
    each rank's batch rows and heads (``local_map``): q's placements
    (batch over the data axes, heads over the model axis, as ``ctx``
    constrained it) are given to k and v and to the output.  Where the
    model axis does not divide the KV heads, k and v are expanded to q's
    heads first, so each rank's query heads find their KV heads."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements)
    head_shards = math.prod(q.device_mesh.size(i) for i, p in enumerate(pl) if p == Shard(2))
    if k.shape[2] % head_shards:
        b, sk, hkv, d = k.shape
        g = q.shape[2] // hkv
        k, v = (t[:, :, :, None].expand(b, sk, hkv, g, d).reshape(b, sk, hkv * g, d)
                for t in (k, v))
    return local_map(fn, out_placements=list(pl), in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v)


def attention_decode(
    p: dict,
    x: torch.Tensor,              # (B, 1, d)
    cache_k: torch.Tensor,        # (B, S_max, Hkv, D): written in place at pos
    cache_v: torch.Tensor,
    pos: torch.Tensor | int,      # index of the new token (0-d int32 tensor)
    cfg: ArchConfig,
    *,
    window: int | None = None,
    ring: bool = False,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: write this token's K/V into the cache at ``pos``
    (in place), attend over the valid prefix ``[0, pos]``.  ``pos`` is read
    with device ops only (no host copy), so the step can be captured in a
    CUDA graph; the caller keeps it inside the cache (``LmEngine`` checks
    the range on the host before the step).

    ``ring=True`` treats the cache as a ring of S_max slots (the hybrid
    family's window cache): the token goes to slot ``pos % S_max`` and
    attention runs over the first ``min(pos + 1, S_max)`` slots, with no
    window mask (every slot of a wrapped ring is inside the window).

    ``use_kernel=True`` runs the decode-attention kernel (K5), which has no
    window mask: a window with the kernel raises instead of being dropped
    (the reference's kernel branch drops it).  ``use_kernel=False`` runs
    ``sdpa`` over the whole cache with the length and window masks.

    Returns (out (B,1,d), cache_k, cache_v).
    """
    b = x.shape[0]
    hd = cfg.hd
    if use_kernel and window is not None:
        raise ValueError(
            f"attention_decode: the decode-attention kernel has no window mask "
            f"(window={window}); pass use_kernel=False for a windowed cache")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).reshape(1)
    q, k, v = _proj_qkv(p, x, x, cfg)
    cos, sin = rope_tables(pos, hd, cfg.rope_theta)  # (1, hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = cache_k.shape[1]
    row = (pos % rows if ring else pos).long()
    kv_len = torch.clamp(pos + 1, max=rows) if ring else pos + 1
    if isinstance(cache_k, DTensor):
        out = split_decode_attend(q, cache_k, cache_v, kv_len, q_pos=pos, window=window,
                                  new_kv=(k, v, row))
        return out.reshape(b, 1, cfg.n_heads * hd) @ p["wo"], cache_k, cache_v
    cache_k.index_copy_(1, row, k.to(cache_k.dtype))
    cache_v.index_copy_(1, row, v.to(cache_v.dtype))
    if use_kernel:
        from repro_torch.kernels.decode_attn import decode_attn_op

        lengths = kv_len.expand(b).contiguous()
        out = decode_attn_op(q[:, 0], cache_k, cache_v, lengths)[:, None]
    else:
        out = sdpa(q, cache_k, cache_v, causal=False, q_offset=pos, kv_len=kv_len,
                   window=window)
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return out @ p["wo"], cache_k, cache_v


def stack_rows(rows: list, max_len: int) -> torch.Tensor:
    """(L, B, max_len, ...) from per-layer (B, s, ...) prompt rows, zeros
    after row s: the cache of a sharded prefill, whose DTensors take no
    slice write."""
    t = torch.stack(rows)
    if max_len > t.shape[2]:
        pad = torch.zeros(*t.shape[:2], max_len - t.shape[2], *t.shape[3:], dtype=t.dtype)
        t = torch.cat([t, pad], dim=2)
    return t


def embed_lookup(table: torch.Tensor, tokens) -> torch.Tensor:
    """Rows ``tokens`` of an embedding table (V, d).

    On DTensors each rank looks up its own rows (``local_map``): tokens
    keep their batch sharding; where the table's rows are sharded, a rank
    answers only the tokens in its vocabulary slice (zeros elsewhere) and
    the output is a partial sum over that axis; where its columns are, so
    is the output's last dim.  Indexing a DTensor table would gather the
    batch instead."""
    ids = torch.as_tensor(tokens, device=table.device).long()
    if not isinstance(table, DTensor):
        return table[ids]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh, tpl = table.device_mesh, tuple(table.placements)
    ipl = tuple(p if p == Shard(0) and tp == Replicate() else Replicate()
                for p, tp in zip(ids.placements, tpl))
    opl = tuple(Partial() if tp == Shard(0) else Shard(2) if tp == Shard(1) else ip
                for tp, ip in zip(tpl, ipl))
    row_dims = [i for i, p in enumerate(tpl) if p == Shard(0)]
    n_rows, lo = table.shape[0], 0
    for i in row_dims:  # mesh order: the first sharding dim outermost
        n_rows //= mesh.size(i)
    for i in row_dims:
        lo = lo * mesh.size(i) + mesh.get_coordinate()[i]
    lo *= n_rows

    def local(t, ids):
        if not row_dims:
            return t[ids]
        here = (ids >= lo) & (ids < lo + t.shape[0])
        return t[(ids - lo).clamp(0, t.shape[0] - 1)] * here[..., None].to(t.dtype)

    # a rank's table gradient covers only its own tokens: a partial sum
    # over the axes that shard them
    tgrad = tuple(Partial() if ip == Shard(0) else tp for tp, ip in zip(tpl, ipl))
    return local_map(local, out_placements=list(opl), in_placements=(tpl, ipl),
                     in_grad_placements=(tgrad, ipl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def _plain(t):
    """The value of a replicated DTensor (its local tensor), or ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def split_decode_attend(q: torch.Tensor, cache_k: DTensor, cache_v: DTensor, kv_len=None, *,
                        q_pos=None, window: int | None = None, new_kv=None) -> torch.Tensor:
    """One-token attention over a sequence-sharded cache (flash-decoding):
    the sharded decode path of ``attention_decode`` and of encdec's
    cross-attention.

    q (B, 1, Hq, D); cache_k/v (B, S, Hkv, D) DTensors whose S is sharded
    (``cache_shardings``).  ``new_kv = (k, v, row)`` first writes the
    token's K/V at global row ``row`` into the shard that holds it (in
    place; the other shards keep their rows).  Each rank then attends over
    its own rows with ``sdpa``'s masks at their global positions (``j <
    kv_len``, and ``j > q_pos - window``) and keeps (max, sum, weighted V)
    in fp32; the shards' partial results are combined with the usual
    rescaling, as DTensor reductions over a leading shard axis.
    Returns (B, 1, Hq, D) in q's dtype.
    """
    from torch.distributed.tensor.experimental import local_map

    mesh = cache_k.device_mesh
    cpl = tuple(cache_k.placements)
    seq_dims = [i for i, p in enumerate(cpl) if p == Shard(1)]
    n_shards = math.prod(mesh.size(i) for i in seq_dims)
    s_local = cache_k.shape[1] // n_shards
    shard, coord = 0, mesh.get_coordinate()
    for i in seq_dims:  # mesh order: the first seq dim outermost
        shard = shard * mesh.size(i) + coord[i]
    off = shard * s_local
    b, _, hq, d = q.shape
    hkv = cache_k.shape[2]
    kv_len = None if kv_len is None else _plain(kv_len)
    q_pos = None if q_pos is None else _plain(q_pos)
    qpl = tuple(p if p == Shard(0) else Replicate() for p in cpl)  # batch as the cache's
    args = [q, cache_k, cache_v]
    if new_kv is not None:
        k_new, v_new, row = new_kv
        args += [k_new.to(cache_k.dtype), v_new.to(cache_v.dtype)]
        row = _plain(row)

    def local(q, ck, cv, *kv):
        j = off + torch.arange(s_local, device=q.device)
        if kv:  # the new row, written where this shard holds it
            idx = (row - off).clamp(0, s_local - 1)
            here = ((row >= off) & (row < off + s_local)).reshape(1, 1, 1, 1)
            for c, t in zip((ck, cv), kv):
                c.index_copy_(1, idx, torch.where(here, t, c.index_select(1, idx)))
        qf = q.reshape(q.shape[0], 1, hkv, hq // hkv, d).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, ck.float()) / d**0.5
        mask = torch.ones(s_local, dtype=torch.bool, device=q.device)
        if kv_len is not None:
            mask &= j < kv_len
        if window is not None:
            mask &= j > q_pos - window
        scores = torch.where(mask, scores, -1e30)
        m = scores.amax(-1, keepdim=True)
        e = torch.exp(scores - m)
        o = torch.einsum("bhgqk,bkhd->bhgqd", e, cv.float())
        return o[None], m[None], e.sum(-1, keepdim=True)[None]

    # the partial results stack on a new leading axis, sharded like the rows
    spl = tuple(Shard(0) if i in seq_dims else Shard(1) if p == Shard(0) else Replicate()
                for i, p in enumerate(cpl))
    o, m, l = local_map(local, out_placements=(spl, spl, spl),
                        in_placements=(qpl, cpl, cpl) + ((qpl, qpl) if new_kv else ()),
                        device_mesh=mesh, redistribute_inputs=True)(*args)
    w = torch.exp(m - m.amax(0, keepdim=True))
    out = (w * o).sum(0) / (w * l).sum(0)           # (B, Hkv, G, 1, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
             lead: tuple = ()) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_up": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, lead),
    }


def mlp(p: dict, x: torch.Tensor, ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    x = replicate_features(x, ctx)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = ctx.constrain(h, (ctx.batch_spec, None, ctx.model_axis))
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# training: the loss and per-layer rematerialisation
# ---------------------------------------------------------------------------

def head_logits(x: torch.Tensor, head: torch.Tensor, ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """``x @ head``, x replicated over the model axis first, so a
    vocabulary-sharded head gives vocabulary-sharded logits (a partial
    x would make every rank compute every column)."""
    return ctx.constrain(x, (ctx.batch_spec, None, None)) @ head


def _sharded_xent(logits: DTensor, labels: DTensor, valid_vocab: int | None) -> torch.Tensor:
    """``softmax_xent`` on DTensor logits, vocabulary-parallel: each rank
    takes the logsumexp of its own columns and the gold logit where its
    columns hold the label; the per-shard logsumexps are combined over a
    leading shard axis and the gold logits summed."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in logits.placements)
    vdims = [i for i, p in enumerate(pl) if p == Shard(2)]
    n_cols, lo = logits.shape[-1], 0
    for i in vdims:  # mesh order: the first sharding dim outermost
        n_cols //= mesh.size(i)
        lo = lo * mesh.size(i) + mesh.get_coordinate()[i]
    lo *= n_cols
    lab_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)

    def local(lg, lab):
        lf = lg.float()
        if valid_vocab is not None and valid_vocab < logits.shape[-1]:
            col = lo + torch.arange(lf.shape[-1], device=lf.device)
            lf = torch.where(col < valid_vocab, lf, -1e30)
        here = ((lab >= lo) & (lab < lo + lf.shape[-1]))[..., None]
        gold = torch.gather(lf, -1, (lab - lo).clamp(0, lf.shape[-1] - 1)[..., None]) * here
        return torch.logsumexp(lf, dim=-1, keepdim=True)[None], gold

    stack = tuple(Shard(0) if i in vdims else Shard(1) if p == Shard(0) else Replicate()
                  for i, p in enumerate(pl))
    gold_pl = tuple(Partial() if i in vdims else p for i, p in enumerate(lab_pl))
    lse, gold = local_map(local, out_placements=(stack, gold_pl), in_placements=(pl, lab_pl),
                          device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return (torch.logsumexp(lse, dim=0) - gold).mean()


def softmax_xent(logits: torch.Tensor, labels, valid_vocab: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32: logits (B, S, V_padded),
    labels (B, S) integers.  ``valid_vocab`` masks the padded vocabulary
    columns with -1e30, so the pad takes no probability mass."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    if isinstance(logits, DTensor):
        return _sharded_xent(logits, labels, valid_vocab)
    lf = logits.float()
    if valid_vocab is not None and valid_vocab < lf.shape[-1]:
        lf = torch.where(torch.arange(lf.shape[-1], device=lf.device) < valid_vocab, lf, -1e30)
    # (B, S, 1) throughout: on vocab-sharded DTensor logits the gather's
    # masked partial result must keep the shape its mask was made for
    gold = torch.gather(lf, -1, labels[..., None])
    return (torch.logsumexp(lf, dim=-1, keepdim=True) - gold).mean()


def remat(fn, *args):
    """``fn(*args)``, one layer of a forward.  Under grad the layer keeps
    only its inputs and recomputes its activations in the backward, as the
    reference's ``jax.checkpoint`` does; with grad off (prefill, serving
    graphs) it is the plain call.  No layer draws random numbers, so no
    RNG state is saved (saving the CUDA one fails inside a graph capture)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked (L, ...) parameter tree (views, no copy)."""
    return tree_map(lambda t: t[i], stacked)
