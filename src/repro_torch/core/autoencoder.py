"""LSTM autoencoder for gravitational-wave anomaly detection (paper Sec. III-A).

    encoder : LSTM(in -> h0) -> ... -> LSTM(-> h_latent)   [last h only]
    bridge  : RepeatVector(T)                               [hard sync point]
    decoder : LSTM(latent -> ...) -> LSTM(-> h_last)        [return sequences]
    head    : TimeDistributed Dense(h_last -> in)

An event is flagged anomalous when the reconstruction error spikes.  The
encoder->decoder boundary is a sync point: only the final latent crosses,
so the two segments plan, pack and run independently.

The nominal model is hidden=(32, 8, 8, 32) with a 1-d strain input; the
small model is hidden=(9, 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.trace import span

from .lstm import LstmConfig, init_lstm
from .quant import EXACT, ActivationSet

Params = dict[str, Any]


@dataclass(frozen=True)
class AutoencoderConfig:
    input_dim: int = 1
    hidden: tuple[int, ...] = (32, 8, 8, 32)
    latent_boundary: int | None = None  # index of first decoder layer
    timesteps: int = 100                # paper default TS
    dtype: torch.dtype = torch.float32
    cell_dtype: torch.dtype = torch.float32
    acts: ActivationSet = EXACT
    impl: str = "split"                 # naive | split | kernel | fused_stack | fused_step | mixed
    #: fused-stack weight storage: "fp32" | "bf16" | "int8" (None = native at
    #: ``dtype``); ``dec_weight_dtype`` overrides the decoder segment
    weight_dtype: str | None = None
    dec_weight_dtype: str | None = None
    #: per-layer weight storage (one entry per ``hidden`` layer; None entries
    #: fall back to the segment-level fields above).  More than one distinct
    #: storage inside a segment needs ``impl="mixed"``, which chains
    #: homogeneous sub-plans; every other backend packs one dtype per
    #: segment and refuses at plan time
    weight_dtypes: tuple[str | None, ...] | None = None
    #: in-kernel activation fake-quant on layer hand-offs (fused backends)
    act_bits: int | None = None

    def __post_init__(self) -> None:
        if self.weight_dtypes is not None and len(self.weight_dtypes) != len(self.hidden):
            raise ValueError(
                f"weight_dtypes needs one entry per hidden layer ({len(self.hidden)}); "
                f"got {len(self.weight_dtypes)}"
            )

    @property
    def boundary(self) -> int:
        return (self.latent_boundary if self.latent_boundary is not None
                else len(self.hidden) // 2)

    def layer_cfgs(self) -> list[LstmConfig]:
        cfgs, lx = [], self.input_dim
        dec_wd = (self.dec_weight_dtype if self.dec_weight_dtype is not None
                  else self.weight_dtype)
        for i, h in enumerate(self.hidden):
            if i == self.boundary:  # the first decoder layer eats the latent
                lx = self.hidden[self.boundary - 1]
            wd = self.weight_dtype if i < self.boundary else dec_wd
            if self.weight_dtypes is not None and self.weight_dtypes[i] is not None:
                wd = self.weight_dtypes[i]
            cfgs.append(LstmConfig(
                in_dim=lx, hidden=h, dtype=self.dtype, cell_dtype=self.cell_dtype,
                acts=self.acts, weight_dtype=wd,
            ))
            lx = h
        return cfgs


def init_autoencoder(cfg: AutoencoderConfig, seed: int | torch.Generator = 0,
                     device: str | torch.device = "cuda") -> Params:
    """Random parameters from ``seed``, or drawn from a CPU
    ``torch.Generator`` (drawn on the CPU, then moved)."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    params: Params = {
        f"lstm_{i}": init_lstm(c, gen, dev) for i, c in enumerate(cfg.layer_cfgs())
    }
    lim = (6.0 / (cfg.hidden[-1] + cfg.input_dim)) ** 0.5
    w = torch.rand(cfg.hidden[-1], cfg.input_dim, generator=gen) * (2 * lim) - lim
    params["dense"] = {
        "w": w.to(cfg.dtype).to(dev),
        "b": torch.zeros(cfg.input_dim, dtype=torch.float32, device=dev),
    }
    return params


def encoder_layers(params: Params, cfg: AutoencoderConfig):
    return ([params[f"lstm_{i}"] for i in range(cfg.boundary)],
            cfg.layer_cfgs()[: cfg.boundary])


def decoder_layers(params: Params, cfg: AutoencoderConfig):
    cfgs = cfg.layer_cfgs()
    return ([params[f"lstm_{i}"] for i in range(cfg.boundary, len(cfgs))],
            cfgs[cfg.boundary:])


def _segment_executor(params: Params, cfg: AutoencoderConfig, segment: str, *,
                      placement: str = "local", mesh: Any = None,
                      impl: str | None = None, chunk_len: int | None = None,
                      tune: str = "default"):
    from .executor import plan_stack

    plist, cfgs = (encoder_layers(params, cfg) if segment == "enc"
                   else decoder_layers(params, cfg))
    return plan_stack(
        cfgs, impl=cfg.impl if impl is None else impl, placement=placement, mesh=mesh,
        chunk_len=chunk_len, act_bits=cfg.act_bits, tune=tune,
    ).bind(plist)


def segment_executors(params: Params, cfg: AutoencoderConfig, *,
                      placement: str = "local", mesh: Any = None,
                      impl: str | None = None, chunk_len: int | None = None,
                      tune: str = "default"):
    """(encoder, decoder) ``StackExecutor``s: each segment gets its own plan
    and pack, bound once per params identity.  ``placement="sharded"``
    splits each segment across the stage devices of ``mesh`` (default:
    the params' device's default stage mesh; see ``plan_stack``).
    ``tune`` is ``plan_stack``'s ("cached": knobs from the autotune store;
    "balanced": the mixed backend's model-chosen storage split, per
    segment)."""
    kw = dict(placement=placement, mesh=mesh, impl=impl, chunk_len=chunk_len, tune=tune)
    return (_segment_executor(params, cfg, "enc", **kw),
            _segment_executor(params, cfg, "dec", **kw))


def encode(params: Params, x: torch.Tensor, cfg: AutoencoderConfig,
           initial_state=None, *, return_state: bool = False,
           executor: Any = None):
    """Run the encoder segment. x: (B, T, input_dim) -> (B, T, h_enc_last)."""
    if executor is None:
        executor = _segment_executor(params, cfg, "enc")
    with span("encode"):
        return executor(x, initial_state, return_state=return_state)


def decode(params: Params, latent: torch.Tensor, cfg: AutoencoderConfig,
           t: int | None = None, initial_state=None, *,
           return_state: bool = False, executor: Any = None):
    """Decoder segment + dense head. latent: (B, h_latent) -> (B, T, input_dim)."""
    t = cfg.timesteps if t is None else t
    if executor is None:
        executor = _segment_executor(params, cfg, "dec")
    with span("decode"):
        h_seq = latent[:, None, :].expand(latent.shape[0], t, latent.shape[1])
        out = executor(h_seq, initial_state, return_state=return_state)
        h_seq, finals = out if return_state else (out, None)
        rec = _dense_head(params["dense"], h_seq, cfg)
    return (rec, finals) if return_state else rec


def _dense_head(dense: Params, h_seq: torch.Tensor, cfg: AutoencoderConfig) -> torch.Tensor:
    """TimeDistributed Dense: ``h @ w`` at the compute dtype, then ``+ b``
    in fp32, with each row's sum in a fixed order (``rowwise_matmul``), so a
    window's reconstruction does not depend on the rows decoded with it."""
    from repro_torch.kernels.rowwise import rowwise_matmul

    batch, t_len, hidden = h_seq.shape
    w = dense["w"]
    with span("head"):
        rec = rowwise_matmul(h_seq.reshape(batch * t_len, hidden).to(cfg.dtype), w.float())
        return (rec.to(cfg.dtype) + dense["b"]).reshape(batch, t_len, w.shape[1])


def reconstruction_error_from_latent(params: Params, latent: torch.Tensor,
                                     x: torch.Tensor, cfg: AutoencoderConfig, *,
                                     exec_dec: Any = None) -> torch.Tensor:
    """Anomaly score given a latent: decode + fp32 MSE against x.  (B,)

    The single definition of the score tail: one-shot scoring and the
    streaming engine (whose latent comes from resident encoder state) both
    route through here.  Each row's error is summed in a fixed order
    (``rowwise_matmul`` against a column of ones), so a row's score does
    not depend on the batch."""
    from repro_torch.kernels.rowwise import rowwise_matmul

    rec = decode(params, latent, cfg, t=x.shape[1], executor=exec_dec)
    with span("error"):
        err = (rec.to(x.dtype).to(torch.float32) - x.to(torch.float32)) ** 2
        n = err.shape[1] * err.shape[2]
        ones = torch.ones(n, 1, dtype=torch.float32, device=err.device)
        return rowwise_matmul(err.reshape(err.shape[0], n), ones)[:, 0] / n


def reconstruction_error(params: Params, x: torch.Tensor, cfg: AutoencoderConfig,
                         *, exec_enc: Any = None, exec_dec: Any = None
                         ) -> torch.Tensor:
    """Per-example anomaly score: mean squared reconstruction error. (B,)"""
    h_seq = encode(params, x, cfg, executor=exec_enc)
    return reconstruction_error_from_latent(params, h_seq[:, -1, :], x, cfg,
                                            exec_dec=exec_dec)


def mse_loss(params: Params, x: torch.Tensor, cfg: AutoencoderConfig) -> torch.Tensor:
    """The training loss: the batch mean of ``reconstruction_error``.

    Differentiable on the backends the reference differentiates (``naive``,
    ``split``); the kernel backends refuse a forward that needs a
    gradient."""
    return torch.mean(reconstruction_error(params, x, cfg))


def auc_score(scores_neg, scores_pos) -> float:
    """AUC via the Mann-Whitney U statistic (ties count one half)."""
    neg = np.asarray(scores_neg, dtype=np.float64)
    pos = np.asarray(scores_pos, dtype=np.float64)
    allv = np.concatenate([neg, pos])
    order = allv.argsort(kind="mergesort")
    ranks = np.empty_like(allv)
    ranks[order] = np.arange(1, len(allv) + 1)
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):  # average ranks over ties
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = ranks[order[i : j + 1]].mean()
        i = j + 1
    n_pos, n_neg = len(pos), len(neg)
    r_pos = ranks[n_neg:].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
