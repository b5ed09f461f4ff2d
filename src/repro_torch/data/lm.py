"""Synthetic LM token pipeline: deterministic, host-sharded, zipfian.

Stands in for the tokenized corpus reader: every (host, step) pair maps to a
disjoint deterministic slice of an infinite zipfian token stream, so
restarts resume exactly (the stream is a pure function of (seed, step)) and
multi-host sharding needs no coordination — the standard recipe at scale.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LmDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    host_id: int = 0
    n_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def lm_batch(cfg: LmDataConfig, step: int) -> dict:
    """{"tokens", "labels"} for one host at one step (pure function)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )
    zipf = rng.zipf(cfg.zipf_a, size=(cfg.host_batch, cfg.seq_len + 1))
    toks = (zipf - 1) % cfg.vocab
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def lm_stream(cfg: LmDataConfig, start_step: int = 0):
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1
