"""Batch scoring: ``AnomalyStreamEngine.score`` on its default plan, one
caller issuing calls back to back (a closed loop), each call a batch of
strain windows from a pool made from the seed in set-up.

Traffic keys: ``batch`` windows a call; ``pool_calls`` distinct batches
the calls cycle through; ``signal_fraction`` of the windows hold a chirp;
the strain parameters of ``gwdata.StrainSource``; ``warmup_calls``;
``keep_stride``: the answers of every ``keep_stride``-th call (from an
offset drawn from the seed) are kept and compared with the reference once
the window has closed; it is coprime with ``pool_calls``, so the kept calls
cycle through every pool batch; ``host_memory``: ``pinned`` keeps the
pool in page-locked host memory, as a reader that streams archived strain
to the card stages it, ``pageable`` in ordinary memory, which the CUDA
driver copies through staging buffers of its own; ``trace_calls`` and
``gap_calls``, the calls a traced run records.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gwbench import gwprogram
from gwbench.gwdata import StrainSource


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.batch = traffic["batch"]
        self.stride = traffic["keep_stride"]
        if math.gcd(self.stride, traffic["pool_calls"]) != 1:
            raise ValueError(f"keep_stride {self.stride} shares a factor with pool_calls "
                             f"{traffic['pool_calls']}: the kept calls would skip pool batches")
        self.offset = seed % self.stride
        self.keep_answers = True
        self.answers: list = []   # (pool index, scores) of the kept calls

    def setup(self) -> None:
        from repro_torch.serve.engine import AnomalyStreamEngine

        gen = gwprogram.generator(self.seed, self.device)
        self.ref = gwprogram.reference_module(self.config)
        self.params = self.ref.init_params(self.config, gen)
        source = StrainSource(self.traffic, self.config["timesteps"], gen)
        n_pool = self.traffic["pool_calls"]
        windows = source.windows(n_pool * self.batch, self.traffic["signal_fraction"])
        pinned = self.traffic["host_memory"] == "pinned" and self.device == "cuda"
        self.host = torch.empty(windows.shape, dtype=windows.dtype, pin_memory=pinned)
        self.host.copy_(windows)
        self.pool = list(self.host.numpy().reshape(n_pool, self.batch, *windows.shape[1:]))
        del windows, source
        if self.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.engine = AnomalyStreamEngine(gwprogram.clone_tree(self.params),
                                          gwprogram.autoencoder_config(self.config),
                                          device=self.device)
        for i in range(self.traffic["warmup_calls"]):
            self.engine.score(self.pool[i % n_pool])

    def call(self, i: int) -> tuple[int, int]:
        """One timed call: (windows submitted, windows without an answer)."""
        j = i % len(self.pool)
        scores = self.engine.score(self.pool[j])
        if self.keep_answers and i % self.stride == self.offset:
            self.answers.append((j, scores))
        return self.batch, max(self.batch - len(scores), 0)

    def release(self) -> None:
        del self.engine
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_scores(self, j: int, tf32: bool = False) -> np.ndarray:
        self.ref.no_tf32()
        x = torch.from_numpy(self.pool[j]).to(self.device)
        return self.ref.scores_in_blocks(self.params, x, self.config, tf32).cpu().numpy()

    def control(self, limits: dict) -> dict:
        """The reference in the program's place, one precision down (TF32),
        answering every pool batch, held as the program is."""
        return self.check(limits, [(j, self.reference_scores(j, tf32=True))
                                   for j in range(len(self.pool))])

    def check(self, limits: dict, answers: list | None = None) -> dict:
        """The kept answers (or ``answers``) against the fp32 reference:
        the largest relative gap of a window's score, and the windows whose
        answer is missing or not finite."""
        answers = self.answers if answers is None else answers
        want = {j: self.reference_scores(j) for j in sorted({j for j, _ in answers})}
        worst, bad = 0.0, 0 if answers else self.batch
        for j, got in answers:
            got = np.asarray(got, dtype=np.float64).reshape(-1)
            ref = want[j].astype(np.float64)
            n = min(len(got), len(ref))
            ok = np.isfinite(got[:n])
            bad += len(ref) - n + int((~ok).sum())
            if ok.any():
                gap = np.abs(got[:n][ok] - ref[:n][ok]) / np.abs(ref[:n][ok])
                worst = max(worst, float(gap.max()))
        return {"score_rel_err": {"value": worst, "limit": limits["score_rel_err"]},
                "bad_answers": {"value": bad, "limit": 0}}
