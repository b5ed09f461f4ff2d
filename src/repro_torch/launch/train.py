"""Training launcher: an LM arch on one device, the port of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 50 --reduced --device cpu
    python -m repro_torch.launch.train --arch smollm-360m --seq-len 4096 \
        --batch 8 --steps 8                  # full width on the card

The flags are the reference's (``--arch --steps --seq-len --batch
--reduced --microbatches --compress-grads --ckpt``) plus ``--device``
(``cuda`` by default; a missing GPU raises, ``cpu`` must be asked for).
The run is the reference's: parameters from seed 0 (drawn on the device),
``lm_stream`` batches of ``--batch`` sequences, ``AdamWConfig(lr=1e-3,
warmup_steps=10, total_steps=steps)``, ``--microbatches`` or the arch's
``train_microbatches``, a checkpoint every ``steps // 2`` steps into
``--ckpt`` (``runs/train_<arch>``) and resumption from the latest one
there.  It goes through ``train.trainer.Trainer``: on the card every step
after the first replays one CUDA graph of the whole step.  The loss is the
family's ``loss_fn`` (plain PyTorch, each layer rematerialised; no kernel
of this package has a backward).  The summary line is the reference's.

As in the reference, a resumed run reads the data stream from step 0
again, not from the checkpoint's step, and an encoder-decoder arch cannot
train here: ``lm_stream`` yields tokens only, and its ``loss_fn`` refuses
a batch without ``frontend_embeds`` (``ValueError``; the reference raises
``KeyError``).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.data.lm import LmDataConfig, lm_stream
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainResult

SEED = 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def make_trainer(args: argparse.Namespace) -> Trainer:
    """The reference launcher's ``Trainer`` for parsed ``args``."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    data_cfg = LmDataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps,
                      compress_grads=args.compress_grads)
    return Trainer(
        loss_fn=lambda p, b: api.loss_fn(p, b, cfg),
        init_params_fn=lambda gen: api.init_params(cfg, seed=SEED, device=dev),
        data_iter=lm_stream(data_cfg),
        cfg=TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=max(args.steps // 2, 1),
            microbatches=args.microbatches or cfg.train_microbatches,
            opt=opt,
        ),
        ckpt_dir=args.ckpt or f"runs/train_{args.arch}",
        device=dev,
    )


def summary(arch: str, result: TrainResult) -> str:
    """The reference launcher's summary line of a run."""
    losses = (f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f}" if result.losses
              else "loss - (no step left to run)")
    return (f"{arch}: step {result.step} {losses} "
            f"stragglers={len(result.straggler_events)} resumed_from={result.resumed_from}")


def main(argv=None) -> TrainResult:
    args = parser().parse_args(argv)
    result = make_trainer(args).run(torch.Generator().manual_seed(SEED))
    print(summary(args.arch, result))
    return result


if __name__ == "__main__":
    main()
