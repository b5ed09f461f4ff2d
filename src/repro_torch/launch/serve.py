"""Serving launcher: LM decode or GW anomaly streaming on the port.

LM mode (batched prefill + greedy decode through ``LmEngine``; every
family: ``dense`` with its VLM backbone, ``moe``, ``ssm``, ``hybrid`` and
``encdec``; random weights from seed 0):

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch smollm-360m --reduced --prompt-len 16 --new-tokens 16

(``--arch qwen2-moe-a2.7b``, ``dbrx-132b``, ``mamba2-130m``,
``hymba-1.5b``, ``llava-next-34b`` or ``seamless-m4t-large-v2`` likewise;
``--device cpu`` with ``--reduced`` on a machine without a card.)  The
frontend stubs' embeddings are drawn from seed 1, standard normal, at the
model's dtype: ``frontend_tokens`` patches in front of each prompt for a
VLM, and ``--prompt-len`` encoder frames beside each decoder prompt for
``encdec`` (the reference's even split of a prefill's length).

Anomaly mode (the paper's use case: persistent-state B=1 streaming on the
fused stack, weights packed once at engine init; short chunks ride the
``fused_step`` step kernel):

    PYTHONPATH=src python -m repro_torch.launch.serve --mode anomaly \\
        --gw-model gw_small --windows 50 --chunk 25 --weight-dtype int8

The flags are the reference's (``repro.launch.serve``) plus ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions).

``--weight-dtype {fp32,bf16,int8}`` picks the packed weight storage;
``--weight-dtypes int8,fp32,fp32,int8`` pins it per layer, which routes
both segments through the ``mixed`` backend (a chain of ``fused_step``
segments).  ``--tune cached`` resolves the plan knobs from the autotune
store (fill it with ``python -m repro_torch.launch.tune``); ``--tune
balanced`` (mixed backend) lets the roofline model choose each segment's
int8/fp32 split.
``--chunk-len N`` overrides the plan's step-kernel threshold.
``--placement sharded`` pipelines each segment's contiguous sub-stacks
across the default stage mesh (``fused_stack_sharded``: one stage per
CUDA card that divides the layers, one stage on the CPU), each stage one
wavefront-kernel launch per chunk of the window.
``--streams N`` serves N independent streams through ``push_many``: every
chunk advances all N with one gathered B=N step call.
``--server`` runs the continuous-batching ``StreamServer``: a Poisson
arrival loop submits chunks for ``--streams`` streams at ``--arrival-hz``
aggregate rate (0 = as fast as possible) and the deadline scheduler
coalesces what is pending (``--deadline-us``, ``--max-coalesce``,
``--overflow``, ``--queue-capacity``; ``--adaptive`` with
``--max-deadline-us`` for the self-tuning policy).  The run prints the
enqueue->score latency p50/p99/max and the scheduler's counters.
``--sanitize {off,reject,hold,reset}`` screens every submitted chunk
(``--saturation-limit``); ``--checkpoint PATH`` snapshots the engine every
``--checkpoint-interval-s`` seconds; ``--restore PATH`` restores it before
serving (fingerprint-checked, and a snapshot of the reference restores
here).  Any of these turns on the health layer and prints its counters.
``--plan-only`` prints the resolved plan of both segments, each knob with
its provenance (explicit, tuned, default, balanced) and a mixed plan's
layer assignment, and exits.

"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.serve.latency import LatencyHistogram


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("lm", "anomaly"), default="lm")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs; cpu runs the plain versions")
    # lm mode
    ap.add_argument("--arch", help="LM arch id (lm mode; every family)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    # anomaly mode
    ap.add_argument("--gw-model", default="gw_small", help="GW_MODELS key")
    ap.add_argument("--windows", type=int, default=50)
    ap.add_argument("--chunk", type=int, default=0,
                    help="chunk length per push; 0 = full windows")
    ap.add_argument("--fpr", type=float, default=0.01)
    ap.add_argument("--weight-dtype", choices=("fp32", "bf16", "int8"), default=None,
                    help="packed weight storage of the fused stack")
    ap.add_argument("--weight-dtypes", default=None, metavar="D0,D1,...",
                    help="per-layer weight storage (one entry per LSTM layer, e.g. "
                         "int8,fp32,fp32,int8); routes both segments through the mixed "
                         "backend")
    ap.add_argument("--placement", choices=("local", "sharded"), default="local",
                    help="fused-stack stage placement (anomaly mode): 'sharded' pipelines "
                         "fused sub-stacks across the default stage mesh "
                         "(fused_stack_sharded)")
    ap.add_argument("--tune", choices=("default", "cached", "balanced"),
                    default="default",
                    help="'cached' resolves plan knobs from the autotune store "
                         "(runs/autotune/tuned.json; fill it with python -m "
                         "repro_torch.launch.tune); 'balanced' (mixed backend) lets the "
                         "roofline model pick each segment's int8/fp32 split")
    ap.add_argument("--chunk-len", type=int, default=None,
                    help="step-kernel threshold: pushes with T <= chunk_len run "
                         "the step kernel")
    ap.add_argument("--streams", type=int, default=1,
                    help="independent streams; > 1 coalesces them into one B=N "
                         "step call per chunk (push_many)")
    ap.add_argument("--plan-only", action="store_true",
                    help="print the execution plan without scoring")
    # continuous-batching server mode
    ap.add_argument("--server", action="store_true",
                    help="serve through the StreamServer with Poisson arrivals")
    ap.add_argument("--deadline-us", type=float, default=200.0)
    ap.add_argument("--max-coalesce", type=int, default=8)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--max-deadline-us", type=float, default=500.0)
    ap.add_argument("--overflow", choices=("block", "drop_oldest", "error"),
                    default="block")
    ap.add_argument("--queue-capacity", type=int, default=4096)
    ap.add_argument("--arrival-hz", type=float, default=0.0,
                    help="aggregate Poisson chunk-arrival rate; 0 = max rate")
    # fault tolerance (server mode; any of these enables the health layer)
    ap.add_argument("--sanitize", choices=("off", "reject", "hold", "reset"),
                    default="off")
    ap.add_argument("--saturation-limit", type=float, default=None)
    ap.add_argument("--checkpoint", default=None, metavar="PATH")
    ap.add_argument("--checkpoint-interval-s", type=float, default=5.0)
    ap.add_argument("--restore", default=None, metavar="PATH")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode == "anomaly":
        return serve_anomaly(args)
    if not args.arch:
        ap.error("--arch is required in lm mode")
    return serve_lm(args)


def serve_lm(args):
    """Batched prefill + greedy decode of random prompts (seed 0) with
    random weights (seed 0) on ``--device``; a VLM's patches and an
    encoder-decoder model's frames from seed 1."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.api import cache_rows, get_model
    from repro_torch.serve.engine import LmEngine

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=args.device)
    n_front = args.prompt_len if cfg.encdec else cfg.frontend_tokens if cfg.frontend else 0
    frontend = None
    if n_front:
        frontend = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (args.batch, n_front, cfg.d_model), dtype=np.float32)).to(cfg.dtype)
    rows = cache_rows(cfg, args.prompt_len, args.new_tokens, n_front)
    engine = LmEngine(params, cfg, max_len=rows, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens, frontend_embeds=frontend)
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"{args.arch}: generated {out.shape} in {dt:.2f}s ({tok_s:.1f} tok/s on "
          f"{args.device}), kernel launches {engine.launches}")
    print("sample:", out[0][:12].tolist())
    return {"tokens": out, "launches": dict(engine.launches)}


def _requested_impl(cfg) -> str:
    return "mixed" if cfg.impl == "mixed" else "fused_step"


def _engine(args, params, cfg):
    from repro_torch.serve.engine import StreamingAnomalyEngine

    return StreamingAnomalyEngine(params, cfg, batch=1, impl=_requested_impl(cfg),
                                  placement=args.placement, chunk_len=args.chunk_len,
                                  tune=args.tune, device=args.device)


def serve_anomaly(args):
    """Continuous B=1 strain scoring with resident state (paper Table III)."""
    import dataclasses

    from repro_torch.configs.gw import GW_MODELS
    from repro_torch.core.autoencoder import init_autoencoder
    from repro_torch.data.gw import GwDataConfig, GwDataset

    cfg = GW_MODELS[args.gw_model]
    if args.weight_dtype is not None:
        cfg = dataclasses.replace(cfg, weight_dtype=args.weight_dtype)
    if args.weight_dtypes is not None or args.tune == "balanced":
        # per-layer storage (and the model-chosen split) only run on the
        # heterogeneous backend: pin it so resolve_impl keeps it
        wds = None
        if args.weight_dtypes is not None:
            wds = tuple(None if w in ("", "native") else w
                        for w in args.weight_dtypes.split(","))
        cfg = dataclasses.replace(cfg, weight_dtypes=wds, impl="mixed")
    params = init_autoencoder(cfg, seed=0, device=args.device)

    if args.plan_only:
        return print_plan(args, params, cfg)

    ds = GwDataset(GwDataConfig(timesteps=cfg.timesteps))

    if args.server:
        return serve_server(args, params, cfg, ds)

    engine = _engine(args, params, cfg)
    wd = engine.fingerprint()["weight_dtype"]
    print(f"{args.gw_model}: impl={engine.effective_impl} "
          f"(requested {_requested_impl(cfg)}, tune={args.tune}), "
          f"placement={args.placement}, weights={wd}, window={engine.window}, "
          f"chunk_len={engine._exec_enc.plan.chunk_len}, device={args.device}")
    thr = engine.calibrate(ds.background(256), fpr=args.fpr)
    print(f"calibrated threshold ({args.fpr:.0%} FPR): {thr:.4f}")

    chunk = args.chunk or cfg.timesteps
    rng = np.random.default_rng(1)
    lat, flagged = [], 0
    if args.streams > 1:
        # N independent streams, one coalesced step call per chunk
        ids = [f"stream-{i}" for i in range(args.streams)]
        for _ in range(args.windows):
            w = np.concatenate([
                ds.events(1) if rng.random() < 0.1 else ds.background(1)
                for _ in ids
            ])
            t0 = time.perf_counter()
            scores = {sid: [] for sid in ids}
            for pos in range(0, cfg.timesteps, chunk):
                res = engine.push_many(ids, w[:, pos : pos + chunk])
                for sid in ids:
                    scores[sid] += res[sid]
            lat.append(time.perf_counter() - t0)
            flagged += sum(int(scores[sid][0][0] > thr) for sid in ids)
    else:
        for _ in range(args.windows):
            w = ds.events(1) if rng.random() < 0.1 else ds.background(1)
            t0 = time.perf_counter()
            scores = []
            for pos in range(0, cfg.timesteps, chunk):
                scores += engine.push(w[:, pos : pos + chunk])
            lat.append(time.perf_counter() - t0)
            flagged += int(scores[0][0] > thr)
    warmup = min(5, len(lat) - 1)  # keep at least one sample
    hist = LatencyHistogram()
    hist.record_many(np.asarray(lat[warmup:]) * 1e6)
    tag = f", {args.streams} coalesced streams" if args.streams > 1 else ""
    print(f"{args.windows} windows ({chunk}-sample chunks{tag}): "
          f"{flagged} flagged; latency p50={hist.percentile(50):.0f}us "
          f"p99={hist.percentile(99):.0f}us max={hist.max_us:.0f}us "
          f"on {args.device}")
    return {"flagged": flagged, "latency": hist.summary("latency")}


def serve_server(args, params, cfg, ds):
    """Continuous-batching serving: Poisson arrivals through the deadline
    coalescer (``serve/server.py``), scheduler metrics as the output."""
    from repro_torch.serve.health import HealthConfig
    from repro_torch.serve.server import AdaptiveConfig, ServerConfig, StreamServer

    engine = _engine(args, params, cfg)
    health = None
    if args.sanitize != "off" or args.checkpoint or args.restore:
        health = HealthConfig(
            sanitize=args.sanitize,
            saturation_limit=args.saturation_limit,
            checkpoint_path=args.checkpoint,
            checkpoint_interval_s=(args.checkpoint_interval_s
                                   if args.checkpoint else None),
        )
    server_cfg = ServerConfig(
        max_coalesce=args.max_coalesce,
        deadline_us=args.deadline_us,
        queue_capacity=args.queue_capacity,
        overflow=args.overflow,
        adaptive=(AdaptiveConfig(max_deadline_us=args.max_deadline_us)
                  if args.adaptive else None),
        health=health,
    )
    if args.restore:
        server = StreamServer.restart_from(args.restore, engine, server_cfg)
        print(f"restored engine from {args.restore}: "
              f"{len(engine.stream_ids)} stream(s) resident, "
              f"threshold={engine.threshold}")
    else:
        server = StreamServer(engine, server_cfg)
    n_streams = max(1, args.streams)
    chunk = args.chunk or cfg.timesteps
    rng = np.random.default_rng(2)

    # each stream serves --windows windows, chopped into fixed chunks; the
    # fleet's chunks arrive in one Poisson-merged order (random stream per
    # arrival, each stream's own chunks in order)
    queues = []
    for _ in range(n_streams):
        w = np.concatenate([
            ds.events(1) if rng.random() < 0.1 else ds.background(1)
            for _ in range(args.windows)
        ], axis=1)[0]  # (windows*T, input_dim)
        queues.append([w[pos : pos + chunk] for pos in range(0, w.shape[0], chunk)])
    total_chunks = sum(len(q) for q in queues)

    policy = (f"adaptive (deadline <= {args.max_deadline_us:.0f}us from "
              "arrival-rate EWMA)" if args.adaptive
              else f"fixed deadline={args.deadline_us:.0f}us")
    print(f"{args.gw_model}: StreamServer impl={engine.effective_impl}, "
          f"{n_streams} streams x {args.windows} windows "
          f"({chunk}-sample chunks, {total_chunks} total), "
          f"{policy} max_coalesce={server.config.max_coalesce} "
          f"overflow={args.overflow} placement={args.placement} device={args.device}"
          + (f", ~{args.arrival_hz:.0f} chunks/s Poisson"
             if args.arrival_hz > 0 else ", max-rate arrivals"))

    # one full-width window first, so the histogram measures scheduling and
    # not the first launches' one-time costs (kernel build and load)
    warm_ids = [f"warm-{i}" for i in range(server.config.max_coalesce)]
    for pos in range(0, engine.window, chunk):
        t = min(chunk, engine.window - pos)
        engine.push_many(warm_ids, np.zeros((len(warm_ids), t, cfg.input_dim),
                                            np.float32))
    for wid in warm_ids:
        engine.drop_stream(wid)

    t0 = time.perf_counter()
    with server:
        live = [i for i, q in enumerate(queues) if q]
        while live:
            i = live[int(rng.integers(len(live)))]
            server.submit(f"stream-{i}", queues[i].pop(0))
            if not queues[i]:
                live.remove(i)
            if args.arrival_hz > 0:
                time.sleep(rng.exponential(1.0 / args.arrival_hz))
    wall = time.perf_counter() - t0

    scores = server.pop_scores()
    n_scores = sum(len(v) for v in scores.values())
    s = server.stats
    print(f"{total_chunks} chunks -> {n_scores} window scores in "
          f"{wall:.2f}s ({total_chunks / wall:.0f} chunks/s)")
    print(f"scheduler: {s.ticks} ticks ({s.full_flushes} full, "
          f"{s.deadline_flushes} deadline, {s.fastpath_flushes} fastpath, "
          f"{s.drain_flushes} drain), {s.drops} dropped, batch fill "
          f"{dict(sorted(s.batch_fill.items()))}"
          + (f", effective width {server.effective_coalesce}"
             if args.adaptive else ""))
    print(f"enqueue->score latency: p50={s.latency.percentile(50):.0f}us "
          f"p99={s.latency.percentile(99):.0f}us "
          f"max={s.latency.max_us:.0f}us over {s.latency.count} chunks")
    if health is not None:
        print(f"health: {s.rejected} rejected, {s.held} held, "
              f"{s.sanitize_resets} sanitize resets, "
              f"{s.watchdog_resets} watchdog resets, "
              f"{s.holddown_suppressed} scores held down, "
              f"{s.engine_errors} engine errors, "
              f"{s.callback_errors} callback errors, "
              f"{s.scheduler_restarts} scheduler restarts, "
              f"{s.checkpoints} checkpoints"
              + (f" -> {args.checkpoint}" if args.checkpoint else ""))
    return {"scores": scores, "stats": s.summary()}


def print_plan(args, params, cfg) -> dict:
    """Resolve both segment plans, bind (packing included), print each
    knob's value and provenance and a mixed plan's layer assignment, exit;
    never runs a scoring step.  Returns {segment: its plan's describe()}."""
    from repro_torch.core.autoencoder import segment_executors
    from repro_torch.core.backends import resolve_impl

    requested = _requested_impl(cfg)
    cfg, effective, reason = resolve_impl(cfg, requested)
    if reason is not None:
        print(f"note: {reason}")
    exec_enc, exec_dec = segment_executors(params, cfg, impl=effective,
                                           placement=args.placement,
                                           chunk_len=args.chunk_len, tune=args.tune)
    print(f"{args.gw_model}: resolved serving plan (window={cfg.timesteps}, "
          f"requested {requested}, tune={args.tune})")
    plans = {}
    for name, ex in (("encoder", exec_enc), ("decoder", exec_dec)):
        plan = ex.plan
        plans[name] = plan.describe()
        stages = "" if ex.mesh is None else " stages=" + ",".join(map(str, ex.mesh))
        print(f"  {name}: {plans[name]} pack_bytes={ex.packed_bytes}{stages}")
        for knob, (value, source) in sorted(plan.knob_provenance().items()):
            shown = "auto" if value is None else value
            print(f"    {knob:<12} = {shown!s:<6} [{source}]")
        if plan.backend.heterogeneous:
            src = dict(plan.knob_sources).get("weight_dtype", "default")
            for row in plan.layer_assignment():
                print(f"    layer {row['layer']} (hidden={row['hidden']:<3}) -> "
                      f"{row['weight_dtype']:<5} stage={row['stage']} "
                      f"chunk_len={row['chunk_len']} [{src}]")
    return plans


if __name__ == "__main__":
    main()
