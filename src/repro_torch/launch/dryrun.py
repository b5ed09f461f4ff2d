"""Dry run: trace every (arch x shape) cell on the production H100 meshes,
check the memory fit and emit roofline inputs.  The port of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod] [--out runs/dryrun]

It needs no card.  Each cell starts a fake process group of 256 (pod,
32 x 8) or 512 (multi-pod, 2 x 32 x 8) ranks in this process, builds its
state as DTensors whose local shards are fake tensors (``FakeTensorMode``,
no storage: dbrx-132b's 132 B parameters take no memory), runs the cell's
step once as rank 0 and counts its costs (``analysis/costs``).  The
process group is destroyed when the cell ends, whatever happens.

Per cell it writes one JSON record (the reference's keys): bytes per rank
(arguments, outputs, the traced peak, its fit against one H100's 80 GB),
dot FLOPs and collective bytes by type per rank.  Keys that describe a
compiled XLA executable (``cost_analysis_raw``, ``compile_s``,
``cpu_convert_artifact_bytes``) are kept with null values.

The step is the port's: ``train.step.make_train_step`` with the arch's
``train_microbatches`` on the train rules' DTensors (AdamW included),
``prefill`` and ``decode_step`` on the serve rules' (``serve_2d`` for a
decode cell of an arch that sets it), each under ``implicit_replication``
so the tensors a model builds for itself (RoPE tables, masks, iotas) act
as replicated.  Kernel entry points get ``use_kernel=False``: the
reference's decode runs its plain attention, and on fake CPU tensors the
kernels' wrappers would take their plain versions anyway.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.analysis.costs import argument_bytes, measure
from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_arch
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import (
    MULTIPOD_SHAPE,
    POD_SHAPE,
    data_axes,
    make_production_mesh,
    mesh_name,
)
from repro_torch.launch.sharding import (
    _map_with_path,
    batch_shardings,
    cache_shardings,
    distribute,
    opt_shardings,
    param_shardings,
)
from repro_torch.models.api import (
    abstract_cache,
    abstract_params,
    fake_inputs,
    fake_mode,
    get_model,
    input_specs,
)
from repro_torch.models.layers import ShardCtx
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.tree import tree_map

#: one H100 SXM's device memory (data sheet)
HBM_BYTES = 80 * 10**9
DEVICE = "H100 80GB"

VARIANTS = ("fsdp_once", "fp8_cache", "naive_cache", "replicated", "compress",
            "dp_all", "dp_all_compress", "mb2", "seq_residual")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks in this process, as
    rank 0 (collectives move nothing); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ctx(mesh, variant: str | None = None) -> ShardCtx:
    residual = "seq" if variant == "seq_residual" else "d"
    if variant in ("dp_all", "dp_all_compress"):  # model axis -> extra DP
        return ShardCtx(mesh=mesh, data_axes=(*data_axes(mesh), "model"),
                        model_axis=None, residual=residual)
    return ShardCtx(mesh=mesh, data_axes=data_axes(mesh), residual=residual)


@dataclass
class Cell:
    """One cell's step and its arguments: ``fn(*args)``."""

    fn: Callable
    args: tuple          # DTensor trees
    specs: tuple         # their spec trees
    cfg: ArchConfig
    shape: InputShape


def _replicated(tree: Any) -> Any:
    return tree_map(lambda _: (), tree)


def build_cell(arch: str | ArchConfig, shape: str | InputShape, mesh,
               variant: str | None = None, state: tuple | None = None) -> Cell:
    """The step of one cell on ``mesh``, its arguments distributed.

    ``state``: the arguments as plain (full) trees, in the step's order:
    (params, opt_state, batch) for train, (params, batch) for prefill,
    (params, cache, batch) for decode.  Without it they are abstract:
    ``abstract_params``, fake inputs and caches, made under the caller's
    ``FakeTensorMode`` or one of their own.

    ``variant`` selects a configuration of the reference's hill-climb:
      fsdp_once    : gather FSDP weights once per step (to the serve
                     rules' 1-D sharding), not per microbatch
      fp8_cache    : KV cache stored in float8_e4m3fn (decode shapes)
      naive_cache  : batch-only cache sharding (no sequence sharding)
      replicated   : pure data-parallel params (no FSDP)
      compress     : bf16 gradient compression with error feedback
      dp_all(_compress): the model axis as extra data parallelism
      mb2          : half the arch's microbatches
      seq_residual : the residual stream sharded over the sequence
    """
    from torch.distributed.tensor.experimental import implicit_replication

    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    api = get_model(cfg)
    ctx = _ctx(mesh, variant)
    state = list(state) if state is not None else None
    params = state.pop(0) if state else abstract_params(cfg)
    kernel_off = {"use_kernel": False}

    def inputs():
        return state.pop(-1) if state else fake_inputs(input_specs(cfg, shape))

    if shape.kind == "train":
        dp_all = variant in ("dp_all", "dp_all_compress")
        p_specs = (_replicated(params) if variant == "replicated" else
                   param_shardings(mesh, params, mode="dp" if dp_all else "train"))
        opt_cfg = AdamWConfig(compress_grads=variant in ("compress", "dp_all_compress"))
        if state:
            opt = state.pop(0)
        else:
            with fake_mode():
                opt = init_opt_state(params, opt_cfg)
        o_specs = (_replicated(opt) if variant == "replicated" else
                   opt_shardings(mesh, opt, p_specs, mode="dp" if dp_all else "train"))
        batch = inputs()
        b_specs = batch_shardings(mesh, batch, shape, extra_axes=("model",) if dp_all else ())

        from repro_torch.train.optimizer import adamw_update
        from repro_torch.train.step import accumulate, make_train_step

        def loss(p, b):
            return api.loss_fn(p, b, cfg, ctx)

        mbs = cfg.train_microbatches
        if variant == "mb2":
            mbs = max(mbs // 2, 1)
        step_fn = make_train_step(loss, opt_cfg, microbatches=mbs)
        if variant == "fsdp_once":
            # weights taken to the serve rules' 1-D (model-only) placements
            # once per step, outside the microbatch loop; their gradients
            # go back to the FSDP placements (a reduce-scatter) for AdamW
            gather = param_shardings(mesh, params, mode="serve")

            def step_fn(p, o, b):  # noqa: F811
                p1 = _map_with_path(lambda path, t: ctx.constrain(t, _spec_at(gather, path)), p)
                l, g = accumulate(loss, tree_map(lambda t: t.detach(), p1), b, mbs)
                g = tree_map(lambda gi, pi: gi.redistribute(pi.device_mesh, pi.placements), g, p)
                return (l, *adamw_update(p, g, o, opt_cfg))

        def fn(p, o, b):
            with implicit_replication():
                return step_fn(p, o, b)

        specs = (p_specs, o_specs, b_specs)
        args = tuple(distribute(mesh, t, s) for t, s in zip((params, opt, batch), specs))
        return Cell(fn, args, specs, cfg, shape)

    # serve_2d only helps DECODE (weights resident vs per-layer gathers)
    serve_mode = "serve_2d" if cfg.serve_2d and shape.kind == "decode" else "serve"
    p_specs = param_shardings(mesh, params, mode=serve_mode)

    if shape.kind == "prefill":
        batch = inputs()
        specs = (p_specs, batch_shardings(mesh, batch, shape))
        kw = kernel_off if "prefill" in api.kernel_entry else {}

        def fn(p, b):
            with implicit_replication():
                return api.prefill(p, b, cfg, None, ctx, **kw)

        args = tuple(distribute(mesh, t, s) for t, s in zip((params, batch), specs))
        return Cell(fn, args, specs, cfg, shape)

    # decode: one token against a seq_len cache
    cache = state.pop(0) if state else abstract_cache(cfg, shape)
    if variant == "fp8_cache":
        with fake_mode():
            cache = tree_map(lambda a: a.to(torch.float8_e4m3fn)
                             if a.dtype == torch.bfloat16 else a, cache)
    if variant == "naive_cache":
        # counterfactual baseline: batch-only cache sharding (no sequence
        # sharding), what a naive GPU-style port would do
        da = data_axes(mesh)

        def naive(path, leaf):
            if leaf.ndim == 0:
                return ()
            if leaf.ndim >= 2 and leaf.shape[1] == shape.global_batch:
                return (None, da, *(None,) * (leaf.ndim - 2))
            return (None,) * leaf.ndim

        c_specs = _map_with_path(naive, cache)
    else:
        c_specs = cache_shardings(mesh, cache, cfg, shape)
    batch = inputs()
    specs = (p_specs, c_specs, batch_shardings(mesh, batch, shape))
    kw = kernel_off if "decode_step" in api.kernel_entry else {}

    def fn(p, c, b):
        with implicit_replication():
            return api.decode_step(p, c, b, cfg, ctx, **kw)

    args = tuple(distribute(mesh, t, s) for t, s in zip((params, cache, batch), specs))
    return Cell(fn, args, specs, cfg, shape)


def _spec_at(specs: dict, path: str):
    for key in path.split("/"):
        specs = specs[key]
    return specs


def _mesh_name(multi_pod: bool, mesh_shape: tuple | None) -> str:
    if mesh_shape is None:
        return mesh_name(multi_pod)
    return "custom_" + "x".join(map(str, mesh_shape))


def run_cell(arch: str | ArchConfig, shape: str | InputShape, multi_pod: bool = False,
             out_dir: Path | None = None, variant: str | None = None,
             mesh_shape: tuple | None = None) -> dict:
    """Trace one cell on its mesh and return (and write) its record.
    ``mesh_shape`` replaces the production mesh: (data, model) or (pod,
    data, model) ranks (tests use small ones)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    name = _mesh_name(multi_pod, mesh_shape)
    cell_id = f"{cfg.name}.{shape.name}.{name}" + (f".{variant}" if variant else "")
    world = math.prod(mesh_shape or (MULTIPOD_SHAPE if multi_pod else POD_SHAPE))
    rec = {"cell": cell_id, "arch": cfg.name, "shape": shape.name, "mesh": name,
           "chips": world, "device": DEVICE}
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return _write(rec, out_dir, cell_id)
    t0 = time.time()
    try:
        with fake_world(world):
            if mesh_shape is None:
                mesh = make_production_mesh(multi_pod=multi_pod)
            else:
                axes = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
                mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=axes)
            # the state is made under the fake mode; the step runs outside
            # it (its fake tensors still dispatch through it), so DTensor's
            # own bookkeeping on the mesh's rank tensor stays real
            with FakeTensorMode(allow_non_fake_inputs=True):
                cell = build_cell(cfg, shape, mesh, variant=variant)
            t_build = time.time() - t0
            out, costs = measure(cell.fn, *cell.args)
            t_trace = time.time() - t0 - t_build
            out_bytes = argument_bytes(*(out if isinstance(out, tuple) else (out,)))
            donated = argument_bytes(*cell.args[:2]) if shape.kind == "train" else \
                argument_bytes(cell.args[1]) if shape.kind == "decode" else 0
            rec.update(
                status="ok",
                lower_s=round(t_build, 1),
                trace_s=round(t_trace, 1),
                compile_s=None,
                memory={
                    "argument_bytes": costs.argument_bytes,
                    "output_bytes": out_bytes,
                    "temp_bytes": costs.peak_bytes - costs.argument_bytes,
                    "alias_bytes": donated,
                    "peak_bytes": costs.peak_bytes,
                    "hbm_bytes": HBM_BYTES,
                    "fits": costs.peak_bytes <= HBM_BYTES,
                },
                cost_analysis_raw={"flops": None, "bytes_accessed": None},
                hlo_dot_flops=costs.dot_flops,
                collective_bytes=dict(costs.collective_bytes),
                collective_count=costs.collective_count,
                cpu_convert_artifact_bytes=None,
                n_params=cfg.n_params(),
                n_active_params=cfg.n_active_params(),
            )
            del cell, out
            gc.collect()
    except Exception as e:  # a failing cell is a bug: surface it loudly
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return _write(rec, out_dir, cell_id)


def _write(rec: dict, out_dir: Path | None, cell_id: str) -> dict:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell_id}.json").write_text(json.dumps(rec, indent=1))
    return rec


def summary(rec: dict) -> str:
    """One line per record, as ``main`` prints it."""
    if rec["status"] == "ok":
        m = rec["memory"]
        coll = " ".join(f"{k}={v:.3e}" for k, v in sorted(rec["collective_bytes"].items()))
        return (f"[ok] {rec['cell']} args={m['argument_bytes'] / 2**30:.2f}GiB/rank "
                f"peak={m['peak_bytes'] / 2**30:.2f}GiB fits80GB={m['fits']} "
                f"dotF={rec['hlo_dot_flops']:.3e} coll[{coll}] trace={rec['trace_s']}s")
    if rec["status"] == "FAILED":
        return f"[FAILED] {rec['cell']} {rec['error'][:160]}"
    return f"[{rec['status']}] {rec['cell']}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--variant", default=None, choices=VARIANTS)
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in sorted(ARCHS) for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            # skip cells whose JSON already exists (resumable sweep)
            cell_id = f"{arch}.{shape}.{mesh_name(mp)}" + (f".{args.variant}" if args.variant else "")
            done = out_dir / f"{cell_id}.json"
            if args.all and done.exists():
                rec = json.loads(done.read_text())
                print(f"[cached] {rec['cell']}: {rec['status']}")
                continue
            rec = run_cell(arch, shape, mp, out_dir, variant=args.variant)
            failures += rec["status"] == "FAILED"
            print(summary(rec), flush=True)
    if failures:
        raise SystemExit(f"{failures} cells FAILED")


if __name__ == "__main__":
    main()
