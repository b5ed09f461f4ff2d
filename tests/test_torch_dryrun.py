"""The port's dry run (``launch/dryrun.py``) on the CPU.

* A real sharded train step on 4 gloo ranks (mesh (2, 2), one process
  per rank, spawned with ``launch.subproc.child_env``): reduced
  granite-3-2b and qwen2-moe-a2.7b (the expert-sharded MoE layer) with
  the reference's params converted, its loss and one
  AdamW step equal the unsharded port step's (loss 1e-6 relative, each
  leaf within 1e-5 of its largest |value|).  Rank 0 also checks that
  DTensor's shard of a dim sharded over ("data", "model") is the one
  JAX's ``PartitionSpec(("data", "model"))`` gives (data-major).
* ``run_cell`` on every reduced arch x shape kind over a fake (2, 2) mesh
  returns ``status: "ok"`` with every key of the record; a variant
  changes what it should (``fp8_cache`` halves the cache bytes,
  ``replicated`` gives every rank the full parameters).
* No test leaves a process group initialised.
"""

import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, all_cells, cell_supported, get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.subproc import child_env
from repro_torch.models.api import abstract_params, get_model
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]

#: small shapes of each kind (the production shapes' widths, cut in length and batch)
SMALL = {"train": InputShape("train_4k", 64, 8, "train"),
         "prefill": InputShape("prefill_32k", 64, 4, "prefill"),
         "decode": InputShape("decode_32k", 64, 4, "decode"),
         "long": InputShape("long_500k", 64, 1, "decode")}

RECORD_KEYS = {"cell", "arch", "shape", "mesh", "chips", "device", "status", "lower_s",
               "trace_s", "compile_s", "memory", "cost_analysis_raw", "hlo_dot_flops",
               "collective_bytes", "collective_count", "cpu_convert_artifact_bytes",
               "n_params", "n_active_params"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes",
               "hbm_bytes", "fits"}


@pytest.fixture(autouse=True)
def _no_process_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group initialised"


# ---------------------------------------------------------------------------
# a real sharded step on 4 gloo ranks
# ---------------------------------------------------------------------------

_RANK = r"""
import sys, dataclasses
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.mesh import make_host_mesh, placements
from repro_torch.launch.sharding import distribute
from repro_torch.train.optimizer import init_opt_state
from repro_torch.tree import flatten
from repro_torch import convert

rank, port, data, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
try:
    mesh = make_host_mesh(model=2, device_type="cpu")
    cfg = dataclasses.replace(get_arch(arch).reduced(), vocab=512)
    z = np.load(data)
    params = lm_params_from_numpy(convert.unflatten(z, prefix="p/"), "cpu")
    batch = {"tokens": torch.from_numpy(z["tokens"]), "labels": torch.from_numpy(z["labels"])}
    shape = InputShape("train_4k", 64, 8, "train")
    cell = build_cell(cfg, shape, mesh, state=(params, init_opt_state(params), batch))
    loss, new_p, new_o = cell.fn(*cell.args)
    loss = loss.full_tensor()
    full = {k: v.full_tensor() for k, v in flatten(new_p).items()}
    # DTensor's shard of a dim over ("data", "model") against JAX's order
    # (data-major: rank (d, m) holds block d * 2 + m)
    t = torch.arange(8.0)
    local = distribute(mesh, t, (("data", "model"),)).to_local()
    d, m = mesh.get_coordinate()
    assert torch.equal(local, t[(d * 2 + m) * 2:(d * 2 + m + 1) * 2]), (rank, local)
    if rank == 0:
        np.savez(data + ".out.npz", loss=loss.numpy(),
                 **{"p/" + k: v.detach().numpy() for k, v in full.items()})
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_gloo_sharded_step_matches_unsharded(tmp_path, arch):
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as r_get_arch
    from repro.models.api import get_model as r_get_model
    from repro_torch.convert import lm_params_from_numpy

    rcfg = dataclasses.replace(r_get_arch(arch).reduced(), vocab=512)
    rparams = jax.tree_util.tree_map(
        np.asarray, r_get_model(rcfg).init_params(jax.random.PRNGKey(0), rcfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (8, 64)).astype(np.int32)
    labels = rng.integers(0, 512, (8, 64)).astype(np.int32)
    data = tmp_path / "in.npz"
    np.savez(data, tokens=tokens, labels=labels,
             **{"p/" + k: v for k, v in flatten(rparams).items()})

    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port, str(data), arch],
                              cwd=ROOT, env=child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    cfg = dataclasses.replace(get_arch(arch).reduced(), vocab=512)
    params = lm_params_from_numpy(rparams, "cpu")
    mbs = cfg.train_microbatches
    # the sharded step's microbatch i holds each data rank's i-th slice of
    # its rows (train.step._split_sharded): the plain step gets the rows in
    # that order, so both average the same microbatches (MoE's aux loss
    # depends on the grouping)
    per_rank, per_mb = 8 // 2, 8 // 2 // mbs
    perm = [d * per_rank + i * per_mb + j for i in range(mbs) for d in range(2)
            for j in range(per_mb)]
    step = make_train_step(lambda p, b: get_model(cfg).loss_fn(p, b, cfg), AdamWConfig(),
                           microbatches=mbs)
    loss, new_p, _ = step(params, init_opt_state(params),
                          {"tokens": torch.from_numpy(tokens[perm]),
                           "labels": torch.from_numpy(labels[perm])})
    got = np.load(str(data) + ".out.npz")
    assert abs(float(got["loss"]) - float(loss)) <= 1e-6 * abs(float(loss))
    bad = {}
    for k, v in flatten(new_p).items():
        want = v.numpy()
        err = np.abs(got["p/" + k] - want)
        if err.max() > 1e-5 * np.abs(want).max():
            i = np.unravel_index(err.argmax(), err.shape)
            bad[k] = (float(err.max()), float(np.abs(want).max()), i, (err > 1e-5 * np.abs(want).max()).sum())
    assert not bad, bad


# ---------------------------------------------------------------------------
# input specs and abstract state against the reference's, all 32 cells
# ---------------------------------------------------------------------------

def _jdt(dtype) -> str:
    return np.dtype(dtype).name


def _tdt(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def test_input_specs_and_abstract_state_match_reference():
    jax = pytest.importorskip("jax")
    from repro.configs import ARCHS as R_ARCHS
    from repro.configs import SHAPES as R_SHAPES
    from repro.models import api as rapi
    from repro_torch.models.api import abstract_cache, input_specs

    def ref_leaves(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path):
                (tuple(leaf.shape), _jdt(leaf.dtype)) for path, leaf in flat}

    def mine(tree):
        return {k: (tuple(v.shape), _tdt(v.dtype)) for k, v in flatten(tree).items()}

    n_cells = 0
    for name, cfg in sorted(ARCHS.items()):
        rcfg = R_ARCHS[name]
        params = abstract_params(cfg)
        assert mine(params) == ref_leaves(rapi.abstract_params(rcfg)), name
        assert sum(int(np.prod(t.shape)) for t in flatten(params).values()) == sum(
            int(np.prod(s)) for s, _ in ref_leaves(rapi.abstract_params(rcfg)).values())
        for shape_name, shape in SHAPES.items():
            if not cell_supported(cfg, shape)[0]:
                continue
            n_cells += 1
            rshape = R_SHAPES[shape_name]
            want = {k: (tuple(v.shape), _jdt(v.dtype))
                    for k, v in rapi.input_specs(rcfg, rshape).items()}
            assert {k: (tuple(v.shape), _tdt(v.dtype))
                    for k, v in input_specs(cfg, shape).items()} == want, (name, shape_name)
            if shape.kind == "decode":
                assert mine(abstract_cache(cfg, shape)) == ref_leaves(
                    rapi.abstract_cache(rcfg, rshape)), (name, shape_name)
    assert n_cells == 32



# ---------------------------------------------------------------------------
# dry-run records on every reduced arch x shape kind (prefill and decode
# here, the train cells in test_torch_costs.py), and the variants
# ---------------------------------------------------------------------------

def _reduced_cells(kinds):
    for cfg, shape, ok, _ in all_cells():
        if ok and shape.kind in kinds:
            yield pytest.param(cfg.name, shape.name, id=f"{cfg.name}-{shape.name}")


def check_record(rec: dict) -> None:
    assert rec["status"] == "ok", rec.get("trace", rec)
    assert set(rec) >= RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS
    m = rec["memory"]
    assert 0 < m["argument_bytes"] <= m["peak_bytes"]
    assert rec["hlo_dot_flops"] > 0 and rec["device"] == "H100 80GB"
    assert rec["chips"] == 4 and rec["mesh"] == "custom_2x2"


@pytest.mark.parametrize("arch,shape", list(_reduced_cells(("prefill", "decode"))))
def test_run_cell_reduced_serving_cells(arch, shape):
    full = SHAPES[shape]
    small = SMALL["long" if shape == "long_500k" else full.kind]
    rec = run_cell(get_arch(arch).reduced(), small, mesh_shape=(2, 2))
    check_record(rec)


def test_variants_change_what_they_should():
    cfg = get_arch("smollm-360m").reduced()
    base = run_cell(cfg, SMALL["decode"], mesh_shape=(2, 2))
    fp8 = run_cell(cfg, SMALL["decode"], mesh_shape=(2, 2), variant="fp8_cache")
    naive = run_cell(cfg, SMALL["decode"], mesh_shape=(2, 2), variant="naive_cache")
    for rec in (base, fp8, naive):
        check_record(rec)
    # the bf16 cache's bytes halve in float8 (reduced models are fp32: cast
    # the cell's arch to bf16 so the cache is bf16)
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    b16 = run_cell(bf16, SMALL["decode"], mesh_shape=(2, 2))
    b8 = run_cell(bf16, SMALL["decode"], mesh_shape=(2, 2), variant="fp8_cache")
    check_record(b16)
    check_record(b8)
    from repro_torch.models.api import abstract_cache

    cache = abstract_cache(bf16, SMALL["decode"])
    # per rank: batch over data (2), sequence over model (2); bf16 is 2 bytes
    kv = sum(int(np.prod(cache[k].shape)) * 2 for k in ("k", "v")) // 4
    assert b16["memory"]["argument_bytes"] - b8["memory"]["argument_bytes"] == kv // 2
    # naive_cache keeps the whole sequence on each rank: more argument bytes
    assert naive["memory"]["argument_bytes"] > base["memory"]["argument_bytes"]
    # replicated: every rank holds the full parameters and moments
    shape = SMALL["train"]
    rep = run_cell(cfg, shape, mesh_shape=(2, 2), variant="replicated")
    check_record(rep)
    n = sum(int(np.prod(t.shape)) * t.element_size()
            for t in flatten(abstract_params(cfg)).values())
    batch = 2 * (shape.global_batch // 2) * shape.seq_len * 4
    assert rep["memory"]["argument_bytes"] == 3 * n + 4 + batch


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="variant"):
        from repro_torch.launch.dryrun import build_cell

        build_cell("smollm-360m", "train_4k", None, variant="nope")


def test_cli_writes_records_and_resumes(tmp_path):
    from repro_torch.launch import dryrun

    out = tmp_path / "dry"
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--mesh", "pod",
                 "--out", str(out)])
    rec = json.loads((out / "mamba2-130m.long_500k.pod_32x8.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["memory"]["fits"] is True
    skipped = dryrun.run_cell("smollm-360m", "long_500k", out_dir=out)
    assert skipped["status"] == "skipped"
