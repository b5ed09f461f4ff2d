"""The dry run's cost accounting (``analysis/costs.py``), the port's
counterpart of ``repro/analysis/hlo.py``.

* A loop of L matmuls counts L x 2d^3 dot FLOPs; code without dots
  counts 0; the fused attention's FLOPs count every query head.
* A known all-gather and all-reduce over 8 fake ranks count their result
  bytes times (n-1)/n and 2(n-1)/n.
* The twin of the reference's dry-run smoke (reduced granite-3-2b, vocab
  512, S=64, B=8, mesh (4, 2)): the port's per-rank argument bytes equal
  the reference's 164,612 and its dot FLOPs are within 2% of those the
  reference's HLO analysis gives for its compiled step (computed in a
  process of its own: importing the reference's dry run rewrites
  ``XLA_FLAGS``, and the mesh needs 8 host devices; the mesh's axes are
  ``Auto``, as the reference's ``with_sharding_constraint`` needs).
* The train cell of every reduced arch over a fake (2, 2) mesh: a record
  with every key, FLOPs, and the FSDP collectives (all-gathers of the
  weights, reduce-scatters of their gradients).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis.costs import Costs, CostCounter, argument_bytes, measure
from repro_torch.configs import all_cells, get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import fake_world, run_cell

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dryrun import SMALL, check_record  # noqa: E402


@pytest.fixture(autouse=True)
def _no_process_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group initialised"


@pytest.mark.parametrize("n_layers", [2, 8])
def test_loop_of_matmuls_counts_each(n_layers):
    d = 64
    x, ws = torch.randn(d, d), torch.randn(n_layers, d, d)

    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    _, costs = measure(f, x, ws)
    assert costs.dot_flops == n_layers * 2 * d**3


def test_no_dots_no_flops():
    _, costs = measure(lambda x: torch.sin(x).sum(), torch.randn(128))
    assert costs.dot_flops == 0.0 and costs.collective_count == 0
    assert costs.argument_bytes == 128 * 4 and costs.peak_bytes >= 128 * 4


def test_attention_counts_every_query_head():
    b, hq, hkv, s, d = 2, 8, 2, 16, 32
    q, k, v = torch.randn(b, hq, s, d), torch.randn(b, hkv, s, d), torch.randn(b, hkv, s, d)
    counted = Costs()
    with CostCounter(counted):
        torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True)
    assert counted.dot_flops == 2 * 2 * b * hq * s * s * d


def test_collectives_count_ring_bytes():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    n = 8
    with fake_world(n):
        mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("data",))
        t = distribute_tensor(torch.randn(n * 4, 16), mesh, (Shard(0),), src_data_rank=None)
        assert argument_bytes({"t": t}) == 4 * 16 * 4
        costs = Costs()
        with CostCounter(costs):
            full = t.redistribute(mesh, (Replicate(),)).to_local()
        assert tuple(full.shape) == (n * 4, 16)
        assert costs.collective_bytes["all-gather"] == n * 4 * 16 * 4 * (n - 1) / n
        costs = Costs()
        with CostCounter(costs):
            (t.sum()).full_tensor()  # a partial sum reduced over the 8 ranks
        assert costs.collective_bytes["all-reduce"] == 4 * 2 * (n - 1) / n
        assert costs.collective_count == 1


_REFERENCE_TWIN = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.analysis.hlo import analyze_hlo
from repro.configs import get_arch
from repro.configs.base import InputShape
from repro.launch.sharding import batch_shardings, opt_shardings, param_shardings
from repro.models.api import abstract_params, get_model, input_specs
from repro.models.layers import ShardCtx
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.step import make_train_step

mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_arch("granite-3-2b").reduced(), vocab=512)
api = get_model(cfg)
shape = InputShape("smoke", seq_len=64, global_batch=8, kind="train")
ctx = ShardCtx(mesh=mesh, data_axes=("data",))
params_abs = abstract_params(cfg)
p_sh = param_shardings(mesh, params_abs, mode="train")
opt_abs = jax.eval_shape(lambda p: init_opt_state(p), params_abs)
o_sh = opt_shardings(mesh, opt_abs, p_sh)
batch_abs = input_specs(cfg, shape)
b_sh = batch_shardings(mesh, batch_abs, shape)
step = make_train_step(lambda p, b: api.loss_fn(p, b, cfg, ctx), AdamWConfig())
fn = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh),
             out_shardings=(NamedSharding(mesh, P()), p_sh, o_sh), donate_argnums=(0, 1))
compiled = fn.lower(params_abs, opt_abs, batch_abs).compile()
print("TWIN " + json.dumps({"dot_flops": analyze_hlo(compiled.as_text()).dot_flops,
                            "argument_bytes": compiled.memory_analysis().argument_size_in_bytes}))
"""


def test_twin_of_the_reference_dryrun_smoke():
    pytest.importorskip("jax")
    from repro.launch.subproc import child_env as ref_child_env

    r = subprocess.run([sys.executable, "-c", _REFERENCE_TWIN], cwd=ROOT, env=ref_child_env(),
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("TWIN ")]
    assert lines, r.stderr[-3000:]
    ref = json.loads(lines[-1][len("TWIN "):])
    assert ref["argument_bytes"] == 164_612
    cfg = dataclasses.replace(get_arch("granite-3-2b").reduced(), vocab=512)
    rec = run_cell(cfg, InputShape("smoke", 64, 8, "train"), mesh_shape=(4, 2))
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["memory"]["argument_bytes"] == 164_612
    assert abs(rec["hlo_dot_flops"] - ref["dot_flops"]) <= 0.02 * ref["dot_flops"]


@pytest.mark.parametrize("arch", [cfg.name for cfg, shape, ok, _ in all_cells()
                                  if ok and shape.kind == "train"])
def test_run_cell_reduced_train_cells(arch):
    rec = run_cell(get_arch(arch).reduced(), SMALL["train"], mesh_shape=(2, 2))
    check_record(rec)
    assert rec["collective_bytes"]["all-gather"] > 0
    assert rec["collective_bytes"]["reduce-scatter"] > 0
    # train arguments: params and AdamW state are donated (the reference's alias)
    assert 0 < rec["memory"]["alias_bytes"] < rec["memory"]["argument_bytes"]
