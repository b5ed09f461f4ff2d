"""The dry run's cells run for real on the card (phases 32-33 of
``chip_smoke.py`` at a reduced size).

Marked ``gpu``: each test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside the ``cuda``
fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dryrun_cuda.py

An NCCL process group of one rank and ``make_host_mesh()`` on the card
((1, 1), ("data", "model")), created and destroyed by each test:

* the train cell of reduced smollm-360m (fp32, S=64, B=8) through
  ``build_cell``: 3 steps of DTensor parameters and AdamW against the
  plain step from the same parameters: losses within 1e-6 and the state
  within 1e-5 of each leaf's largest |value|;
* the decode cell (serve rules, a 128-row cache after a 16-token prompt,
  4 steps) against ``LmEngine``'s plain path under teacher forcing,
  within 1e-5 of the largest |logit|;
* the dry run's predicted argument bytes of both cells equal the real
  ones (the same cells traced on fake CPU tensors over a fake (1, 1)
  mesh, in a process of their own).
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis.costs import argument_bytes
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.data.lm import LmDataConfig, lm_batch
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import distribute
from repro_torch.launch.subproc import child_env
from repro_torch.models.api import get_model
from repro_torch.serve.engine import LmEngine
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
TRAIN = InputShape("train_4k", 64, 8, "train")
DECODE = InputShape("decode_32k", 128, 8, "decode")

_PREDICT = r"""
import json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_cell
out = {}
for name, seq, batch, kind in (("train_4k", 64, 8, "train"), ("decode_32k", 128, 8, "decode")):
    rec = run_cell(get_arch("smollm-360m").reduced(), InputShape(name, seq, batch, kind),
                   mesh_shape=(1, 1))
    out[kind] = rec["memory"]["argument_bytes"] if rec["status"] == "ok" else rec
print("PREDICTED " + json.dumps(out))
"""


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def predicted():
    r = subprocess.run([sys.executable, "-c", _PREDICT], cwd=ROOT, env=child_env(),
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("PREDICTED ")]
    assert lines, r.stderr[-3000:]
    return json.loads(lines[-1][len("PREDICTED "):])


@pytest.mark.gpu
def test_train_cell_matches_the_plain_step(mesh, predicted):
    cfg = get_arch("smollm-360m").reduced()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device="cuda")
    opt = init_opt_state(params)
    data = LmDataConfig(vocab=cfg.vocab, seq_len=TRAIN.seq_len, global_batch=TRAIN.global_batch)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in lm_batch(data, i).items()}
               for i in range(3)]
    cell = build_cell(cfg, TRAIN, mesh, state=(params, opt, batches[0]))
    assert argument_bytes(*cell.args) == predicted["train"]
    args = cell.args
    plain = make_train_step(lambda p, b: api.loss_fn(p, b, cfg), AdamWConfig())
    p, o = params, opt
    for i, b in enumerate(batches):
        if i:
            args = (args[0], args[1], distribute(mesh, b, cell.specs[2]))
        loss_d, p_d, o_d = cell.fn(*args)
        args = (p_d, o_d, None)
        loss, p, o = plain(p, o, b)
        assert abs(float(loss_d.full_tensor()) - float(loss)) <= 1e-6 * abs(float(loss))
    got, want = flatten({"p": p_d, "o": o_d}), flatten({"p": p, "o": o})
    for k, w in want.items():
        err = (got[k].full_tensor().float() - w.float()).abs().max().item()
        assert err <= 1e-5 * max(w.float().abs().max().item(), 1e-30), k


@pytest.mark.gpu
def test_decode_cell_matches_the_plain_engine(mesh, predicted):
    cfg = get_arch("smollm-360m").reduced()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device="cuda")
    toks = lm_batch(LmDataConfig(vocab=cfg.vocab, seq_len=21, global_batch=8), 0)["tokens"]
    prompt, follow = toks[:, :16], toks[:, 16:]
    want = LmEngine(params, cfg, max_len=DECODE.seq_len, device="cuda", use_kernel=False,
                    graphs=False).teacher_forced(prompt, follow)[1]
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": torch.as_tensor(prompt).cuda()}, cfg,
                               DECODE.seq_len)
        first = {"tokens": torch.as_tensor(follow[:, :1]).cuda()}
        cell = build_cell(cfg, DECODE, mesh, state=(params, cache, first))
        assert argument_bytes(*cell.args) == predicted["decode"]
        p_d, c_d = cell.args[0], cell.args[1]
        for i in range(4):
            b = distribute(mesh, {"tokens": torch.as_tensor(follow[:, i:i + 1]).cuda()},
                           cell.specs[2])
            logits, c_d = cell.fn(p_d, c_d, b)
            got = logits.full_tensor()[:, 0].float()
            assert (got - want[i]).abs().max().item() <= 1e-5 * want[i].abs().max().item(), i
