#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the fused LSTM-stack kernels from ``src/repro_torch``, holds each
kernel against its plain PyTorch version at the GW nominal shapes, drives
the serving path (batch scoring, streaming pushes, push_many) at the full
``gw_nominal`` width with weights from the golden fixture
(``tests/data/torch_port_gw_nominal.npz``, produced by the JAX reference),
checks the scores against the reference's, and times the kernels beside
their plain versions, their bound and cuDNN's LSTM.  Every phase raises on
failure; the last line is ``{"ok": true, "device": {...}}``.  Needs one
CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_port_gw_nominal.npz"
TOL = dict(rtol=1e-5, atol=1e-5)            # kernel outputs and engine scores
STREAM_TOL = dict(rtol=1e-6, atol=1e-7)     # chunked streaming vs one-shot

#: H100 SXM peaks (NVIDIA data sheet, dense): the kernels run on the fp32
#: CUDA cores, not the tensor cores
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, kernel: str | None = None) -> float | None:
    """Device time per call of ``fn`` from ``torch.profiler``: the device
    kernels whose name contains ``kernel`` (all of them if None), summed and
    divided by ``reps``.  None when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and (kernel is None or kernel in e.name)
    )
    return total_us / reps / 1e3 if total_us > 0 else None


def bound(step: bool, L: int, W: int, T: int, B: int, w_bytes: int) -> tuple[float, str]:
    """Least time the card needs for one call: bytes over the memory rate
    vs fp32 operations over the fp32 peak; returns (ms, "bytes"|"operations").

    Bytes count each input read once and each output written once.
    Operations count 2 per multiply-add of the gate products (layer 0's
    input product only in the step kernel; the wavefront kernel receives
    it), 4 per gate pre-activation and 10 per cell element.
    """
    w4 = 4 * W
    inputs = (B * T * W * 4 if step else T * B * w4 * 4) + 2 * L * W * w4 * w_bytes \
        + L * w4 * 4 + L * 8 * 4 + 2 * L * B * W * 4
    outputs = B * T * W * 4 + 2 * L * B * W * 4
    macs = T * B * W * w4 * (2 * L if step else 2 * L - 1)
    ops = 2 * macs + T * B * L * (4 * w4 + 10 * W)
    t_bytes, t_ops = (inputs + outputs) / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gw import GW_MODELS
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.autoencoder import decoder_layers, encoder_layers
    from repro_torch.core.quant import EXACT, PAPER_HW_KERNEL, make_act_quant
    from repro_torch.device import resolve_device
    from repro_torch.kernels.lstm_stack.lstm_stack import library, lstm_stack
    from repro_torch.kernels.lstm_stack.ops import pack_stack, project_layer0
    from repro_torch.kernels.lstm_stack.ref import lstm_stack_ref
    from repro_torch.kernels.lstm_stack.step import lstm_stack_step, lstm_stack_step_plain
    from repro_torch.serve.engine import AnomalyStreamEngine, StreamingAnomalyEngine

    # the wrapper modules, whose plain-version references phase 5 blocks
    k1_mod = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]
    k2_mod = sys.modules["repro_torch.kernels.lstm_stack.step"]

    # -- phase 1: environment ----------------------------------------------
    dev = resolve_device("cuda")  # also switches TF32 off for matmul and cuDNN
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    built = library()
    log(f"phase 2 build ok: {built.path.name}, nvcc {built.seconds:.1f} s, "
        f"load {time.perf_counter() - t0:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line:
            log("  ptxas: " + line.strip())

    with np.load(FIXTURE) as data:
        golden = {k: data[k] for k in data.files}
    tree: dict = {}
    for key, value in golden.items():
        if key.startswith("params/"):
            _, layer, name = key.split("/")
            tree.setdefault(layer, {})[name] = value
    params = params_from_numpy(tree, dev)
    cfg = GW_MODELS["gw_nominal"]
    T = cfg.timesteps

    def packs(wd):
        c = dataclasses.replace(cfg, weight_dtype=wd)
        return {"enc": pack_stack(*encoder_layers(params, c)),
                "dec": pack_stack(*decoder_layers(params, c))}

    gen = torch.Generator().manual_seed(0)

    def segment_input(seg, pk, batch, t_len):
        """Main-path-shaped input of a segment, padded to the pack width:
        strain windows for the encoder, a repeated latent for the decoder."""
        if seg == "enc":
            x = torch.randn(batch, t_len, 1, generator=gen)
        else:
            x = (torch.rand(batch, 1, pk.in_dims[0], generator=gen) * 2 - 1).expand(
                batch, t_len, pk.in_dims[0])
        return pk.pad_input(x.to(dev))

    def state(pk, batch):
        shape = (pk.n_layers, batch, pk.width_p)
        return ((torch.randn(shape, generator=gen) * 0.3).to(dev),
                (torch.randn(shape, generator=gen) * 0.3).to(dev))

    def plain_kw(pk, acts, act_bits):
        return dict(scales=pk.stacked.get("scales"), sigma=acts.sigma, tanh=acts.tanh,
                    act_quant=make_act_quant(act_bits) if act_bits else None)

    def compare(got, want, what):
        err = 0.0
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"{what}: {m}")
            err = max(err, (a.float() - b.float()).abs().max().item())
        return err

    all_packs = {wd: packs(wd) for wd in ("fp32", "bf16", "int8")}
    matrix = [(wd, acts, bits) for wd in all_packs for acts in (EXACT, PAPER_HW_KERNEL)
              for bits in (None, 16)]

    # -- phase 3: K1 against its plain version -----------------------------
    t0, k1_err, n = time.perf_counter(), 0.0, 0
    for wd, acts, bits in matrix:
        for seg, pk in all_packs[wd].items():
            s = pk.stacked
            for batch in (1, 64):
                xw0 = project_layer0(segment_input(seg, pk, batch, T), s, wd)
                h0, c0 = state(pk, batch)
                got = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                 scales=s.get("scales"), acts=acts, act_bits=bits)
                want = lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0,
                                      **plain_kw(pk, acts, bits))
                torch.cuda.synchronize()
                k1_err = max(k1_err, compare(got, want, f"K1 {wd} {acts.name} {bits} {seg} B={batch}"))
                n += 1
    log(f"phase 3 K1 ok: {n} cases, max |kernel - plain| = {k1_err:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 4: K2 against its plain version -----------------------------
    t0, k2_err, n = time.perf_counter(), 0.0, 0
    for wd, acts, bits in matrix:
        for seg, pk in all_packs[wd].items():
            s = pk.stacked
            for t_len in (1, 25, 32):
                for batch in (1, 8, 64):
                    xs = segment_input(seg, pk, batch, t_len)
                    h0, c0 = state(pk, batch)
                    got = lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0,
                                          scales=s.get("scales"), acts=acts, act_bits=bits)
                    want = lstm_stack_step_plain(xs, s["w_x"], s["w_h"], s["b"], h0, c0,
                                                 **plain_kw(pk, acts, bits))
                    torch.cuda.synchronize()
                    k2_err = max(k2_err, compare(
                        got, want, f"K2 {wd} {acts.name} {bits} {seg} T={t_len} B={batch}"))
                    n += 1
    log(f"phase 4 K2 ok: {n} cases, max |kernel - plain| = {k2_err:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 5: the serving path at full gw_nominal width ----------------
    def refuse_plain(*args, **kwargs):
        raise AssertionError("the main path reached a plain version on the card")

    saved = (k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain)
    k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain = refuse_plain, refuse_plain
    lstm_stack.launches = lstm_stack_step.launches = 0
    t0 = time.perf_counter()
    windows = golden["windows"]
    n_bg = int(golden["n_background"])
    for wd in ("fp32", "bf16", "int8"):
        c = dataclasses.replace(cfg, weight_dtype=wd)
        batch_eng = AnomalyStreamEngine(params, c, impl="fused_stack")
        assert batch_eng.effective_impl == "fused_stack", batch_eng.effective_impl
        np.testing.assert_allclose(batch_eng.score(windows), golden[f"scores/{wd}"], **TOL,
                                   err_msg=f"batch scores vs reference, {wd}")
        lock = StreamingAnomalyEngine(params, c, batch=len(windows))
        streamed = []
        for pos in range(0, T, 25):
            streamed += lock.push(windows[:, pos : pos + 25])
        np.testing.assert_allclose(streamed[0], golden[f"streamed/{wd}"], **TOL,
                                   err_msg=f"streamed scores vs reference, {wd}")
    eng = StreamingAnomalyEngine(params, cfg, batch=1)
    assert eng.effective_impl == "fused_step", eng.effective_impl
    threshold = eng.calibrate(windows[:n_bg], fpr=0.1)
    flags = eng.flag(windows)
    one_shot = eng.score(windows[:1])
    by_25 = [s for pos in range(0, T, 25) for s in eng.push(windows[:1, pos : pos + 25])]
    by_1 = [s for pos in range(T) for s in eng.push(windows[:1, pos : pos + 1])]
    for got in (by_25, by_1):
        assert len(got) == 1
        np.testing.assert_allclose(got[0], one_shot, **STREAM_TOL,
                                   err_msg="chunked streaming vs one-shot")
    n_streams = 8
    rng = np.random.RandomState(0)
    x = np.concatenate([windows[:n_streams], windows[n_streams : 2 * n_streams]], axis=1)
    x = x + rng.randn(*x.shape).astype(np.float32) * 0.01
    ids = [f"det{i}" for i in range(n_streams)]
    lead = 3  # three streams start 7 samples ahead: ragged fill levels
    pool = StreamingAnomalyEngine(params, cfg, batch=1)
    pool.push_many(ids[:lead], x[:lead, :7])
    got = {sid: [] for sid in ids}
    starts = [7 if i < lead else 0 for i in range(n_streams)]
    for a, b in ((0, 1), (1, 26), (26, 50), (50, 2 * T - 7)):
        res = pool.push_many(ids, np.stack([x[i, s + a : s + b] for i, s in enumerate(starts)]))
        for sid in ids:
            got[sid] += res[sid]
    seq = StreamingAnomalyEngine(params, cfg, batch=1)
    for i, sid in enumerate(ids):
        seq.reset()  # the same chunks, pushed by one stream alone
        cuts = ([0] if starts[i] else []) + [starts[i] + a for a in (0, 1, 26, 50, 2 * T - 7)]
        want = [sc for a, b in zip(cuts, cuts[1:]) for sc in seq.push(x[i : i + 1, a:b])]
        assert len(got[sid]) == len(want) >= 1, (sid, len(got[sid]), len(want))
        for g, w in zip(got[sid], want):
            np.testing.assert_array_equal(g, w, err_msg="push_many vs sequential pushes")
    torch.cuda.synchronize()
    launches = {"lstm_stack_wavefront": lstm_stack.launches,
                "lstm_stack_step": lstm_stack_step.launches}
    k1_mod.lstm_stack_ref, k2_mod.lstm_stack_step_plain = saved
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the serving path never launched {name}")
    log(f"phase 5 engine ok: scores match the reference (fp32/bf16/int8), threshold "
        f"{threshold:.6g} flags {int(flags.sum())}/{len(flags)}, push_many bit-equal over "
        f"{n_streams} streams, launches {launches} ({time.perf_counter() - t0:.1f} s)")

    # launches per scored window by streaming mode, and per batch score call
    per_window = {}
    for mode, chunk in (("push_T1", 1), ("push_T25", 25)):
        lstm_stack.launches = lstm_stack_step.launches = 0
        for pos in range(0, T, chunk):
            eng.push(windows[:1, pos : pos + chunk])
        per_window[mode] = (lstm_stack.launches, lstm_stack_step.launches)
    lstm_stack.launches = lstm_stack_step.launches = 0
    eng.score(windows)
    per_window[f"score_call_B{len(windows)}"] = (lstm_stack.launches, lstm_stack_step.launches)

    # -- phase 6: timing ---------------------------------------------------
    t0 = time.perf_counter()
    enc = all_packs["fp32"]["enc"]
    s = enc.stacked
    L, W = enc.n_layers, enc.width_p
    lib_lstm = torch.nn.LSTM(W, W, num_layers=L).to(dev)
    with torch.no_grad():
        for l in range(L):
            getattr(lib_lstm, f"weight_ih_l{l}").copy_(s["w_x"][l].T)
            getattr(lib_lstm, f"weight_hh_l{l}").copy_(s["w_h"][l].T)
            getattr(lib_lstm, f"bias_ih_l{l}").copy_(s["b"][l])
            getattr(lib_lstm, f"bias_hh_l{l}").zero_()
    rows = {"lstm_stack_wavefront": [], "lstm_stack_step": []}
    for name, t_len, batch in (("lstm_stack_wavefront", T, 1), ("lstm_stack_wavefront", T, 64),
                               ("lstm_stack_step", 1, 1), ("lstm_stack_step", 25, 1),
                               ("lstm_stack_step", 1, 64), ("lstm_stack_step", 25, 64)):
        xs = segment_input("enc", enc, batch, t_len)
        h0, c0 = state(enc, batch)
        if name == "lstm_stack_wavefront":
            xw0 = project_layer0(xs, s, "fp32")
            kernel = lambda: lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
            plain = lambda: lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
        else:
            kernel = lambda: lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
            plain = lambda: lstm_stack_step_plain(xs, s["w_x"], s["w_h"], s["b"], h0, c0)  # noqa: E731
        x_tb = xs.transpose(0, 1).contiguous()
        lib_call = lambda: lib_lstm(x_tb, (h0, c0))  # noqa: E731
        with torch.no_grad():
            ours = lstm_stack_step(xs, s["w_x"], s["w_h"], s["b"], h0, c0) if t_len <= 32 \
                else lstm_stack(project_layer0(xs, s, "fp32"), s["w_x"], s["w_h"], s["b"], h0, c0)
            lib_err = (lib_call()[1][1] - ours[2]).abs().max().item()
            lib_ms = median_ms(lib_call, reps=50)
            lib_dev = device_ms(lib_call, reps=50)
        b_ms, b_by = bound(name == "lstm_stack_step", L, W, t_len, B=batch, w_bytes=4)
        call_ms = median_ms(kernel, reps=50)
        ms = device_ms(kernel, reps=50, kernel="lstm_stack_kernel")
        rows[name].append({
            "T": t_len, "B": batch,
            "ms": ms if ms is not None else call_ms,
            "ms_source": "profiler" if ms is not None else "events",
            "call_ms": call_ms, "plain_ms": median_ms(plain, reps=3, warmup=1),
            "library_ms": lib_dev if lib_dev is not None else lib_ms,
            "library_call_ms": lib_ms, "library_max_abs_err_c": lib_err,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    # end to end, host clock: one T=1 push (a window completion every T
    # pushes runs the decoder), and one batch score call
    push_ms = []
    for pos in range(2 * T):
        t1 = time.perf_counter()
        eng.push(windows[:1, pos % T : pos % T + 1])
        torch.cuda.synchronize()
        push_ms.append((time.perf_counter() - t1) * 1e3)
    batch_eng = AnomalyStreamEngine(params, cfg, impl="fused_stack")
    score_ms = []
    for _ in range(20):
        t1 = time.perf_counter()
        batch_eng.score(windows)
        score_ms.append((time.perf_counter() - t1) * 1e3)
    log(json.dumps({"e2e": {
        "push_T1_B1_ms_median": statistics.median(push_ms),
        "push_T1_B1_ms_p99": float(np.percentile(push_ms, 99)),
        f"score_B{len(windows)}_T{T}_ms_median": statistics.median(score_ms[2:]),
    }}))
    log(f"phase 6 timing ok ({time.perf_counter() - t0:.1f} s)")

    kernels = []
    for name, err, replaces, mode in (
        ("lstm_stack_wavefront", k1_err, "src/repro/kernels/lstm_stack/lstm_stack.py:165",
         "push_T1"),
        ("lstm_stack_step", k2_err, "src/repro/kernels/lstm_stack/step.py:210", "push_T1"),
    ):
        head = rows[name][0]  # the B=1 streaming shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/lstm_stack/csrc/lstm_stack.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "launches_per_window": {m: v[0 if name == "lstm_stack_wavefront" else 1]
                                    for m, v in per_window.items()},
            "shapes": rows[name],
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
