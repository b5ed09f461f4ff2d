"""Autotune CLI: sweep the knob grid, fit the model, fill the cache.

    # the standard smoke grid, full knob grids, cache filled in place
    PYTHONPATH=src python -m repro_torch.launch.tune --smoke

    # one stack, e.g. the GW nominal encoder on the mixed backend
    PYTHONPATH=src python -m repro_torch.launch.tune --dims 1x32,32x8 \\
        --impl mixed --batch 8 --t-len 8 --balanced

The flags are the reference's (``repro.launch.tune``) plus ``--device``
(``cuda`` by default; ``cpu`` times the kernels' plain versions, which
says nothing about the card).

Cache entries are keyed by exact stack geometry, and the serving engines
plan the encoder and decoder as separate segments: tune the segment
geometries you serve (``launch.serve --plan-only`` prints them).

Each sweep times every legal knob assignment (min-of-``--k`` over
``--reps``-call batches) through the call serving uses (``autotune.sweep``),
writes the records to ``--jsonl``, fits the roofline model over them
(predicted-vs-measured error printed per record), and stores each case's
measured-best knobs in the tuned-plan cache (``--cache``; by default the
store ``plan_stack(tune="cached")`` reads).  A case whose best point is
the default gets no entry.  Entries are keyed by the device fingerprint:
run this on the card you serve on.
"""

from __future__ import annotations

import argparse


def parse_dims(text: str) -> list[tuple[int, int]]:
    """``"1x32,32x8,8x8"`` -> ``[(1, 32), (32, 8), (8, 8)]``."""
    dims = []
    for part in text.split(","):
        a, sep, b = part.strip().partition("x")
        if not sep or not a.isdigit() or not b.isdigit():
            raise ValueError(f"bad --dims segment {part!r}: want in_dimxhidden pairs like "
                             "1x32,32x8,8x8")
        dims.append((int(a), int(b)))
    return dims


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.autotune.cache import DEFAULT_CACHE_PATH

    ap = argparse.ArgumentParser(
        description="measure knob grids, fit the roofline model, cache the winners")
    ap.add_argument("--smoke", action="store_true",
                    help="run the standard smoke grid instead of a single --dims case")
    ap.add_argument("--dims", default=None,
                    help="stack geometry as in_dimxhidden pairs, e.g. 1x32,32x8,8x8")
    ap.add_argument("--impl", default="fused_step", help="backend to tune (default fused_step)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--t-len", type=int, default=8, help="chunk length timed per call")
    ap.add_argument("--weight-dtype", choices=("fp32", "bf16", "int8"), default=None)
    ap.add_argument("--k", type=int, default=5, help="min-of-k timing samples per point")
    ap.add_argument("--reps", type=int, default=5, help="calls per timing sample")
    ap.add_argument("--max-points", type=int, default=None,
                    help="thin each grid to at most N points (default: the full grid)")
    ap.add_argument("--jsonl", default="runs/autotune/sweep.jsonl",
                    help="raw sweep records land here (JSONL)")
    ap.add_argument("--cache", default=DEFAULT_CACHE_PATH, help="tuned-plan cache file to update")
    ap.add_argument("--no-cache", action="store_true",
                    help="measure and report only; leave the cache alone")
    ap.add_argument("--balanced", action="store_true",
                    help="after the fit, run the mixed-split balancer on each multi-layer "
                         "case with the fitted model and print its scores and choice")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sweep runs; cpu times the plain versions")
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns the records, the fit, each case's best and
    default record, the balancer's choices and the cache path written."""
    from repro_torch.autotune.cache import TunedPlanCache, canonical_weight_dtype, device_fingerprint
    from repro_torch.autotune.model import attach_costs, fit_roofline
    from repro_torch.autotune.sweep import (
        best_record,
        default_record,
        run_sweep,
        smoke_cases,
        sweep_case,
        write_jsonl,
    )

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.smoke == (args.dims is not None):
        ap.error("pass exactly one of --smoke or --dims")
    if args.smoke:
        cases = list(smoke_cases())
    else:
        cases = [sweep_case(parse_dims(args.dims), args.impl, batch=args.batch,
                            t_len=args.t_len, weight_dtype=args.weight_dtype)]

    print(f"device fingerprint: {device_fingerprint()} (sweeping on {args.device})")
    all_records, winners = [], []
    for case in cases:
        print(f"\n== sweep {case.tag} ==")
        records = run_sweep(case, k=args.k, reps=args.reps, max_points=args.max_points,
                            device=args.device,
                            progress=lambda r: print(f"  {r['point']:<42} {r['us']:10.1f}us"))
        all_records += records
        best, default = best_record(records), default_record(records)
        ratio = default["us"] / best["us"]
        print(f"  best: {best['point']} ({best['us']:.1f}us, {ratio:.3f}x vs default "
              f"{default['us']:.1f}us)")
        winners.append((case, best, default, ratio))

    path = write_jsonl(all_records, args.jsonl)
    print(f"\nwrote {len(all_records)} records to {path}")

    print("\n== roofline fit (predicted vs measured) ==")
    fit = fit_roofline(attach_costs(all_records))
    print(fit.describe())
    for tag, point, pred, meas, err in fit.per_record:
        print(f"  {tag:<42} {point:<28} model {pred:9.1f}us  measured {meas:9.1f}us  "
              f"({err:+.1%})")

    choices = {}
    if args.balanced:
        from repro_torch.core.stage_balance import choose_mixed_split, segment_runs

        print("\n== mixed-split balancer (fitted model) ==")
        for case in cases:
            cfgs = case.cfgs()
            if len(cfgs) < 2:
                continue  # a single layer has no interior split
            choice = choices[case.tag] = choose_mixed_split(
                cfgs, batch=case.batch, t_len=case.t_len, fit=fit)
            print(f"  {case.tag}:")
            for cand, max_us, total_us in choice.scored:
                segs = " | ".join(f"L{a}..{b - 1}:{cand[a]}" for a, b in segment_runs(cand))
                mark = " <- chosen" if cand == choice.dtypes else ""
                print(f"    {'+'.join(cand):<24} max {max_us:8.3f}us total {total_us:8.3f}us"
                      f"  [{segs}]{mark}")
            per_seg = ", ".join(f"L{a}..{b - 1}={us:.3f}us"
                                for (a, b), us in zip(choice.segments, choice.segment_us))
            print(f"    chosen split={choice.split} (per-segment predicted: {per_seg})")

    result = {"records": all_records, "fit": fit, "choices": choices,
              "winners": [(c.tag, b, d, r) for c, b, d, r in winners], "cache": None}
    if args.no_cache:
        print("\n--no-cache: tuned-plan cache left untouched")
        return result
    cache = TunedPlanCache.load(args.cache)
    stored = 0
    for case, best, default, ratio in winners:
        if not best["knobs"]:
            continue  # the default won: nothing to override
        # key under the dtype the plan request resolves to, so a sweep run
        # without --weight-dtype is found by plan_stack(tune="cached")
        cache.put(case.dims, case.impl, canonical_weight_dtype(case.cfgs(), case.weight_dtype),
                  best["knobs"],
                  meta={"best_us": best["us"], "default_us": default["us"], "ratio": ratio,
                        "point": best["point"], "batch": case.batch, "t_len": case.t_len,
                        "k": best["k"], "reps": best["reps"]})
        stored += 1
    result["cache"] = cache.save(args.cache)
    print(f"\nstored {stored} tuned entr{'y' if stored == 1 else 'ies'} ({len(cache)} total) "
          f"in {result['cache']}")
    print('serving picks them up via plan_stack(tune="cached") / launch.serve --tune cached')
    return result


if __name__ == "__main__":
    main()
