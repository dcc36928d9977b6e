"""Readings for the limits of a cell's comparison (run on the card).

    python3 stretto_bench/calibrate.py --workload <cell> \\
        --seeds 11,12,... --control-seeds 21,22,23 [--seconds 2]

For each of `--seeds` it runs the cell as `run.py` does, with a short
window, and prints the numbers its comparison read; for each of
`--control-seeds` it reads the same numbers of the control, the plain
reference computed in float8 (e4m3) in the program's place. One JSON
line per reading, then a summary line: per number, the largest reading
of sound runs (the lower reading) and the smallest of the control (the
upper reading). A limit is set between the two (PERF.md). The
benchmark's own runs never run this.
"""
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import os
    from stretto_bench import run as run_mod
    for key, path in run_mod.CACHE_DIRS.items():
        os.environ[key] = str(path)
    import torch
    from stretto_bench import devtrace, harness
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    low, high = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        records = []
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                cell=cell, records=records)
        vals = records[0]["values"]
        for k, v in vals.items():
            low[k] = max(low.get(k, 0.0), v)
        print(json.dumps({"seed": seed, "program": vals,
                          "metrics": line["metrics"],
                          "s": time.perf_counter() - t0}), flush=True)
        devtrace.free("cuda")
    kind = cell.workload["kind"]
    traffic = harness.load_module(HERE / "traffic" / f"{kind}.py",
                                  f"stretto_bench_traffic_{kind}")
    for seed in controls:
        t0 = time.perf_counter()
        ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                              device=torch.device("cuda"), t0=t0)
        ctx.cfg = harness.port_config(cell.model)
        vals = traffic.control(ctx)
        for k, v in vals.items():
            high[k] = min(high.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "control": vals,
                          "s": time.perf_counter() - t0}), flush=True)
        devtrace.free("cuda")
    print(json.dumps({"workload": args.workload, "lower": low,
                      "upper": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
