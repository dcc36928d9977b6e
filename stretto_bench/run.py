"""Run one cell of the benchmark once and print its result line.

    python3 stretto_bench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It makes its inputs from the seed, builds the port's kernels
into `build/kernels` in the checkout (once per checkout), warms up,
measures for `--seconds`, and with `--trace 1` traces a short window
with `torch.profiler`. Then it compares what the timed path produced
with the plain reference and prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics`
(end-to-end with trace 0, per-layer with trace 1), `device`, with trace 1
`breakdown`, and last `checks`, each compared number beside its limit.
The same numbers close standard error.

It exits non-zero and prints no result when CUDA is missing or has fewer
cards than the cell asks for, when the run fails, or when a module of
JAX or of the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the package, not this folder: its module names must not shadow others
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# every build and kernel cache at a fixed path inside the checkout
BUILD = ROOT / "build"
CACHE_DIRS = {"REPRO_TORCH_BUILD_DIR": BUILD / "kernels",
              "TRITON_CACHE_DIR": BUILD / "triton",
              "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
              "CUDA_CACHE_PATH": BUILD / "cuda_cache"}
# the port's switches: a run takes the defaults
PORT_SWITCHES = ("STRETTO_TORCH_KERNELS", "STRETTO_FUSED",
                 "STRETTO_DEVICE_CACHE", "STRETTO_ASYNC_H2D")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)
    for key in PORT_SWITCHES:
        os.environ.pop(key, None)

    import torch
    from stretto_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda", t0=T0,
                            cell=cell)
    bad = harness.bad_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"correct {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
