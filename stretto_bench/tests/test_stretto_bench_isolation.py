"""What the benchmark loads: no JAX, no JAX package, and a reference that
loads nothing of the program.

Compared by whole top-level names: `repro_torch` (the port) is not
`repro` (the JAX package). Each check runs in a fresh interpreter."""
import json
import subprocess
import sys

from stretto_bench_tiny import ROOT

BAD = ("jax", "jaxlib", "flax", "repro")

RUN_ALL = """
import json, sys, tempfile
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from stretto_bench_tiny import tiny_root
from stretto_bench import harness, run, calibrate
with tempfile.TemporaryDirectory() as t:
    root = tiny_root(t)
    bench = json.load(open(root / "BENCHMARK.json"))
    for cell in bench["workloads"]:
        c = harness.load_cell(cell["name"], root)
        c.end_to_end += c.per_layer          # every reader of the cell
        harness.run_cell(cell["name"], 5, 0.05, False, device="cpu",
                         root=root, cell=c)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}]
import torch
from stretto_bench import compare, cost, inputs, layout
from stretto_bench.reference import model as R
cfg = json.load(open({cfg!r}))
cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
           num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
           vocab_size=256)
_, params = inputs.weights(cfg, 1, "cpu")
cache = inputs.cache(cfg, [9, 20], 32, 1, "cpu", {{"k": 1.0, "v": 1.0}})
R.Reference(cfg, params).decode(cache, [9, 20], torch.tensor([[1, 2]]))
R.Reference(cfg, params, "fp8").prefill(torch.arange(20))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_runs_load_no_jax_and_no_jax_package():
    names = loaded(RUN_ALL.format(src=str(ROOT / "src"), root=str(ROOT),
                                  tests=str(ROOT / "stretto_bench" /
                                            "tests")))
    assert "repro_torch" in names and "stretto_bench" in names
    assert not set(names) & set(BAD), sorted(set(names) & set(BAD))


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE_ONLY.format(
        root=str(ROOT),
        cfg=str(ROOT / "stretto_bench" / "configs" / "granite-8b-l4.json")))
    assert "torch" in names
    assert not set(names) & set(BAD + ("repro_torch",)), names
