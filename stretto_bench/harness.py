"""Runs one cell once and builds its result line.

Everything a cell is comes from files, found by name:

  BENCHMARK.json                      cells, configurations, metrics
  stretto_bench/workloads/<cell>.json the traffic's kind, its parameters
                                      and the limits of its comparison
  stretto_bench/configs/<config>.json the configuration's published keys,
                                      its cuts and how the port names it
  stretto_bench/traffic/<kind>.py     the generator and driver of a kind
                                      of traffic: `run(ctx)` -> a record
  stretto_bench/metrics/<metric>.py   the reader of one metric:
                                      `read(record)` -> a number or None

A traffic module sets up, warms up, measures for `ctx.seconds`, traces a
short window when `ctx.trace`, reads the peak memory, frees the program's
state and then compares what the timed path produced with the plain
reference (`stretto_bench/reference`). Its record is what every reader
reads. With trace 0 the line carries the cell's end-to-end metrics, with
trace 1 its per-layer ones.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
BAD_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: dict           # the configuration file
    workload: dict        # the workload file
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path

    @property
    def params(self) -> dict:
        return self.workload["params"]


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = load_json(root / "stretto_bench" / "workloads"
                         / f"{name}.json")
    if workload["traffic"] != entry["traffic"] \
            or workload["config"] != entry["config"]:
        raise ValueError(f"{name}: the workload file names "
                         f"{workload['config']}/{workload['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/"
                         f"{entry['traffic']}")
    return Cell(name=name, chips=int(entry["chips"]),
                model=load_json(root / conf["file"]), workload=workload,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                root=root)


# ---------------------------------------------------------------------------
# the program's view of a configuration
# ---------------------------------------------------------------------------

def port_config(model: dict):
    """The port's ModelConfig for a configuration file: the registry's
    entry under `port.arch` with `port.replace` applied, checked against
    the file's published keys."""
    from repro_torch.configs import get_config
    port = model["port"]
    base = get_config(port["arch"])
    cfg = dataclasses.replace(base, **{
        k: (dataclasses.replace(getattr(base, k), **v)
            if isinstance(v, dict) else v)
        for k, v in port.get("replace", {}).items()})
    want = {"d_model": model["hidden_size"],
            "n_layers": model["num_hidden_layers"],
            "n_heads": model["num_attention_heads"],
            "vocab_size": model["vocab_size"],
            "norm_eps": model["rms_norm_eps"],
            "rope_theta": model["rope_theta"],
            "tie_embeddings": model.get("tie_word_embeddings", False),
            "dtype": model["torch_dtype"]}
    if "kv_lora_rank" in model:
        want.update({"mla.kv_lora_rank": model["kv_lora_rank"],
                     "mla.q_lora_rank": model.get("q_lora_rank") or 0,
                     "mla.qk_nope_dim": model["qk_nope_head_dim"],
                     "mla.qk_rope_dim": model["qk_rope_head_dim"],
                     "mla.v_head_dim": model["v_head_dim"]})
    else:
        want.update({"n_kv_heads": model["num_key_value_heads"],
                     "d_head": model.get("head_dim")
                     or model["hidden_size"] // model["num_attention_heads"]})
    if model.get("n_routed_experts"):
        want.update({"moe.n_experts": model["n_routed_experts"],
                     "moe.top_k": model["num_experts_per_tok"],
                     "moe.d_ff_expert": model["moe_intermediate_size"],
                     "moe.n_shared_experts": model["n_shared_experts"],
                     "moe.capacity_factor":
                         model["assumed"]["capacity_factor"]})
    else:
        want["d_ff"] = model["intermediate_size"]
    for key, value in want.items():
        got = cfg
        for part in key.split("."):
            got = getattr(got, part)
        if got != value:
            raise ValueError(f"the port's {port['arch']} has {key}={got!r}, "
                             f"the configuration file {value!r}")
    if cfg.window or cfg.global_every or cfg.global_layers:
        raise ValueError("sliding windows are not in this configuration")
    return cfg


def check_layout(cfg, model: dict) -> None:
    """The port's parameter template has the benchmark's leaves."""
    from repro_torch.models import model_template
    from stretto_bench import layout

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), tuple(v.shape)
    port = dict(walk(model_template(cfg)))
    ours = dict(layout.leaves(model))
    if port != ours:
        diff = sorted(set(port.items()) ^ set(ours.items()))
        raise ValueError(f"parameter layout differs from the port's: {diff}")


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float             # when the process began its set-up
    cfg: Any = None       # the port's ModelConfig

    @property
    def model(self) -> dict:
        return self.cell.model

    @property
    def params(self) -> dict:
        return self.cell.params


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, t0: Optional[float] = None,
             cell: Optional[Cell] = None,
             records: Optional[list] = None) -> Dict[str, Any]:
    """Run cell `name` once; returns the result line as a dict (the
    comparison's numbers last, under "checks"). The traffic's record,
    every number it read included, is appended to `records`."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or load_cell(name, root)
    dev = torch.device(device)
    ctx = Context(cell=cell, seed=int(seed), seconds=float(seconds),
                  trace=bool(trace), device=dev, t0=t0)
    ctx.cfg = port_config(cell.model)
    check_layout(ctx.cfg, cell.model)
    kind = cell.workload["kind"]
    traffic = load_module(root / "stretto_bench" / "traffic" / f"{kind}.py",
                          f"stretto_bench_traffic_{kind}")
    record = traffic.run(ctx)
    record.update(model=cell.model, params=cell.params, kind=kind)
    if records is not None:
        records.append(record)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        reader = load_module(root / "stretto_bench" / "metrics"
                             / f"{m['name']}.py",
                             "stretto_bench_metric_" + m["name"]
                             .replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = record["checks"]
    correct = record["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell.chips if dev.type == "cuda" else 1,
                "memory_peak_bytes": int(record["memory_peak_bytes"])}
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(record["attempted"]),
                            "failed": int(record["failed"]),
                            "metrics": metrics, "device": dev_info}
    if trace and record.get("trace"):
        tr = record["trace"]
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["top_ops"],
                             "idle_gaps": tr["top_gaps"]}
    line["checks"] = checks
    return line


def bad_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: `repro_torch` is not `repro`)."""
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in BAD_MODULES)
