"""Dry run of every (arch x shape) cell on a pod of H100s, with no card.

The port of `repro.launch.dryrun`:

  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch

Each cell: the cell's function, argument stand-ins and shardings over the
production mesh (`build_cell`, the JAX package's knobs); per-device
argument bytes exactly from those shardings; and one step of the port's
own code traced on fake tensors (shape and dtype, no storage) under the
op counter (`launch/op_count.py`). Prefill and decode trace on fake CUDA
tensors, so they take the card's route: kernel D in prefill, kernel B
(B-int8 under kv_quant=1) in decode, each call priced by
`kernels/cost.py`, nothing built or launched. A train step traces on fake
CPU tensors: autograd records a stream per CUDA input, which a PyTorch
built without CUDA cannot give, and the train step's differentiable route
runs the same ops on any device. With microbatches, one microbatch is
traced and its counts multiplied by their number (the record says so).

The port runs no partitioned program, so the traced step's flops, bytes
and temp are split evenly over the mesh's devices (`"split": "even"`),
and collective bytes are not reckoned (`null`, which is not zero). The
roofline prices the per-device figures against `resolve_peaks(H100_SXM)`.
Every figure of a record is reckoned, none measured. Nothing touches a
device, so the dry run runs on a machine with no card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ASSIGNED, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (H100_SXM, make_production_mesh,
                                     resolve_peaks, virtual_mesh)
from repro_torch.launch.op_count import OpCounter, fake_cuda, fake_like
from repro_torch.models import layers as L
from repro_torch.models.transformer import (cache_axes, decode_step,
                                            param_axes, prefill)
from repro_torch.training.optimizer import opt_state_axes
from repro_torch.training.train_step import train_step
from repro_torch.training.tree import (leaves, leaves_with_paths, path_key,
                                       unflatten)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE); D = tokens processed."""
    n = cfg.n_active_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    tokens = shape.global_batch            # one token per item
    return 2.0 * n * tokens


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               opts: Optional[Dict[str, str]] = None):
    """Returns (fn, args_sds, in_shardings, rules), as the JAX package's.

    opts — the JAX package's knobs:
      fsdp=none|data          weight sharding over the data axis
      remat_policy=none|dots  activation-checkpoint policy
      mb=<int>                gradient-accumulation microbatches
      flash_block=<int>       blocked-attention block size (q and k)
      moe=dense|scatter|auto  MoE dispatch implementation
      moe_shard=2d            experts over data, per-expert FFN over model
      kv_quant=1              int8 KV cache for decode shapes
    """
    opts = opts or {}
    fsdp = {"none": None, "data": "data"}.get(opts.get("fsdp", "data"),
                                              "data")
    rules = SP.rules_for(cfg, shape, mesh, fsdp=fsdp)
    if opts.get("moe_shard") == "2d":
        rules["expert"] = "data"
        rules["ffe"] = "model"
    if "flash_block" in opts:
        L.FLASH_BLOCK = int(opts["flash_block"])
    if "moe" in opts:
        L.MOE_IMPL = opts["moe"]
    kv_quant = bool(int(opts.get("kv_quant", "0")))
    with sh.use_rules(rules, mesh):
        p_sds = SP.params_sds(cfg)
        p_shard = SP.shardings_for(param_axes(cfg), mesh)
        b_sds = SP.batch_sds(cfg, shape)
        b_shard = SP.shardings_for(SP.batch_axes(cfg, shape), mesh)
        if shape.kind == "train":
            o_sds = SP.opt_state_sds(cfg)
            o_shard = SP.shardings_for(opt_state_axes(param_axes(cfg)),
                                       mesh)
            # grad-accumulate in microbatches, as the JAX package's cell
            mb = int(opts.get("mb", 16))
            mb = mb if shape.global_batch % mb == 0 else 1
            fn = _train_fn(cfg, mb, opts.get("remat_policy", "none"))
            return (fn, (p_sds, o_sds, b_sds), (p_shard, o_shard, b_shard),
                    rules)
        if shape.kind == "prefill":
            def fn(params, batch):
                return prefill(params, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"))
            return fn, (p_sds, b_sds), (p_shard, b_shard), rules
        c_sds = SP.cache_sds(cfg, shape.global_batch, shape.seq_len,
                             quant=kv_quant)
        c_shard = SP.shardings_for(cache_axes(cfg, quant=kv_quant), mesh)

        def fn(params, cache, batch):
            return decode_step(params, cfg, cache,
                               tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"), uniform_pos=True)
        return fn, (p_sds, c_sds, b_sds), (p_shard, c_shard, b_shard), rules


def _train_fn(cfg: ModelConfig, mb: int, remat_policy: str):
    """`train_step(microbatches=mb)` for the trace. Under an op counter
    (`counter=`) it passes the counter's `scaled` on, so that one
    microbatch is traced and counted for all `mb`."""
    def fn(params, opt_state, batch, counter: Optional[OpCounter] = None):
        return train_step(params, opt_state, batch, cfg, microbatches=mb,
                          remat_policy=remat_policy,
                          scaled=None if counter is None else counter.scaled)
    fn.microbatches = mb
    return fn


def _sharding_leaves(tree, path=()):
    """[(path, NamedSharding)] in flatten order (a NamedSharding is a
    leaf here, not a tuple)."""
    if isinstance(tree, SP.NamedSharding):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _sharding_leaves(tree[k], path + (k,))]
    if hasattr(tree, "_fields"):
        return [pl for f, v in zip(tree._fields, tree)
                for pl in _sharding_leaves(v, path + (f,))]
    return [pl for i, v in enumerate(tree)
            for pl in _sharding_leaves(v, path + (i,))]


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's block of a (shape) array under PartitionSpec entries
    `spec`: each dim divided by the product of the mesh axes its entry
    names (rounded up where it does not divide)."""
    sizes = mesh.shape
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        out[i] = -(-out[i] // math.prod(sizes[a] for a in axes))
    return tuple(out)


def per_device_argument_bytes(args_sds, in_shardings, mesh) -> list:
    """Per argument: the bytes one device holds of it, from its
    shardings."""
    out = []
    for sds, shard in zip(args_sds, in_shardings):
        specs = {path_key(p): s.spec for p, s in _sharding_leaves(shard)}
        total = 0
        for p, t in leaves_with_paths(sds):
            local = shard_shape(tuple(t.shape), specs[path_key(p)], mesh)
            total += math.prod(local) * t.element_size()
        out.append(total)
    return out


def _to_fake(tree, device: str):
    return unflatten(tree, [fake_like(t, device) for t in leaves(tree)])


def trace_cell(fn, args_sds, device: str) -> Dict[str, Any]:
    """One call of `fn` on fake tensors like `args_sds` on `device`,
    under the op counter: its record, with the traced outputs' bytes and
    the arguments' (whole, not per device)."""
    with fake_cuda():
        args = [_to_fake(a, device) for a in args_sds]
        counter = OpCounter()
        t0 = time.perf_counter()
        with counter:
            if getattr(fn, "microbatches", 1) > 1:
                out = fn(*args, counter=counter)
            else:
                with torch.no_grad():
                    out = fn(*args)
        trace_s = time.perf_counter() - t0
        arg_ptrs = {t.untyped_storage()._cdata for t in leaves(args)}
        output = sum(t.untyped_storage().nbytes() for t in leaves(out)
                     if isinstance(t, torch.Tensor)
                     and t.untyped_storage()._cdata not in arg_ptrs)
        rec = counter.record()
        del out, args
    rec.update(trace_s=trace_s, output_bytes=output)
    return rec


def _mesh_for(multi_pod: bool, opts: Dict[str, str]):
    if "tp" not in opts:
        return make_production_mesh(multi_pod=multi_pod)
    tp = int(opts["tp"])
    per_pod = 256
    if multi_pod:
        return virtual_mesh((2, per_pod // tp, tp), ("pod", "data", "model"))
    return virtual_mesh((per_pod // tp, tp), ("data", "model"))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True,
             opts: Optional[Dict[str, str]] = None,
             n_layers: Optional[int] = None) -> Dict[str, Any]:
    """The record of one cell. `n_layers` cuts the depth (a test's or a
    card run's cut; the record says so)."""
    import dataclasses
    opts = opts or {}
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
    shape = SHAPES[shape_name]
    mesh = _mesh_for(multi_pod, opts)
    n_dev = mesh.size
    peaks = resolve_peaks(H100_SXM)
    fn, args_sds, in_shardings, rules = build_cell(cfg, shape, mesh, opts)
    arg_bytes = per_device_argument_bytes(args_sds, in_shardings, mesh)
    device = "cpu" if shape.kind == "train" else "cuda"
    tr = trace_cell(fn, args_sds, device)
    flops = tr["flops"] / n_dev
    nbytes = tr["bytes"] / n_dev
    temp = tr["peak_bytes"] / n_dev
    t_compute = flops / peaks.flops
    t_memory = nbytes / peaks.hbm_bw
    dominant = "compute" if t_compute >= t_memory else "memory"
    mf = model_flops(cfg, shape)
    names = ("params", "opt_state", "batch") if shape.kind == "train" else (
        ("params", "batch") if shape.kind == "prefill"
        else ("params", "cache", "batch"))
    rec = {
        "arch": arch, "shape": shape_name, "opts": opts,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "peaks": peaks.name,
        "n_devices": n_dev,
        "ok": True,
        "reckoned": True,
        "n_layers": cfg.n_layers,
        "trace_device": device,
        "trace_s": tr["trace_s"],
        "split": "even",
        "microbatches": {"mb": getattr(fn, "microbatches", 1),
                         "traced": 1 if getattr(fn, "microbatches", 1) > 1
                         else None},
        "per_device_bytes": {
            "arguments": sum(arg_bytes),
            "arguments_by_kind": dict(zip(names, arg_bytes)),
            "output": tr["output_bytes"] / n_dev,
            "temp": temp,
            "total": sum(arg_bytes) + temp,
        },
        "flops_per_dev": flops,
        "aten_flops_per_dev": tr["aten_flops"] / n_dev,
        "bytes_per_dev": nbytes,
        "coll_bytes_per_dev": None,
        "op_counts": tr["op_counts"],
        "kernel_calls": tr["kernel_calls"],
        "roofline": {
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": None,
            "dominant": dominant,
            "bound_s": max(t_compute, t_memory),
        },
        "model_flops_total": mf,
        "model_flops_per_dev": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / flops if flops else 0.0,
    }
    if n_layers is not None:
        rec["cut"] = f"depth {cfg.n_layers} of {get_config(arch).n_layers}"
    if verbose:
        print(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--opt", action="append", default=[],
                    help="perf knob key=val (repeatable)")
    ap.add_argument("--tag", type=str, default="",
                    help="suffix for output filenames")
    args = ap.parse_args(argv)
    opts = dict(kv.split("=", 1) for kv in args.opt)

    if args.all:
        cells = [(arch, s.name) for arch in ASSIGNED
                 for s in applicable_shapes(get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    records = []
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           verbose=not args.out, opts=opts)
        except Exception as e:  # noqa: BLE001 — record the failure
            rec = {"arch": arch, "shape": shape, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(rec))
        records.append(rec)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            tag = "mp" if args.multi_pod else "sp"
            if args.tag:
                tag += "__" + args.tag
            with open(f"{args.out}/{arch}__{shape}__{tag}.json", "w") as f:
                json.dump(rec, f, indent=2)
            print(f"[dryrun] {arch} x {shape} ({tag}) -> "
                  f"{'OK' if rec.get('ok') else 'FAIL'}")
    return records


if __name__ == "__main__":
    main()
