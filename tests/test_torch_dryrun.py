"""The port's launch tooling against the JAX package's, on the CPU.

`repro.launch.dryrun` sets XLA_FLAGS to 512 host devices when it is
imported, which would change every later test on the same worker, so one
subprocess imports it and prints, as JSON: `model_flops` of every
ASSIGNED x applicable_shapes cell, each cell's per-device argument bytes
on both production meshes (the JAX package's `build_cell` stand-ins and
shardings, `NamedSharding.shard_shape` of each leaf; nothing is
compiled), its sharding rules, and the peak sets under the roofline env
overrides. The port must equal all of these exactly.

The op counter is held to `repro.launch.hlo_stats.analyze` of the JAX
package's compiled step on a 2-layer granite cut (d_model 64, float32,
the JAX weights carried across), on the CPU route. Decode and a train
step (remat off) count the same dot flops exactly. Prefill differs by
one term only: the JAX package computes the logits at every position and
keeps the last, the port only at the last, so hlo_stats counts
2 B (S - 1) d V flops more; after that term the two are equal.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import REGISTRY as JREGISTRY
from repro.launch.hlo_stats import analyze
from repro.models import transformer as jT
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import ASSIGNED, REGISTRY, SHAPES, \
    applicable_shapes, get_config
from repro_torch.kernels import build, cost, ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_count as OC
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": False, "2x16x16": True}
ENVS = {"none": {}, "gflops": {"STRETTO_ROOFLINE_GFLOPS": "500"},
        "bw": {"STRETTO_ROOFLINE_BW_GBS": "1200"},
        "both": {"STRETTO_ROOFLINE_GFLOPS": "1.5",
                 "STRETTO_ROOFLINE_BW_GBS": "7"}}

_JAX_SIDE = r"""
import dataclasses, json, os, sys
from repro.launch import dryrun as D     # sets the 512-device flag first
import jax
import numpy as np
from repro.configs import ASSIGNED, applicable_shapes, get_config
from repro.launch import mesh as M
envs = json.loads(sys.argv[1])
meshes = {"16x16": M.make_production_mesh(),
          "2x16x16": M.make_production_mesh(multi_pod=True)}
out = {"flops": {}, "bytes": {}, "rules": {}, "peaks": {}}
for arch in ASSIGNED:
    cfg = get_config(arch)
    out.setdefault("shapes", {})[arch] = [
        s.name for s in applicable_shapes(cfg)]
    for shape in applicable_shapes(cfg):
        key = f"{arch}/{shape.name}"
        out["flops"][key] = D.model_flops(cfg, shape)
        for name, mesh in meshes.items():
            fn, args, shards, rules = D.build_cell(cfg, shape, mesh)
            out["bytes"][f"{key}/{name}"] = [
                sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                    for x, s in zip(jax.tree.leaves(a), jax.tree.leaves(sh)))
                for a, sh in zip(args, shards)]
            out["rules"][f"{key}/{name}"] = {
                k: list(v) if isinstance(v, tuple) else v
                for k, v in rules.items()}
for name, env in envs.items():
    for k in ("STRETTO_ROOFLINE_GFLOPS", "STRETTO_ROOFLINE_BW_GBS"):
        os.environ.pop(k, None)
    os.environ.update(env)
    out["peaks"][name] = {
        "tpu": dataclasses.asdict(M.resolve_peaks(M.TPU_V5E)),
        "cpu": dataclasses.asdict(M.resolve_peaks())}
out["peaks"]["sets"] = {"TPU_V5E": dataclasses.asdict(M.TPU_V5E),
                        "CI_CPU": dataclasses.asdict(M.CI_CPU)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_side_proc():
    """The JAX package's side, started with the module's first test so
    it runs beside the in-process tests (its tests come last)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("STRETTO_ROOFLINE")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE,
                             json.dumps(ENVS)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_side(_jax_side_proc):
    out, err = _jax_side_proc.communicate(timeout=300)
    assert _jax_side_proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_n_active_params_and_shapes_match_jax(arch):
    j, t = JREGISTRY[arch], REGISTRY[arch]
    assert t.n_active_params == j.n_active_params
    assert t.n_params == j.n_params
    from repro.configs import applicable_shapes as japplicable
    assert [s.name for s in applicable_shapes(t)] == \
        [s.name for s in japplicable(j)]


def test_production_mesh_is_virtual():
    m = tmesh.make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.devices[1][15][15] == torch.device("meta")
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}


# ---------------------------------------------------------------------------
# a small granite cut, the JAX weights carried across
# ---------------------------------------------------------------------------

B, S, M = 2, 16, 32


def _jax_tree(tree):
    return {k: _jax_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def granite():
    """(JAX config, params, compiled prefill and decode, port config,
    params, tokens). The weights are drawn once (the port's init, carried
    to JAX as numpy); the JAX steps are compiled once, their HLO read by
    hlo_stats and their executables run."""
    jcfg = JREGISTRY["granite-8b"].reduced(dtype="float32")
    cfg = REGISTRY["granite-8b"].reduced(dtype="float32")
    tp = tT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = _jax_tree(tp)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jt = jnp.asarray(toks)
    pre = jax.jit(lambda p, t: jT.prefill(p, jcfg, tokens=t, max_len=M)) \
        .lower(jp, jt).compile()
    _, jc = pre(jp, jt)
    dec = jax.jit(lambda p, c, t: jT.decode_step(
        p, jcfg, c, tokens=t, uniform_pos=True)).lower(jp, jc,
                                                       jt[:, :1]).compile()
    return dict(jcfg=jcfg, jp=jp, pre=pre, dec=dec, jc=jc, cfg=cfg, tp=tp,
                toks=toks)


def _port_cache(g, full=False):
    _, tc = tT.prefill(g["tp"], g["cfg"],
                       tokens=torch.from_numpy(g["toks"]).long(), max_len=M)
    if full:
        tc["lengths"] = torch.full((B,), M, dtype=torch.int32)
    return tc


def test_decode_uniform_pos_matches_jax(granite):
    g = granite
    jl, jnew = g["dec"](g["jp"], g["jc"], jnp.asarray(g["toks"][:, :1]))
    t1 = torch.from_numpy(g["toks"][:, :1]).long()
    outs = {u: tT.decode_step(g["tp"], g["cfg"], _port_cache(g), tokens=t1,
                              uniform_pos=u) for u in (True, False)}
    logits, new = outs[True]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), np.asarray(jnew[name]),
                                   rtol=1e-5, atol=1e-5)
    assert new["lengths"].tolist() == np.asarray(jnew["lengths"]).tolist()
    # the default path writes the same rows with the same arithmetic
    logits_d, new_d = outs[False]
    assert torch.equal(logits, logits_d)
    assert all(torch.equal(new[n], new_d[n]) for n in ("k", "v"))


def test_decode_uniform_pos_clamps_as_jax(granite):
    """A position past the cache is clamped to its last row, as
    `dynamic_update_slice` clamps its start."""
    g = granite
    jc = dict(g["jc"], lengths=jnp.full((B,), M, jnp.int32))
    _, jnew = g["dec"](g["jp"], jc, jnp.asarray(g["toks"][:, :1]))
    _, new = tT.decode_step(g["tp"], g["cfg"], _port_cache(g, full=True),
                            tokens=torch.from_numpy(g["toks"][:, :1]).long(),
                            uniform_pos=True)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), np.asarray(jnew[name]),
                                   rtol=1e-5, atol=1e-5)


def _count(fn, grad=False):
    with OC.OpCounter() as oc:
        if grad:
            fn()
        else:
            with torch.no_grad():
                fn()
    return oc


@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
def test_op_counter_matches_hlo_stats(granite, step):
    """Dot flops of the port's step on the CPU route against hlo_stats of
    the JAX package's compiled step; tolerance 0 after the one term the
    module docstring names."""
    g = granite
    cfg, tp = g["cfg"], g["tp"]
    tt = torch.from_numpy(g["toks"]).long()
    gap = 0
    if step == "prefill":
        want = analyze(g["pre"].as_text()).flops
        oc = _count(lambda: tT.prefill(tp, cfg, tokens=tt, max_len=M))
        gap = 2 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    elif step == "decode":
        want = analyze(g["dec"].as_text()).flops
        tc = _port_cache(g)
        oc = _count(lambda: tT.decode_step(tp, cfg, tc, tokens=tt[:, :1],
                                           uniform_pos=True))
    else:
        jp = g["jp"]
        want = analyze(jax.jit(jts.make_train_step(g["jcfg"], remat=False))
                       .lower(jp, jopt.adamw_init(jp),
                              {"tokens": jnp.asarray(g["toks"])})
                       .compile().as_text()).flops
        oc = _count(lambda: tts.train_step(tp, topt.adamw_init(tp),
                                           {"tokens": tt}, cfg, remat=False),
                    grad=True)
    assert oc.kernel_calls == {}
    assert oc.flops + gap == want
    assert oc.bytes > 0 and oc.peak_bytes > 0


def test_traced_microbatch_counts_equal_the_whole_loop(granite):
    """The dry run traces one of mb identical microbatches and multiplies:
    its flops, bytes and calls equal tracing `train_step`'s whole loop."""
    cfg, tp = granite["cfg"], granite["tp"]
    mb, toks = 2, torch.randint(0, cfg.vocab_size, (4, S))
    fn = D._train_fn(cfg, mb, "none")
    opt = topt.adamw_init(tp)
    with OC.OpCounter() as once:
        fn(tp, opt, {"tokens": toks}, counter=once)
    with OC.OpCounter() as whole:
        tts.train_step(tp, opt, {"tokens": toks}, cfg, microbatches=mb)
    assert (once.flops, once.bytes, once.calls) == \
        (whole.flops, whole.bytes, whole.calls)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops_of(fn):
    with _OpLog() as log:
        out = fn()
    return out, [op for op in log.ops if op != "aten.lift_fresh.default"]


def test_fake_cuda_indexing_equals_torch():
    """The bindings rerouted for fake CUDA tensors give PyTorch's own
    results through PyTorch's own aten ops (checked on CPU tensors)."""
    x = torch.arange(4 * 5 * 6, dtype=torch.float32).reshape(4, 5, 6)
    i = torch.tensor([0, 3, 1, 1])
    b = torch.arange(4)
    for idx in ((b, i), (slice(None), 2), (..., 1), (1, slice(1, 4), None),
                (slice(None), slice(0, 1)), (b[:2], slice(None), i[:2]),
                (None, ..., -1), 2, slice(None), slice(1, 3), b,
                (slice(None), slice(0, 5)), (slice(1, None), i[:3])):
        want, want_ops = _ops_of(lambda: x[idx])
        got, got_ops = _ops_of(lambda: OC._getitem(x, idx))
        assert torch.equal(got, want) and got_ops == want_ops, idx
    for idx, val in (((b, i), torch.ones(4, 6)), ((slice(None), 0), 7.0),
                     ((slice(None), slice(0, 1)), torch.full((4, 1, 6), 2.)),
                     ((0,), torch.full((1, 5, 6), 3.)), ((b, i), 2.0),
                     (0, torch.ones(5, 6))):
        want, got = x.clone(), x.clone()
        _, want_ops = _ops_of(lambda: want.__setitem__(idx, val))
        _, got_ops = _ops_of(lambda: OC._setitem(got, idx, val))
        assert torch.equal(got, want) and got_ops == want_ops, idx
    t = x.transpose(0, 1)
    assert torch.equal(OC._contiguous(t), t.contiguous())


# ---------------------------------------------------------------------------
# fake CUDA tensors at full width
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernels/build.py ran during a dry run")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_full_width_cell_takes_the_card_route(no_build, shape):
    cfg, sh = get_config("granite-8b"), SHAPES[shape]
    before = ops.launch_counts()
    rec = D.run_cell("granite-8b", shape, verbose=False)
    assert ops.launch_counts() == before
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["peaks"] == "h100-sxm" and rec["split"] == "even"
    assert rec["coll_bytes_per_dev"] is None
    B, S, KV, dh = sh.global_batch, sh.seq_len, cfg.n_kv_heads, cfg.d_head
    G, L = cfg.n_heads // KV, cfg.n_layers
    if shape == "prefill_32k":
        name = "prefill_attention"
        flops, nbytes = cost.prefill_work(B, S, KV, G, dh, dh, 2,
                                          cost.GLOBAL, True)
    else:
        name = "decode_attention"
        flops, nbytes = cost.decode_work(B, 1, KV, G, dh, dh, S, [S] * B,
                                         cost.GLOBAL, 2, 2)
    assert rec["kernel_calls"] == {name: {"calls": L, "flops": L * flops,
                                          "bytes": L * nbytes}}
    assert rec["flops_per_dev"] * 256 == pytest.approx(
        rec["aten_flops_per_dev"] * 256 + L * flops, rel=1e-12)
    r = rec["roofline"]
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"]) > 0
    assert r["collective_s"] is None


def test_train_cell_at_a_depth_cut(no_build):
    rec = D.run_cell("granite-8b", "train_4k", verbose=False, n_layers=1)
    assert rec["ok"] and rec["cut"] == "depth 1 of 36"
    assert rec["trace_device"] == "cpu" and rec["kernel_calls"] == {}
    assert rec["microbatches"] == {"mb": 16, "traced": 1}
    assert rec["per_device_bytes"]["temp"] > 0
    assert rec["useful_flops_ratio"] > 0


def test_dryrun_knobs_reach_the_layers(no_build):
    prev = (tL.FLASH_BLOCK, tL.MOE_IMPL)
    try:
        D.build_cell(get_config("granite-8b"), SHAPES["train_4k"],
                     tmesh.make_production_mesh(),
                     {"flash_block": "256", "moe": "scatter"})
        assert (tL.FLASH_BLOCK, tL.MOE_IMPL) == (256, "scatter")
    finally:
        tL.FLASH_BLOCK, tL.MOE_IMPL = prev


def test_cost_formulas_give_the_perf_table_bounds():
    """kernels/cost.py on chip_smoke.py's kernel-row shapes gives the
    bounds PERF.md's kernel table lists (ms, to its digits)."""
    bf16 = torch.bfloat16
    # A / B at the 8B flush: B 14, KV 8, G 4, d 128, S 1152, bf16 q; the
    # row's seeded lengths leave 8768 visible cache rows (chip_smoke.py's
    # `visible_rows`); bf16 K / V, and int8 with 8 bytes of scales
    lengths = [626] * 13 + [8768 - 626 * 13]
    for kv_size, scales, want in ((2, 0, 0.01079), (1, 8, 0.005596)):
        f, n = cost.decode_work(14, 1, 8, 4, 128, 128, 1152, lengths,
                                cost.GLOBAL, 2, kv_size, scales)
        ms, by = cost.bound(n, f, bf16)
        assert (float(f"{ms:.4g}"), by) == (want, "bytes")
    # C at the 8B Session chunk: L 32, B 4, S 512, KV 8, G 4, dk 128, bf16
    k_numel, st_numel = 32 * 4 * 512 * 8 * 128, 32 * 8 * 4 * 128
    f, n = cost.expected_attention_work(k_numel, 2, st_numel, 2,
                                        32 * 4 * 512 * 8)
    ms, by = cost.bound(n, f, torch.float32)
    assert (round(ms, 5), by) == (0.04085, "bytes")
    # D bf16 at B 4, S 512, KV 8, G 4, d 128, causal
    f, n = cost.prefill_work(4, 512, 8, 4, 128, 128, 2, cost.GLOBAL, True)
    ms, by = cost.bound(n, f, bf16)
    assert (round(ms, 5), by) == (0.01252, "bytes")
    # D f32 (FMA) at the planted lg build: B 16, S 160, KV 4, G 1, d 24
    f, n = cost.prefill_work(16, 160, 4, 1, 24, 24, 4, cost.GLOBAL, True)
    ms, by = cost.bound(n, f, torch.float32)
    assert (round(ms, 6), by) == (0.001181, "operations")


@pytest.mark.parametrize("S,window,causal", [
    (1, 1, True), (7, 3, True), (160, cost.GLOBAL, True), (200, 17, False),
    (130, 17, True), (64, 64, False), (50, 80, False), (33, 1, False)])
def test_prefill_live_pairs_closed_form(S, window, causal):
    loop = sum((i + 1 if causal else S) - max(0, i - window + 1)
               for i in range(S))
    assert cost.prefill_live_pairs(S, window, causal) == loop


# ---------------------------------------------------------------------------
# against the JAX package's dry run (the subprocess)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_and_shapes_match_jax(jax_side, arch):
    cfg = get_config(arch)
    assert [s.name for s in applicable_shapes(cfg)] == \
        jax_side["shapes"][arch]
    for shape in applicable_shapes(cfg):
        assert D.model_flops(cfg, shape) == \
            jax_side["flops"][f"{arch}/{shape.name}"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_per_device_argument_bytes_match_jax(jax_side, arch, mesh_name):
    mesh = tmesh.make_production_mesh(multi_pod=MESHES[mesh_name])
    assert mesh.size == (512 if MESHES[mesh_name] else 256)
    for shape in applicable_shapes(get_config(arch)):
        key = f"{arch}/{shape.name}/{mesh_name}"
        fn, args, shards, rules = D.build_cell(get_config(arch),
                                               SHAPES[shape.name], mesh)
        assert D.per_device_argument_bytes(args, shards, mesh) == \
            jax_side["bytes"][key], key
        assert {k: list(v) if isinstance(v, tuple) else v
                for k, v in rules.items()} == jax_side["rules"][key], key


def test_hardware_peaks_match_jax(jax_side, monkeypatch):
    sets = jax_side["peaks"]["sets"]
    assert dataclasses.asdict(tmesh.TPU_V5E) == sets["TPU_V5E"]
    assert dataclasses.asdict(tmesh.CI_CPU) == sets["CI_CPU"]
    for name, env in ENVS.items():
        for k in ("STRETTO_ROOFLINE_GFLOPS", "STRETTO_ROOFLINE_BW_GBS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        want = jax_side["peaks"][name]
        assert dataclasses.asdict(tmesh.resolve_peaks(tmesh.TPU_V5E)) == \
            want["tpu"]
        assert dataclasses.asdict(tmesh.resolve_peaks()) == want["cpu"]
    monkeypatch.delenv("STRETTO_ROOFLINE_GFLOPS", raising=False)
    monkeypatch.delenv("STRETTO_ROOFLINE_BW_GBS", raising=False)
    h = tmesh.resolve_peaks(tmesh.H100_SXM)
    assert (h.name, h.flops, h.hbm_bw, h.ici_bw) == \
        ("h100-sxm", 989e12, 3.35e12, 450e9)
    assert (cost.PEAK_BF16_TC_FLOPS, cost.PEAK_BYTES_S) == \
        (h.flops, h.hbm_bw)
