#!/usr/bin/env python3
"""The independent ablation's thresholds, port against JAX package, and
each package against itself with its start moved by one float32 ulp.

    PYTHONPATH=src python3 scripts/independent_gap.py [--worlds 5:100,5:120]

Runs on the CPU and imports both packages, as the parity tests do. For
each world (dataset seed : items), both packages build the planted world
of `tests/test_torch_baselines.py` (same models, ladder and query: an f1
filter and a v3 map, targets 0.6, 150 steps) and plan it with
`plan_stretto_independent` under the tests' pinned profiling clock; then
each plans it again with every start parameter moved up by one ulp
(nextafter towards +inf) before its Adam loop. Prints one JSON line per
world: whether the stages agree, the largest gap between the thresholds
of stages both plans keep (port vs JAX, port vs nudged port, JAX vs
nudged JAX) and each run's bounds. A gap between packages no larger than
what one ulp of the start does within a package is rounding carried
along the trajectory, not a different algorithm.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"),
                os.path.join(HERE, "..", "tests")]

LADDER = dict(sm_ratios=(0.5, 0.0), lg_ratios=(0.5,))
FAST = dict(steps=150, restarts=2, snapshots=3)


def build(seed, n, root):
    from repro.cache.store import CacheStore as JStore
    from repro.data import synthetic as jsyn
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.operators import make_registry as jmake_registry
    from repro_torch.cache.store import CacheStore
    from repro_torch.data import synthetic as tsyn
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.operators import make_registry
    ds = jsyn.make_dataset("baselines", n, seed=seed)
    jeng = JEngine(JStore(os.path.join(root, "j")), device_cache=False)
    teng = ServingEngine(CacheStore(os.path.join(root, "t")),
                         device_cache=False, device="cpu")
    for size in ("sm", "lg"):
        jcfg = jsyn.planted_config(size)
        jeng.register_model(size, jcfg, jsyn.make_planted_params(jcfg,
                                                                 seed=1))
        jeng.build_profiles(size, ds.items, ratios=(0.0, 0.5),
                            prefill_batch=40)
        tcfg = tsyn.planted_config(size)
        teng.register_model(size, tcfg, tsyn.make_planted_params(
            tcfg, seed=1, device="cpu"))
        teng.build_profiles(size, ds.items, ratios=(0.0, 0.5),
                            prefill_batch=40)
    return ds, jmake_registry(jeng, **LADDER), make_registry(teng, **LADDER)


def plan(pkg, ds, reg, nudge):
    import pytest
    if pkg == "jax":
        import jax.numpy as jnp
        import repro.core.baselines as BL
        from repro.core import PlannerConfig, Query, SemFilter, SemMap
        up = lambda x: jnp.nextafter(x, jnp.inf)    # noqa: E731
        kw = {}
    else:
        import torch
        import repro_torch.core.baselines as BL
        from repro_torch.core import PlannerConfig, Query, SemFilter, SemMap
        up = lambda x: torch.nextafter(x, torch.tensor(float("inf")))  # noqa
        kw = dict(device="cpu")
    import repro.runtime.executor as jex
    import repro_torch.runtime.executor as tex
    from test_torch_planner import pin_clock
    query = Query([SemFilter("f1", 1), SemMap("extract v3", 3)],
                  target_recall=0.6, target_precision=0.6)
    with pytest.MonkeyPatch.context() as mp:
        pin_clock(mp, jex)
        pin_clock(mp, tex)
        if nudge:
            real = BL.flatten_params
            mp.setattr(BL, "flatten_params", lambda p: up(real(p)))
        return BL.plan_stretto_independent(
            query, ds.items, reg, PlannerConfig(**FAST), sample_frac=0.3,
            seed=0, **kw)


def thresholds(p):
    return {(s.logical_idx, s.op_name): (s.thr_hi, s.thr_lo)
            for s in p.stages if not s.is_gold}


def gap(a, b) -> float:
    ta, tb = thresholds(a), thresholds(b)
    return max([abs(x - y) for k in set(ta) & set(tb)
                for x, y in zip(ta[k], tb[k])], default=0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds", default="5:100,5:120,7:100,7:120,11:120")
    args = ap.parse_args()
    for w in args.worlds.split(","):
        seed, n = (int(v) for v in w.split(":"))
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "..",
                                                          "build")) as root:
            ds, jreg, treg = build(seed, n, root)
            runs = {(pkg, nudge): plan(pkg, ds, reg, nudge)
                    for pkg, reg in (("jax", jreg), ("torch", treg))
                    for nudge in (False, True)}
        stages = {f"{pkg}{'_nudged' if nudge else ''}":
                  [s.op_name for s in p.stages]
                  for (pkg, nudge), p in runs.items()}
        print(json.dumps(dict(
            seed=seed, items=n, stages=stages,
            gap_port_vs_jax=gap(runs["torch", False], runs["jax", False]),
            gap_port_vs_nudged_port=gap(runs["torch", False],
                                        runs["torch", True]),
            gap_jax_vs_nudged_jax=gap(runs["jax", False], runs["jax", True]),
            bounds={f"{pkg}{'_nudged' if nudge else ''}":
                    [p.recall_bound, p.precision_bound]
                    for (pkg, nudge), p in runs.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
