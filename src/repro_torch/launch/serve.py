"""Concurrent serving launcher: build cache profiles for a corpus, then
admit a stream of SemFrame queries through the QueryScheduler (the
paper's online phase, many tenants sharing one engine pool).

    python -m repro_torch.launch.serve --items 200 --ratios 0.0,0.5,0.8 \\
        --requests 8 --concurrency 4 [--device cuda]

Each request is a declarative SemFrame query planned and executed by the
Session; requests overlap under the scheduler, so flushes from different
queries that target the same (engine, operator) coalesce into merged
engine calls. The summary line reports how many engine calls the
coalescing saved and the per-tenant fairness accounting. The engines run
on `--device` ("cuda" by default: the hand-written kernels on the card;
"cpu" runs their plain versions) over the planted reduced models.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.api import Session, SessionConfig
from repro_torch.core.optimizer import PlannerConfig
from repro_torch.data.synthetic import make_dataset
from repro_torch.scheduler import TenantSpec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=200)
    ap.add_argument("--ratios", type=str, default="0.0,0.5,0.8")
    ap.add_argument("--cache-dir", type=str, default=None)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--concurrency", type=int, default=4,
                    help="scheduler slots (queries in flight)")
    ap.add_argument("--recall", type=float, default=0.7)
    ap.add_argument("--precision", type=float, default=0.7)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the engines (cuda, cpu)")
    args = ap.parse_args(argv)
    ratios = tuple(float(r) for r in args.ratios.split(","))

    ds = make_dataset("serve", args.items, seed=0)
    session = Session(SessionConfig(
        cache_dir=args.cache_dir or tempfile.mkdtemp(),
        profile_ratios=ratios,
        sm_ratios=ratios, lg_ratios=ratios,
        planner=PlannerConfig(steps=150, restarts=2, snapshots=2),
        sample_frac=0.3, device=args.device,
        tenants=(TenantSpec("premium", tier="premium"),
                 TenantSpec("standard"),
                 TenantSpec("batch", tier="cold"))))
    t0 = time.time()
    session.prepare(ds.items)
    print(f"[serve] offline phase: {time.time() - t0:.1f}s "
          f"({args.items} items x {len(session.config.models)} models "
          f"x {len(ratios)} ratios) on {session.device}")

    rng = np.random.default_rng(0)
    tenants = ("premium", "standard", "batch")
    t0 = time.time()
    with session, session.scheduler(
            max_concurrent=args.concurrency) as sched:
        handles = []
        for i in range(args.requests):
            task = int(rng.integers(0, ds.n_filter_tasks))
            frame = (session.frame(ds.items)
                     .sem_filter(f"filter task {task}", task_id=task)
                     .with_guarantees(recall=args.recall,
                                      precision=args.precision))
            tenant = tenants[i % len(tenants)]
            handles.append((i, task, tenant, sched.submit(frame,
                                                          tenant=tenant)))
        for i, task, tenant, h in handles:
            res = h.result(timeout=600)
            s = res.sched
            print(f"[serve] req{i}: filter task={task} tenant={tenant} "
                  f"-> {int(res.accepted.sum())}/{len(ds.items)} accepted, "
                  f"wait={s.queue_wait_s * 1e3:.0f}ms "
                  f"run={s.run_wall_s:.2f}s "
                  f"shared_batches={s.shared_batches}")
        stats = sched.stats()
    wall = time.time() - t0
    print(f"[serve] online phase: {args.requests} queries in {wall:.1f}s "
          f"({args.requests / max(wall, 1e-9):.2f} q/s) — "
          f"{stats['n_flushes']} flushes -> {stats['n_calls']} engine "
          f"calls ({stats['saved_calls']} saved by coalescing)")
    for name, t in sorted(stats["tenants"].items()):
        if not t["n_queries"]:
            continue
        print(f"[serve]   tenant {name} ({t['tier']}, w={t['weight']}): "
              f"{t['n_queries']} queries, {t['n_tuples']} tuples, "
              f"vtime={t['vtime']:.0f}, warm_batches={t['warm_batches']}, "
              f"evictions={t['evictions']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
