"""Stretto runtime of the port: the single execution path for plans.

  kernel.py    — accept/reject/unsure decision rule (numpy; torch for
                 the relaxation)
  backend.py   — Backend protocol + Oracle / KVCache / Reference backends
                 and the engine pool (PoolBackend)
  executor.py  — streaming partitioned cascade executor (StageStats)
  dispatch.py  — flush dispatch: inline / thread pool, and the partition
                 scatter: sharded / mesh (STRETTO_DISPATCHER)
  plan_utils.py — gold plans, gold membership, PipelineData lifting and
                 selectivity estimates for the planner
  tree.py      — join-tree execution: both sides, then the pair cascade
                 over blocked survivor pairs

Attribute access is lazy (PEP 562), as in the JAX package.
"""
from __future__ import annotations

_EXPORTS = {
    "decide": "repro_torch.runtime.kernel",
    "gold_decide": "repro_torch.runtime.kernel",
    "Backend": "repro_torch.runtime.backend",
    "OracleBackend": "repro_torch.runtime.backend",
    "KVCacheBackend": "repro_torch.runtime.backend",
    "ReferenceBackend": "repro_torch.runtime.backend",
    "RegistryBackend": "repro_torch.runtime.backend",
    "PoolBackend": "repro_torch.runtime.backend",
    "EngineTaggedOperator": "repro_torch.runtime.backend",
    "as_backend": "repro_torch.runtime.backend",
    "StageStats": "repro_torch.runtime.executor",
    "RuntimeResult": "repro_torch.runtime.executor",
    "PartitionResult": "repro_torch.runtime.executor",
    "run_plan": "repro_torch.runtime.executor",
    "iter_plan": "repro_torch.runtime.executor",
    "run_operator": "repro_torch.runtime.executor",
    "stage_stats_by_engine": "repro_torch.runtime.executor",
    "merge_stage_stats": "repro_torch.runtime.executor",
    "gold_plan_for": "repro_torch.runtime.plan_utils",
    "gold_membership": "repro_torch.runtime.plan_utils",
    "pipelines_data": "repro_torch.runtime.plan_utils",
    "estimate_selectivities": "repro_torch.runtime.plan_utils",
    "DEFAULT_COALESCE": "repro_torch.runtime.dispatch",
    "FlushTask": "repro_torch.runtime.dispatch",
    "backend_engines": "repro_torch.runtime.dispatch",
    "InlineDispatcher": "repro_torch.runtime.dispatch",
    "ThreadPoolDispatcher": "repro_torch.runtime.dispatch",
    "ShardedDispatcher": "repro_torch.runtime.dispatch",
    "MeshDispatcher": "repro_torch.runtime.dispatch",
    "resolve_dispatcher": "repro_torch.runtime.dispatch",
    "effective_spec": "repro_torch.runtime.dispatch",
    "DISPATCHER_ENV": "repro_torch.runtime.dispatch",
    "PairItem": "repro_torch.runtime.tree",
    "TreeResult": "repro_torch.runtime.tree",
    "make_pairs": "repro_torch.runtime.tree",
    "survivor_pairs": "repro_torch.runtime.tree",
    "run_tree": "repro_torch.runtime.tree",
    "run_gold_tree": "repro_torch.runtime.tree",
    "evaluate_pairs": "repro_torch.runtime.tree",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
