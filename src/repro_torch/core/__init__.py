"""The planner of the port: the logical IR (`logical.py`) and physical
plan (`physical.py`), framework-free copies of the JAX package's modules;
profiling (`profiling.py`), the continuous relaxation (`relaxation.py`),
the Beta credible bounds (`bounds.py`, kernel E on the card), the
gradient optimizer (`optimizer.py`, one CUDA graph per Adam step on the
card), the DP reorderer (`ordering.py`), `planner.plan_query` /
`plan_tree`, and the paper's comparison planners (`baselines.py`), in
torch and numpy.

The names below are the JAX package's `repro.core` exports. Access is
lazy (PEP 562), so importing a submodule (the runtime imports
`core.relaxation`) does not pull in the planner, which imports the
runtime."""
_EXPORTS = {
    "repro_torch.core.bounds": (
        "beta_lower_bound", "betaincinv", "precision_lower_bound",
        "recall_lower_bound"),
    "repro_torch.core.executor": (
        "ExecutionResult", "evaluate_vs_gold", "execute_plan"),
    "repro_torch.core.logical": (
        "AggNode", "JoinNode", "LogicalNode", "PipelineLeaf", "Query",
        "RelFilter", "SemAgg", "SemFilter", "SemJoin", "SemMap", "SemTopK",
        "TopKNode", "as_tree", "lower_tree", "normalize",
        "pull_up_semantic"),
    "repro_torch.core.optimizer": (
        "OptimizedPlan", "PlannerConfig", "optimize_query"),
    "repro_torch.core.physical": (
        "CostCurve", "PhysicalOperator", "PhysicalPlan", "PhysicalPlanStage",
        "ProfiledPipeline", "TreePlan"),
    "repro_torch.core.planner": ("plan_query", "plan_tree"),
    "repro_torch.core.profiling": (
        "MeasuredBatchStore", "batch_drift", "fit_cost_curve",
        "profile_query"),
    "repro_torch.core.relaxation": (
        "BatchHint", "PipelineData", "PipelineParams", "QueryCounts",
        "query_counts", "simulate_pipeline"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name in _WHERE:
        import importlib
        value = getattr(importlib.import_module(_WHERE[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
