"""repro_torch — the Stretto execution engine ported to PyTorch and CUDA.

A second package beside the JAX reference `repro`; it imports neither
JAX nor `repro`. The documented entry point is the declarative API::

    import repro_torch
    with repro_torch.Session(lg_int8=(0.3,)) as sess:      # on the card
        result = (sess.frame(items)
                  .sem_filter("mentions topic 1", task_id=1)
                  .with_guarantees(recall=0.9, precision=0.9)
                  .execute())

Layers:
  repro_torch.api      — Session / SemFrame / EXPLAIN / streaming results
  repro_torch.configs  — ModelConfig + stretto-llama-8b
  repro_torch.models   — the GQA decoder (prefill, decode, fused decode)
  repro_torch.data     — planted corpora and constructed weights
  repro_torch.cache    — Expected-Attention compression + npz CacheStore
  repro_torch.serving  — prefill-skip ServingEngine and its operators
  repro_torch.core     — the planner: plan IR, profiling, relaxation,
                         Beta bounds, gradient optimizer, DP reorder
  repro_torch.runtime  — backends, dispatchers, streaming executor
  repro_torch.kernels  — hand-written CUDA kernels for Hopper (csrc/),
                         their plain PyTorch versions and the nvcc loader

Entry points take an explicit `device` (default "cuda") and raise when
CUDA is missing; tests pass device="cpu". Top-level attribute access is
lazy (PEP 562): ``import repro_torch`` loads nothing else until a name
is used.
"""
__version__ = "0.2.0"

_EXPORTS = {
    "Session": "repro_torch.api",
    "SessionConfig": "repro_torch.api",
    "EngineSpec": "repro_torch.api",
    "SemFrame": "repro_torch.api",
    "ExplainReport": "repro_torch.api",
    "QueryResult": "repro_torch.api",
    "ResultStream": "repro_torch.api",
    "PlannerConfig": "repro_torch.core.optimizer",
    "MeasuredBatchStore": "repro_torch.core.profiling",
    "Query": "repro_torch.core.logical",
    "SemFilter": "repro_torch.core.logical",
    "SemMap": "repro_torch.core.logical",
    "RelFilter": "repro_torch.core.logical",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


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
