"""Stretto runtime of the port: the single execution path for plans.

  kernel.py    — accept/reject/unsure decision rule (numpy)
  backend.py   — Backend protocol + Oracle / KVCache / Reference backends
  executor.py  — streaming partitioned cascade executor (StageStats)
  dispatch.py  — flush dispatch: inline / thread pool (STRETTO_DISPATCHER)

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
    "as_backend": "repro_torch.runtime.backend",
    "StageStats": "repro_torch.runtime.executor",
    "RuntimeResult": "repro_torch.runtime.executor",
    "PartitionResult": "repro_torch.runtime.executor",
    "run_plan": "repro_torch.runtime.executor",
    "iter_plan": "repro_torch.runtime.executor",
    "run_operator": "repro_torch.runtime.executor",
    "DEFAULT_COALESCE": "repro_torch.runtime.dispatch",
    "FlushTask": "repro_torch.runtime.dispatch",
    "InlineDispatcher": "repro_torch.runtime.dispatch",
    "ThreadPoolDispatcher": "repro_torch.runtime.dispatch",
    "resolve_dispatcher": "repro_torch.runtime.dispatch",
    "effective_spec": "repro_torch.runtime.dispatch",
    "DISPATCHER_ENV": "repro_torch.runtime.dispatch",
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
