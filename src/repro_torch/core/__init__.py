"""The planner of the port: the logical IR (`logical.py`) and physical
plan (`physical.py`), framework-free copies of the JAX package's modules;
profiling (`profiling.py`), the continuous relaxation (`relaxation.py`),
the Beta credible bounds (`bounds.py`), the gradient optimizer
(`optimizer.py`), the DP reorderer (`ordering.py`) and `planner.plan_query`
in torch and numpy. Join-tree planning and the baselines are not ported
yet."""
