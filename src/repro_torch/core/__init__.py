"""Plan-layer dataclasses of the port: the logical IR (`logical.py`) and
the physical plan (`physical.py`), framework-free copies of the JAX
package's modules. The planner itself is not ported yet."""
