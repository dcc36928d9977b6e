import gc
import os
import sys

import pytest

# tests see the real device count (1); only the dry-run forces 512.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# The device-resident profile cache intentionally skips kv_bytes on hits,
# which would make the suite's many repeated-execution / schedule-parity
# assertions depend on test ordering. Default it off for the suite;
# dedicated device-cache tests enable it explicitly per engine.
os.environ.setdefault("STRETTO_DEVICE_CACHE", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_mmap_growth():
    """Every XLA CPU executable holds ~3 anonymous mappings (code /
    rodata / data), a single engine-heavy module compiles hundreds, and
    the kernel's default vm.max_map_count is 65530 — a full one-process
    suite run ends within a few percent of the ceiling and segfaults in
    LLVM ("Cannot allocate memory") when it crosses. Dropping the
    compiled-executable caches between modules releases those mappings
    (measured: 3054 -> 537 after one module); jitted callables simply
    recompile on next use, so only wall time is affected. Clear only
    when genuinely near the ceiling to keep cross-module cache reuse."""
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:                    # non-linux: no limit to manage
        return
    if n > 30_000:
        import jax
        jax.clear_caches()
        gc.collect()
