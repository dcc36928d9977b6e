"""The PyTorch port stands alone: importing every `repro_torch` module
pulls in neither JAX nor any module of the JAX package."""
import json
import os
import pkgutil
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _port_modules():
    sys.path.insert(0, SRC)
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_port_imports_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.decode_attention" in mods
    assert "repro_torch.serving.engine" in mods
    assert "repro_torch.kernels.prefill_attention" in mods
    assert "repro_torch.runtime.tree" in mods
    for m in ("repro_torch.scheduler", "repro_torch.scheduler.hub",
              "repro_torch.scheduler.scheduler",
              "repro_torch.scheduler.tenants", "repro_torch.remote",
              "repro_torch.remote.protocol", "repro_torch.remote.server",
              "repro_torch.remote.client", "repro_torch.remote.testing",
              "repro_torch.launch.remote_worker",
              "repro_torch.launch.serve", "repro_torch.launch.mesh",
              "repro_torch.distributed.sharding",
              "repro_torch.configs.deepseek_v2_lite_16b",
              "repro_torch.training", "repro_torch.training.optimizer",
              "repro_torch.training.train_step",
              "repro_torch.training.checkpoint",
              "repro_torch.training.loop", "repro_torch.training.tree",
              "repro_torch.data.pipeline", "repro_torch.launch.train",
              "repro_torch.launch.specs", "repro_torch.launch.dryrun",
              "repro_torch.launch.op_count", "repro_torch.kernels.cost"):
        assert m in mods
    # the lazy exports resolve too (a module path in a string is an import)
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {os.path.abspath(SRC)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import repro_torch, repro_torch.runtime as R, "
        "repro_torch.scheduler as S, repro_torch.remote as W\n"
        "for mod in (repro_torch, R, S, W):\n"
        "    [getattr(mod, n) for n in mod.__all__ if n != '__version__']\n"
        "assert R.PoolBackend.__module__ == 'repro_torch.runtime.backend'\n"
        "assert R.EngineTaggedOperator.__module__ == "
        "'repro_torch.runtime.backend'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ""})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_never_name_the_jax_package():
    root = os.path.join(SRC, "repro_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and (
                            " jax" in s or s.startswith(("import repro.",
                                                         "from repro."))
                            or s in ("import repro", "import jax")):
                        offenders.append(f"{path}:{i}: {s}")
    assert offenders == []


def test_port_sources_name_no_module_of_the_jax_package():
    """No module path of the JAX package in a string either (lazy
    exports, importlib): the scheduler's and runtime's PEP 562 tables
    name `repro_torch.*` only."""
    import re
    root = os.path.join(SRC, "repro_torch")
    pat = re.compile(r"[\"']repro(\.[a-z_]+)*[\"']")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if pat.search(line):
                            offenders.append(f"{path}:{i}: {line.strip()}")
    assert offenders == []
